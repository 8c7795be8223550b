"""Mesh and sharding layer: instances over the data axes, validators over
`val`, on `torch.distributed` (twin of `agnes_tpu.parallel`).

The two scaling axes of a consensus fleet are instances (independent
machines, sharded as data parallelism, no collective) and validators
(the tally's reduction axis, whose quorum sums are `all_reduce`s over
the mesh's `val` group).  The port runs one process per device
(parallel/mesh.py); `make_hierarchical_mesh` adds an outer `slice` axis
that, like `data`, carries no collective; `make_pod_mesh` makes its
slices hosts (distributed/).
"""

from agnes_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SLICE_AXIS,
    VAL_AXIS,
    make_hierarchical_mesh,
    make_mesh,
    make_pod_mesh,
)
from agnes_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedStep,
    gather_step_outputs,
    gather_tree,
    make_sharded_honest_heights,
    make_sharded_step,
    make_sharded_step_seq,
    make_sharded_step_seq_signed,
    place_step_state,
    shard_step_args,
    shard_tree,
)
