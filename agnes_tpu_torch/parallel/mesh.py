"""Device meshes of the consensus data plane (twin of
`agnes_tpu.parallel.mesh`).

Axes:
  * ``slice`` — (hierarchical meshes only) the outer instance axis: one
    shard per group of hosts.  Nothing in the step communicates over it.
  * ``data`` — instance axis: independent consensus instances, no
    cross-talk.
  * ``val``  — validator axis: the tally's reduction axis; its partial
    weights are combined by `all_reduce` over the axis's process group
    (`device/tally.psum`).

Departure from the twin: JAX drives its mesh from one controller
process; the port's mesh is one process per device.  Each process calls
`torch.distributed.init_process_group` itself (address, world size and
rank given by the caller: `tcp://localhost:<port>` or a `file://`
rendezvous), then builds the same mesh here, a
`torch.distributed.device_mesh.DeviceMesh` whose rank r sits at row-major
position r of the grid.  Every rank holds the blocks of its mesh
coordinate (parallel/sharded.py).  Device type "cuda" (NCCL, one card a
rank, the card picked by the caller's `torch.cuda.set_device`) unless the
caller asks for "cpu" (gloo, the CPU differentials).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

SLICE_AXIS = "slice"
DATA_AXIS = "data"
VAL_AXIS = "val"


def _mesh(shape, names, device_type: str) -> DeviceMesh:
    need = 1
    for n in shape:
        need *= int(n)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        dims = "x".join(str(n) for n in shape)
        raise ValueError(f"mesh {dims} needs {need} devices, have {have}")
    grid = torch.arange(need, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def make_mesh(n_data: int, n_val: int,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data=n_data, val=n_val) mesh over the first n_data * n_val
    ranks of the initialized default process group."""
    return _mesh((n_data, n_val), (DATA_AXIS, VAL_AXIS), device_type)


def make_hierarchical_mesh(n_slices: int, n_data: int, n_val: int,
                           device_type: str = "cuda") -> DeviceMesh:
    """A (slice=n_slices, data=n_data, val=n_val) mesh: instances shard
    over slice x data, the tally's all_reduces stay on val."""
    return _mesh((n_slices, n_data, n_val),
                 (SLICE_AXIS, DATA_AXIS, VAL_AXIS), device_type)
