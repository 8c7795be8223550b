"""The pod: one signed deployment served by several processes over
`torch.distributed` (twin of `agnes_tpu.distributed`).

  topology.py    sharding math, the decision-frame codec, liveness
  membership.py  repartition, re-lift and negotiation math and the
                 MembershipEpoch protocol (numpy only)
  pod.py         initialize_pod; lockstep agree / barrier and the
                 byte-frame all_gather over a gloo group of every rank
  driver.py      DistributedDriver: one host's dense step on its (data,
                 val) sub-mesh, its read-outs gathered over the host
  shard.py       HostShard: a process's serve front end (screen, warmup
                 barriers, decision gather, drain)
  elastic.py     ElasticShard: per-tick shape negotiation, host leave /
                 rejoin at epoch boundaries
  smoke.py       the spawnable worker and `spawn_pod` (tests, the chip
                 smoke): `python -m agnes_tpu_torch.distributed.smoke`

A host is a block of consecutive ranks (`per_host`, one process a
device); across hosts only the plan digests, the warmup barriers, the
decision frames and the elastic frames pass.
"""

from agnes_tpu_torch.distributed.driver import DistributedDriver  # noqa: F401
from agnes_tpu_torch.distributed.elastic import (  # noqa: F401
    ElasticFrame,
    ElasticShard,
    pack_elastic_frame,
    unpack_elastic_frame,
)
from agnes_tpu_torch.distributed.membership import (  # noqa: F401
    MembershipEpoch,
    MembershipError,
    MembershipView,
    Repartition,
    TickSlot,
    merge_tick_plans,
    partition_ranges,
    relift_ranges,
    relift_tree,
    validate_partition,
)
from agnes_tpu_torch.distributed.pod import (  # noqa: F401
    PodCoordinator,
    PodDivergenceError,
    initialize_pod,
    shutdown_pod,
)
from agnes_tpu_torch.distributed.shard import HostShard  # noqa: F401
from agnes_tpu_torch.distributed.topology import (  # noqa: F401
    DeadHostError,
    HostPlan,
    PodConfigError,
    PodDecision,
    StragglerMonitor,
    frame_capacity_bytes,
    pack_decision_frame,
    rebase_wire_instances,
    unpack_decision_frame,
    unpack_decision_frames,
)
from agnes_tpu_torch.parallel.mesh import make_pod_mesh  # noqa: F401


def __getattr__(name):
    # the worker module stays unimported until asked for, so that
    # `python -m agnes_tpu_torch.distributed.smoke` runs it fresh
    if name == "spawn_pod":
        from agnes_tpu_torch.distributed.smoke import spawn_pod

        return spawn_pod
    raise AttributeError(name)
