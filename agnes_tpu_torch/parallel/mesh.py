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

A pod (distributed/) is a hierarchical mesh whose slices are hosts:
`make_pod_mesh` lays the world out host-major, and each host's ranks
form its (data, val) sub-mesh, over which a host's driver shards its
own instance block.
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


def make_pod_mesh(n_val: int, per_host: int, group=None,
                  device_type: str = "cuda") -> DeviceMesh:
    """The pod's mesh over the whole world: (slice=n_hosts,
    data=per_host // n_val, val=n_val), host-major, so host h is ranks
    [h * per_host, (h + 1) * per_host) and its (data, val) sub-mesh is
    `mesh["data", "val"]`.  Checked against the machines the ranks run
    on, gathered over `group` (a process group of every rank that takes
    CPU objects; default the pod's gloo group, distributed/pod.py):
    every host's ranks must share one machine (an interleaved rank order
    would put one host's all_reduces across machines)."""
    import socket

    if group is None:
        from agnes_tpu_torch.distributed.pod import pod_group

        group = pod_group()
    world = dist.get_world_size()
    if per_host < 1 or world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per_host}")
    if per_host % n_val:
        raise ValueError(f"{per_host} ranks a host do not split into "
                         f"val={n_val}")
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname(), group=group)
    for r, name in enumerate(names):
        first = names[r - r % per_host]
        if name != first:
            raise ValueError(
                f"rank order is not host-major: rank {r} runs on {name}, "
                f"rank {r - r % per_host} of its host on {first}; number "
                f"each machine's ranks consecutively")
    return make_hierarchical_mesh(world // per_host, per_host // n_val,
                                  n_val, device_type)
