"""Device-memory planner for the fused signed verify (twin of the planner
half of `agnes_tpu.utils.budget`).

At the north-star shape (2 vote classes x 10,000 instances x 1,000
validators = 20,000,000 lanes) the packed lanes alone are 512 B a lane,
10.24 GB on the card, and the verify's per-lane temporaries come on top.
`plan_lane_verify` (packed lanes) and `plan_dense_verify` (the dense
[Ps, I, V] cells, tiled by instance rows) size verify microbatches so
the step (`device/step.py`, `verify_chunk`) streams tiles through the
same kernel with a bounded peak; every lane's verdict is independent
integer math, so chunked and unchunked runs agree lane for lane.
`mesh_local_shape` is the (instances, validators) block one rank of a
mesh holds, the shape a per-device plan bounds.

The budget is the card's whole memory (`device_hbm_bytes`), with the
lanes resident inside it.  A CPU device has no budget: callers there
pass `hbm_bytes`.  Pure arithmetic otherwise: nothing is allocated.

Waiting for a later slice: the `Deadline` / timeout half of the twin
(the benchmark tooling, ROADMAP §1 item 7a).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from agnes_tpu_torch.device.encoding import resolve_device

GIB = 1 << 30

#: bytes per verify lane for each operand (the bridge packs bytes as
#: int32 lanes: `bridge/ingest.py::_pack_verify_inputs_np`)
SIG_LANE_BYTES = 64 * 4            # [.., 64] int32
PUB_LANE_BYTES = 32 * 4            # [.., 32] int32
BLOCK_LANE_BYTES = 32 * 4          # per SHA-512 block: [.., 32] int32

#: transient bytes a lane while the verify runs: the plain-torch
#: prologue (SHA-512 on int64 words, the Barrett reduction, the digit
#: planes) and the kernel's inputs and output.  `chip_smoke.py` phase 3
#: measures it on the step of an unchunked I = 1,024 x V = 1,000 height
#: as (peak - allocated before the step) / lanes: 1,428.0 B on an
#: "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md), and the north-star
#: height read the same 1,427 B a lane at 8,388,608-lane chunks; phase
#: 3 fails if the reading outgrows the constant.  The constant adds
#: what the lane plan leaves out and must fit beside the chunk, the
#: phases and the tally (41 B a lane at that height), and rounds up to
#: a multiple of 256 B: an overestimate only shrinks the tile, an
#: underestimate runs out of memory at full shape.  (The twin models
#: JAX's 20-limb temporaries at 10,240 B a lane.)
VERIFY_WORKSPACE_LANE_BYTES = 1536


class BudgetError(RuntimeError):
    """No verify tiling fits the given memory budget."""


@dataclasses.dataclass(frozen=True)
class VerifyPlan:
    """A chunked-execution plan for the fused signed verify.

    ``tile`` is the microbatch size in lanes; the last chunk may be
    ragged.  The fields are the twin's, whose dense plan tiles instance
    rows of n_phases * n_validators lanes; a lane plan is one lane a
    row."""

    n_phases: int
    n_instances: int
    n_validators: int
    n_blocks: int
    tile: int                  # lanes per chunk
    n_chunks: int
    lanes_per_chunk: int
    resident_bytes: int        # persistent operands (live for the whole step)
    chunk_bytes: int           # transient workspace of ONE microbatch
    hbm_bytes: int
    safety: float

    @property
    def peak_bytes(self) -> int:
        return self.resident_bytes + self.chunk_bytes

    def fits(self, hbm_bytes: Optional[int] = None) -> bool:
        budget = self.hbm_bytes if hbm_bytes is None else hbm_bytes
        return self.peak_bytes <= budget * self.safety

    @property
    def chunked(self) -> bool:
        return self.n_chunks > 1

    def describe(self) -> str:
        return (f"verify plan: {self.n_chunks} chunk(s) x {self.tile} "
                f"(lanes/chunk={self.lanes_per_chunk}); resident "
                f"{self.resident_bytes / GIB:.2f} GiB + chunk "
                f"{self.chunk_bytes / GIB:.2f} GiB = peak "
                f"{self.peak_bytes / GIB:.2f} GiB of "
                f"{self.hbm_bytes / GIB:.2f} GiB "
                f"(safety {self.safety:.2f})")


def _floor_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def device_hbm_bytes(device="cuda") -> int:
    """The card's total memory in bytes (`torch.cuda.mem_get_info`).
    A CPU device has no memory budget: ValueError (RuntimeError, as
    everywhere in the port, when CUDA is asked for and absent)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no device memory budget on {dev}: pass "
                         f"hbm_bytes (hbm_budget_bytes on the driver)")
    return int(torch.cuda.mem_get_info(dev)[1])


def _budget(hbm_bytes: Optional[int]) -> int:
    return device_hbm_bytes() if hbm_bytes is None else int(hbm_bytes)


def dense_resident_bytes(n_phases: int, n_instances: int,
                         n_validators: int, n_blocks: int = 1,
                         n_seq_phases: Optional[int] = None) -> int:
    """Persistent memory of the dense fused signed step: the full sig
    and blocks tensors (they stay resident while tiles stream), the
    pubkey table, the dense phase tensors and verdict mask, and the
    tally's per-validator arrays (voted and equiv; a 4-round window of
    2 classes).  The twin's formula."""
    P = n_seq_phases if n_seq_phases is not None else n_phases + 1
    lanes = n_phases * n_instances * n_validators
    cells = n_instances * n_validators
    sig = lanes * SIG_LANE_BYTES
    blocks = lanes * n_blocks * BLOCK_LANE_BYTES
    pub_table = n_validators * PUB_LANE_BYTES
    # phases: slots int32 + mask bool per (seq phase, cell); vmask bool
    phases = P * cells * (4 + 1) + P * cells
    # tally: voted [I, W=4, 2, V] int32 + equiv [I, V] bool
    tally = cells * 4 * 2 * 4 + cells
    return sig + blocks + pub_table + phases + tally


def plan_dense_verify(n_phases: int, n_instances: int, n_validators: int,
                      n_blocks: int = 1,
                      hbm_bytes: Optional[int] = None,
                      safety: float = 0.9,
                      workspace_lane_bytes: Optional[int] = None,
                      ) -> VerifyPlan:
    """Size the instance-row tile of the dense fused signed step
    (`consensus_step_seq_signed_dense`): the largest power-of-two row
    count whose tile fits the memory left after the resident operands;
    a lane of a tile costs `workspace_lane_bytes` plus its pub
    broadcast.  `tile` counts instance rows (n_phases * n_validators
    lanes each).  The default workspace is VERIFY_WORKSPACE_LANE_BYTES
    plus the tile's contiguous copy of its sig and n_blocks blocks,
    which a tile of Ps > 1 classes cuts out of the [Ps, I, V] layout
    (`device/step._verify_dense`; the lane path's chunks are views): a
    departure from the twin, whose formula this is with the twin's
    workspace passed.  Raises BudgetError when even a one-row tile does
    not fit, ValueError on an empty shape."""
    if min(n_phases, n_instances, n_validators) <= 0:
        raise ValueError("n_phases/n_instances/n_validators must be >= 1")
    if workspace_lane_bytes is None:
        workspace_lane_bytes = (VERIFY_WORKSPACE_LANE_BYTES + SIG_LANE_BYTES
                                + n_blocks * BLOCK_LANE_BYTES)
    hbm = _budget(hbm_bytes)
    resident = dense_resident_bytes(n_phases, n_instances, n_validators,
                                    n_blocks)
    avail = hbm * safety - resident
    # a tile's lane: the verify workspace plus the [Ps, tile, V, 32]
    # int32 pub broadcast the tile materializes
    lane_cost = workspace_lane_bytes + PUB_LANE_BYTES
    row_lanes = n_phases * n_validators
    max_rows = int(avail // (row_lanes * lane_cost))
    if max_rows < 1:
        raise BudgetError(
            f"dense fused verify cannot fit {n_phases}x{n_instances}x"
            f"{n_validators} (nb={n_blocks}) in {hbm / GIB:.2f} GiB: "
            f"resident {resident / GIB:.2f} GiB leaves "
            f"{max(avail, 0) / GIB:.2f} GiB, one instance row needs "
            f"{row_lanes * lane_cost / GIB:.3f} GiB")
    tile = min(n_instances, _floor_pow2(max_rows))
    return VerifyPlan(
        n_phases=n_phases, n_instances=n_instances,
        n_validators=n_validators, n_blocks=n_blocks,
        tile=tile, n_chunks=-(-n_instances // tile),
        lanes_per_chunk=tile * row_lanes,
        resident_bytes=resident,
        chunk_bytes=tile * row_lanes * lane_cost,
        hbm_bytes=hbm, safety=safety)


def mesh_local_shape(mesh, n_instances: int, n_validators: int,
                     n_hosts: int = 1,
                     n_live: Optional[int] = None) -> Tuple[int, int]:
    """(instances, validators) as one rank of `mesh` (parallel/mesh.py,
    a DeviceMesh) holds them: instances split over its data axes
    (`slice` and `data`), validators over `val`.  `mesh` None is one
    device.  Shared by DeviceDriver's chunk planning and
    ShapeLadder.plan_dense.

    `n_hosts` and `n_live` are the pod's (ROADMAP §1 item 6), as in the
    twin: where `n_instances` is already one host's slice of a mesh
    spanning `n_hosts` hosts, the data extent one host owns is the
    mesh's over the live host count (`n_live`, default `n_hosts`); the
    caller passes the slice the live owner serves.  ValueError when
    the live count is outside [1, n_hosts] or does not split the data
    extent."""
    if mesh is None:
        return int(n_instances), int(n_validators)
    from agnes_tpu_torch.parallel.mesh import DATA_AXIS, SLICE_AXIS, VAL_AXIS

    live = int(n_live) if n_live is not None else int(n_hosts)
    if not 1 <= live <= max(1, int(n_hosts)):
        raise ValueError(
            f"live membership {live} outside [1, {n_hosts}]")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_data = shape.get(DATA_AXIS, 1) * shape.get(SLICE_AXIS, 1)
    if live > 1:
        if n_data % live:
            raise ValueError(
                f"mesh data extent {n_data} does not split over "
                f"{live} live host(s)")
        n_data //= live
    return (int(n_instances) // n_data,
            int(n_validators) // shape.get(VAL_AXIS, 1))


def plan_lane_verify(n_lanes: int, n_blocks: int = 1,
                     hbm_bytes: Optional[int] = None,
                     safety: float = 0.9,
                     workspace_lane_bytes: int = VERIFY_WORKSPACE_LANE_BYTES,
                     ) -> VerifyPlan:
    """Size the lane chunk for the packed-lane fused signed path
    (`consensus_step_seq_signed`): the largest power-of-two lane count
    whose workspace fits the memory left after the resident lanes.
    Raises BudgetError when even one lane does not fit."""
    if n_lanes <= 0:
        raise ValueError("n_lanes must be >= 1")
    hbm = _budget(hbm_bytes)
    resident = n_lanes * (SIG_LANE_BYTES + PUB_LANE_BYTES
                          + n_blocks * BLOCK_LANE_BYTES)
    avail = hbm * safety - resident
    max_lanes = int(avail // workspace_lane_bytes)
    if max_lanes < 1:
        raise BudgetError(
            f"lane fused verify cannot fit {n_lanes} lanes "
            f"(nb={n_blocks}) in {hbm / GIB:.2f} GiB")
    tile = min(n_lanes, _floor_pow2(max_lanes))
    return VerifyPlan(
        n_phases=1, n_instances=n_lanes, n_validators=1,
        n_blocks=n_blocks, tile=tile, n_chunks=-(-n_lanes // tile),
        lanes_per_chunk=tile, resident_bytes=resident,
        chunk_bytes=tile * workspace_lane_bytes,
        hbm_bytes=hbm, safety=safety)
