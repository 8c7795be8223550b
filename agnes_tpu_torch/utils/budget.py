"""Device-memory planner for the fused signed verify (twin of the planner
half of `agnes_tpu.utils.budget`).

At the north-star shape (2 vote classes x 10,000 instances x 1,000
validators = 20,000,000 lanes) the packed lanes alone are 512 B a lane,
10.24 GB on the card, and the verify's per-lane temporaries come on top.
`plan_lane_verify` sizes verify microbatches so the step (`device/step.py`, `verify_chunk`) streams tiles through the
same kernel with a bounded peak; every lane's verdict is independent
integer math, so chunked and unchunked runs agree lane for lane.

The budget is the card's whole memory (`device_hbm_bytes`), with the
lanes resident inside it.  A CPU device has no budget: callers there
pass `hbm_bytes`.  Pure arithmetic otherwise: nothing is allocated.

Waiting for later slices: `plan_dense_verify`, `dense_resident_bytes`
and `mesh_local_shape` (the dense step and the mesh) and the `Deadline`
/ timeout half of the twin (the benchmark tooling).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
