"""Deadline-aware micro-batching over a precomputed shape ladder (twin of
`agnes_tpu.serve.batcher`).

The stage between admission (serve/queue.py) and densify/dispatch
(serve/pipeline.py).  Two jobs:

* **When to close a batch** (`MicroBatcher`): size-or-deadline.  A
  batch closes the moment the queue holds `target_votes` records, or
  when the oldest queued record has waited `max_delay_s`.
* **What shapes may reach the card** (`ShapeLadder`): powers of two
  from `min_rung` to a top rung planned against the card's memory
  (`utils/budget.plan_lane_verify`; a rung whose resident verify
  operands cannot fit is dropped).  The pipeline pads every signed
  build onto a rung and caps it at the top one, so a service launches
  at most len(rungs) lane shapes a phase count for its whole life, each
  launched once at startup by `ServePipeline.warmup` and held there by
  the retrace tripwire (analysis/retrace.py).  Nothing here compiles
  per shape; the rungs bound the set of shapes, the memory and the
  padding work.  `bls_rungs` / `bls_class_rungs` pace the BLS aggregate
  lane's MSMs and pairing calls the same way.

Departure from the twin: `plan` sizes rungs with the port's measured
verify workspace (`utils/budget.VERIFY_WORKSPACE_LANE_BYTES`, 1,536 B a
lane against the twin's modelled 10,240 B), and a CPU device has no
default budget, so a CPU caller passes `hbm_bytes`.  On a shape the
budget binds, the port's top rung may be larger than the twin's, by
design.  `plan_dense` is the dense dispatch mode's ladder: its rungs
only pace the votes a micro-batch carries, and the dense verify of the
deployment (per device, `utils/budget.mesh_local_shape`) must fit the
budget at least chunked (`plan_dense_verify` at the port's dense
workspace).

The batch-fill ratio (votes / rung) is the utilization number: padding
lanes do real work on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

from agnes_tpu_torch.utils.budget import (
    BudgetError,
    plan_dense_verify,
    plan_lane_verify,
)


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ShapeLadder:
    """Ascending power-of-two shapes the serve plane may emit: lane
    counts of a signed build (`rungs`), signer counts of one BLS class
    (`bls_rungs`) and classes of one pairing call (`bls_class_rungs`).
    Empty lane rungs = a ladder that only paces a BLS lane."""

    rungs: Tuple[int, ...] = ()
    bls_rungs: Tuple[int, ...] = ()
    bls_class_rungs: Tuple[int, ...] = ()

    def __post_init__(self):
        for r in self.rungs + self.bls_rungs + self.bls_class_rungs:
            if r & (r - 1) or r <= 0:
                raise ValueError(f"rungs must be powers of two: {r}")
        for name in ("rungs", "bls_rungs", "bls_class_rungs"):
            v = getattr(self, name)
            if list(v) != sorted(set(v)):
                raise ValueError(f"{name} must be ascending: {v}")

    @property
    def min_rung(self) -> int:
        if not self.rungs:
            raise ValueError("empty shape ladder")
        return self.rungs[0]

    @property
    def max_rung(self) -> int:
        if not self.rungs:
            raise ValueError("empty shape ladder")
        return self.rungs[-1]

    def rung_for(self, n_votes: int) -> int:
        """Smallest rung holding `n_votes` lanes.  Above the top rung is
        a caller bug (the micro-batcher's target is clamped to it)."""
        for r in self.rungs:
            if n_votes <= r:
                return r
        raise ValueError(
            f"{n_votes} votes exceed the ladder's top rung "
            f"{self.max_rung} (close smaller batches)")

    @classmethod
    def plan(cls, n_instances: int, n_validators: int,
             max_votes: Optional[int] = None, min_rung: int = 256,
             hbm_bytes: Optional[int] = None) -> "ShapeLadder":
        """Rungs from `min_rung` up to the smaller of `max_votes`
        (default one full both-classes tick, 2*I*V) and the largest rung
        whose resident verify operands fit the memory budget at all
        (`hbm_bytes`, default the card's; chunked execution handles the
        workspace)."""
        top_want = 2 * n_instances * n_validators
        if max_votes is not None:
            top_want = min(top_want, int(max_votes))
        min_rung = _ceil_pow2(min_rung)
        top = max(_ceil_pow2(top_want), min_rung)
        rungs = []
        r = min_rung
        while r <= top:
            try:
                plan_lane_verify(r, hbm_bytes=hbm_bytes)
            except BudgetError:
                break          # larger rungs only get worse
            rungs.append(r)
            r <<= 1
        if not rungs:
            raise BudgetError(
                f"no ladder rung >= {min_rung} fits the memory budget "
                f"(shape {n_instances}x{n_validators})")
        return cls(rungs=tuple(rungs))

    @classmethod
    def plan_dense(cls, n_instances: int, n_validators: int,
                   local_shape: Optional[Tuple[int, int]] = None,
                   n_classes: int = 2,
                   max_votes: Optional[int] = None, min_rung: int = 256,
                   hbm_bytes: Optional[int] = None,
                   n_hosts: int = 1,
                   n_live: Optional[int] = None) -> "ShapeLadder":
        """The ladder of the dense dispatch mode (mesh serving).  A dense
        step's shape is (P, I, V), fixed by the deployment, so the rungs
        only pace how many votes a micro-batch carries (host densify
        and latency).  What the budget checks instead is the deployment:
        the dense verify of `n_classes` signed classes over the
        per-device `local_shape` (utils/budget.mesh_local_shape;
        default the whole shape over the live hosts) must fit
        `hbm_bytes` (default the card's) at least chunked, or
        `plan_dense_verify` raises BudgetError here, at plan time.

        `n_hosts` / `n_live` are the pod's (ROADMAP §1 item 6), as in
        the twin: the top rung is one full both-classes tick of the
        instance slice one live host serves, n_instances / n_live; a
        deployment that does not split evenly raises ValueError."""
        nh = max(1, int(n_hosts))
        live = int(n_live) if n_live is not None else nh
        if not 1 <= live <= nh:
            raise ValueError(
                f"live membership {live} outside [1, {nh}]")
        if n_instances % nh:
            raise ValueError(
                f"{n_instances} instances do not shard evenly over "
                f"{n_hosts} hosts")
        if n_instances % live:
            raise ValueError(
                f"{n_instances} instances do not repartition evenly "
                f"over {live} live host(s)")
        li, lv = (local_shape if local_shape is not None
                  else (n_instances // live, n_validators))
        plan_dense_verify(n_classes, li, lv, hbm_bytes=hbm_bytes)
        top_want = 2 * (n_instances // live) * n_validators
        if max_votes is not None:
            top_want = min(top_want, int(max_votes))
        min_rung = _ceil_pow2(min_rung)
        top = max(_ceil_pow2(top_want), min_rung)
        rungs = []
        r = min_rung
        while r <= top:
            rungs.append(r)
            r <<= 1
        return cls(rungs=tuple(rungs))

    def with_bls(self, n_validators: int, min_rung: int = 16,
                 class_rungs: Tuple[int, ...] = (1, 4)) -> "ShapeLadder":
        """Extend with BLS aggregation rungs (powers of two from
        `min_rung` up to the validator count: a class never holds more
        signers than validators) and the pairing class rungs (one small
        and one burst shape; closes above the top rung chunk)."""
        min_rung = _ceil_pow2(min_rung)
        top = max(_ceil_pow2(n_validators), min_rung)
        rungs = []
        r = min_rung
        while r <= top:
            rungs.append(r)
            r <<= 1
        return dataclasses.replace(
            self, bls_rungs=tuple(rungs),
            bls_class_rungs=tuple(sorted(set(class_rungs))))

    def bls_rung_for(self, n_signers: int) -> int:
        """Smallest BLS rung holding `n_signers` aggregation lanes."""
        for r in self.bls_rungs:
            if n_signers <= r:
                return r
        raise ValueError(
            f"{n_signers} signers exceed the top BLS rung "
            f"{self.bls_rungs[-1] if self.bls_rungs else 0}")

    def bls_class_rung_for(self, n_classes: int) -> int:
        """Smallest pairing class rung holding `n_classes`; callers
        CHUNK above the top rung."""
        for r in self.bls_class_rungs:
            if n_classes <= r:
                return r
        if not self.bls_class_rungs:
            raise ValueError("no bls_class_rungs planned")
        return self.bls_class_rungs[-1]

    def describe(self) -> str:
        out = ("shape ladder: " + " ".join(str(r) for r in self.rungs)
               + " lanes")
        if self.bls_rungs:
            out += (" | bls: "
                    + " ".join(str(r) for r in self.bls_rungs))
        if self.bls_class_rungs:
            out += (" | bls classes: "
                    + " ".join(str(r) for r in self.bls_class_rungs))
        return out


class MicroBatcher:
    """Size-or-deadline batch closer over an AdmissionQueue."""

    def __init__(self, queue, ladder: ShapeLadder,
                 target_votes: Optional[int] = None,
                 max_delay_s: float = 0.005,
                 clock=time.monotonic):
        self.queue = queue
        self.ladder = ladder
        self.target = min(int(target_votes) if target_votes is not None
                          else ladder.max_rung, ladder.max_rung)
        if self.target <= 0:
            raise ValueError(f"target_votes must be positive: "
                             f"{target_votes}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0: {max_delay_s}")
        self.max_delay_s = float(max_delay_s)
        self._clock = clock
        self.batches_closed = 0
        self.closed_by_size = 0
        self.closed_by_deadline = 0

    def poll(self, now: Optional[float] = None):
        """Close and return a batch (WireColumns) iff the size target is
        met or the oldest queued record's deadline has passed; else
        None."""
        if self.queue.depth <= 0:
            return None
        by_size = self.queue.depth >= self.target
        if not by_size:
            oldest = self.queue.oldest_ts
            now = self._clock() if now is None else now
            if oldest is None or now - oldest < self.max_delay_s:
                return None
        batch = self.queue.drain(self.target)
        if batch is not None:
            self.batches_closed += 1
            if by_size:
                self.closed_by_size += 1
            else:
                self.closed_by_deadline += 1
        return batch

    def flush(self):
        """Close a batch regardless of size/deadline (drain path)."""
        batch = self.queue.drain(self.target)
        if batch is not None:
            self.batches_closed += 1
        return batch

    def fill(self, n_votes: int) -> float:
        """Batch-fill ratio: votes over the rung they pad onto."""
        return n_votes / self.ladder.rung_for(min(n_votes,
                                                  self.ladder.max_rung))
