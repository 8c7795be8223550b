"""Pod topology: instance-range sharding math, the decision-gather wire
codec, and heartbeat-age liveness (twin of
`agnes_tpu.distributed.topology`, the port's own copy).

Three small pieces, each testable without a process group:

* **HostPlan** — which instances a host owns.  The pod mesh puts hosts
  on the outer `slice` axis (parallel/mesh.py: no collective crosses
  it), so every host's instance range is a contiguous block and local
  <-> global id translation is an offset.  Each host's front door
  screens on this range.
* **Decision-gather codec** — the per-tick decision exchange rides the
  96-byte wire records of `bridge/native_ingest.pack_wire_votes`: one
  record per newly latched decision (instance = global id, validator =
  reporting host, height / round = the decision's, value = the decided
  value id), framed into a fixed-size buffer so an all_gather can carry
  it (the header counts the real records, the tail is zero padding).
* **StragglerMonitor** — per-host last-evidence ages (fed by completed
  gathers and peers' heartbeat trails) against a straggler age and a
  dead age.  `check()` raises DeadHostError past the dead age: a dead
  host never joins another all_gather, so the caller drains fail-closed
  instead of waiting.  With the elastic pod's membership attached
  (distributed/membership.py) a dead peer becomes a leave intent
  instead, and its resumed evidence a join.

Numpy and the stdlib only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from agnes_tpu_torch.bridge.native_ingest import (
    REC_SIZE,
    pack_wire_votes,
    unpack_wire_votes,
)

#: decision frame header: record count (u32) + reporting host (u32)
FRAME_HEADER = 8


class PodConfigError(ValueError):
    """A pod shape the sharding math cannot satisfy."""


class DeadHostError(RuntimeError):
    """A host's liveness evidence is older than the dead age: pod
    collectives would hang on it, so drain must fail closed."""


@dataclasses.dataclass(frozen=True)
class HostPlan:
    """Which contiguous instance block each of `n_hosts` hosts owns.

    `n_instances` must divide evenly: the sharded step needs the
    instance dimension to split exactly over the mesh's data axes, and a
    ragged host would need padding instances that every comparison would
    have to exclude, so the plan refuses it."""

    n_hosts: int
    n_instances: int

    def __post_init__(self):
        if self.n_hosts <= 0:
            raise PodConfigError(f"n_hosts must be >= 1: {self.n_hosts}")
        if self.n_instances <= 0:
            raise PodConfigError(
                f"n_instances must be >= 1: {self.n_instances}")
        if self.n_instances % self.n_hosts:
            raise PodConfigError(
                f"{self.n_instances} instances do not shard evenly "
                f"over {self.n_hosts} hosts (the sharded step's data "
                f"axes need an exact split: pad the deployment or "
                f"change the pod size)")

    @property
    def local_instances(self) -> int:
        return self.n_instances // self.n_hosts

    def instance_range(self, host: int) -> Tuple[int, int]:
        """[lo, hi) global instance ids host `host` owns."""
        self._check_host(host)
        lo = host * self.local_instances
        return lo, lo + self.local_instances

    def owner_of(self, instance: int) -> int:
        """The host owning global instance id `instance`."""
        if not 0 <= instance < self.n_instances:
            raise PodConfigError(
                f"instance {instance} outside [0, {self.n_instances})")
        return instance // self.local_instances

    def to_local(self, host: int, instance) -> np.ndarray:
        """Global instance ids -> host-local ids (the caller guarantees
        ownership: `owned_mask`)."""
        lo, _ = self.instance_range(host)
        return np.asarray(instance, np.int64) - lo

    def to_global(self, host: int, instance) -> np.ndarray:
        """Host-local instance ids -> global ids."""
        lo, _ = self.instance_range(host)
        return np.asarray(instance, np.int64) + lo

    def owned_mask(self, host: int, instance) -> np.ndarray:
        """[N] bool: which global ids fall in `host`'s range."""
        lo, hi = self.instance_range(host)
        inst = np.asarray(instance, np.int64)
        return (inst >= lo) & (inst < hi)

    def _check_host(self, host: int) -> None:
        if not 0 <= host < self.n_hosts:
            raise PodConfigError(
                f"host {host} outside [0, {self.n_hosts})")


def wire_instance_ids(rec: np.ndarray) -> np.ndarray:
    """[N] int64 instance ids of a [N, REC_SIZE] record view (the
    instance is the first little-endian u32)."""
    n = len(rec)
    return rec[:, 0:4].copy().view(np.uint32).reshape(n) \
        .astype(np.int64)


def shift_instances_inplace(rec: np.ndarray, offset: int) -> None:
    """Shift every record's instance field by `offset` in a writable
    [N, REC_SIZE] record array (one pass, no re-parse)."""
    n = len(rec)
    if n:
        inst = (wire_instance_ids(rec) + offset).astype(np.uint32)
        rec[:, 0:4] = inst[:, None].view(np.uint8).reshape(n, 4)


def rebase_wire_instances(wire_bytes, offset: int) -> bytes:
    """Shift every whole record's instance field by `offset` in the raw
    96-byte wire layout, without an unpack / repack round trip.  A
    truncated tail is kept as it is (the admission queue counts it
    malformed, as it would have)."""
    buf = np.frombuffer(bytes(wire_bytes), np.uint8).copy()
    n = len(buf) // REC_SIZE
    if n:
        shift_instances_inplace(buf[:n * REC_SIZE].reshape(n, REC_SIZE),
                                offset)
    return buf.tobytes()


# -- decision-gather codec ----------------------------------------------------

def frame_capacity_bytes(max_decisions: int) -> int:
    """Fixed frame size for a gather carrying up to `max_decisions`
    records (a host latches at most its local instance count of new
    first decisions a tick)."""
    return FRAME_HEADER + int(max_decisions) * REC_SIZE


def pack_decision_frame(host: int, instances, values, rounds, heights,
                        max_decisions: int) -> np.ndarray:
    """[frame_capacity_bytes] uint8: header + one 96-byte wire record a
    decision + zero padding.  `instances` are global ids; `values` the
    decided value ids (< 0 = nil, the wire codec's encoding); the
    signature bytes are zero (a decision report is not a vote: the pod
    transport vouches for it)."""
    inst = np.asarray(instances, np.int64)
    n = len(inst)
    if n > max_decisions:
        raise PodConfigError(
            f"{n} decisions exceed the frame capacity {max_decisions}")
    frame = np.zeros(frame_capacity_bytes(max_decisions), np.uint8)
    frame[0:4] = np.uint32(n).reshape(1).view(np.uint8)
    frame[4:8] = np.uint32(host).reshape(1).view(np.uint8)
    if n:
        wire = pack_wire_votes(
            inst, np.full(n, host, np.int64),
            np.asarray(heights, np.int64), np.asarray(rounds, np.int64),
            np.zeros(n, np.int64), np.asarray(values, np.int64))
        frame[FRAME_HEADER:FRAME_HEADER + n * REC_SIZE] = \
            np.frombuffer(wire, np.uint8)
    return frame


@dataclasses.dataclass(frozen=True)
class PodDecision:
    """One decision as gathered pod-wide (global instance id)."""

    instance: int
    host: int
    height: int
    round: int
    value_id: Optional[int]        # None = nil


def unpack_decision_frame(frame: np.ndarray) -> List[PodDecision]:
    """Inverse of pack_decision_frame (one host's frame)."""
    frame = np.asarray(frame, np.uint8)
    if len(frame) < FRAME_HEADER:
        raise PodConfigError(f"frame shorter than the header: "
                             f"{len(frame)} bytes")
    n = int(frame[0:4].view(np.uint32)[0])
    cap = (len(frame) - FRAME_HEADER) // REC_SIZE
    if n > cap:
        raise PodConfigError(
            f"frame claims {n} records but holds at most {cap}")
    if n == 0:
        return []
    raw = frame[FRAME_HEADER:FRAME_HEADER + n * REC_SIZE].tobytes()
    inst, val, hts, rnd, _typ, value, _sigs = unpack_wire_votes(raw)
    return [PodDecision(
        instance=int(inst[k]), host=int(val[k]), height=int(hts[k]),
        round=int(rnd[k]),
        value_id=(int(value[k]) if value[k] >= 0 else None))
        for k in range(n)]


def unpack_decision_frames(frames: np.ndarray) -> List[PodDecision]:
    """Every host's frame ([n_hosts, frame_bytes]) -> one decision list,
    host-major."""
    out: List[PodDecision] = []
    for row in np.asarray(frames, np.uint8):
        out.extend(unpack_decision_frame(row))
    return out


# -- liveness -----------------------------------------------------------------

class StragglerMonitor:
    """Per-host liveness from last-evidence ages (module docstring).

    Evidence is anything that proves recent progress: `beat(host)`, or
    `beat(None)` after a completed gather or barrier (an all_gather that
    returned proves every host live), or `observe_heartbeat_files` over
    peers' heartbeat trails.  The clock is injectable so the verdicts
    test on a stubbed clock.

    A dead verdict is not permanent: fresh evidence for a host past the
    dead age clears it and counts a `readmissions`.  With a membership
    attached (`attach_membership`, the elastic pod) a dead peer becomes a
    latched leave intent, applied at the next epoch boundary, and
    `check()` returns the stragglers instead of raising; resumed evidence
    latches the matching join.  Without one the contract stays
    fail-closed: `check()` raises DeadHostError, because without a
    repartition protocol a dead peer hangs the next collective."""

    def __init__(self, n_hosts: int, host: int,
                 dead_after_s: float = 30.0,
                 straggler_after_s: float = 5.0,
                 clock=time.monotonic):
        if dead_after_s <= straggler_after_s:
            raise PodConfigError(
                f"dead_after_s ({dead_after_s}) must exceed "
                f"straggler_after_s ({straggler_after_s})")
        self.n_hosts = int(n_hosts)
        self.host = int(host)
        self.dead_after_s = float(dead_after_s)
        self.straggler_after_s = float(straggler_after_s)
        self._clock = clock
        now = self._clock()
        self._last: Dict[int, float] = {h: now for h in
                                        range(self.n_hosts)}
        self.membership = None         # a MembershipEpoch, once attached
        self.readmissions = 0          # dead verdicts cleared by evidence
        self._reported_dead: set = set()

    def attach_membership(self, membership) -> None:
        """Attach the elastic pod's membership: dead peers become leave
        intents and resumed peers join intents, where check() would fail
        closed (class docstring)."""
        self.membership = membership

    def beat(self, host: Optional[int] = None,
             now: Optional[float] = None) -> None:
        """Record evidence for one host (None = every host: the
        completed-collective case).  Evidence for a host past the dead
        age is a recovery (`_evidence`)."""
        now = self._clock() if now is None else now
        hosts = range(self.n_hosts) if host is None else (int(host),)
        for h in hosts:
            self._evidence(h, now, now)

    def _evidence(self, h: int, t: float, now: float) -> None:
        """Fold in one observation of host h (evidence instant `t`,
        judged at clock instant `now`): a peer past the dead age is
        readmitted, counted, and on an attached membership its join
        latched.  Every evidence source goes through here."""
        if t <= self._last[h]:
            return
        if h != self.host and now - self._last[h] > self.dead_after_s:
            self.readmissions += 1
            self._reported_dead.discard(h)
            if self.membership is not None:
                self.membership.note_join(h)
        self._last[h] = t

    def observe_heartbeat_files(self, paths: Sequence[Optional[str]],
                                now: Optional[float] = None) -> None:
        """Fold in peers' heartbeat trails: paths[h] is host h's NDJSON
        file (None or unreadable = no new evidence).  The age is the
        trail's last valid line's, the number a post-mortem reads
        (utils/flightrec.last_line_age_s, wall-clock based), entered into
        the monotonic ledger as now - age."""
        from agnes_tpu_torch.utils.flightrec import last_line_age_s

        now = self._clock() if now is None else now
        for h, path in enumerate(paths):
            if h >= self.n_hosts or path is None:
                continue
            age = last_line_age_s(path)
            if age is not None:
                self._evidence(h, now - age, now)

    def ages(self, now: Optional[float] = None) -> Dict[int, float]:
        now = self._clock() if now is None else now
        return {h: now - t for h, t in self._last.items()}

    def stragglers(self, now: Optional[float] = None) -> List[int]:
        """Hosts past the straggler age but not yet dead (a host is
        never its own straggler)."""
        return [h for h, age in self.ages(now).items()
                if h != self.host
                and self.straggler_after_s < age <= self.dead_after_s]

    def dead(self, now: Optional[float] = None) -> List[int]:
        return [h for h, age in self.ages(now).items()
                if h != self.host and age > self.dead_after_s]

    def check(self, now: Optional[float] = None) -> List[int]:
        """Raise DeadHostError when any peer is past the dead age; the
        (possibly empty) straggler list otherwise.  The gate before a
        pod collective: a dead peer means the next all_gather would
        never complete.  With a membership attached each newly dead peer
        latches a leave intent once and the stragglers are returned
        (class docstring)."""
        gone = self.dead(now)
        if gone and self.membership is not None:
            for h in gone:
                if h not in self._reported_dead:
                    self._reported_dead.add(h)
                    self.membership.note_leave(h)
            return self.stragglers(now)
        if gone:
            ages = self.ages(now)
            raise DeadHostError(
                f"host(s) {gone} show no liveness evidence for "
                + ", ".join(f"{ages[h]:.1f}s" for h in gone)
                + f" (> dead_after_s={self.dead_after_s}); pod "
                f"collectives would hang: drain fail-closed")
        return self.stragglers(now)
