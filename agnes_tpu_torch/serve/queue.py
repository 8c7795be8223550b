"""Bounded admission queue over packed 96-byte wire records (twin of
`agnes_tpu.serve.queue`).

The first stage of the serve plane: a network front pushes raw wire
bytes in, the micro-batcher drains FIFO column batches out.  Nothing
here is authenticated (signatures are checked downstream, on the card),
so this queue is the system's overload valve and its first DoS surface:

* **Bounded, fail-closed.**  `capacity` records, hard.  The default
  overload policy is reject-newest (a full queue refuses new work and
  tells the caller); `drop_oldest` sheds the oldest admitted records
  instead, for deployments that prefer the freshest votes.
* **Per-instance fairness.**  An instance may never occupy more than
  `instance_cap` queue slots, so one flooded consensus instance cannot
  starve the others; records beyond the cap are rejected at admission.
* **Cheap screens only.**  Records are parsed (`unpack_wire_votes`) and
  screened just enough to account fairness: a truncated tail and
  out-of-range instance ids are malformed here; every deeper screen
  (validator range, class, height, signature) stays with the batcher
  and the card.
* **Verified-vote dedup.**  With a `VerifiedCache` (serve/cache.py)
  attached, every admitted record's 96 bytes are SHA-256'd and looked
  up: a hit (identical bytes already verified on the card in a settled
  dispatch) marks the record pre-verified, and the pipeline routes it
  to the verify-free unsigned step.  Misses carry their digest so the
  pipeline can insert them once their verify lands clean.  Rejected
  records are never hashed.

The reject taxonomy, the overload policies, the fairness cap and the
drained columns are the twin's, byte for byte.  Pure numpy + stdlib.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np

from agnes_tpu_torch.bridge.native_ingest import REC_SIZE, unpack_wire_votes

#: overload policies
REJECT_NEWEST = "reject_newest"
DROP_OLDEST = "drop_oldest"


class AdmitResult(NamedTuple):
    """Per-submit admission verdict (counts of records)."""

    accepted: int
    rejected_overflow: int
    rejected_fairness: int
    rejected_malformed: int
    evicted: int               # drop_oldest only: old records shed
    pre_verified: int = 0      # dedup-cache hits among `accepted`

    @property
    def rejected(self) -> int:
        return (self.rejected_overflow + self.rejected_fairness
                + self.rejected_malformed)


class WireColumns(NamedTuple):
    """A drained FIFO batch as VoteBatcher.add_arrays columns."""

    instance: np.ndarray       # [N] int64
    validator: np.ndarray      # [N] int64
    height: np.ndarray         # [N] int64
    round_: np.ndarray         # [N] int64
    typ: np.ndarray            # [N] int64
    value: np.ndarray          # [N] int64 (-1 = nil)
    signatures: np.ndarray     # [N, 64] uint8
    verified: np.ndarray       # [N] bool — dedup-cache pre-verified
    digest: Optional[np.ndarray]  # [N, 32] uint8 wire SHA-256s (cache
    #                               attached) or None (dedup off)
    t_first: float             # earliest admission instant in the batch
    #: a NativePhases bundle when the native drain already built this
    #: batch's phase/lane arrays (None on the Python queue and on a
    #: drain that bailed to the Python path).  The columns above are
    #: filled either way: the adopter logs them as evidence, and a
    #: window that moved before stage falls back to add_arrays on them.
    native_phases: Optional["NativePhases"] = None

    def __len__(self) -> int:
        return len(self.instance)


class PhaseBuildState(NamedTuple):
    """Inputs a native phase drain needs to replay the batcher's
    device-verify build: the window the batch will be staged against
    (predicted: the drain runs before ServePipeline._sync_window) plus
    the value-table and ladder geometry.  Built by
    ServePipeline.native_phase_state()."""

    heights: np.ndarray        # [I] int64 window heights (predicted)
    base_round: np.ndarray     # [I] int64 window base rounds
    window: int                # rounds per window (W)
    slot_lut: np.ndarray       # [I, S] int64 dense SlotMap export as the
    #                            predicted window will hold it (rows of
    #                            advancing instances empty)
    pubkeys: np.ndarray        # [V, 32] uint8 validator keys
    n_validators: int
    lane_floor: int            # pad floor (0: exact lanes, the port's
    #                            served builds)
    max_votes: int             # ladder.max_rung (defer threshold)
    phase_offset: int          # entry-phase slot count (1)
    pin_memory: bool = False   # lane arrays in pinned host memory (the
    #                            card's path: one non-blocking upload)


@dataclass
class NativePhases:
    """The device-build arrays a native phase drain produced: exactly
    VoteBatcher.build_phases_device's layout, filled by
    core/native/admission_phases.cpp into host tensors (pinned when the
    pipeline serves a card) that the adopter uploads whole, with no
    per-record Python work.  A drain allocates its own tensors, so no
    buffer is reused while an upload from it may be in flight.
    `heights` / `base_round` / `slot_lut` echo the PhaseBuildState the
    build assumed, so the adopter can check the prediction."""

    n_phases: int
    n_lanes: int               # real lanes (== batch length)
    n_pad: int                 # lanes built (n_lanes unless floored)
    round_: int                # the single round of the batch
    typ: np.ndarray            # [n_phases] int64 phase vote types
    counts: np.ndarray         # [n_phases] int64 votes per phase
    slots: object              # [n_phases, I, V] int32 tensor
    mask: object               # [n_phases, I, V] bool tensor
    pub: object                # [n_pad, 32] int32 tensor
    sig: object                # [n_pad, 64] int32 tensor
    blocks: object             # [n_pad, 1, 32] int32 tensor (the uint32
    #                            SHA-512 words' bits)
    phase_idx: object          # [n_pad] int32 tensor
    inst: object               # [n_pad] int32 tensor
    val: object                # [n_pad] int32 tensor
    real: object               # [n_pad] bool tensor
    lane_rows: np.ndarray      # [n_lanes] int64 lane -> drained-row
    #                            permutation (the phase-grouped order)
    heights: np.ndarray        # [I] int64 window the build assumed
    base_round: np.ndarray     # [I] int64
    slot_lut: np.ndarray = field(kw_only=True)
    #                            [I, S] int64 slot LUT the build assumed
    #                            (keyword-only: a port field the twin's
    #                            positional order lacks)


def _record_digests(wire_bytes, idx: np.ndarray) -> np.ndarray:
    """[len(idx), 32] uint8 SHA-256 of the selected whole 96-byte wire
    records — the dedup cache key, hashed from the raw bytes so the key
    means exactly "these bytes were verified"."""
    mv = memoryview(bytes(wire_bytes))
    out = np.empty((len(idx), 32), np.uint8)
    for j, k in enumerate(idx):
        k = int(k)
        out[j] = np.frombuffer(
            hashlib.sha256(mv[k * REC_SIZE:(k + 1) * REC_SIZE]).digest(),
            np.uint8)
    return out


@dataclass
class _Chunk:
    """One admitted submit's (surviving) columns + admission time."""

    cols: tuple                # 8 arrays, WireColumns order sans
    #                            digest/t_first
    dig: Optional[np.ndarray]  # [N, 32] uint8 or None (dedup off)
    ts: float

    def __len__(self) -> int:
        return len(self.cols[0])

    def split(self, n: int):
        head = _Chunk(tuple(c[:n] for c in self.cols),
                      self.dig[:n] if self.dig is not None else None,
                      self.ts)
        tail = _Chunk(tuple(c[n:] for c in self.cols),
                      self.dig[n:] if self.dig is not None else None,
                      self.ts)
        return head, tail


def _cumcount(x: np.ndarray) -> np.ndarray:
    """[N] rank of each element within its value group, in arrival
    order (groupby-cumcount, vectorized)."""
    n = len(x)
    order = np.argsort(x, kind="stable")
    sx = x[order]
    new = np.ones(n, bool)
    new[1:] = sx[1:] != sx[:-1]
    starts = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    out = np.empty(n, np.int64)
    out[order] = np.arange(n) - starts
    return out


class Inbox:
    """Thread-safe bounded blob inbox: network threads `put` raw
    wire-bytes blobs, a submit thread `get`s them and feeds the
    AdmissionQueue.  A put is a bounded-deque append under a private
    mutex, so producers never wait on device work.  Fail-closed like the
    queue (a full or closed inbox refuses the blob and counts it), in
    blobs, not records."""

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self._q: collections.deque = collections.deque()
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self.closed = False
        self.enqueued = 0
        self.dropped = 0

    @property
    def depth(self) -> int:
        return len(self._q)          # len(deque) is atomic

    def put(self, blob) -> bool:
        """Enqueue a wire blob; False (and counted) when full or
        closed."""
        with self._mu:
            # schedcheck: atomic (the closed check and the append under
            # one hold: a put checked outside the mutex could land after
            # the final flush)
            if self.closed or len(self._q) >= self.capacity:
                self.dropped += 1
                return False
            self._q.append(blob)
            self.enqueued += 1
            self._not_empty.notify()
        return True

    def close(self) -> None:
        """Stop accepting blobs: every `put` that returned True
        happened before this call and its blob is still drainable;
        every later `put` returns False."""
        with self._mu:
            # schedcheck: atomic (close orders every racing put against
            # the final flush)
            self.closed = True
            self._not_empty.notify_all()

    def get(self, timeout: Optional[float] = None):
        """Dequeue the oldest blob, waiting up to `timeout` seconds
        (None = until a blob arrives or the inbox closes); None on
        timeout or empty-after-close."""
        with self._not_empty:
            # schedcheck: atomic (predicate and popleft under one hold:
            # a wakeup that re-checked nothing would double-pop against
            # a racing get)
            self._not_empty.wait_for(lambda: self._q or self.closed,
                                     timeout)
            return self._q.popleft() if self._q else None


class AdmissionQueue:
    """FIFO of admitted wire records, bounded with per-instance
    fairness (module docstring).  `submit` admits, `drain` hands FIFO
    column batches to the micro-batcher.  Not internally synchronized:
    a threaded host guards it with its admission lock."""

    native = False

    def __init__(self, n_instances: int, capacity: int,
                 instance_cap: Optional[int] = None,
                 policy: str = REJECT_NEWEST,
                 cache=None,
                 bls_table=None,
                 clock=time.monotonic):
        """`cache` is an optional serve/cache.VerifiedCache (None =
        dedup off, no added work).  `bls_table` (serve/bls_lane.
        BlsClassTable) enables `submit_bls`, which folds BLS wire shares
        into per-class aggregate buckets instead of the record queue;
        its rejects surface through this queue's counters."""
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        if policy not in (REJECT_NEWEST, DROP_OLDEST):
            raise ValueError(f"unknown overload policy: {policy}")
        self.I = int(n_instances)
        self.capacity = int(capacity)
        # default: 2x the fair share — bursty-but-honest instances
        # breathe, a single flooder still can't take the whole queue
        self.instance_cap = (int(instance_cap) if instance_cap is not None
                             else max(1, (2 * self.capacity) // self.I))
        if self.instance_cap <= 0:
            raise ValueError(
                f"instance_cap must be positive: {instance_cap}")
        self.policy = policy
        self.cache = cache
        self.bls_table = bls_table
        # optional utils.metrics.Histogram: submit -> drain wait per
        # drained chunk (VoteService wires its registry's in)
        self.wait_hist = None
        self._clock = clock
        # a deque: one micro-batch may span hundreds of small submits
        self._chunks: collections.deque = collections.deque()
        self.depth = 0
        self._inst_counts = np.zeros(self.I, np.int64)
        self.counters = {
            "submitted": 0, "admitted": 0, "rejected_overflow": 0,
            "rejected_fairness": 0, "rejected_malformed": 0,
            "evicted": 0, "drained": 0,
        }

    @property
    def oldest_ts(self) -> Optional[float]:
        """Admission instant of the oldest queued record (None when
        empty) — the micro-batcher's deadline anchor."""
        return self._chunks[0].ts if self._chunks else None

    def instance_depth(self, instance: int) -> int:
        return int(self._inst_counts[instance])

    # -- admission -----------------------------------------------------------

    def submit(self, wire_bytes) -> AdmitResult:
        """Admit packed wire records.  Returns per-record counts;
        rejected records are counted and dropped, never queued."""
        raw_len = len(wire_bytes)
        n_whole = raw_len // REC_SIZE
        malformed = 1 if raw_len % REC_SIZE else 0   # truncated tail
        cols = unpack_wire_votes(wire_bytes)
        inst = cols[0]
        self.counters["submitted"] += n_whole + malformed
        if n_whole == 0:
            self.counters["rejected_malformed"] += malformed
            return AdmitResult(0, 0, 0, malformed, 0)

        # instance-range screen: fairness accounting needs a valid id
        ok = (inst >= 0) & (inst < self.I)
        malformed += int(n_whole - ok.sum())
        keep = np.nonzero(ok)[0]

        # fairness: occupancy-so-far + rank-within-this-submit < cap
        inst_k = inst[keep]
        occ = self._inst_counts[inst_k] + _cumcount(inst_k)
        fair = occ < self.instance_cap
        rejected_fairness = int(len(keep) - fair.sum())
        keep = keep[fair]

        # capacity
        rejected_overflow = 0
        evicted = 0
        room = self.capacity - self.depth
        if len(keep) > room:
            if self.policy == REJECT_NEWEST:
                rejected_overflow = len(keep) - max(room, 0)
                keep = keep[:max(room, 0)]
            else:                                     # DROP_OLDEST
                # shed the oldest queued records; a submit alone above
                # capacity keeps its newest `capacity` records
                if len(keep) > self.capacity:
                    rejected_overflow = len(keep) - self.capacity
                    keep = keep[len(keep) - self.capacity:]
                evicted = min(self.depth,
                              len(keep) - (self.capacity - self.depth))
                if evicted > 0:
                    self._pop(evicted, count_drained=False)
                    self.counters["evicted"] += evicted

        accepted = len(keep)
        pre_verified = 0
        if accepted:
            sub = tuple(c[keep] for c in cols)
            # the dedup lookup last, on exactly the admitted records:
            # hits + misses add up to `admitted`
            if self.cache is not None:
                dig = _record_digests(wire_bytes, keep)
                ver = self.cache.lookup(dig)
                pre_verified = int(ver.sum())
            else:
                dig = None
                ver = np.zeros(accepted, bool)
            self._chunks.append(_Chunk(sub + (ver,), dig, self._clock()))
            self.depth += accepted
            np.add.at(self._inst_counts, sub[0], 1)

        self.counters["admitted"] += accepted
        self.counters["rejected_overflow"] += rejected_overflow
        self.counters["rejected_fairness"] += rejected_fairness
        self.counters["rejected_malformed"] += malformed
        return AdmitResult(accepted, rejected_overflow,
                           rejected_fairness, malformed, evicted,
                           pre_verified)

    def submit_bls(self, wire_bytes) -> AdmitResult:
        """Fold packed BLS wire records (serve/bls_lane wire format)
        into the aggregate-class table.  Folded shares count as
        accepted; PoP-missing, unknown-validator, duplicate and
        quarantined shares as fairness rejects, class-table overflow as
        overflow, bad points and truncation as malformed."""
        if self.bls_table is None:
            raise ValueError(
                "submit_bls on a queue without a bls_table (pass "
                "BlsClassTable/BlsLane at construction)")
        res = self.bls_table.fold(wire_bytes)
        fairness = (res["pop_missing"] + res["unknown_validator"]
                    + res["duplicate"] + res["quarantined"])
        self.counters["submitted"] += (res["folded"] + fairness
                                       + res["malformed"]
                                       + res["overflow"])
        self.counters["admitted"] += res["folded"]
        self.counters["rejected_overflow"] += res["overflow"]
        self.counters["rejected_fairness"] += fairness
        self.counters["rejected_malformed"] += res["malformed"]
        return AdmitResult(res["folded"], res["overflow"], fairness,
                           res["malformed"], 0)

    # -- state-space surface --------------------------------------------------

    def mc_clone(self) -> "AdmissionQueue":
        """O(live state) copy for state-space branching.  `_Chunk`s are
        never mutated after construction, so the clone shares them; the
        cache is shared too."""
        q = type(self).__new__(type(self))
        q.I = self.I
        q.capacity = self.capacity
        q.instance_cap = self.instance_cap
        q.policy = self.policy
        q.cache = self.cache
        q.bls_table = self.bls_table
        q._clock = self._clock
        q.wait_hist = self.wait_hist
        q._chunks = collections.deque(self._chunks)
        q.depth = self.depth
        q._inst_counts = self._inst_counts.copy()
        q.counters = dict(self.counters)
        return q

    def mc_canonical(self) -> tuple:
        """Canonical int-only form of the queued content: rows in FIFO
        order, signatures left out, counters left out (they are
        history, not behavior)."""
        rows = []
        for c in self._chunks:
            inst, val, hts, rnd, typ, value = c.cols[:6]
            ver = c.cols[7]
            for j in range(len(c)):
                rows.append((int(inst[j]), int(val[j]), int(hts[j]),
                             int(rnd[j]), int(typ[j]), int(value[j]),
                             int(ver[j])))
        return (tuple(rows), self.depth)

    # -- drain ---------------------------------------------------------------

    def _pop(self, n: int, count_drained: bool = True) -> List[_Chunk]:
        """Remove the n oldest records (n <= depth), updating counts."""
        out: List[_Chunk] = []
        left = n
        while left > 0:
            c = self._chunks[0]
            if len(c) <= left:
                self._chunks.popleft()
                out.append(c)
                left -= len(c)
            else:
                head, tail = c.split(left)
                self._chunks[0] = tail
                out.append(head)
                left = 0
        for c in out:
            np.subtract.at(self._inst_counts, c.cols[0], 1)
        self.depth -= n
        if count_drained:
            self.counters["drained"] += n
        return out

    def drain(self, max_records: Optional[int] = None
              ) -> Optional[WireColumns]:
        """Pop up to `max_records` oldest records as one column batch
        (None when empty).  FIFO across submits; a submit may split
        across drains."""
        if self.depth == 0:
            return None
        n = self.depth if max_records is None else min(self.depth,
                                                       int(max_records))
        if n <= 0:
            return None
        chunks = self._pop(n)
        if self.wait_hist is not None:
            # every record of a chunk was admitted in one submit, so
            # (now - chunk.ts) weighted by its records is the wait
            now = self._clock()
            for c in chunks:
                self.wait_hist.record(now - c.ts, len(c))
        t_first = min(c.ts for c in chunks)
        if len(chunks) == 1:
            cols = chunks[0].cols
            dig = chunks[0].dig
        else:
            cols = tuple(np.concatenate([c.cols[k] for c in chunks])
                         for k in range(8))
            # cache attachment is per queue: digests are all-or-none
            dig = (np.concatenate([c.dig for c in chunks])
                   if chunks[0].dig is not None else None)
        return WireColumns(*cols, digest=dig, t_first=t_first)
