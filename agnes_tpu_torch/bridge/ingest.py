"""VoteBatcher: sparse signed wire votes -> dense device phases (twin of
`agnes_tpu.bridge.ingest`).

Wire votes carrying (instance, validator, height, round, class, value,
signature) are densified into the [I, V] VotePhase matrices the fused
step consumes.  The build is vectorized numpy (sort + run-length
layering + fancy-indexed scatter); votes sharing an (instance,
validator, round, class) cell are *layered* so equivocating votes still
reach the tally.  Window discipline: future rounds (>= base+W) are held
back until `sync_device` reports the rotated window; past rounds are
tallied on the host (`core.round_votes`), and a late precommit-value
quorum surfaces through `drain_host_events`.

`build_phases_device` defers verification to the device: it returns
the phases plus `SignedLanes` whose verdicts `consensus_step_seq_signed`
computes with the CUDA verify kernel and ANDs into the masks on the
card.  `build_phases(pubkeys)` verifies on the batcher's device first
and drops failures: per lane (`verify_mode="lanes"`, the port's own
`verify_batch`) or by the MSM batch check with bisection to per-lane
leaves (`verify_mode="msm"`, `crypto/msm.py`).  The verdicts are the
same; the mode is a throughput choice.  In MSM mode
`build_phases_device` takes the host-verified build and returns
(phases, None), as the twin does.

Port notes: device tensors are built from pinned host memory with
non-blocking copies (the JAX twin's `jnp.asarray` sites); lanes are not
rounded up to a power of two (nothing recompiles per shape here), though
`lane_floor` still pads; the serve plane builds exact lane counts too,
capped at its ladder's top rung.  The serve pieces are the twin's: the dedup columns (`verified`,
`digest`) riding the pending and held queues, `split_pending_verified`
/ `adopt_pending`, `last_build_keys` and the `max_votes` cap
(`_defer_pending`), and `adopt_native_phases`, which takes a build the
native admission drain already densified.  `build_phases_device_dense`
gives the same build in the dense [Ps, I, V] lane layout
(`DenseSignedPhases`), which shards with the phases on a mesh.

Evidence.  Every build retains the votes it screened (`_log`), as the
twin does: host-verified and unsigned builds after the screen, device-
verify builds before their verdicts exist, with that build's pubkey
table beside the batch (`_log_pk`).  `signed_evidence` joins a device
equivocation flag back to the two conflicting signed votes, and
re-verifies pre-verdict rows against their build's table first (on a
CUDA batcher through the verify kernel).  `clear_log` drops both lists
together: the twin's clears only `_log`, so after it a batch's pubkey
table is another batch's (ROADMAP §3).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from agnes_tpu_torch.bridge.value_table import MAX_VALUE_ID, SlotMap
from agnes_tpu_torch.core.round_votes import RoundVotes, ThreshKind
from agnes_tpu_torch.crypto.encoding import VOTE_MSG_LEN
from agnes_tpu_torch.device.encoding import I32, resolve_device
from agnes_tpu_torch.device.step import (
    DenseSignedPhases,
    SignedLanes,
    VotePhase,
)
from agnes_tpu_torch.device.tally import VOTED_NIL
from agnes_tpu_torch.types import MAX_ROUND, NIL_ID, Vote, VoteType

_NIL = -1                 # array encoding of a nil vote's value

# packed (instance, value) pair keys: value ids are 31-bit, so ascending
# int64 order over packed keys == lexicographic (instance, value) order
# — the framework-wide slot interning order
_PAIR_SHIFT = 31


def _pack_pairs(b: "_Batch") -> np.ndarray:
    """Non-nil lanes of a batch -> sorted-comparable packed keys."""
    nn = b.value >= 0
    return (b.instance[nn].astype(np.int64) << _PAIR_SHIFT) \
        | b.value[nn].astype(np.int64)


def _unpack_pair(pk: np.int64) -> Tuple[int, int]:
    return int(pk >> _PAIR_SHIFT), int(pk & ((1 << _PAIR_SHIFT) - 1))


@dataclass(frozen=True)
class WireVote:
    """One signed vote addressed to a consensus instance."""

    instance: int
    validator: int
    height: int
    round: int
    typ: VoteType
    value: Optional[int]       # None = nil
    signature: Optional[bytes] = None


@dataclass
class _Batch:
    """Column arrays for one pending batch of votes."""

    instance: np.ndarray       # [N] int64
    validator: np.ndarray      # [N] int64
    height: np.ndarray         # [N] int64
    round: np.ndarray          # [N] int64
    typ: np.ndarray            # [N] int64
    value: np.ndarray          # [N] int64 (_NIL = nil)
    signature: Optional[np.ndarray]   # [N, 64] uint8 or None
    # the serve plane's dedup columns: [N] bool verified upstream (a
    # dedup-cache hit, or the BLS lane's cleared rows) and the [N, 32]
    # wire SHA-256s; None when no row carries one
    verified: Optional[np.ndarray] = None
    digest: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.instance)

    def take(self, idx: np.ndarray) -> "_Batch":
        def opt(a):
            return a[idx] if a is not None else None

        return _Batch(
            self.instance[idx], self.validator[idx], self.height[idx],
            self.round[idx], self.typ[idx], self.value[idx],
            opt(self.signature), opt(self.verified), opt(self.digest))


def _opt_concat(batches: List[_Batch], name: str, zeros) -> Optional[
        np.ndarray]:
    """Concatenate an optional column, zero-filling batches without it
    (None when no batch has it)."""
    cols = [getattr(b, name) for b in batches]
    if all(c is None for c in cols):
        return None
    return np.concatenate([c if c is not None else zeros(len(b))
                           for c, b in zip(cols, batches)])


def _concat(batches: List[_Batch]) -> _Batch:
    if len(batches) == 1:
        return batches[0]            # no copy; columns are never mutated
    sig = _opt_concat(batches, "signature",
                      lambda n: np.zeros((n, 64), np.uint8))
    ver = _opt_concat(batches, "verified", lambda n: np.zeros(n, bool))
    dig = _opt_concat(batches, "digest",
                      lambda n: np.zeros((n, 32), np.uint8))
    return _Batch(*([np.concatenate([getattr(b, f) for b in batches])
                     for f in ("instance", "validator", "height", "round",
                               "typ", "value")] + [sig, ver, dig]))


def vote_messages_np(height: np.ndarray, round_: np.ndarray,
                     typ: np.ndarray, value: np.ndarray) -> np.ndarray:
    """[N] int64 columns -> [N, 45] uint8 canonical signing messages —
    the vectorized twin of crypto.encoding.vote_signing_bytes (value
    _NIL signs the all-ones NIL_WIRE field)."""
    n = len(height)
    msg = np.zeros((n, VOTE_MSG_LEN), np.uint8)
    msg[:, 0] = (typ & 0xFF).astype(np.uint8)
    h = height.astype(np.uint64)
    for i in range(8):
        msg[:, 1 + i] = ((h >> np.uint64(8 * i))
                         & np.uint64(0xFF)).astype(np.uint8)
    r = round_.astype(np.int64).astype(np.uint32)
    for i in range(4):
        msg[:, 9 + i] = ((r >> np.uint32(8 * i))
                         & np.uint32(0xFF)).astype(np.uint8)
    nil = value == _NIL
    v = np.where(nil, 0, value).astype(np.uint64)
    for i in range(8):          # value ids are < 2^31; 8 LE bytes cover
        msg[:, 13 + i] = ((v >> np.uint64(8 * i))
                          & np.uint64(0xFF)).astype(np.uint8)
    msg[nil, 13:45] = 0xFF      # NIL_WIRE = 2^256 - 1
    return msg


def _sha_blocks_np(r_bytes: np.ndarray, a_bytes: np.ndarray,
                   msg: np.ndarray) -> np.ndarray:
    """R[N,32] || A[N,32] || M[N,45] -> [N, 1, 32] uint32 padded SHA-512
    blocks (109 bytes + 0x80 + 16-byte bit length = 1 block)."""
    n = len(msg)
    buf = np.zeros((n, 128), np.uint8)
    buf[:, :32] = r_bytes
    buf[:, 32:64] = a_bytes
    buf[:, 64:109] = msg
    buf[:, 109] = 0x80
    bitlen = 109 * 8
    buf[:, 126] = (bitlen >> 8) & 0xFF
    buf[:, 127] = bitlen & 0xFF
    w = buf.reshape(n, 32, 4).astype(np.uint32)
    words = (w[:, :, 0] << 24) | (w[:, :, 1] << 16) \
        | (w[:, :, 2] << 8) | w[:, :, 3]
    return words.reshape(n, 1, 32)


class VoteBatcher:
    """Collects wire votes for one ingestion tick and emits dense
    phases on `device` (default "cuda"; raises when absent).  `heights`
    ([I], default zeros) is the instances' starting height, `powers`
    ([V], default ones) the validators' voting power (`set_validators`
    changes it at a height boundary), and `held_cap` bounds the
    future-round hold-back (default two full [I, V] ticks, at least
    65,536 votes)."""

    def __init__(self, n_instances: int, n_validators: int, n_slots: int,
                 heights: Optional[np.ndarray] = None,
                 n_rounds: int = 4,
                 powers: Optional[np.ndarray] = None,
                 held_cap: Optional[int] = None,
                 verify_mode: str = "lanes",
                 msm_leaf: int = 64, *, device="cuda"):
        if held_cap is not None and int(held_cap) <= 0:
            raise ValueError(f"held_cap must be positive: {held_cap}")
        if verify_mode not in ("lanes", "msm"):
            raise ValueError(f"verify_mode must be lanes|msm: {verify_mode}")
        if int(msm_leaf) < 2:
            # leaf 1 would make the adaptive bisection midpoint
            # degenerate (lo + n//2 == lo) on a failing lane
            raise ValueError(f"msm_leaf must be >= 2: {msm_leaf}")
        self.verify_mode = verify_mode
        self.msm_leaf = int(msm_leaf)
        self.device = resolve_device(device)
        self.I, self.V = n_instances, n_validators
        self.W = n_rounds
        self.slots = SlotMap(n_instances, n_slots)
        # per-instance height / window base (synced from the device)
        self.heights = np.asarray(
            heights if heights is not None
            else np.zeros(n_instances, np.int64)).astype(np.int64)
        self.base_round = np.zeros(n_instances, np.int64)
        self.powers = (np.asarray(powers, np.int64) if powers is not None
                       else np.ones(n_validators, np.int64))
        self._pending: List[_Batch] = []
        self._held: List[_Batch] = []          # future-round hold-back
        self._held_n = 0
        # the hold-back fills BEFORE signature verification, so it is
        # capped (an unauthenticated memory-exhaustion vector otherwise)
        self.held_cap = (int(held_cap) if held_cap is not None
                         else max(65536, 2 * self.I * self.V))
        # device-verify build state: pubkeys for the host-fallback
        # checks + lane batches aligned with the emitted phases
        self._dv_pubkeys: Optional[np.ndarray] = None
        self._emitted_lane_groups: List[_Batch] = []
        # retained votes (slashing evidence) and, per entry, the pubkey
        # table of the device-verify build that logged it pre-verdict
        # (None: logged post-screen, nothing to re-check)
        self._log: List[_Batch] = []
        self._log_pk: List[Optional[np.ndarray]] = []
        # (digest [N,32], instance [N], height [N]) of the real lanes the
        # last device-verify build emitted (None when the build had no
        # digest column or fell back host-verified): the serve pipeline
        # inserts them into the dedup cache once that dispatch settles
        # with zero rejected lanes
        self.last_build_keys: Optional[Tuple] = None
        self.rejected_signature = 0
        self.rejected_malformed = 0
        self.overflow_votes = 0
        self.dropped_stale_height = 0
        self.dropped_held_overflow = 0
        # host fallback tallies for past (rotated-out) rounds
        self._host_tally: Dict[Tuple[int, int, int], RoundVotes] = {}
        self._host_events: List[Tuple[int, int, int, int]] = []

    def set_validators(self, powers: np.ndarray) -> None:
        """Validator-set epoch: adopt new voting powers AT A HEIGHT
        BOUNDARY (right after the sync_device that advanced heights)."""
        pw = np.asarray(powers, np.int64)
        if pw.shape != (self.V,):
            raise ValueError(f"powers must be [{self.V}], got {pw.shape}")
        self.powers = pw

    # -- enqueue -------------------------------------------------------------

    def add_arrays(self, instance, validator, height, round_, typ, value,
                   signatures: Optional[np.ndarray] = None,
                   verified: Optional[np.ndarray] = None,
                   digest: Optional[np.ndarray] = None) -> None:
        """Bulk enqueue: [N] integer arrays (+ optional [N, 64] uint8
        signatures).  value < 0 means nil.  `verified` / `digest` are the
        serve plane's dedup columns (queue.WireColumns): a [N] bool
        cache-hit mask and the [N, 32] wire SHA-256s; they ride the
        pending and held queues so the pipeline can keep pre-verified
        re-deliveries apart from fresh traffic."""
        self._pending.append(_Batch(
            np.asarray(instance, np.int64), np.asarray(validator, np.int64),
            np.asarray(height, np.int64), np.asarray(round_, np.int64),
            np.asarray(typ, np.int64), np.asarray(value, np.int64),
            np.asarray(signatures, np.uint8)
            if signatures is not None else None,
            np.asarray(verified, bool) if verified is not None else None,
            np.asarray(digest, np.uint8) if digest is not None else None))

    def add_class_votes(self, instance, validator, height, round_, typ,
                        value) -> None:
        """Enqueue PRE-VERIFIED class votes: the BLS aggregate lane's
        cleared (or per-share fallback-verified) rows, which carry no
        Ed25519 signature.  A whole class densifies to one phase carrying
        its signers' combined weight; `build_phases` skips their
        verification (and `build_phases_device` takes the host-verified
        build when they are pending).  Callers must have a cleared
        pairing or a per-share verify behind every row."""
        n = len(np.asarray(instance))
        self.add_arrays(instance, validator, height, round_, typ, value,
                        verified=np.ones(n, bool))

    def add(self, vote: WireVote) -> None:
        """Enqueue one wire vote: a one-row `add_arrays`.  A signature
        that is not 64 bytes cannot ride the [N, 64] column, so it is
        screened here into `rejected_malformed` (one hostile vote must
        not fail the whole tick's build)."""
        if vote.signature is not None and len(vote.signature) != 64:
            self.rejected_malformed += 1
            return
        sig = (np.frombuffer(vote.signature, np.uint8)[None, :]
               if vote.signature is not None else None)
        self.add_arrays([vote.instance], [vote.validator], [vote.height],
                        [vote.round], [int(vote.typ)],
                        [_NIL if vote.value is None else vote.value], sig)

    def extend(self, votes) -> None:
        """`add` each vote of an iterable, in order."""
        for v in votes:
            self.add(v)

    # -- device sync ---------------------------------------------------------

    def sync_device(self, base_round, heights) -> None:
        """Adopt the device plane's rotated window bases and heights.
        Held future-round votes whose window arrived re-enter the
        pending queue; a height advance resets that instance's slots."""
        new_heights = np.asarray(heights, np.int64)
        advanced = np.nonzero(new_heights > self.heights)[0]
        for i in advanced:
            self.slots.reset_instance(int(i))
        if len(advanced):
            adv = set(int(i) for i in advanced)
            # decided heights can never commit again: drop their tallies
            self._host_tally = {
                k: v for k, v in self._host_tally.items()
                if not (k[0] in adv and k[1] < new_heights[k[0]])}
        self.heights = new_heights
        self.base_round = np.asarray(base_round, np.int64)
        if self._held:
            held, self._held = self._held, []
            self._held_n = 0
            self._pending.extend(held)

    def clear_log(self) -> None:
        """Drop retained evidence batches (extract evidence for flagged
        validators via `signed_evidence` first)."""
        self._log = []
        self._log_pk = []

    # -- the serve plane's queue surface -------------------------------------

    @property
    def held_votes(self) -> int:
        """Future-round votes held back (they re-enter on the
        sync_device that rotates their window in)."""
        return self._held_n

    @property
    def pending_votes(self) -> int:
        """Votes enqueued but not yet drained by a build."""
        return sum(len(b) for b in self._pending)

    def split_pending_verified(self) -> List[_Batch]:
        """Remove the pre-verified rows (the `verified` column) from the
        pending queue and return them as their own batches, arrival
        order kept within each stream.  The pipeline builds the fresh
        rows signed, then hands these back through `adopt_pending` and
        builds them unsigned.  The split lives here because held
        future-round votes re-enter `_pending` with their flag: a fresh
        vote must never ride an unsigned build."""
        pre: List[_Batch] = []
        fresh: List[_Batch] = []
        for b in self._pending:
            v = b.verified
            if v is None or not v.any():
                fresh.append(b)
            elif v.all():
                pre.append(b)
            else:
                pre.append(b.take(np.nonzero(v)[0]))
                fresh.append(b.take(np.nonzero(~v)[0]))
        self._pending = fresh
        return pre

    def adopt_pending(self, batches: List[_Batch]) -> None:
        """Re-queue batches returned by `split_pending_verified`."""
        self._pending.extend(batches)

    def _defer_pending(self, max_votes: Optional[int]) -> List[_Batch]:
        """Cap the next build at `max_votes` pending votes (arrival
        order; a straddling batch splits) and return the deferred tail,
        which the caller restores after the build.  The serve plane's
        ladder cap: a held burst re-entering beside a full tick builds
        separately, each onto a warmed rung."""
        if max_votes is None:
            return []
        if int(max_votes) <= 0:
            raise ValueError(f"max_votes must be positive: {max_votes}")
        left = int(max_votes)
        head: List[_Batch] = []
        tail: List[_Batch] = []
        for b in self._pending:
            if left <= 0:
                tail.append(b)
            elif len(b) <= left:
                head.append(b)
                left -= len(b)
            else:
                head.append(b.take(np.arange(left)))
                tail.append(b.take(np.arange(left, len(b))))
                left = 0
        self._pending = head
        return tail

    # -- host -> device ------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """numpy -> tensor on the batcher's device; on the card through
        pinned host memory and a non-blocking copy on the current stream
        (PyTorch's pinned-memory allocator holds the buffer until that
        copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- signature verification ----------------------------------------------

    def _pack_verify_inputs_np(self, b: _Batch, pubkeys: np.ndarray):
        """Numpy (pub, sig, blocks) verify inputs for a batch — the ONE
        packing recipe for the host-verified and the device-fused paths.
        blocks are the uint32 words as int32 bit patterns."""
        msg = vote_messages_np(b.height, b.round, b.typ, b.value)
        a_bytes = np.asarray(pubkeys)[b.validator]        # [N, 32]
        sig = (b.signature if b.signature is not None
               else np.zeros((len(b), 64), np.uint8))
        return (a_bytes.astype(np.int32), sig.astype(np.int32),
                _sha_blocks_np(sig[:, :32], a_bytes, msg).view(np.int32))

    def _verify(self, b: _Batch, pubkeys: np.ndarray) -> np.ndarray:
        """Batch-verify on the batcher's device; returns [N] bool."""
        from agnes_tpu_torch.crypto import msm
        from agnes_tpu_torch.crypto.ed25519 import verify_batch

        pub, sig, blocks = (self._to_device(a) for a in
                            self._pack_verify_inputs_np(b, pubkeys))
        if self.verify_mode == "msm":
            return msm.verify_batch_adaptive(pub, sig, blocks,
                                             leaf=self.msm_leaf)
        return verify_batch(pub, sig, blocks).cpu().numpy()

    # -- host fallback for past rounds ---------------------------------------

    def _host_tally_screened(self, b: _Batch) -> None:
        """Route votes to the host tally; in device-verify mode they are
        verified HERE first, since device verdicts never reach the host
        buckets."""
        if self._dv_pubkeys is not None and len(b):
            good = self._verify(b, self._dv_pubkeys)
            self.rejected_signature += int(len(b) - good.sum())
            b = b.take(np.nonzero(good)[0])
        if len(b):
            self._host_tally_past(b)

    def _host_tally_past(self, b: _Batch) -> None:
        """Tally rotated-out rounds with the host RoundVotes; only +2/3
        precommit-value (commit from ANY round) is surfaced."""
        total = int(self.powers.sum())
        for k in range(len(b)):
            inst, hgt, rnd = (int(b.instance[k]), int(b.height[k]),
                              int(b.round[k]))
            rv = self._host_tally.get((inst, hgt, rnd))
            if rv is None:
                rv = RoundVotes(height=hgt, round=rnd, total=total)
                self._host_tally[(inst, hgt, rnd)] = rv
            val = None if b.value[k] == _NIL else int(b.value[k])
            thresh = rv.add_vote(
                Vote(typ=VoteType(int(b.typ[k])), round=rnd, value=val,
                     height=hgt, validator=int(b.validator[k])),
                int(self.powers[b.validator[k]]))
            if (int(b.typ[k]) == int(VoteType.PRECOMMIT)
                    and thresh.kind == ThreshKind.VALUE):
                self._host_events.append((inst, hgt, rnd, thresh.value))

    def drain_host_events(self) -> List[Tuple[int, int, int, int]]:
        """[(instance, height, round, value_id)] late precommit-value
        quorums detected by the host fallback."""
        ev, self._host_events = self._host_events, []
        return ev

    # -- densification -------------------------------------------------------

    def build_phases(self, pubkeys: Optional[np.ndarray] = None,
                     _device_verify: bool = False,
                     max_votes: Optional[int] = None
                     ) -> List[Tuple[VotePhase, int]]:
        """Drain pending votes into dense phases: [(phase, n_votes)], one
        per (round, class, layer), deterministic order.  With `pubkeys`,
        signatures are batch-verified first and failures dropped (and
        counted).  `_device_verify` (internal; use build_phases_device)
        defers the bulk verification to the fused step — only the
        host-tallied subsets (past rounds, slot spill) verify here.
        `max_votes` caps the build at the oldest `max_votes` pending
        votes; the rest stay pending (`_defer_pending`)."""
        if max_votes is not None:
            tail = self._defer_pending(max_votes)
            try:
                return self.build_phases(pubkeys,
                                         _device_verify=_device_verify)
            finally:
                if tail:
                    self._pending.extend(tail)
        if not self._pending:
            return []
        b, self._pending = _concat(self._pending), []
        n0 = len(b)
        if n0 == 0:
            return []

        # --- malformed screen
        ok = ((b.instance >= 0) & (b.instance < self.I)
              & (b.validator >= 0) & (b.validator < self.V)
              & (b.round >= 0) & (b.round <= MAX_ROUND)
              & (b.typ >= 0) & (b.typ <= 1)
              & (b.value <= MAX_VALUE_ID))
        self.rejected_malformed += int(n0 - ok.sum())
        inst_c = np.clip(b.instance, 0, self.I - 1)
        h_ok = b.height == self.heights[inst_c]
        self.dropped_stale_height += int((ok & ~h_ok).sum())
        b = b.take(np.nonzero(ok & h_ok)[0])
        if len(b) == 0:
            return []
        # normalize the nil encoding (any value < 0 is nil); rebuild
        # rather than mutate (columns can alias caller arrays)
        if (b.value < _NIL).any():
            b = replace(b, value=np.where(b.value < 0, _NIL, b.value))

        # --- hold back future rounds BEFORE verification
        widx = b.round - self.base_round[b.instance]
        future = widx >= self.W
        if future.any():
            fut = np.nonzero(future)[0]
            room = self.held_cap - self._held_n
            if len(fut) > room:           # cap: fail closed, count
                self.dropped_held_overflow += len(fut) - max(room, 0)
                fut = fut[:max(room, 0)]
            if len(fut):
                self._held.append(b.take(fut))
                self._held_n += len(fut)
            b = b.take(np.nonzero(~future)[0])
            if len(b) == 0:
                return []

        # --- signature verification: unsigned votes must FAIL, not
        # bypass (missing signatures verify as zero signatures)
        self._dv_pubkeys = pubkeys if _device_verify else None
        if pubkeys is not None:
            if b.signature is None:
                b = replace(b, signature=np.zeros((len(b), 64), np.uint8))
            if not _device_verify:
                good = (b.verified.copy() if b.verified is not None
                        else np.zeros(len(b), bool))
                need = np.nonzero(~good)[0]
                if len(need):
                    good[need] = self._verify(b.take(need), pubkeys)
                self.rejected_signature += int(len(b) - good.sum())
                b = b.take(np.nonzero(good)[0])
                if len(b) == 0:
                    return []

        # --- retain votes for slashable evidence: post-screen, or
        # pre-verdict with the build's pubkey table (device verify)
        self._log.append(b)
        self._log_pk.append(self._dv_pubkeys)

        # --- past (rotated-out) rounds go to the host tally
        past = (b.round - self.base_round[b.instance]) < 0
        if past.any():
            self._host_tally_screened(b.take(np.nonzero(past)[0]))
            b = b.take(np.nonzero(~past)[0])
            if len(b) == 0:
                return []

        # --- fast path: one round, each class's (instance, validator)
        # cells occupied at most once; classes emit (prevote, precommit)
        if (b.round[0] == b.round).all():
            parts = []
            for t in (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT)):
                m = b.typ == t
                if not m.any():
                    continue
                sub = b.take(np.nonzero(m)[0])
                cell_id = sub.instance * self.V + sub.validator
                counts = np.bincount(cell_id, minlength=self.I * self.V)
                if (counts > 1).any():
                    parts = None
                    break
                parts.append(sub)
            if parts is not None:
                # both classes with different values: intern new
                # (instance, value) pairs in one ascending pass first so
                # slot numbering never depends on class order
                if len(parts) > 1:
                    monos = []
                    for sub in parts:
                        nn = sub.value[sub.value >= 0]
                        if len(nn):
                            lo, hi = nn.min(), nn.max()
                            monos.append(int(lo) if lo == hi else -1)
                    if -1 in monos or len(set(monos)) > 1:
                        packed = [_pack_pairs(sub) for sub in parts]
                        packed = [p for p in packed if len(p)]
                        for pk in np.unique(np.concatenate(packed)):
                            self.slots.prealloc(*_unpack_pair(pk))
                groups = []
                for sub in parts:
                    sub, slot = self._intern_and_spill(sub)
                    if len(sub):
                        groups.append((sub, slot, int(sub.round[0]),
                                       int(sub.typ[0])))
                return self._emit(groups) if groups else []

        # --- general path: ONE lexsort orders everything; duplicates,
        # layers and phase groups fall out of adjacency scans
        arrival = np.arange(len(b))
        order = np.lexsort((arrival, b.value, b.validator, b.instance,
                            b.typ, b.round))
        bs = b.take(order)

        def cell_runs(x: _Batch) -> np.ndarray:
            return ((x.round[1:] == x.round[:-1])
                    & (x.typ[1:] == x.typ[:-1])
                    & (x.instance[1:] == x.instance[:-1])
                    & (x.validator[1:] == x.validator[:-1]))

        same_cell = cell_runs(bs)
        dup = np.zeros(len(bs), bool)
        dup[1:] = same_cell & (bs.value[1:] == bs.value[:-1])
        if dup.any():
            bs = bs.take(np.nonzero(~dup)[0])
            same_cell = cell_runs(bs)
        n = len(bs)

        # layer = rank within the (still sorted) cell run
        new_cell = np.ones(n, bool)
        new_cell[1:] = ~same_cell
        group_start = np.maximum.accumulate(
            np.where(new_cell, np.arange(n), 0))
        layer = np.arange(n) - group_start

        bs, slot, layer = self._intern_and_spill(bs, layer)
        if len(bs) == 0:
            return []

        # group into phases by packed (round, typ, layer) int64 key
        pkey = ((bs.round.astype(np.int64) << 22)
                | (bs.typ.astype(np.int64) << 21)
                | np.minimum(layer, (1 << 21) - 1))
        ukeys, pinv = np.unique(pkey, return_inverse=True)
        groups = []
        for p, k in enumerate(ukeys):
            sel = np.nonzero(pinv == p)[0]
            groups.append((bs.take(sel), slot[sel],
                           int(k >> 22), int((k >> 21) & 1)))
        return self._emit(groups)

    def _device_verify_eligible(self) -> bool:
        """Gate for the device-fused build: ONE round, each (class,
        instance, validator) cell at most once, at most ONE distinct
        non-nil value per instance.  Anything else takes the
        host-verified path (forged votes must not touch slots or mint
        phases before verdicts exist)."""
        if not self._pending:
            return False
        b = _concat(self._pending)
        self._pending = [b]            # keep the concat for the build
        if len(b) == 0 or (b.round != b.round[0]).any():
            return False
        if b.verified is not None and b.verified.any():
            return False               # pre-verified rows carry no lanes
        if ((b.typ < 0) | (b.typ > 1) | (b.instance < 0)
                | (b.instance >= self.I) | (b.validator < 0)
                | (b.validator >= self.V)).any():
            return False
        cell = ((b.typ * self.I + b.instance) * self.V + b.validator)
        if (np.bincount(cell, minlength=2 * self.I * self.V) > 1).any():
            return False
        nn = b.value >= 0
        if nn.any():
            lo = np.full(self.I, np.iinfo(np.int64).max, np.int64)
            hi = np.full(self.I, -1, np.int64)
            np.minimum.at(lo, b.instance[nn], b.value[nn])
            np.maximum.at(hi, b.instance[nn], b.value[nn])
            if ((hi >= 0) & (lo != hi)).any():
                return False
        return True

    def build_phases_device(self, pubkeys: np.ndarray,
                            phase_offset: int = 0,
                            lane_floor: int = 0,
                            max_votes: Optional[int] = None):
        """Drain pending votes into dense phases with verification
        deferred to the device: returns (phases, SignedLanes) where lane
        j carries one emitted vote's packed Ed25519 inputs keyed to its
        phase index (+ `phase_offset` for callers that prepend e.g. an
        entry phase).  Feed both to DeviceDriver.step_seq_signed.

        Falls back to the HOST-verified build — (phases, None) — when
        the traffic is not the honest dense shape, and in MSM mode.  `lane_floor` pads
        the lanes to at least that many with copies of lane 0 aimed at
        an out-of-range phase (dropped on the device; `real` False).
        `max_votes` caps the build at the oldest pending votes
        (`_defer_pending`)."""
        phases, cat, pidx = self._build_device_common(pubkeys,
                                                      max_votes=max_votes)
        if cat is None:
            return phases, None
        phase_idx = pidx + phase_offset
        n = len(cat)
        n_pad = max(n, int(lane_floor))
        real = np.ones(n_pad, bool)
        if n_pad > n:
            real[n:] = False
            cat = _concat([cat, cat.take(np.zeros(n_pad - n, np.intp))])
            phase_idx = np.concatenate(
                [phase_idx,
                 np.full(n_pad - n, phase_offset + len(phases), np.int64)])
        pub, sig, blocks = self._pack_verify_inputs_np(cat, pubkeys)
        t = self._to_device
        lanes = SignedLanes(
            pub=t(pub), sig=t(sig), blocks=t(blocks),
            phase_idx=t(phase_idx.astype(np.int32)),
            inst=t(cat.instance.astype(np.int32)),
            val=t(cat.validator.astype(np.int32)),
            real=t(real))
        return phases, lanes

    def build_phases_device_dense(self, pubkeys: np.ndarray,
                                  max_votes: Optional[int] = None):
        """`build_phases_device` in the dense lane layout: returns
        (phases, DenseSignedPhases) with sig and blocks scattered to
        [Ps, I, V, ...] (Ps = the phases built) — feed both to
        DeviceDriver.step_seq_signed_dense, on one device or a mesh.
        Cells without a vote hold zeros and verify False, which the
        mask AND discards.  The same eligibility gate, host-fallback
        screening and `max_votes` cap as build_phases_device, and the
        same fallback to (host-verified phases, None).  The scatter runs
        in numpy, on the card's path straight into pinned host tensors,
        and each tensor goes up once by a non-blocking copy; nothing is
        read back from the device."""
        phases, cat, pidx = self._build_device_common(pubkeys,
                                                      max_votes=max_votes)
        if cat is None:
            return phases, None
        Ps = len(phases)
        _, sig_np, blocks_np = self._pack_verify_inputs_np(cat, pubkeys)
        pin = self.device.type == "cuda"
        sig = torch.zeros((Ps, self.I, self.V, 64), dtype=I32,
                          pin_memory=pin)
        blocks = torch.zeros((Ps, self.I, self.V) + blocks_np.shape[1:],
                             dtype=I32, pin_memory=pin)
        cell = (pidx, cat.instance, cat.validator)
        sig.numpy()[cell] = sig_np
        blocks.numpy()[cell] = blocks_np
        del sig_np, blocks_np

        def up(t: torch.Tensor) -> torch.Tensor:
            return t if not pin else t.to(self.device, non_blocking=True)

        dense = DenseSignedPhases(
            pub=self._to_device(np.asarray(pubkeys).astype(np.int32)),
            sig=up(sig), blocks=up(blocks))
        return phases, dense

    def adopt_native_phases(self, cols, ph, pubkeys: np.ndarray):
        """Adopt a native phase drain: `cols` is the drained WireColumns
        batch and `ph` the NativePhases that core/native/
        admission_phases.cpp filled for it — the arrays
        build_phases_device would have produced for these rows against
        this window and slot table (the native side bails to a plain
        drain wherever the Python build would drop, split or spill).
        Returns (phases, SignedLanes) on the batcher's device, each
        array uploaded whole.

        What it still owes the Python build, per batch: the slot
        interning of the (instance, value) pairs the drain gave a fresh
        slot; the evidence log entry (the arrival-order batch with the
        nil encoding normalized) and, beside it, the build's pubkey
        table, so a later `clear_log` drops both together; and
        `last_build_keys` in the build's phase-grouped lane order.

        The caller (ServePipeline.stage) owns the preconditions: nothing
        else pending, and ph.heights / base_round / slot_lut equal to
        the batcher's window and slot table after the sync."""
        value = cols.value
        nn = value >= 0
        if nn.any():
            # at most one non-nil value an instance (the drain's rule):
            # a scatter finds it, no sort
            per_inst = np.full(self.I, -1, np.int64)
            per_inst[cols.instance[nn]] = value[nn]
            inst_u = np.nonzero(per_inst >= 0)[0]
            val_u = per_inst[inst_u]
            row = ph.slot_lut[inst_u]
            hit = row == val_u[:, None]
            want = np.where(hit.any(1), hit.argmax(1),
                            (row == -1).argmax(1))
            got = [self.slots.slot_for(int(i), int(v))
                   for i, v in zip(inst_u, val_u)]
            if got != want.tolist():       # not an assert: survives -O
                raise RuntimeError(
                    "native phase drain and SlotMap disagree on a slot")
        if (value < _NIL).any():
            value = np.where(value < 0, _NIL, value)
        self._log.append(_Batch(
            cols.instance, cols.validator, cols.height, cols.round_,
            cols.typ, value, cols.signatures,
            np.asarray(cols.verified, bool), cols.digest))
        self._log_pk.append(pubkeys)
        rows = ph.lane_rows
        self.last_build_keys = (
            (cols.digest[rows], cols.instance[rows], cols.height[rows])
            if cols.digest is not None else None)
        dev = self.device

        def up(t: torch.Tensor) -> torch.Tensor:
            # the drain's own host tensors (pinned on the card's path):
            # a non-blocking upload, or the tensor itself on the CPU
            return t if dev.type == "cpu" else t.to(dev, non_blocking=True)

        hts = self._to_device(self.heights.astype(np.int32))
        slots, mask = up(ph.slots), up(ph.mask)
        phases = [(VotePhase(
            round=torch.full((self.I,), int(ph.round_), dtype=I32,
                             device=dev),
            typ=torch.full((self.I,), int(ph.typ[p]), dtype=I32,
                           device=dev),
            slots=slots[p], mask=mask[p], height=hts), int(ph.counts[p]))
            for p in range(ph.n_phases)]
        lanes = SignedLanes(
            pub=up(ph.pub), sig=up(ph.sig), blocks=up(ph.blocks),
            phase_idx=up(ph.phase_idx), inst=up(ph.inst),
            val=up(ph.val), real=up(ph.real))
        return phases, lanes

    def _build_device_common(self, pubkeys: np.ndarray,
                             max_votes: Optional[int] = None):
        """Shared device-verify build core: (phases, cat, phase_idx)
        with 0-based numpy phase indices, or (host-verified phases,
        None, None) on the fallback paths (ineligible traffic, MSM mode).
        `max_votes` defers the pending tail before the eligibility gate,
        so eligibility is judged on exactly the votes this build
        drains."""
        tail = self._defer_pending(max_votes)
        self.last_build_keys = None
        # digests are all-or-none across the batches this build drains:
        # _concat zero-fills a missing column, and a zero digest must
        # never become a cache key
        all_digests = bool(self._pending) and all(
            b.digest is not None for b in self._pending)
        try:
            if (self.verify_mode != "lanes"
                    or not self._device_verify_eligible()):
                return self.build_phases(pubkeys), None, None
            self._emitted_lane_groups = []
            phases = self.build_phases(pubkeys, _device_verify=True)
            groups, self._emitted_lane_groups = \
                self._emitted_lane_groups, []
            self._dv_pubkeys = None
            if not phases:
                return [], None, None
            if len(groups) != len(phases):
                raise RuntimeError("lane groups out of step with phases")
            cat = _concat(groups)
            phase_idx = np.concatenate([np.full(len(g), i, np.int64)
                                        for i, g in enumerate(groups)])
            if all_digests and cat.digest is not None:
                # cache keys for exactly the emitted real lanes
                self.last_build_keys = (cat.digest, cat.instance,
                                        cat.height)
            return phases, cat, phase_idx
        finally:
            if tail:
                self._pending.extend(tail)

    def _intern_and_spill(self, b: _Batch, layer: Optional[np.ndarray] = None):
        """Intern slots; votes whose value overflows the instance's slot
        budget spill to the HOST tally.  Returns the kept batch + slots
        (+ layers when given)."""
        slot = self._intern_slots(b)
        ovf = slot == VOTED_NIL - 1
        if ovf.any():
            self._host_tally_screened(b.take(np.nonzero(ovf)[0]))
            keep = np.nonzero(~ovf)[0]
            b, slot = b.take(keep), slot[~ovf]
            if layer is not None:
                layer = layer[~ovf]
        return (b, slot) if layer is None else (b, slot, layer)

    def _intern_slots(self, b: _Batch) -> np.ndarray:
        """[N] slot per vote (VOTED_NIL for nil, VOTED_NIL-1 for
        overflow); python only over UNIQUE new (instance, value)."""
        slot = np.full(len(b), VOTED_NIL, np.int64)
        nonnil = b.value >= 0
        if nonnil.any():
            nn = np.nonzero(nonnil)[0]
            if (b.value[nn] == b.value[nn[0]]).all():
                uinst = np.unique(b.instance[nn])
                v0 = int(b.value[nn[0]])
                lut = np.full(self.I, VOTED_NIL - 1, np.int64)
                for inst in uinst:
                    s = self.slots.slot_for(int(inst), v0)
                    lut[inst] = VOTED_NIL - 1 if s is None else s
                slot[nn] = lut[b.instance[nn]]
            else:
                pair = _pack_pairs(b)
                upairs, inv = np.unique(pair, return_inverse=True)
                uslots = np.empty(len(upairs), np.int64)
                for j, pk in enumerate(upairs):
                    s = self.slots.slot_for(*_unpack_pair(pk))
                    uslots[j] = VOTED_NIL - 1 if s is None else s
                slot[nn] = uslots[inv]
        self.overflow_votes += int((slot == VOTED_NIL - 1).sum())
        return slot

    def _emit(self, groups) -> List[Tuple[VotePhase, int]]:
        """[(batch, slot, round, typ)] -> dense VotePhases (fancy-index
        scatter on the host, one upload per tensor).  In device-verify
        mode the per-phase lane batches are retained, aligned with the
        emitted phase order."""
        hts = self._to_device(self.heights.astype(np.int32))
        phases: List[Tuple[VotePhase, int]] = []
        for bg, sg, rnd, typ in groups:
            keep = sg != VOTED_NIL - 1
            if not keep.all():
                idx = np.nonzero(keep)[0]
                bg, sg = bg.take(idx), sg[idx]
            if len(bg) == 0:
                continue
            if self._dv_pubkeys is not None:
                self._emitted_lane_groups.append(bg)
            slots = np.full((self.I, self.V), VOTED_NIL, np.int32)
            mask = np.zeros((self.I, self.V), bool)
            slots[bg.instance, bg.validator] = sg
            mask[bg.instance, bg.validator] = True
            phases.append((VotePhase(
                round=torch.full((self.I,), rnd, dtype=I32,
                                 device=self.device),
                typ=torch.full((self.I,), typ, dtype=I32,
                               device=self.device),
                slots=self._to_device(slots),
                mask=self._to_device(mask),
                height=hts), int(len(bg))))
        return phases

    # -- evidence ------------------------------------------------------------

    def signed_evidence(self, instance: int, validator: int
                        ) -> Optional[Tuple[WireVote, WireVote]]:
        """The two conflicting signed votes behind a device
        equivocation flag: the first two votes, in arrival order, by
        `validator` in `instance` with the same (height, round, class)
        and different values.  Returns (first, second) WireVotes whose
        signatures prove the double-sign to any third party, or None
        (`signed_evidence_many` for one cell)."""
        return self.signed_evidence_many([instance], [validator]).get(
            (instance, validator))

    def signed_evidence_many(self, instances, validators
                             ) -> Dict[Tuple[int, int],
                                       Tuple[WireVote, WireVote]]:
        """`signed_evidence` for many (instance, validator) cells in one
        walk of the retained batches: {cell: (first, second)} for the
        cells that have a conflicting pair.

        Batches logged by device-verify builds are pre-verdict, so their
        candidate votes (the rows of cells still without a pair) are
        re-verified against that build's pubkey table, in one batched
        `_verify` per batch (on a CUDA batcher the verify kernel), and
        unverifiable votes are skipped.  Host-verified and unsigned
        builds logged post-screen and are trusted.  The walk stops after
        the batch that completes the last pair."""
        def packed(i, v):
            return (np.asarray(i, np.int64) << 32) \
                | (np.asarray(v, np.int64) & 0xFFFFFFFF)

        open_cells = np.unique(packed(instances, validators))
        seen: Dict[Tuple[int, int],
                   Dict[Tuple[int, int, int],
                        Tuple[int, Optional[bytes]]]] = {}
        found: Dict[Tuple[int, int], Tuple[WireVote, WireVote]] = {}
        for batch, pk in zip(self._log, self._log_pk):
            if len(open_cells) == 0:
                break
            hit = np.nonzero(np.isin(packed(batch.instance,
                                            batch.validator),
                                     open_cells))[0]
            if len(hit) == 0:
                continue
            if pk is not None:
                if batch.signature is None:
                    continue
                good = np.asarray(self._verify(batch.take(hit), pk))
                hit = hit[good.astype(bool)]
            for k in hit:
                cell = (int(batch.instance[k]), int(batch.validator[k]))
                if cell in found:
                    continue
                key = (int(batch.height[k]), int(batch.round[k]),
                       int(batch.typ[k]))
                val_k = int(batch.value[k])
                sig = (batch.signature[k].tobytes()
                       if batch.signature is not None else None)
                votes = seen.setdefault(cell, {})
                if key not in votes:
                    votes[key] = (val_k, sig)
                elif votes[key][0] != val_k:
                    h, r, t = key

                    def mk(v, s):
                        return WireVote(
                            instance=cell[0], validator=cell[1],
                            height=h, round=r, typ=VoteType(t),
                            value=None if v == _NIL else v, signature=s)

                    found[cell] = (mk(*votes[key]), mk(val_k, sig))
            if found:
                open_cells = np.setdiff1d(
                    open_cells, packed(*np.asarray(list(found)).T))
        return found

    def decode_slot(self, instance: int, slot: int) -> Optional[int]:
        """Device slot -> value id (for reading decisions back)."""
        if slot == NIL_ID:
            return None
        return self.slots.value_for(instance, slot)
