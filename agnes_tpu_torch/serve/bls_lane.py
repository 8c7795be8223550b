"""BLS aggregate-precommit lane: one pairing per vote class (twin of
`agnes_tpu.serve.bls_lane`).

BLS verification is slower per signature than Ed25519 but AGGREGATES,
so a whole vote class costs one aggregate check:

  wire shares ──fold──> AggregateClass buckets per (instance, height,
      round, typ, value): signer bitmap + share table; PoP-less /
      unknown / duplicate / malformed / quarantined shares rejected and
      counted at admission
  class closes (size-or-deadline) ──> O(N) on the device:
      `crypto/bls.py::bls_aggregate`, the stake-weighted G1 and G2 MSMs
      on a padded ladder rung
      ──> O(1) on the device: every closed class's pairing check in ONE
          `crypto/bls_pairing.py::bls_pairing_product` call per padded
          class rung, consuming the MSM outputs in place; only a [C]
          bool vector crosses back; verdicts memoized per (class key,
          epoch, signer set), memos pruned on epoch advance
  pairing clears ──> the class's rows enter the bridge pre-verified
      (`VoteBatcher.add_class_votes`) and densify to one phase per
      signer set
  pairing fails ──> per-share fallback against the `bls_ref` HOST
      oracle: good shares still dispatch, forged shares are dropped and
      counted (and their signers struck, then quarantined); one forged
      share can neither poison the class nor suppress honest shares.

Host-pairing mode (`device_pairing=False`, or a CPU lane with no
pairing class rungs planned): per-class MSM fetch + oracle pairing.  A
CUDA lane pairs on the device unless host pairing is asked for, and
raises when no class rungs are planned.

Every field product and reduce of both device calls is a launch of the
CUDA kernels of `csrc/bls_fp.cu` on the card (the plain PyTorch versions
for a lane on the CPU).  Bound to a serve plane (`bind` with the
service's driver, registry and ladder), each MSM and pairing call is
observed by the driver's retrace tripwire and each pairing dispatch
leaves a flight-recorder event.  With `BlsClassTable.native_screen` set
(a `VoteService(native_admission=True)` sets it) the fold's header
screens run in C++ (`serve/native_admission.bls_screen`).  The table's
`mc_clone` / `mc_canonical` are the admission model checker's state
surface (analysis/admission_mc.py); the host side is numpy + stdlib."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from agnes_tpu_torch.crypto import bls as BLS
from agnes_tpu_torch.crypto import bls_pairing as BP
from agnes_tpu_torch.crypto import bls_ref as ref
from agnes_tpu_torch.crypto.encoding import vote_signing_bytes
from agnes_tpu_torch.device.encoding import resolve_device
from agnes_tpu_torch.serve.batcher import _ceil_pow2
from agnes_tpu_torch.utils.metrics import (  # noqa: F401 (re-exported)
    BLS_DEVICE_PAIRING_DISPATCHES,
    BLS_PAIRING_WALL_S,
)

#: wire record: the 96-byte Ed25519 record's 32-byte header followed
#: by a 192-byte UNCOMPRESSED G2 share (bls_ref.g2_to_bytes layout) —
#: uncompressed so admission never pays an Fp2 square root per share
BLS_HEADER = 32
BLS_SIG_BYTES = 192
BLS_REC_SIZE = BLS_HEADER + BLS_SIG_BYTES


def pack_bls_wire(instance, validator, height, round_, typ, value,
                  shares: np.ndarray) -> bytes:
    """Column arrays + [N, 192] share bytes -> packed BLS wire records
    (the 96-byte Ed25519 wire record's header layout)."""
    n = len(np.asarray(instance))
    rec = np.zeros((n, BLS_REC_SIZE), np.uint8)
    rec[:, 0:4] = np.asarray(instance, np.uint32)[:, None].view(
        np.uint8).reshape(n, 4)
    rec[:, 4:8] = np.asarray(validator, np.uint32)[:, None].view(
        np.uint8).reshape(n, 4)
    rec[:, 8:16] = np.asarray(height, np.int64)[:, None].view(
        np.uint8).reshape(n, 8)
    rec[:, 16:20] = np.asarray(round_, np.int32)[:, None].view(
        np.uint8).reshape(n, 4)
    rec[:, 20] = np.asarray(typ, np.uint8)
    val = np.asarray(value, np.int64)
    rec[:, 21] = (val >= 0).astype(np.uint8)
    rec[:, 24:32] = np.maximum(val, 0)[:, None].view(
        np.uint8).reshape(n, 8)
    rec[:, BLS_HEADER:] = np.asarray(shares, np.uint8).reshape(
        n, BLS_SIG_BYTES)
    return rec.tobytes()


def unpack_bls_wire(wire) -> Tuple[np.ndarray, ...]:
    """Packed BLS records -> (instance, validator, height, round, typ,
    value, shares [N, 192]); trailing partial record dropped (counted
    by the caller via len % BLS_REC_SIZE)."""
    buf = np.frombuffer(wire, np.uint8) \
        if isinstance(wire, (bytes, bytearray, memoryview)) \
        else np.asarray(wire, np.uint8).ravel()
    n = len(buf) // BLS_REC_SIZE
    rec = buf[:n * BLS_REC_SIZE].reshape(n, BLS_REC_SIZE)

    def field(lo, hi, dt):
        return np.ascontiguousarray(rec[:, lo:hi]).view(dt)[:, 0]

    inst = field(0, 4, np.uint32).astype(np.int64)
    val = field(4, 8, np.uint32).astype(np.int64)
    height = field(8, 16, np.int64).copy()
    round_ = field(16, 20, np.int32).astype(np.int64)
    typ = rec[:, 20].astype(np.int64)
    nonnil = rec[:, 21] != 0
    value = np.where(nonnil, field(24, 32, np.int64), -1)
    shares = np.ascontiguousarray(rec[:, BLS_HEADER:])
    return inst, val, height, round_, typ, value, shares


class BlsKeyRegistry:
    """Validator BLS key table + proof-of-possession ledger.

    Construction decompresses (and subgroup-checks) every pubkey once;
    `register_pop` verifies a validator's PoP against the oracle and
    unlocks them for aggregation.  `mark_trusted` is the deployment
    trust-root seam (keys whose PoPs were verified out of band, e.g. a
    genesis file) — folding NEVER happens for a validator that is in
    neither state, counted `bls_pop_missing`."""

    def __init__(self, pubkeys, powers=None):
        pk = np.asarray(pubkeys, np.uint8)
        if pk.ndim != 2 or pk.shape[1] != 48:
            raise ValueError(f"pubkeys must be [V, 48]: {pk.shape}")
        self.V = pk.shape[0]
        self.pk_bytes = [bytes(pk[v]) for v in range(self.V)]
        self.pk_points = [ref.g1_decompress(b) for b in self.pk_bytes]
        pw = (np.asarray(powers, np.int64) if powers is not None
              else np.ones(self.V, np.int64))
        if pw.shape != (self.V,):
            raise ValueError(f"powers must be [{self.V}]: {pw.shape}")
        if (pw < 0).any() or (pw >= (1 << BLS.W_BITS)).any():
            raise ValueError(
                f"powers must fit {BLS.W_BITS} bits (the MSM weight "
                f"width)")
        self.powers = pw
        #: the deployment's weight WIDTH, fixed at construction: the
        #: MSM's window count (a fixed shape of every class's MSM,
        #: bls.n_windows_for) derives from it, so set_powers must
        #: stay inside it — uniform-stake deployments (w_bits=1) pay
        #: one window's bucket scan per class instead of six
        self.w_bits = max(1, int(pw.max()).bit_length()) \
            if self.V else 1
        #: [V, 2, NLIMBS] int32 — the G1 MSM's pubkey rows, packed once
        self.pk_limbs = BLS.pack_g1_rows(self.pk_points)
        self.pop_ok = np.zeros(self.V, bool)
        #: liveness defense (README threat model): per-validator count
        #: of shares the fallback PROVED forged, and the quarantine
        #: flag the lane raises after `BlsLane.quarantine_after`
        #: strikes — a quarantined validator's folds are rejected at
        #: admission (`bls_quarantined`), so a PoP-verified-but-
        #: malicious validator cannot re-bill the per-share pairing
        #: sweep forever by minting fresh garbage points per class
        self.forged_strikes = np.zeros(self.V, np.int64)
        self.quarantined = np.zeros(self.V, bool)
        #: bumped by set_powers — pairing memo keys carry it so a
        #: validator-set epoch can never reuse a stale verdict
        self.epoch = 0

    @classmethod
    def from_state(cls, pk_bytes, pk_points, pk_limbs, powers, pop_ok,
                   forged_strikes, quarantined, epoch
                   ) -> "BlsKeyRegistry":
        """A registry holding the given state as it is (no decompression,
        no screens): `convert.bls_registry_from_jax`'s constructor."""
        reg = cls.__new__(cls)
        reg.V = len(pk_bytes)
        reg.pk_bytes = [bytes(b) for b in pk_bytes]
        reg.pk_points = list(pk_points)
        reg.pk_limbs = np.array(pk_limbs, np.int32)
        reg.powers = np.array(powers, np.int64)
        reg.w_bits = max(1, int(reg.powers.max()).bit_length()) \
            if reg.V else 1
        reg.pop_ok = np.array(pop_ok, bool)
        reg.forged_strikes = np.array(forged_strikes, np.int64)
        reg.quarantined = np.array(quarantined, bool)
        reg.epoch = int(epoch)
        return reg

    @property
    def n_windows(self) -> int:
        return BLS.n_windows_for(self.w_bits)

    def register_pop(self, validator: int, pop_bytes: bytes) -> bool:
        """Verify + record a proof of possession; False (and no state
        change) on a bad proof."""
        v = int(validator)
        if not 0 <= v < self.V:
            return False
        if not ref.pop_verify(self.pk_bytes[v], pop_bytes):
            return False
        self.pop_ok[v] = True
        return True

    def mark_trusted(self, validators) -> None:
        """Trust-root seam: mark validators whose PoPs were verified
        out of band (module docstring)."""
        self.pop_ok[np.asarray(validators, np.int64)] = True

    def set_powers(self, powers) -> None:
        """Validator-set epoch: adopt new voting powers at a height
        boundary (the `set_validators` contract) and advance the
        epoch, invalidating every memoized pairing verdict."""
        pw = np.asarray(powers, np.int64)
        if pw.shape != (self.V,):
            raise ValueError(f"powers must be [{self.V}]: {pw.shape}")
        if (pw < 0).any() or (pw >= (1 << BLS.W_BITS)).any():
            raise ValueError(f"powers must fit {BLS.W_BITS} bits")
        new_bits = max(1, int(pw.max()).bit_length()) if self.V else 1
        if BLS.n_windows_for(new_bits) > self.n_windows:
            # the window COUNT is fixed per deployment (the twin warms
            # and compiles it): an epoch may not need more windows
            # (widths within the same 4-bit window granularity are fine)
            raise ValueError(
                f"epoch powers need "
                f"{BLS.n_windows_for(new_bits)} MSM windows > the "
                f"deployment's warmed {self.n_windows} "
                f"(construct the registry with the widest epoch)")
        self.powers = pw
        self.epoch += 1


@dataclasses.dataclass
class AggregateClass:
    """One (instance, height, round, typ, value) precommit class:
    signer bitmap + raw shares, growing until the lane closes it."""

    key: Tuple[int, int, int, int, int]
    signers: np.ndarray                 # [V] bool
    shares: Dict[int, bytes]            # validator -> 192-byte share
    weight: int
    t_first: float

    @property
    def n_signers(self) -> int:
        return len(self.shares)


class BlsClassTable:
    """Admission-side class-bucket store.  Bounded fail-closed: at most
    `max_classes` open classes, at most one share per (class,
    validator), shares only from PoP-verified validators.  Thread-safe
    under one leaf mutex (a submit thread and a dispatch thread may
    fold and poll concurrently)."""

    def __init__(self, registry: BlsKeyRegistry, n_instances: int,
                 max_classes: int = 256,
                 clock=time.monotonic):
        if max_classes <= 0:
            raise ValueError(f"max_classes must be positive: "
                             f"{max_classes}")
        self.registry = registry
        self.I = int(n_instances)
        self.max_classes = int(max_classes)
        self._clock = clock
        self._mu = threading.Lock()
        #: the fold's range / PoP / quarantine header screens in C++
        #: (serve/native_admission.bls_screen), the Python loop walking
        #: only the survivors (which still pay the on-curve decode); the
        #: taxonomy is the same either way
        self.native_screen = False
        self.classes: Dict[tuple, AggregateClass] = {}
        self.counters = {
            "bls_shares_submitted": 0, "bls_shares_folded": 0,
            "bls_malformed": 0, "bls_unknown_validator": 0,
            "bls_pop_missing": 0, "bls_duplicate_share": 0,
            "bls_class_overflow": 0, "bls_quarantined": 0,
        }

    # -- admission -----------------------------------------------------------

    def fold(self, wire_bytes, decode: bool = True) -> dict:
        """Fold packed BLS wire records into class buckets; returns
        the per-cause counts of this submit.  `decode=False` skips the
        on-curve share screen (the admission model checker's seam —
        its shares are opaque tokens)."""
        raw_len = len(wire_bytes)
        n = raw_len // BLS_REC_SIZE
        res = {k: 0 for k in ("folded", "malformed",
                              "unknown_validator", "pop_missing",
                              "duplicate", "overflow",
                              "quarantined")}
        tail = 1 if raw_len % BLS_REC_SIZE else 0
        res["malformed"] = tail
        cols = unpack_bls_wire(wire_bytes)
        inst, val, height, round_, typ, value, shares = cols
        now = self._clock()
        reg = self.registry
        # pass 1, LOCK-FREE: range/PoP screens + the on-curve decode
        # (a pure-python Fp2 check per share; holding the mutex across
        # it would block a concurrent poll() for the whole submit).
        # With the native screen the header screens are one C call and
        # the reject counts a bincount over its codes.
        if self.native_screen and n:
            from agnes_tpu_torch.serve.native_admission import bls_screen

            codes = bls_screen(wire_bytes, self.I, reg.V, reg.pop_ok,
                               reg.quarantined)
            bc = np.bincount(codes, minlength=5)
            res["malformed"] += int(bc[1])
            res["unknown_validator"] += int(bc[2])
            res["pop_missing"] += int(bc[3])
            res["quarantined"] += int(bc[4])
            candidates = np.flatnonzero(codes == 0)
        else:
            candidates = None
        staged = []
        for j in (range(n) if candidates is None else candidates):
            j = int(j)
            i, v = int(inst[j]), int(val[j])
            if candidates is None:
                if not (0 <= i < self.I and 0 <= typ[j] <= 1):
                    res["malformed"] += 1
                    continue
                if not 0 <= v < reg.V:
                    res["unknown_validator"] += 1
                    continue
                if not reg.pop_ok[v]:
                    # rogue-key defense: no verified proof of
                    # possession, no aggregation — ever
                    res["pop_missing"] += 1
                    continue
                if reg.quarantined[v]:
                    # proven-forger liveness defense: this validator's
                    # shares have failed the per-share fallback
                    # repeatedly
                    res["quarantined"] += 1
                    continue
            share = shares[j].tobytes()
            if decode:
                try:
                    if ref.g2_from_bytes(share) is None:
                        raise ValueError("identity share")
                except ValueError:
                    res["malformed"] += 1
                    continue
            staged.append(((i, int(height[j]), int(round_[j]),
                            int(typ[j]), int(value[j])), v, share))
        # pass 2, under the mutex: class-dict mutation only
        with self._mu:
            self.counters["bls_shares_submitted"] += n + tail
            for key, v, share in staged:
                cls = self.classes.get(key)
                if cls is None:
                    if len(self.classes) >= self.max_classes:
                        res["overflow"] += 1
                        continue
                    cls = self.classes[key] = AggregateClass(
                        key=key, signers=np.zeros(reg.V, bool),
                        shares={}, weight=0, t_first=now)
                if v in cls.shares:
                    res["duplicate"] += 1
                    continue
                cls.shares[v] = share
                cls.signers[v] = True
                cls.weight += int(reg.powers[v])
                res["folded"] += 1
            self.counters["bls_shares_folded"] += res["folded"]
            self.counters["bls_malformed"] += res["malformed"]
            self.counters["bls_unknown_validator"] += \
                res["unknown_validator"]
            self.counters["bls_pop_missing"] += res["pop_missing"]
            self.counters["bls_duplicate_share"] += res["duplicate"]
            self.counters["bls_class_overflow"] += res["overflow"]
            self.counters["bls_quarantined"] += res["quarantined"]
        return res

    # -- close ---------------------------------------------------------------

    def poll(self, now: Optional[float] = None,
             target_signers: Optional[int] = None,
             max_delay_s: float = 0.005) -> List[AggregateClass]:
        """Remove and return the classes ready to aggregate:
        size-closed (signers >= target, default the full validator
        set) or deadline-closed (oldest share older than
        max_delay_s) — the micro-batcher's size-or-deadline dial
        applied to classes."""
        tgt = (int(target_signers) if target_signers is not None
               else self.registry.V)
        out: List[AggregateClass] = []
        with self._mu:
            now = self._clock() if now is None else now
            for key in list(self.classes):
                cls = self.classes[key]
                if cls.n_signers >= tgt \
                        or now - cls.t_first >= max_delay_s:
                    out.append(self.classes.pop(key))
        return out

    def ready(self, now: Optional[float] = None,
              target_signers: Optional[int] = None,
              max_delay_s: float = 0.005) -> bool:
        """Non-destructive poll(): would any class close right now?  (A
        dispatch loop gates its pump on this; a destructive peek would
        strand classes outside the pump's lock domain.)"""
        tgt = (int(target_signers) if target_signers is not None
               else self.registry.V)
        with self._mu:
            now = self._clock() if now is None else now
            return any(c.n_signers >= tgt
                       or now - c.t_first >= max_delay_s
                       for c in self.classes.values())

    def flush(self) -> List[AggregateClass]:
        """Remove and return every open class (drain path)."""
        with self._mu:
            out = list(self.classes.values())
            self.classes.clear()
        return out

    @property
    def open_classes(self) -> int:
        return len(self.classes)

    @property
    def pending_shares(self) -> int:
        """Shares folded into the open classes (each signer once)."""
        with self._mu:
            return sum(c.n_signers for c in self.classes.values())

    # -- state-space surface (analysis/admission_mc.py) ----------------------

    def mc_clone(self) -> "BlsClassTable":
        t = type(self).__new__(type(self))
        t.registry = self.registry
        t.I = self.I
        t.max_classes = self.max_classes
        t._clock = self._clock
        t.native_screen = self.native_screen
        t._mu = threading.Lock()
        with self._mu:
            t.classes = {
                k: AggregateClass(key=c.key, signers=c.signers.copy(),
                                  shares=dict(c.shares),
                                  weight=c.weight, t_first=c.t_first)
                for k, c in self.classes.items()}
            t.counters = dict(self.counters)
        return t

    def mc_canonical(self) -> tuple:
        """Canonical int-only bucket content (counters excluded:
        monotone history, as in AdmissionQueue.mc_canonical)."""
        with self._mu:
            return tuple(sorted(
                (c.key, tuple(sorted(c.shares)), c.weight)
                for c in self.classes.values()))

    def snapshot(self) -> dict:
        with self._mu:
            out = dict(self.counters)
            out["open_classes"] = len(self.classes)
        return out


class BlsLane:
    """The dispatch-side half: device aggregation + memoized pairing +
    forged-share fallback (module docstring).  Constructed around a
    BlsKeyRegistry on `device` (default "cuda"; raises when absent);
    `bind()` wires the driver, a metrics registry and the ladder in at
    service setup."""

    def __init__(self, registry: BlsKeyRegistry, n_instances: int,
                 max_classes: int = 256,
                 target_signers: Optional[int] = None,
                 max_delay_s: float = 0.005,
                 quarantine_after: int = 3,
                 device_pairing: Optional[bool] = None,
                 clock=time.monotonic, device="cuda"):
        self.registry = registry
        self.device = resolve_device(device)
        self.table = BlsClassTable(registry, n_instances,
                                   max_classes=max_classes,
                                   clock=clock)
        self.target_signers = target_signers
        self.max_delay_s = float(max_delay_s)
        #: strikes before a proven forger's folds are refused at
        #: admission (registry docstring; <= 0 disables quarantine)
        self.quarantine_after = int(quarantine_after)
        #: None = auto (a CUDA lane pairs on the device; a CPU lane
        #: does iff the bound ladder planned pairing class rungs);
        #: True/False forces it
        self.device_pairing = device_pairing
        self._clock = clock
        self.driver = None
        self.metrics = None
        self.ladder = None
        self._h_pairing = None
        #: memoized per-class-message G2 hash and pairing verdicts
        self._msg_memo: Dict[tuple, object] = {}
        self._pair_memo: Dict[tuple, bool] = {}
        #: per-SHARE verdicts from fallback isolation, keyed by
        #: (validator, epoch, message key, share bytes): a forged share
        #: replayed into a later class costs a dict hit, not a host
        #: pairing
        self._share_memo: Dict[tuple, bool] = {}
        #: the epoch the verdict/share memos were built under: an epoch
        #: advance prunes both (the keys carry the epoch, so no stale
        #: verdict is reused; the prune bounds the memory)
        self._memo_epoch = registry.epoch
        self.counters = {
            "agg_classes": 0, "agg_votes": 0,
            "fallback_classes": 0, "fallback_votes": 0,
            "rejected_share_signature": 0,
            "pairing_memo_hits": 0,
            BLS_DEVICE_PAIRING_DISPATCHES: 0,
            "bls_memo_evictions": 0,
        }

    def bind(self, driver, metrics=None, ladder=None) -> None:
        self.driver = driver
        self.metrics = metrics
        self.ladder = ladder
        if metrics is not None:
            self._h_pairing = metrics.histogram(BLS_PAIRING_WALL_S)

    # -- admission passthrough ----------------------------------------------

    def poll(self, now: Optional[float] = None) -> List[AggregateClass]:
        return self.table.poll(now, self.target_signers,
                               self.max_delay_s)

    def ready(self, now: Optional[float] = None) -> bool:
        """Would poll() return anything?  (Non-destructive.)"""
        return self.table.ready(now, self.target_signers,
                                self.max_delay_s)

    def flush(self) -> List[AggregateClass]:
        return self.table.flush()

    # -- aggregation + verification ------------------------------------------

    def _rung_for(self, n: int) -> int:
        if self.ladder is not None and self.ladder.bls_rungs:
            return self.ladder.bls_rung_for(n)
        return _ceil_pow2(n)

    def _class_msg_point(self, key: tuple):
        """hash_to_g2 of the class's canonical signing message — the
        SAME bytes an Ed25519 vote would sign
        (crypto.encoding.vote_signing_bytes), memoized per class."""
        mk = key[1:]                      # (height, round, typ, value)
        pt = self._msg_memo.get(mk)
        if pt is None:
            h, r, t, val = mk
            pt = ref.hash_to_g2(vote_signing_bytes(
                h, r, t, None if val < 0 else val))
            if len(self._msg_memo) >= 4096:
                self._msg_memo.clear()
            self._msg_memo[mk] = pt
        return pt

    @property
    def uses_device_pairing(self) -> bool:
        """Resolved pairing mode: forced; else auto = always on a CUDA
        lane (whose sweep raises without planned class rungs), and on a
        CPU lane iff the bound ladder planned pairing class rungs."""
        if self.device_pairing is not None:
            return bool(self.device_pairing)
        if self.device.type == "cuda":
            return True
        return (self.ladder is not None
                and bool(self.ladder.bls_class_rungs))

    def _prune_epoch_memos(self) -> None:
        """Epoch advance -> drop every memoized pairing/share verdict of
        the old generation (counted `bls_memo_evictions`).  The
        message-point memo survives: the class message is
        epoch-independent."""
        ep = self.registry.epoch
        if ep == self._memo_epoch:
            return
        n = len(self._pair_memo) + len(self._share_memo)
        self._pair_memo.clear()
        self._share_memo.clear()
        self._memo_epoch = ep
        if n:
            self.counters["bls_memo_evictions"] += n

    def _msm_dispatch(self, cls: AggregateClass, signers):
        """One class's O(N) MSMs on a padded ladder rung; returns the
        aggregated (G1P, G2P) on the lane's device, not fetched, so
        consecutive classes' launches queue back to back."""
        n = len(signers)
        rung = self._rung_for(n)
        pk_rows = np.zeros((rung, 2, BLS.NLIMBS), np.int32)
        sig_rows = np.zeros((rung, 4, BLS.NLIMBS), np.int32)
        w = np.zeros(rung, np.int64)
        pk_rows[:n] = self.registry.pk_limbs[signers]
        sig_rows[:n] = BLS.pack_g2_rows(
            [ref.g2_from_bytes(cls.shares[v]) for v in signers])
        w[:n] = self.registry.powers[signers]
        args = [torch.from_numpy(a).to(self.device)
                for a in (pk_rows, sig_rows, BLS.pack_weights(w))]
        nw = self.registry.n_windows
        if self.driver is not None:
            self.driver._observe("bls_aggregate", tuple(args),
                                 statics=(nw,))
        return BLS.bls_aggregate(*args, n_windows=nw)

    def _aggregate_device(self, cls: AggregateClass, signers):
        """Host-pairing mode's aggregation: MSM dispatch + one fetch at
        the class-close boundary; returns bls_ref affine points for the
        oracle pairing."""
        agg_pk, agg_sig = self._msm_dispatch(cls, signers)
        return BLS.g1_from_device(agg_pk), BLS.g2_from_device(agg_sig)

    def _host_pairing_sweep(self, pending) -> Dict[tuple, bool]:
        """Per class, fetch the aggregates and pay one oracle
        pairing-product (seconds of pure Python each).  The histogram
        times exactly the pairing-product."""
        out: Dict[tuple, bool] = {}
        for memo_key, cls, signers, msg_pt in pending:
            agg_pk, agg_sig = self._aggregate_device(cls, signers)
            t0 = self._clock()
            out[memo_key] = ref.pairing_product_is_one(
                [(ref.point_neg(ref.G1), agg_sig),
                 (agg_pk, msg_pt)])
            if self._h_pairing is not None:
                self._h_pairing.record(self._clock() - t0)
        return out

    def _device_pairing_sweep(self, pending) -> Dict[tuple, bool]:
        """The steady state, zero host crypto: every pending class's
        MSMs queue back to back, their outputs feed ONE
        `bls_pairing_product` call per padded class rung (chunked above
        the top rung), and only the [C] bool verdicts cross back.  The
        histogram records the pairing wall divided over its classes."""
        if self.ladder is None or not self.ladder.bls_class_rungs:
            raise ValueError(
                "device pairing needs planned bls_class_rungs "
                "(ShapeLadder.with_bls) — bind a ladder with pairing "
                "rungs or construct the lane with "
                "device_pairing=False")
        cap = self.ladder.bls_class_rungs[-1]
        out: Dict[tuple, bool] = {}
        dev = self.device
        neg_g1 = torch.from_numpy(BP.NEG_G1_LIMBS).to(dev)
        for k0 in range(0, len(pending), cap):
            chunk = pending[k0:k0 + cap]
            p_rows, q_rows = [], []
            for _mk, cls, signers, msg_pt in chunk:
                agg_pk, agg_sig = self._msm_dispatch(cls, signers)
                p_rows.append(torch.stack(
                    [neg_g1, torch.stack([agg_pk.x, agg_pk.y, agg_pk.z])]))
                q_rows.append(torch.stack(
                    [torch.stack([agg_sig.x, agg_sig.y, agg_sig.z]),
                     torch.from_numpy(BP.pack_g2_proj(msg_pt)).to(dev)]))
            C = len(chunk)
            rung = self.ladder.bls_class_rung_for(C)
            pad = rung - C
            p = torch.stack(p_rows + [torch.zeros_like(p_rows[0])] * pad)
            q = torch.stack(q_rows + [torch.zeros_like(q_rows[0])] * pad)
            if self.driver is not None:
                self.driver._observe("bls_pairing_product", (p, q))
            if dev.type == "cuda":
                # the queued MSMs first, so the histogram times the
                # pairing itself
                torch.cuda.synchronize(dev)
            t0 = self._clock()
            ok = BP.bls_pairing_product(p, q).cpu().numpy()
            wall = self._clock() - t0
            if self._h_pairing is not None:
                self._h_pairing.record(wall / C, n=C)
            self.counters[BLS_DEVICE_PAIRING_DISPATCHES] += 1
            if self.metrics is not None:
                self.metrics.count(BLS_DEVICE_PAIRING_DISPATCHES)
            fr = getattr(self.driver, "flightrec", None)
            if fr is not None:
                fr.event(BLS_DEVICE_PAIRING_DISPATCHES, classes=C,
                         rung=rung, wall_s=round(wall, 4))
            for (mk, *_rest), verdict in zip(chunk, ok[:C]):
                out[mk] = bool(verdict)
        return out

    def clear_classes(self, classes: List[AggregateClass]
                      ) -> Optional[dict]:
        """Aggregate + verify a batch of closed classes; returns the
        verified row columns (all verified=True — the unsigned-entry
        contract) or None when nothing survived.  In the steady state
        every un-memoized class rides ONE device pairing dispatch
        (`_device_pairing_sweep`); a class whose pairing fails falls
        back to per-share oracle verification: good shares still
        dispatch, forged shares are dropped and counted
        (`rejected_share_signature`)."""
        self._prune_epoch_memos()
        entries: List[tuple] = []
        pending: List[tuple] = []
        # verdicts for THIS batch, resolved at lookup/sweep time —
        # never re-read from _pair_memo below: the memo's capacity
        # clear (4096 entries) may fire mid-update, and a memo-HIT
        # class re-read after the clear would default to False and
        # take a spurious host fallback sweep
        verdicts: Dict[tuple, bool] = {}
        for cls in classes:
            signers = np.nonzero(cls.signers)[0]
            if not len(signers):
                continue
            memo_key = (cls.key, self.registry.epoch,
                        signers.tobytes())
            msg_pt = self._class_msg_point(cls.key)
            entries.append((cls, signers, memo_key, msg_pt))
            hit = self._pair_memo.get(memo_key)
            if hit is not None:
                self.counters["pairing_memo_hits"] += 1
                verdicts[memo_key] = hit
            else:
                pending.append((memo_key, cls, signers, msg_pt))
        if pending:
            sweep = (self._device_pairing_sweep
                     if self.uses_device_pairing
                     else self._host_pairing_sweep)
            swept = sweep(pending)
            verdicts.update(swept)
            for mk, verdict in swept.items():
                if len(self._pair_memo) >= 4096:
                    self._pair_memo.clear()
                self._pair_memo[mk] = verdict
        out: List[tuple] = []
        t_first = None
        for cls, signers, memo_key, msg_pt in entries:
            key = cls.key
            ok = verdicts[memo_key]
            if ok:
                good = signers
                self.counters["agg_classes"] += 1
                self.counters["agg_votes"] += len(signers)
            else:
                # forged share(s) somewhere in the class: isolate
                # per share against the oracle; honest shares still
                # count, forged ones are dropped forever.  Verdicts
                # memoize per share so replays cost a lookup.
                reg = self.registry
                good_list = []
                for v in signers:
                    sk = (int(v), reg.epoch, key[1:],
                          cls.shares[v])
                    ok_s = self._share_memo.get(sk)
                    if ok_s is None:
                        ok_s = ref.verify_share(
                            reg.pk_points[v], msg_pt,
                            ref.g2_from_bytes(cls.shares[v]))
                        if len(self._share_memo) >= 8192:
                            self._share_memo.clear()
                        self._share_memo[sk] = ok_s
                        if not ok_s:
                            # PROVEN forgery (not a replay): strike
                            # the signer; past the threshold their
                            # folds are refused at admission, so
                            # fresh-garbage-per-class cannot re-bill
                            # the pairing sweep forever
                            reg.forged_strikes[v] += 1
                            if 0 < self.quarantine_after \
                                    <= reg.forged_strikes[v]:
                                reg.quarantined[v] = True
                    if ok_s:
                        good_list.append(v)
                good = np.asarray(good_list, np.int64)
                self.counters["fallback_classes"] += 1
                self.counters["fallback_votes"] += len(good)
                self.counters["rejected_share_signature"] += \
                    len(signers) - len(good)
            if len(good):
                out.append((key, good))
                t_first = cls.t_first if t_first is None \
                    else min(t_first, cls.t_first)
        if not out:
            return None
        inst = np.concatenate([np.full(len(g), k[0], np.int64)
                               for k, g in out])
        vals = np.concatenate([g for _k, g in out])
        height = np.concatenate([np.full(len(g), k[1], np.int64)
                                 for k, g in out])
        round_ = np.concatenate([np.full(len(g), k[2], np.int64)
                                 for k, g in out])
        typ = np.concatenate([np.full(len(g), k[3], np.int64)
                              for k, g in out])
        value = np.concatenate([np.full(len(g), k[4], np.int64)
                                for k, g in out])
        return {"instance": inst, "validator": vals, "height": height,
                "round_": round_, "typ": typ, "value": value,
                "t_first": t_first}

    def snapshot(self) -> dict:
        out = dict(self.counters)
        out.update(self.table.snapshot())
        return out
