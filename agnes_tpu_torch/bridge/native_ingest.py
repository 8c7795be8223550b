"""NativeIngestLoop: the C++ ingestion event loop, and the 96-byte wire
record codec it reads (twin of `agnes_tpu.bridge.native_ingest`).

A wire vote is one packed record: instance (u32), validator (u32),
height (i64), round (i32), class (u8), a non-nil flag (u8), two pad
bytes, value (i64) and the 64-byte Ed25519 signature, little-endian.
`pack_wire_votes` builds records from columns and `unpack_wire_votes`
is its exact inverse (pure numpy); the serve plane's admission queue
parses with it.

`NativeIngestLoop` is the native twin of `bridge.ingest.VoteBatcher`
with the same tick protocol, over the port's own C++ copy
(`core/native/ingest.cpp`, built with g++ by `core/native_build.py`).
Packed records flow through parse -> screen -> window discipline ->
batch verify -> verdict filter, dedup, layering, slot interning ->
dense [I, V] phases, with rotated-out rounds falling back to the C++
RoundVotes host tally (late precommit-value quorums surface through
`drain_host_events`).  Everything but the verify is host C++: on a
signed loop `build_phases` has the C++ side stage the pending lanes and
fill their verify inputs (int32 pub and sig bytes, uint32 SHA-512
blocks: the twin's ABI) straight into pinned host memory, uploads them,
runs the port's `crypto/ed25519.py::verify_batch` on the loop's device
(one launch of the window-5 CUDA kernel on the card; its plain version
for device="cpu"), and hands the verdicts back to C++, which drops the
failed lanes and emits the phases.

Double buffering: `ag_ing_emit` flips between two phase-buffer sets and
reuses a set at the emit after next.  Every phase leaves a C++ view
through one copy (`pin_memory()` before a non-blocking upload on the
card, `clone()` on the CPU) that has finished reading the view when
`build_phases` returns.

Differential parity with the twin and with the port's VoteBatcher:
tests/test_torch_native_ingest.py.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from agnes_tpu_torch.core.native_build import lib as _build_lib
from agnes_tpu_torch.device.encoding import I32, resolve_device
from agnes_tpu_torch.device.step import VotePhase

REC_SIZE = 96

_configured = False


def _lib() -> ctypes.CDLL:
    """The native library with the loop's C ABI declared (built on
    first use; a failed build raises)."""
    global _configured
    L = _build_lib()
    if not _configured:
        c = ctypes
        L.ag_ing_new.restype = c.c_void_p
        L.ag_ing_new.argtypes = [c.c_int64, c.c_int64, c.c_int64,
                                 c.c_int64, c.c_char_p, c.c_void_p]
        L.ag_ing_set_held_cap.argtypes = [c.c_void_p, c.c_int64]
        L.ag_ing_free.argtypes = [c.c_void_p]
        L.ag_ing_sync.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
        L.ag_ing_push.restype = c.c_int64
        L.ag_ing_push.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
        L.ag_ing_stage.restype = c.c_int64
        L.ag_ing_stage.argtypes = [c.c_void_p]
        L.ag_ing_fill_verify_inputs.argtypes = [c.c_void_p, c.c_void_p,
                                                c.c_void_p, c.c_void_p]
        L.ag_ing_apply_verdicts.restype = c.c_int64
        L.ag_ing_apply_verdicts.argtypes = [c.c_void_p, c.c_char_p]
        L.ag_ing_emit.restype = c.c_int64
        L.ag_ing_emit.argtypes = [c.c_void_p]
        L.ag_ing_phase.restype = c.c_int64
        L.ag_ing_phase.argtypes = [
            c.c_void_p, c.c_int64, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int64),
            c.POINTER(c.POINTER(c.c_int32)),
            c.POINTER(c.POINTER(c.c_uint8))]
        L.ag_ing_drain_events.restype = c.c_int64
        L.ag_ing_drain_events.argtypes = [c.c_void_p, c.c_void_p,
                                          c.c_int64]
        L.ag_ing_decode_slot.restype = c.c_int64
        L.ag_ing_decode_slot.argtypes = [c.c_void_p, c.c_int64, c.c_int32]
        L.ag_ing_evidence.restype = c.c_int64
        L.ag_ing_evidence.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                      c.c_char_p]
        L.ag_ing_clear_log.argtypes = [c.c_void_p]
        L.ag_ing_counters.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_ing_export_slots.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_ing_import_slots.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_ing_log_size.restype = c.c_int64
        L.ag_ing_log_size.argtypes = [c.c_void_p]
        L.ag_ing_export_log.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_ing_import_log.restype = c.c_int64
        L.ag_ing_import_log.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
        L.ag_ing_restore_counters.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_ing_get_held_cap.restype = c.c_int64
        L.ag_ing_get_held_cap.argtypes = [c.c_void_p]
        L.ag_ing_push_async.restype = c.c_int64
        L.ag_ing_push_async.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
        L.ag_ing_flush.argtypes = [c.c_void_p]
        L.ag_ing_async_depth.restype = c.c_int64
        L.ag_ing_async_depth.argtypes = [c.c_void_p]
        L.ag_ing_set_validators.restype = c.c_int64
        L.ag_ing_set_validators.argtypes = [c.c_void_p, c.c_char_p,
                                            c.c_void_p]
        _configured = True
    return L


def pack_wire_votes(instance, validator, height, round_, typ, value,
                    signatures: Optional[np.ndarray] = None) -> bytes:
    """Column arrays -> packed 96-byte wire records (vectorized).
    value < 0 encodes nil."""
    n = len(np.asarray(instance))
    rec = np.zeros((n, REC_SIZE), np.uint8)
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
    if signatures is not None:
        rec[:, 32:96] = np.asarray(signatures, np.uint8).reshape(n, 64)
    return rec.tobytes()


def unpack_wire_votes(wire) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """Packed 96-byte wire records -> column arrays (vectorized), the
    exact inverse of `pack_wire_votes`: (instance, validator, height,
    round, typ, value, signatures[N, 64]); value is -1 for nil.  A
    trailing partial record is dropped (the caller counts it via
    `len(wire) % REC_SIZE`)."""
    buf = np.frombuffer(wire, np.uint8) if isinstance(wire, (bytes,
                                                             bytearray,
                                                             memoryview)) \
        else np.asarray(wire, np.uint8).ravel()
    n = len(buf) // REC_SIZE
    rec = buf[:n * REC_SIZE].reshape(n, REC_SIZE)

    def field(lo, hi, dt):
        return np.ascontiguousarray(rec[:, lo:hi]).view(dt)[:, 0]

    inst = field(0, 4, np.uint32).astype(np.int64)
    val = field(4, 8, np.uint32).astype(np.int64)
    height = field(8, 16, np.int64).copy()
    round_ = field(16, 20, np.int32).astype(np.int64)
    typ = rec[:, 20].astype(np.int64)
    nonnil = rec[:, 21] != 0
    value = np.where(nonnil, field(24, 32, np.int64), -1)
    sigs = np.ascontiguousarray(rec[:, 32:96])
    return inst, val, height, round_, typ, value, sigs


class NativeIngestLoop:
    """One C++ ingestion loop per (driver, height window): the native
    fast lane with VoteBatcher's tick protocol.  Phases and verify
    inputs live on `device` (default "cuda"; raises when absent)."""

    def __init__(self, n_instances: int, n_validators: int,
                 n_slots: int, n_rounds: int = 4,
                 pubkeys: Optional[np.ndarray] = None,
                 powers: Optional[np.ndarray] = None,
                 held_cap: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.I, self.V = n_instances, n_validators
        self._n_slots, self._n_rounds = n_slots, n_rounds
        self.signed = pubkeys is not None
        L = _lib()
        if pubkeys is not None:
            pubkeys = np.ascontiguousarray(pubkeys, np.uint8)
            if pubkeys.shape != (n_validators, 32):
                # the C side copies V*32 bytes blind: screen here
                raise ValueError(
                    f"pubkeys must be [{n_validators}, 32] uint8, "
                    f"got {pubkeys.shape}")
        pk = pubkeys.tobytes() if pubkeys is not None else None
        pw = None
        if powers is not None:
            pw = np.ascontiguousarray(powers, np.int64)
            if pw.shape != (n_validators,):
                raise ValueError(
                    f"powers must be [{n_validators}], got {pw.shape}")
        self._powers = pw
        self._h = L.ag_ing_new(
            n_instances, n_validators, n_rounds, n_slots, pk,
            pw.ctypes.data if pw is not None else None)
        if not self._h:
            # the C side fails closed (NULL) on hostile dimensions
            raise ValueError(
                f"invalid ingest-loop dimensions: I={n_instances} "
                f"V={n_validators} W={n_rounds} S={n_slots}")
        self._free = L.ag_ing_free     # bound now: survives shutdown
        if held_cap is not None:
            # the raw ABI treats cap <= 0 as reset-to-default; the
            # wrapper contract (shared with VoteBatcher) wants it positive
            if int(held_cap) <= 0:
                raise ValueError(f"held_cap must be positive: {held_cap}")
            L.ag_ing_set_held_cap(self._h, int(held_cap))
        # read back the enforced cap: the C side owns the default
        self.held_cap = int(L.ag_ing_get_held_cap(self._h))
        # import_state's freshness rule: ANY interaction (push, sync,
        # build, clear_log) makes the loop non-restorable; the evidence
        # log alone would miss pushed-but-unbuilt votes
        self._used = False

    def __del__(self):
        if getattr(self, "_h", None):
            self._free(self._h)
            self._h = None

    # -- tick protocol -------------------------------------------------------

    def sync_device(self, base_round, heights) -> None:
        """Adopt the device plane's window bases and heights ([I] each):
        held future-round votes whose window arrived re-enter, a height
        advance resets that instance's slots."""
        base = np.ascontiguousarray(base_round, np.int64)
        hts = np.ascontiguousarray(heights, np.int64)
        if base.shape != (self.I,) or hts.shape != (self.I,):
            # the C side reads I int64s from each blind
            raise ValueError(
                f"base_round/heights must be [{self.I}], got "
                f"{base.shape}/{hts.shape}")
        self._heights = hts
        self._base_round = base
        self._used = True
        _lib().ag_ing_sync(self._h, base.ctypes.data, hts.ctypes.data)

    def push(self, wire_bytes: bytes) -> int:
        """Packed wire records in; returns the records accepted (held
        counts as accepted; rejects show up in `counters`)."""
        n = len(wire_bytes) // REC_SIZE
        self._used = True
        return _lib().ag_ing_push(self._h, wire_bytes, n)

    def push_async(self, wire_bytes: bytes) -> int:
        """Queue packed records for the C++ worker thread, which parses
        and malformed-screens them while the caller goes on (drives the
        device step, packs the next batch).  Returns the records queued;
        `build_phases` and `flush` synchronize, so a tick's result is
        `push`'s."""
        n = len(wire_bytes) // REC_SIZE
        self._used = True
        return _lib().ag_ing_push_async(self._h, wire_bytes, n)

    def flush(self) -> None:
        """Block until every queued async buffer is parsed into the
        pending set (`build_phases` implies it)."""
        _lib().ag_ing_flush(self._h)

    @property
    def async_depth(self) -> int:
        """Records queued or mid-parse on the worker thread."""
        return int(_lib().ag_ing_async_depth(self._h))

    def set_validators(self, pubkeys: Optional[np.ndarray] = None,
                       powers: Optional[np.ndarray] = None) -> None:
        """Validator-set epoch at a height boundary (right after the
        sync_device that advanced heights): swap the pubkey table (key
        rotation, signed loops only) and/or the voting powers.  A power
        of 0 models removal; None leaves a table unchanged."""
        self.flush()                     # no worker batch mid-parse
        pk = None
        if pubkeys is not None:
            if not self.signed:
                raise ValueError(
                    "pubkey upload on an unsigned loop (verification "
                    "policy is construction-time)")
            pubkeys = np.ascontiguousarray(pubkeys, np.uint8)
            if pubkeys.shape != (self.V, 32):
                raise ValueError(
                    f"pubkeys must be [{self.V}, 32], got {pubkeys.shape}")
            pk = pubkeys.tobytes()
        pw = None
        if powers is not None:
            pw = np.ascontiguousarray(powers, np.int64)
            if pw.shape != (self.V,):
                raise ValueError(
                    f"powers must be [{self.V}], got {pw.shape}")
            self._powers = pw
        self._used = True
        rc = _lib().ag_ing_set_validators(
            self._h, pk, pw.ctypes.data if pw is not None else None)
        if rc < 0:
            raise ValueError("set_validators rejected by the native loop")

    def build_phases(self) -> List[Tuple[VotePhase, int]]:
        """Stage -> (one batched verify on the loop's device if signed)
        -> verdict filter and emit.  Returns [(phase, n_votes)] like
        `VoteBatcher.build_phases`, the phases' tensors on the loop's
        device, copied out of the C++ double buffer."""
        n, inputs = self._stage()
        ok = self._verify(*inputs) if inputs is not None else None
        return self._phases(self._apply_and_emit(n, ok))

    def _host_buffer(self, shape) -> torch.Tensor:
        """An int32 host tensor the C side fills in place: pinned when
        the loop's device is a GPU, so its upload is one non-blocking copy."""
        return torch.empty(shape, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A `_host_buffer` tensor -> the loop's device (a non-blocking
        copy from pinned memory on the card; the CPU tensor itself
        otherwise)."""
        if self.device.type == "cpu":
            return t
        return t.to(self.device, non_blocking=True)

    def _copy_out(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of host tensor `t` on the loop's device that no longer
        reads `t` when this returns (a pinned copy, then a non-blocking
        upload, on the card)."""
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self):
        """Snapshot the pending votes (window and height screens run
        here) and, on a signed loop, have C++ fill their verify inputs:
        (n, (pub [n, 32], sig [n, 64], blocks [n, 32]) host int32
        tensors, or None)."""
        L = _lib()
        self._used = True
        n = L.ag_ing_stage(self._h)
        if n == 0 or not self.signed:
            return n, None
        pub = self._host_buffer((n, 32))
        sig = self._host_buffer((n, 64))
        blocks = self._host_buffer((n, 32))   # uint32 words' bits
        L.ag_ing_fill_verify_inputs(self._h, pub.data_ptr(),
                                    sig.data_ptr(), blocks.data_ptr())
        return n, (pub, sig, blocks)

    def _verify(self, pub, sig, blocks) -> np.ndarray:
        """Upload the verify inputs and run the batched verify on the
        loop's device: [n] uint8 verdicts on the host."""
        from agnes_tpu_torch.crypto.ed25519 import verify_batch

        n = pub.shape[0]
        good = verify_batch(self._to_device(pub), self._to_device(sig),
                            self._to_device(blocks).reshape(n, 1, 32))
        return good.cpu().numpy().astype(np.uint8)

    def _apply_and_emit(self, n: int, ok: Optional[np.ndarray]) -> int:
        """Hand the verdicts (None: unsigned) to C++, which drops failed
        lanes, routes past rounds to the host tally, dedups, layers,
        interns and scatters into the next buffer set.  Returns the
        phase count."""
        L = _lib()
        if n:
            rc = L.ag_ing_apply_verdicts(
                self._h, ok.tobytes() if ok is not None else None)
            if rc < 0:      # not an assert: must survive python -O
                raise RuntimeError(
                    "ag_ing_apply_verdicts rejected the tick (a signed "
                    "loop requires verdicts)")
        return L.ag_ing_emit(self._h)

    def _phases(self, n_phases: int) -> List[Tuple[VotePhase, int]]:
        """The emitted buffer set's phases as VotePhases on the loop's
        device: one copy of each C++ view (see the module docstring)."""
        L = _lib()
        c = ctypes
        dev = self.device
        hts = self._copy_out(torch.from_numpy(getattr(
            self, "_heights", np.zeros(self.I, np.int64)).astype(np.int32)))
        out: List[Tuple[VotePhase, int]] = []
        for k in range(n_phases):
            rnd, typ = c.c_int32(), c.c_int32()
            nv = c.c_int64()
            slots_p = c.POINTER(c.c_int32)()
            mask_p = c.POINTER(c.c_uint8)()
            L.ag_ing_phase(self._h, k, c.byref(rnd), c.byref(typ),
                           c.byref(nv), c.byref(slots_p), c.byref(mask_p))
            slots, mask = (self._copy_out(torch.from_numpy(
                np.ctypeslib.as_array(p, shape=(self.I, self.V))))
                for p in (slots_p, mask_p))
            out.append((VotePhase(
                round=torch.full((self.I,), int(rnd.value), dtype=I32,
                                 device=dev),
                typ=torch.full((self.I,), int(typ.value), dtype=I32,
                               device=dev),
                slots=slots, mask=mask.view(torch.bool),
                height=hts), int(nv.value)))
        return out

    # -- host fallback / evidence / introspection ----------------------------

    def drain_host_events(self) -> List[Tuple[int, int, int, int]]:
        """[(instance, height, round, value_id)] late precommit-value
        quorums detected by the host fallback tally."""
        buf = np.empty((64, 4), np.int64)
        out: List[Tuple[int, int, int, int]] = []
        while True:
            n = _lib().ag_ing_drain_events(self._h, buf.ctypes.data, 64)
            out.extend(tuple(int(x) for x in row) for row in buf[:n])
            if n < 64:
                return out

    def decode_slot(self, instance: int, slot: int) -> Optional[int]:
        """Device slot -> value id (for reading decisions back)."""
        v = _lib().ag_ing_decode_slot(self._h, instance, slot)
        return None if v < 0 else int(v)

    def signed_evidence(self, instance: int, validator: int
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Two conflicting signed wire records ([96] uint8 each) by
        `validator` in `instance`, or None: the slashable proof behind a
        device equivocation flag.  The log holds verified votes only."""
        buf = ctypes.create_string_buffer(2 * REC_SIZE)
        if not _lib().ag_ing_evidence(self._h, instance, validator, buf):
            return None
        raw = np.frombuffer(buf.raw, np.uint8)
        return raw[:REC_SIZE].copy(), raw[REC_SIZE:].copy()

    def clear_log(self) -> None:
        """Drop the retained evidence records.  The C++ log keeps no
        pubkey table beside its records (they are verified before they
        are logged), so there is no second table to clear, unlike
        `VoteBatcher.clear_log`."""
        self._used = True
        _lib().ag_ing_clear_log(self._h)

    # -- snapshot surface (utils.checkpoint.save/load_native_loop) ----------

    def export_state(self) -> dict:
        """The durable state a crash must not lose: slot maps (decision
        decode), the verified-vote log (slashing evidence), counters and
        the synced window.  In-flight votes are not exported (a
        restarted node re-receives them from peers)."""
        L = _lib()
        slots = np.empty(self.I * self._n_slots, np.int64)
        L.ag_ing_export_slots(self._h, slots.ctypes.data)
        n = L.ag_ing_log_size(self._h)
        log = np.empty((n, REC_SIZE), np.uint8)
        if n:
            L.ag_ing_export_log(self._h, log.ctypes.data)
        c = self.counters
        return {
            "slots": slots.reshape(self.I, self._n_slots),
            "log": log,
            "counters": np.asarray(
                [c["rejected_malformed"], c["dropped_stale_height"],
                 c["rejected_signature"], c["overflow_votes"],
                 c["dropped_held_overflow"]], np.int64),
            "heights": getattr(self, "_heights",
                               np.zeros(self.I, np.int64)),
            "base_round": getattr(self, "_base_round",
                                  np.zeros(self.I, np.int64)),
        }

    def import_state(self, st: dict) -> None:
        """Restore `export_state`'s leaves into this loop, which must be
        fresh: merging into live state would mix pre-restore votes and
        evidence with the snapshot's.  Every leaf is screened before
        anything changes, so a refused snapshot leaves the loop as it
        was."""
        L = _lib()
        if self._used:
            raise RuntimeError(
                "import_state: loop has already been used (push/sync/"
                "build); snapshots restore only into a fresh loop")
        slots = np.ascontiguousarray(st["slots"], np.int64)
        if slots.shape != (self.I, self._n_slots):
            raise ValueError(f"slots must be [{self.I}, {self._n_slots}]")
        log = np.ascontiguousarray(st["log"], np.uint8)
        if log.ndim != 2 or log.shape[1] != REC_SIZE:
            # the C side reads n*96 bytes blind
            raise ValueError(f"log must be [n, {REC_SIZE}]: {log.shape}")
        cnt = np.ascontiguousarray(st["counters"], np.int64)
        if cnt.shape != (5,):
            raise ValueError("counters must be [5]")
        base = np.ascontiguousarray(st["base_round"], np.int64)
        hts = np.ascontiguousarray(st["heights"], np.int64)
        if base.shape != (self.I,) or hts.shape != (self.I,):
            # sync_device's own screen would fire only after the log
            # import below: check here to keep a refusal side-effect-free
            raise ValueError(f"base_round/heights must be [{self.I}]")
        if len(log):
            # the C side screens record content in two passes (a corrupt
            # snapshot commits nothing)
            dropped = L.ag_ing_import_log(self._h, log.tobytes(),
                                          len(log))
            if dropped:
                # > 0: records failed the malformed screen; -1: the C
                # side's fresh-only refusal (for direct ABI users)
                raise RuntimeError(
                    f"snapshot log rejected (code {dropped}): corrupt "
                    "records or non-fresh loop; nothing was imported")
        self.sync_device(base, hts)
        L.ag_ing_import_slots(self._h, slots.ctypes.data)
        L.ag_ing_restore_counters(self._h, cnt.ctypes.data)

    @property
    def counters(self) -> dict:
        buf = np.empty(7, np.int64)
        _lib().ag_ing_counters(self._h, buf.ctypes.data)
        return {"rejected_malformed": int(buf[0]),
                "dropped_stale_height": int(buf[1]),
                "rejected_signature": int(buf[2]),
                "overflow_votes": int(buf[3]),
                "held": int(buf[4]),
                "log": int(buf[5]),
                "dropped_held_overflow": int(buf[6])}
