"""NativeAdmissionQueue and NativeAdmissionShards: the C++ admission front
end (twin of `agnes_tpu.serve.native_admission`).

Drop-in twins of `serve.queue.AdmissionQueue` with the per-record hot
path — wire parse, malformed/fairness/capacity screens, overload policy,
the dedup cache's SHA-256 digests, densify-to-columns — behind ONE
ctypes call per submit and per drain, over the port's own C++ copy
(`core/native/admission*.cpp`, built with g++ by `core/native_build.py`;
a failed build raises).  ctypes releases the GIL for every foreign call,
so the threaded host's submit thread spends its time in native code
instead of serializing producers behind the interpreter.

What stays in Python: the VerifiedCache itself (the native side computes
the digests, the wrapper does one vectorized `lookup` per submit, so
hit/miss counts match the Python queue per record); the BLS share
decode (`bls_screen` runs the class-bucket header screens natively for
`BlsClassTable.fold`; the on-curve check stays with the oracle); and
everything downstream — `drain` returns the Python queue's
`WireColumns`.

The phase drain: when the pipeline wires a `phase_state` hook
(`ServePipeline.native_phase_state`) and it yields a PhaseBuildState,
the same single drain call also fills the signed step's phase planes and
lane arrays for eligible rows (core/native/admission_phases.cpp) into
host tensors it allocates per drain — pinned when the pipeline serves a
card — and the batch carries them as a `NativePhases` bundle that
`ServePipeline.stage` adopts without `add_arrays` or
`build_phases_device`.

Thread safety: the native handle holds its own mutexes, so submit and
drain may race; the class attribute `native = True` tells
ThreadedVoteService to elide its Python admission lock around both.
Where the native queue and serve/queue.py could disagree, serve/queue.py
is the specification (tests/test_torch_native_admission.py).
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Optional

import numpy as np
import torch

from agnes_tpu_torch.bridge.native_ingest import REC_SIZE, unpack_wire_votes
from agnes_tpu_torch.core.native_build import lib as _build_lib
from agnes_tpu_torch.serve.queue import (
    DROP_OLDEST,
    REJECT_NEWEST,
    AdmitResult,
    NativePhases,
    WireColumns,
)

_configured = False


def _lib() -> ctypes.CDLL:
    """The native library with the admission C ABI declared (built on
    first use; a failed build raises)."""
    global _configured
    L = _build_lib()
    if not _configured:
        c = ctypes
        L.ag_adm_new.restype = c.c_void_p
        L.ag_adm_new.argtypes = [c.c_int64, c.c_int64, c.c_int64,
                                 c.c_int32, c.c_int32]
        L.ag_adm_free.argtypes = [c.c_void_p]
        L.ag_adm_submit.restype = c.c_int64
        L.ag_adm_submit.argtypes = [c.c_void_p, c.c_char_p, c.c_int64,
                                    c.c_void_p, c.c_void_p]
        L.ag_adm_set_chunk_ts.argtypes = [c.c_void_p, c.c_int64,
                                          c.c_double]
        L.ag_adm_mark_verified.argtypes = [c.c_void_p, c.c_int64,
                                           c.c_char_p, c.c_int64]
        L.ag_adm_depth.restype = c.c_int64
        L.ag_adm_depth.argtypes = [c.c_void_p]
        L.ag_adm_instance_depth.restype = c.c_int64
        L.ag_adm_instance_depth.argtypes = [c.c_void_p, c.c_int64]
        L.ag_adm_oldest_ts.restype = c.c_double
        L.ag_adm_oldest_ts.argtypes = [c.c_void_p]
        L.ag_adm_counters.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_adm_add_counters.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_adm_drain.restype = c.c_int64
        L.ag_adm_drain.argtypes = [c.c_void_p, c.c_int64] + \
            [c.c_void_p] * 10
        L.ag_adm_export.restype = c.c_int64
        L.ag_adm_export.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                    c.c_int64]
        L.ag_adm_bls_screen.restype = c.c_int64
        L.ag_adm_bls_screen.argtypes = [c.c_char_p, c.c_int64,
                                        c.c_int64, c.c_int64,
                                        c.c_void_p, c.c_void_p,
                                        c.c_void_p]
        # the phase drain: handle, n, 10 column pointers, the
        # PhaseBuildState scalars and pointers, 13 phase/lane outputs
        phase_args = ([c.c_void_p, c.c_int64] + [c.c_void_p] * 10
                      + [c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p,
                         c.c_int64, c.c_int64, c.c_void_p, c.c_int64,
                         c.c_int64, c.c_int64, c.c_int64]
                      + [c.c_void_p] * 13)
        L.ag_adm_drain_phases.restype = c.c_int64
        L.ag_adm_drain_phases.argtypes = phase_args
        # the shard group: the ag_adm_* entries under ag_adms_
        L.ag_adms_new.restype = c.c_void_p
        L.ag_adms_new.argtypes = [c.c_int64, c.c_int64, c.c_int64,
                                  c.c_int64, c.c_int32, c.c_int32]
        L.ag_adms_free.argtypes = [c.c_void_p]
        L.ag_adms_submit.restype = c.c_int64
        L.ag_adms_submit.argtypes = [c.c_void_p, c.c_char_p, c.c_int64,
                                     c.c_void_p, c.c_void_p]
        L.ag_adms_set_chunk_ts.argtypes = [c.c_void_p, c.c_int64,
                                           c.c_double]
        L.ag_adms_mark_verified.argtypes = [c.c_void_p, c.c_int64,
                                            c.c_char_p, c.c_int64]
        L.ag_adms_depth.restype = c.c_int64
        L.ag_adms_depth.argtypes = [c.c_void_p]
        L.ag_adms_shard_depth.restype = c.c_int64
        L.ag_adms_shard_depth.argtypes = [c.c_void_p, c.c_int64]
        L.ag_adms_instance_depth.restype = c.c_int64
        L.ag_adms_instance_depth.argtypes = [c.c_void_p, c.c_int64]
        L.ag_adms_oldest_ts.restype = c.c_double
        L.ag_adms_oldest_ts.argtypes = [c.c_void_p]
        L.ag_adms_counters.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_adms_shard_counters.argtypes = [c.c_void_p, c.c_int64,
                                             c.c_void_p]
        L.ag_adms_add_counters.argtypes = [c.c_void_p, c.c_void_p]
        L.ag_adms_drain.restype = c.c_int64
        L.ag_adms_drain.argtypes = [c.c_void_p, c.c_int64] + \
            [c.c_void_p] * 10
        L.ag_adms_drain_phases.restype = c.c_int64
        L.ag_adms_drain_phases.argtypes = phase_args
        L.ag_adms_export.restype = c.c_int64
        L.ag_adms_export.argtypes = [c.c_void_p, c.c_void_p,
                                     c.c_void_p, c.c_int64]
        _configured = True
    return L


def bls_screen(wire_bytes, n_instances: int, n_validators: int,
               pop_ok: np.ndarray, quarantined: np.ndarray
               ) -> np.ndarray:
    """Native BLS class-bucket header screen: per whole record the code
    of the first failing screen (0 ok, 1 malformed, 2 unknown validator,
    3 PoP missing, 4 quarantined) in BlsClassTable.fold's order.  The
    trailing partial record stays with the caller."""
    from agnes_tpu_torch.serve.bls_lane import BLS_REC_SIZE

    raw = bytes(wire_bytes)
    n = len(raw) // BLS_REC_SIZE
    codes = np.empty(max(n, 1), np.uint8)
    pop = np.ascontiguousarray(pop_ok, np.uint8)
    quar = np.ascontiguousarray(quarantined, np.uint8)
    if pop.shape != (int(n_validators),) or quar.shape != pop.shape:
        raise ValueError(
            f"pop_ok/quarantined must be [{n_validators}]: "
            f"{pop.shape}/{quar.shape}")
    got = _lib().ag_adm_bls_screen(
        raw, len(raw), int(n_instances), int(n_validators),
        pop.ctypes.data, quar.ctypes.data, codes.ctypes.data)
    return codes[:got]


def _counters(buf: np.ndarray) -> dict:
    return {"submitted": int(buf[0]), "admitted": int(buf[1]),
            "rejected_overflow": int(buf[2]),
            "rejected_fairness": int(buf[3]),
            "rejected_malformed": int(buf[4]),
            "evicted": int(buf[5]), "drained": int(buf[6])}


def _native_drain(q, drain_fn, phases_fn, max_records):
    """The drain body of both native queues (`q` supplies _h / I /
    cache / _clock and the histogram and hook attributes; the fns are
    the handle's C entries).

    Pops up to `max_records` oldest records into the WireColumns arrays
    in one GIL-releasing call (None when empty), sized from the call's
    return value: the queue may shrink between the depth read and the
    call under concurrent drains.  With a `phase_state` hook yielding a
    PhaseBuildState, the same call also fills the phase planes and lane
    arrays when the rows are device-verify eligible, and the batch
    carries them as NativePhases; ineligible rows fill only the plain
    columns, and the Python path owns every screen and split.

    The wait histogram keeps the Python queue's chunk granularity: the
    records of one submit share one admission instant, so the runs of
    the ts column are the chunks."""
    n = q.depth
    if n == 0:
        return None
    if max_records is not None:
        n = min(n, int(max_records))
        if n <= 0:
            return None
    st = None
    if phases_fn is not None and q.phase_state is not None:
        st = q.phase_state()
        if st is not None and n > int(st.max_votes):
            st = None      # the batcher would split this batch: Python
    inst = np.empty(n, np.int64)
    val = np.empty(n, np.int64)
    hts = np.empty(n, np.int64)
    rnd = np.empty(n, np.int64)
    typ = np.empty(n, np.int64)
    value = np.empty(n, np.int64)
    sigs = np.empty((n, 64), np.uint8)
    ver = np.empty(n, np.uint8)
    dig = np.empty((n, 32), np.uint8) if q.cache is not None else None
    ts = np.empty(n, np.float64)
    cols = (inst.ctypes.data, val.ctypes.data, hts.ctypes.data,
            rnd.ctypes.data, typ.ctypes.data, value.ctypes.data,
            sigs.ctypes.data, ver.ctypes.data,
            dig.ctypes.data if dig is not None else None,
            ts.ctypes.data)
    ph = None
    t0 = time.perf_counter()
    if st is None:
        got = int(drain_fn(q._h, n, *cols))
    else:
        I = q.I
        S = int(st.slot_lut.shape[1])
        V = int(st.n_validators)
        pad_cap = max(n, int(st.lane_floor))

        def host(shape, dtype):
            # a fresh tensor a drain: no upload from an earlier drain's
            # buffer can still be in flight when the C side writes here
            return torch.empty(shape, dtype=dtype,
                               pin_memory=bool(st.pin_memory))

        ph_slots = host((2, I, V), torch.int32)
        ph_mask = host((2, I, V), torch.bool)
        ph_typ = np.empty(2, np.int64)
        ph_counts = np.empty(2, np.int64)
        l_pub = host((pad_cap, 32), torch.int32)
        l_sig = host((pad_cap, 64), torch.int32)
        l_blocks = host((pad_cap, 32), torch.int32)   # uint32 words' bits
        l_pidx = host((pad_cap,), torch.int32)
        l_inst = host((pad_cap,), torch.int32)
        l_val = host((pad_cap,), torch.int32)
        l_real = host((pad_cap,), torch.bool)
        l_rows = np.empty(n, np.int64)
        meta = np.zeros(5, np.int64)
        win_h = np.ascontiguousarray(st.heights, np.int64)
        win_b = np.ascontiguousarray(st.base_round, np.int64)
        lut = np.ascontiguousarray(st.slot_lut, np.int64)
        pk = np.ascontiguousarray(st.pubkeys, np.uint8)
        got = int(phases_fn(
            q._h, n, *cols, win_h.ctypes.data, win_b.ctypes.data,
            int(st.window), lut.ctypes.data, S, V, pk.ctypes.data,
            int(st.lane_floor), int(st.max_votes),
            int(st.phase_offset), pad_cap, ph_slots.data_ptr(),
            ph_mask.data_ptr(), ph_typ.ctypes.data,
            ph_counts.ctypes.data, l_pub.data_ptr(), l_sig.data_ptr(),
            l_blocks.data_ptr(), l_pidx.data_ptr(), l_inst.data_ptr(),
            l_val.data_ptr(), l_real.data_ptr(), l_rows.ctypes.data,
            meta.ctypes.data))
        if meta[0] == 1:
            n_ph, n_ln, n_pad = int(meta[1]), int(meta[2]), int(meta[3])
            ph = NativePhases(
                n_phases=n_ph, n_lanes=n_ln, n_pad=n_pad,
                round_=int(meta[4]), typ=ph_typ[:n_ph],
                counts=ph_counts[:n_ph], slots=ph_slots[:n_ph],
                mask=ph_mask[:n_ph], pub=l_pub[:n_pad],
                sig=l_sig[:n_pad],
                blocks=l_blocks[:n_pad].reshape(n_pad, 1, 32),
                phase_idx=l_pidx[:n_pad], inst=l_inst[:n_pad],
                val=l_val[:n_pad], real=l_real[:n_pad],
                lane_rows=l_rows[:n_ln], heights=win_h,
                base_round=win_b, slot_lut=lut)
            q.phase_fill += 1
        else:
            q.phase_bail += 1
    wall = time.perf_counter() - t0
    # rows past `got` are uninitialized and must never reach the batcher
    if got == 0:
        return None
    if got < n:
        n = got
        inst, val, hts, rnd, typ, value, ts = (
            a[:n] for a in (inst, val, hts, rnd, typ, value, ts))
        sigs, ver = sigs[:n], ver[:n]
        if dig is not None:
            dig = dig[:n]
    if q.drain_hist is not None:
        q.drain_hist.record(wall, n)
    if ph is not None and q.densify_hist is not None:
        q.densify_hist.record(wall, n)
    # a record popped between a lock-free submit and its set_chunk_ts
    # stamp carries NaN: count it as admitted now (never taken
    # single-threaded, so the fake-clock parity of the tests holds)
    nan = np.isnan(ts)
    if nan.any():
        ts[nan] = q._clock()
    if q.wait_hist is not None:
        # one clock read, only with a histogram attached (the Python
        # queue's clock discipline)
        now = q._clock()
        edges = np.flatnonzero(np.diff(ts)) + 1
        starts = np.concatenate(([0], edges))
        ends = np.concatenate((edges, [n]))
        for s, e in zip(starts, ends):
            q.wait_hist.record(now - ts[s].item(), int(e - s))
    return WireColumns(inst, val, hts, rnd, typ, value, sigs,
                       ver.astype(bool), digest=dig,
                       t_first=ts.min().item(), native_phases=ph)


def _check_dims(capacity, policy, n_instances, instance_cap):
    """AdmissionQueue.__init__'s validation and default fairness cap."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive: {capacity}")
    if policy not in (REJECT_NEWEST, DROP_OLDEST):
        raise ValueError(f"unknown overload policy: {policy}")
    cap = (int(instance_cap) if instance_cap is not None
           else max(1, (2 * int(capacity)) // int(n_instances)))
    if cap <= 0:
        raise ValueError(f"instance_cap must be positive: {instance_cap}")
    return cap


class _NativeBase:
    """What the single queue and the shard group share: the Python
    queue's attributes, the frozen digest flag, and submit / drain /
    introspection over the handle's C entries (`_fn(name)`)."""

    #: the threaded host's lock-elision marker: the handle synchronizes
    #: itself, so no Python lock is held across its GIL-releasing calls
    native = True
    _prefix = "ag_adm_"

    def _init_common(self, capacity, policy, cache, bls_table, clock):
        self.capacity = int(capacity)
        self.policy = policy
        # the native handle freezes its digest flag at construction
        self._digests = cache is not None
        self._cache = cache
        self.bls_table = bls_table
        self.wait_hist = None        # .record(seconds, n) sinks the
        self.drain_hist = None       # service wires in
        self.densify_hist = None
        #: ServePipeline.native_phase_state, wired by the service
        self.phase_state = None
        self.phase_fill = 0          # phase drains filled / bailed
        self.phase_bail = 0
        self._clock = clock

    def _fn(self, name: str):
        return getattr(_lib(), self._prefix + name)

    def __del__(self):
        if getattr(self, "_h", None):
            self._free(self._h)
            self._h = None

    @property
    def cache(self):
        return self._cache

    @cache.setter
    def cache(self, value) -> None:
        # attaching a cache to a digest-less handle would hand
        # cache.lookup uninitialized digest bytes: refuse
        if value is not None and not self._digests:
            raise ValueError(
                f"{type(self).__name__} cannot attach a dedup cache "
                f"after construction: the native handle was created "
                f"without digest computation (pass cache= to __init__)")
        self._cache = value

    # -- admission -----------------------------------------------------------

    def submit(self, wire_bytes) -> AdmitResult:
        """Admit packed wire records: parse, screens, fairness, policy
        and digests in one GIL-releasing call, then (cache attached) one
        vectorized lookup and one native mark-back.  Counts equal
        AdmissionQueue.submit's."""
        raw = wire_bytes if isinstance(wire_bytes, bytes) \
            else bytes(wire_bytes)
        n_whole = len(raw) // REC_SIZE
        counts = np.zeros(5, np.int64)
        # one read of the cache: submit runs lock-free on the threaded
        # host while the setter allows a detach
        cache = self.cache
        dig = (np.empty((n_whole, 32), np.uint8)
               if cache is not None and n_whole else None)
        seq = self._fn("submit")(
            self._h, raw, len(raw), counts.ctypes.data,
            dig.ctypes.data if dig is not None else None)
        accepted = int(counts[0])
        if accepted:
            # one clock read per accepted submit, after admission: the
            # Python queue's discipline
            self._fn("set_chunk_ts")(self._h, seq, self._clock())
        pre_verified = 0
        if cache is not None and accepted:
            ver = cache.lookup(dig[:accepted])
            pre_verified = int(ver.sum())
            if pre_verified or self._always_mark:
                self._fn("mark_verified")(
                    self._h, seq,
                    np.ascontiguousarray(ver, np.uint8).tobytes(),
                    accepted)
        return AdmitResult(accepted, int(counts[1]), int(counts[2]),
                           int(counts[3]), int(counts[4]), pre_verified)

    def submit_bls(self, wire_bytes) -> AdmitResult:
        """Fold BLS wire shares through the class table (its header
        screens native when `native_screen` is set); the reject taxonomy
        lands on this queue's counters as in AdmissionQueue.submit_bls."""
        if self.bls_table is None:
            raise ValueError(
                "submit_bls on a queue without a bls_table (pass "
                "BlsClassTable/BlsLane at construction)")
        res = self.bls_table.fold(wire_bytes)
        fairness = (res["pop_missing"] + res["unknown_validator"]
                    + res["duplicate"] + res["quarantined"])
        deltas = np.asarray(
            [res["folded"] + fairness + res["malformed"]
             + res["overflow"],
             res["folded"], res["overflow"], fairness,
             res["malformed"]], np.int64)
        self._fn("add_counters")(self._h, deltas.ctypes.data)
        return AdmitResult(res["folded"], res["overflow"], fairness,
                           res["malformed"], 0)

    # -- introspection -------------------------------------------------------

    @property
    def depth(self) -> int:
        return int(self._fn("depth")(self._h))

    @property
    def oldest_ts(self) -> Optional[float]:
        """Admission instant of the oldest stamped queued record; None
        when empty or when nothing queued is stamped yet."""
        v = self._fn("oldest_ts")(self._h)
        return None if math.isnan(v) else v

    def instance_depth(self, instance: int) -> int:
        return int(self._fn("instance_depth")(self._h, int(instance)))

    @property
    def counters(self) -> dict:
        buf = np.empty(7, np.int64)
        self._fn("counters")(self._h, buf.ctypes.data)
        return _counters(buf)

    def native_snapshot(self) -> dict:
        """The drain report's native-admission section."""
        out = self.counters
        out["depth"] = self.depth
        out["phase_fill"] = self.phase_fill
        out["phase_bail"] = self.phase_bail
        return out

    def mc_canonical(self) -> tuple:
        """AdmissionQueue.mc_canonical's row format, rebuilt from the
        native FIFO export (the queue-content differential)."""
        n = self.depth
        raw = np.empty((max(n, 1), REC_SIZE), np.uint8)
        ver = np.empty(max(n, 1), np.uint8)
        # cap = the buffers' size: a concurrent submit may have grown
        # the queue since the depth read; the C side clamps
        n = int(self._fn("export")(self._h, raw.ctypes.data,
                                   ver.ctypes.data, n))
        inst, val, hts, rnd, typ, value, _ = unpack_wire_votes(
            raw[:n].tobytes())
        rows = [(int(inst[j]), int(val[j]), int(hts[j]), int(rnd[j]),
                 int(typ[j]), int(value[j]), int(ver[j]))
                for j in range(n)]
        return (tuple(rows), n)

    def drain(self, max_records: Optional[int] = None
              ) -> Optional[WireColumns]:
        """Pop up to `max_records` oldest records in one GIL-releasing
        call: WireColumns, with a NativePhases build when the pipeline
        wired a phase_state hook and the rows are eligible."""
        return _native_drain(self, self._fn("drain"),
                             self._fn("drain_phases"), max_records)


class NativeAdmissionQueue(_NativeBase):
    """C++-backed FIFO of admitted wire records with AdmissionQueue's
    interface (module docstring)."""

    _always_mark = False     # mark back only submits with cache hits

    def __init__(self, n_instances: int, capacity: int,
                 instance_cap: Optional[int] = None,
                 policy: str = REJECT_NEWEST,
                 cache=None,
                 bls_table=None,
                 clock=time.monotonic):
        self.instance_cap = _check_dims(capacity, policy, n_instances,
                                        instance_cap)
        self.I = int(n_instances)
        self._init_common(capacity, policy, cache, bls_table, clock)
        L = _lib()
        self._h = L.ag_adm_new(
            self.I, self.capacity, self.instance_cap,
            0 if policy == REJECT_NEWEST else 1,
            1 if cache is not None else 0)
        if not self._h:
            # the C side fails closed (NULL) on hostile dimensions
            raise ValueError(
                f"invalid admission dimensions: I={n_instances} "
                f"capacity={capacity} instance_cap={instance_cap}")
        self._free = L.ag_adm_free   # bound now: module globals are gone
        #                              at interpreter shutdown


class NativeAdmissionShards(_NativeBase):
    """N C++ admission shards behind the NativeAdmissionQueue interface:
    one handle (and mutex) per shard, shard s owning instances [s*L,
    (s+1)*L) with L = I / n_shards, one submit fan-in routing each record
    by instance, and a k-way merged drain in global (seq, sub_idx) order
    — the single queue's stream whenever the accept decisions agree.

    Fairness is exact at any shard count (the partition key is the
    fairness key); capacity splits evenly (capacity / n_shards a shard),
    so overflow near the ceiling can differ from a single queue on a
    skewed instance mix.  Needs I % n_shards == 0 and capacity %
    n_shards == 0.  With a cache attached, every accepted submit is
    marked back (hits or not): the native side keeps a per-submit route
    that the mark consumes."""

    _prefix = "ag_adms_"
    _always_mark = True

    def __init__(self, n_instances: int, capacity: int,
                 instance_cap: Optional[int] = None,
                 policy: str = REJECT_NEWEST,
                 cache=None,
                 bls_table=None,
                 clock=time.monotonic,
                 n_shards: int = 1):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        self.n_shards = int(n_shards)
        self.I = int(n_instances)
        if self.n_shards <= 0:
            raise ValueError(f"n_shards must be positive: {n_shards}")
        if self.I % self.n_shards != 0:
            raise ValueError(
                f"n_instances={n_instances} not divisible by "
                f"n_shards={n_shards} (equal instance ranges)")
        if int(capacity) % self.n_shards != 0:
            raise ValueError(
                f"capacity={capacity} not divisible by "
                f"n_shards={n_shards}: the per-shard ceiling must be "
                f"an integer")
        self.L = self.I // self.n_shards
        self.instance_cap = _check_dims(capacity, policy, n_instances,
                                        instance_cap)
        self._init_common(capacity, policy, cache, bls_table, clock)
        L = _lib()
        self._h = L.ag_adms_new(
            self.n_shards, self.I, self.capacity, self.instance_cap,
            0 if policy == REJECT_NEWEST else 1,
            1 if cache is not None else 0)
        if not self._h:
            raise ValueError(
                f"invalid admission dimensions: I={n_instances} "
                f"capacity={capacity} instance_cap={instance_cap} "
                f"n_shards={n_shards}")
        self._free = L.ag_adms_free

    def shard_depth(self, shard: int) -> int:
        return int(_lib().ag_adms_shard_depth(self._h, int(shard)))

    def shard_counters(self, shard: int) -> dict:
        buf = np.empty(7, np.int64)
        _lib().ag_adms_shard_counters(self._h, int(shard),
                                      buf.ctypes.data)
        return _counters(buf)

    def native_snapshot(self) -> dict:
        """The native-admission section with the per-shard breakdown."""
        out = super().native_snapshot()
        out["n_shards"] = self.n_shards
        out["shards"] = [dict(self.shard_counters(s),
                              depth=self.shard_depth(s))
                         for s in range(self.n_shards)]
        return out
