"""Port differential: the native admission front end
(`agnes_tpu_torch.serve.native_admission`, over the port's own C++ copy
`core/native/admission*.cpp`) on the CPU.

(a) the native SHA-256 (the dedup-cache key) == hashlib;
(b) the port's NativeAdmissionQueue == the JAX package's
    NativeAdmissionQueue (its C++ through its numpy wrapper) == the
    port's Python AdmissionQueue, the specification, on the same seeded
    hostile wire at I = 4: AdmitResults, counters, depth, oldest_ts,
    per-instance depth, `mc_canonical`, drained WireColumns and the
    wait histogram, under both overload policies, with and without a
    dedup cache, and the degenerate submits;
(c) NativeAdmissionShards == the single native queue (and the twin's
    shards) over shard counts {1, 2, 4} and both policies, its
    construction checks, and `oldest_ts` before a stamp;
(d) `bls_screen` codes == the twin's, and the fold with the native
    screen == without;
(e) the phase drain: NativePhases == the port's own
    `build_phases_device` on the same rows, leaf for leaf, at the exact
    lane count (a fresh value, an interned one, nil votes, a lane
    floor), and the drain bails wherever the Python build drops, splits
    or spills; the twin's drain agrees on the first n_lanes lanes where
    it fills, bails on a fresh value where the port fills, and, given
    the pre-sync slot table its pipeline passes, hands a value the slot
    the Python build would not;
(f) a signed port VoteService at I = 4 x V = 8 (validator 7 forged in
    both classes), native admission on against off and against
    `native_shards=2`: the same dispatch stream, decisions, state, tally
    and rejected lanes, with `native_phase_builds` == the heights;
(g) `adopt_native_phases` logs the batch and its key table together, so
    `signed_evidence` after `clear_log` sees no stale table.

The twin side runs only its C++ and numpy wrappers (no JAX service).
Every comparison is exact.
"""

import hashlib

import numpy as np
import pytest
import torch

from agnes_tpu.serve import native_admission as jna
from agnes_tpu.serve.cache import VerifiedCache as JCache
from agnes_tpu.serve.queue import PhaseBuildState as JPhaseBuildState
from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.bridge.native_ingest import REC_SIZE, pack_wire_votes
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.serve import ShapeLadder, VoteService
from agnes_tpu_torch.serve.bls_lane import (
    BlsClassTable,
    pack_bls_wire,
    unpack_bls_wire,
)
from agnes_tpu_torch.serve.cache import VerifiedCache
from agnes_tpu_torch.serve.native_admission import (
    NativeAdmissionQueue,
    NativeAdmissionShards,
    bls_screen,
)
from agnes_tpu_torch.serve.queue import AdmissionQueue, PhaseBuildState
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I = 4


def make_clock(step: float = 1.0):
    v = {"t": 0.0}

    def clock():
        v["t"] += step
        return v["t"]

    return clock


def rand_wire(rng, n, hostile=False):
    """Packed records; `hostile` mixes out-of-range instances, negative
    rounds and a truncated tail."""
    inst = rng.integers(0, I + (3 if hostile else 0), n)
    val = rng.integers(0, 8, n)
    h = rng.integers(0, 3, n)
    r = rng.integers(-2 if hostile else 0, 4, n)
    t = rng.integers(0, 2, n)
    v = rng.integers(-1, 9, n)
    sig = rng.integers(0, 256, (n, 64)).astype(np.uint8)
    w = pack_wire_votes(inst, val, h, r, t, v, sig)
    if hostile and n > 2:
        w = w + bytes(rng.integers(0, 256, int(rng.integers(1, 95))))
    return w


class _Hist:
    def __init__(self):
        self.recs = []

    def record(self, v, n=1):
        self.recs.append((round(float(v), 9), int(n)))


def _same_batch(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for k in range(9):                 # 8 columns + digest
        fa, fb = a[k], b[k]
        if fa is None or fb is None:
            assert fa is None and fb is None, k
        else:
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb),
                                          err_msg=str(k))
    assert a.t_first == b.t_first


def _queues(policy="reject_newest", capacity=20, instance_cap=7,
            cache=False):
    """(port Python, port native, twin native) over one geometry."""
    def cache_for(cls):
        return cls() if cache else None

    return (AdmissionQueue(I, capacity, instance_cap=instance_cap,
                           policy=policy, cache=cache_for(VerifiedCache),
                           clock=make_clock()),
            NativeAdmissionQueue(I, capacity, instance_cap=instance_cap,
                                 policy=policy,
                                 cache=cache_for(VerifiedCache),
                                 clock=make_clock()),
            jna.NativeAdmissionQueue(I, capacity,
                                     instance_cap=instance_cap,
                                     policy=policy,
                                     cache=cache_for(JCache),
                                     clock=make_clock()))


# -- (a) SHA-256 --------------------------------------------------------------

def test_native_sha256_matches_hashlib():
    rng = np.random.default_rng(7)
    wire = rand_wire(rng, 16)
    q = NativeAdmissionQueue(I, 64, cache=VerifiedCache())
    q.submit(wire)
    b = q.drain()
    want = [hashlib.sha256(wire[j * REC_SIZE:(j + 1) * REC_SIZE]).digest()
            for j in range(16)
            if int.from_bytes(wire[j * REC_SIZE:j * REC_SIZE + 4],
                              "little") < I]
    assert [bytes(d) for d in b.digest] == want


# -- (b) queue: port native == twin native == port Python ---------------------

@pytest.mark.parametrize("policy", ["reject_newest", "drop_oldest"])
@pytest.mark.parametrize("cache", [False, True])
def test_queue_matches_twin_and_python(policy, cache):
    rng = np.random.default_rng(3)
    qs = _queues(policy=policy, cache=cache)
    for q in qs:
        q.wait_hist = _Hist()
    seedw = None
    if cache:
        # the same known records in every cache: their re-delivery is a
        # pre-verified hit on every queue
        seedw = rand_wire(rng, 6)
        digs = np.stack([np.frombuffer(hashlib.sha256(
            seedw[k * REC_SIZE:(k + 1) * REC_SIZE]).digest(), np.uint8)
            for k in range(6)])
        for q in qs:
            q.cache.insert(digs, np.zeros(6, np.int64),
                           np.zeros(6, np.int64))
    for k in range(20):
        w = (seedw if seedw is not None and k % 5 == 4
             else rand_wire(rng, int(rng.integers(1, 14)),
                            hostile=(k % 2 == 0)))
        res = [tuple(q.submit(w)) for q in qs]
        assert res[0] == res[1] == res[2], (k, res)
        assert len({q.depth for q in qs}) == 1
        assert len({q.oldest_ts for q in qs}) == 1
        for i in range(I):
            assert len({q.instance_depth(i) for q in qs}) == 1, i
        if k % 4 == 3:
            take = int(rng.integers(1, 9))
            a, b, c = (q.drain(take) for q in qs)
            _same_batch(a, b)
            _same_batch(a, c)
        if k == 10:
            assert all(q.drain(0) is None and q.drain(-3) is None
                       for q in qs)
    assert qs[0].mc_canonical()[0] == qs[1].mc_canonical()[0] \
        == qs[2].mc_canonical()[0]
    while qs[0].depth:
        a, b, c = (q.drain(6) for q in qs)
        _same_batch(a, b)
        _same_batch(a, c)
    assert qs[1].drain() is None and qs[2].drain() is None
    assert qs[0].counters == qs[1].counters == qs[2].counters
    assert qs[0].wait_hist.recs == qs[1].wait_hist.recs \
        == qs[2].wait_hist.recs
    if cache:
        assert qs[0].cache.counters == qs[1].cache.counters
    c = qs[0].counters
    assert c["rejected_malformed"] and c["rejected_fairness"]
    assert c["admitted"] and c["drained"]


def test_degenerate_submits_eviction_and_nil_flag_parity():
    """Empty and pure-tail submits, one drop_oldest submit larger than
    capacity, and a non-canonical non-nil flag byte: the three queues
    agree record for record."""
    rng = np.random.default_rng(11)
    qs = _queues()
    for w in (b"", b"\x01\x02\x03", bytes(95)):
        assert len({tuple(q.submit(w)) for q in qs}) == 1
    assert all(q.drain() is None for q in qs[1:])
    w = bytearray(rand_wire(rng, 3))
    w[REC_SIZE + 21] = 2               # any nonzero flag byte: non-nil
    w[2 * REC_SIZE + 21] = 0           # nil
    w = bytes(w)
    assert len({tuple(q.submit(w)) for q in qs}) == 1
    a, b, c = (q.drain() for q in qs)
    _same_batch(a, b)
    _same_batch(a, c)
    assert a.value[2] == -1
    qs = _queues(policy="drop_oldest", capacity=6, instance_cap=100)
    small, big = rand_wire(rng, 3), rand_wire(rng, 10)
    for q in qs:
        q.submit(small)
        q.submit(big)
    assert qs[0].counters == qs[1].counters == qs[2].counters
    assert qs[0].counters["evicted"] > 0
    a, b, c = (q.drain() for q in qs)
    _same_batch(a, b)
    _same_batch(a, c)


def test_wrapper_validation():
    with pytest.raises(ValueError):
        NativeAdmissionQueue(I, 0)
    with pytest.raises(ValueError):
        NativeAdmissionQueue(I, 8, policy="nope")
    with pytest.raises(ValueError):
        NativeAdmissionQueue(I, 8, instance_cap=-1)
    q = NativeAdmissionQueue(I, 8)
    with pytest.raises(ValueError):
        q.submit_bls(b"")
    # the digest flag is frozen into the handle at construction
    with pytest.raises(ValueError, match="cannot attach"):
        q.cache = VerifiedCache()
    qc = NativeAdmissionQueue(I, 8, cache=VerifiedCache())
    qc.cache = None
    qc.cache = VerifiedCache()
    assert NativeAdmissionQueue.native and NativeAdmissionShards.native


# -- (c) shards ---------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("policy", ["reject_newest", "drop_oldest"])
def test_shards_match_single_queue(n_shards, policy):
    """Capacity 40 keeps every instance below the per-shard ceiling, so
    the admission decisions must agree exactly."""
    kw = dict(instance_cap=7, policy=policy)
    qa = NativeAdmissionQueue(I, 40, cache=VerifiedCache(),
                              clock=make_clock(), **kw)
    qb = NativeAdmissionShards(I, 40, cache=VerifiedCache(),
                               clock=make_clock(), n_shards=n_shards, **kw)
    qj = jna.NativeAdmissionShards(I, 40, cache=JCache(),
                                   clock=make_clock(), n_shards=n_shards,
                                   **kw)
    rng = np.random.default_rng(100 + n_shards)
    for k in range(40):
        w = rand_wire(rng, int(rng.integers(1, 6)), hostile=(k % 5 == 4))
        res = [tuple(q.submit(w)) for q in (qa, qb, qj)]
        assert res[0] == res[1] == res[2], (k, res)
        assert qa.depth == qb.depth and qa.oldest_ts == qb.oldest_ts
        for i in range(I):
            assert qa.instance_depth(i) == qb.instance_depth(i)
        if k % 4 == 3:
            a, b, c = (q.drain(5) for q in (qa, qb, qj))
            _same_batch(a, b)
            _same_batch(b, c)
    assert qa.mc_canonical() == qb.mc_canonical() == qj.mc_canonical()
    a, b, c = (q.drain() for q in (qa, qb, qj))
    _same_batch(a, b)
    _same_batch(b, c)
    assert qa.counters == qb.counters == qj.counters
    assert qa.cache.counters == qb.cache.counters
    assert [qb.shard_counters(s) for s in range(n_shards)] \
        == [qj.shard_counters(s) for s in range(n_shards)]
    agg = {k: 0 for k in qb.counters}
    for s in range(n_shards):
        for key, v in qb.shard_counters(s).items():
            agg[key] += v
    assert agg == qb.counters
    snap = qb.native_snapshot()
    assert snap["n_shards"] == n_shards and len(snap["shards"]) == n_shards


def test_shards_construction_and_oldest_ts_before_a_stamp():
    with pytest.raises(ValueError, match="not divisible"):
        NativeAdmissionShards(I, 40, n_shards=3)
    with pytest.raises(ValueError, match="not divisible"):
        NativeAdmissionShards(I, 42, n_shards=4)
    with pytest.raises(ValueError, match="n_shards"):
        NativeAdmissionShards(I, 40, n_shards=0)
    q = NativeAdmissionShards(I, 40, n_shards=2)
    with pytest.raises(ValueError, match="cannot attach"):
        q.cache = VerifiedCache()
    # admitted but not yet stamped (the raw C API: the wrapper stamps at
    # once): None, never NaN; one chunk across both shards
    from agnes_tpu_torch.serve import native_admission as na

    w = pack_wire_votes(np.array([0, 2]), np.arange(2),
                        np.zeros(2, np.int64), np.zeros(2, np.int64),
                        np.zeros(2, np.int64), np.zeros(2, np.int64),
                        np.zeros((2, 64), np.uint8))
    L = na._lib()
    counts = np.zeros(5, np.int64)
    sq = NativeAdmissionQueue(I, 40, clock=make_clock())
    seq = L.ag_adm_submit(sq._h, w, len(w), counts.ctypes.data, None)
    assert int(counts[0]) == 2 and sq.oldest_ts is None
    L.ag_adm_set_chunk_ts(sq._h, seq, 7.5)
    assert sq.oldest_ts == 7.5
    g = NativeAdmissionShards(I, 40, clock=make_clock(), n_shards=2)
    seq = L.ag_adms_submit(g._h, w, len(w), counts.ctypes.data, None)
    assert g.oldest_ts is None
    L.ag_adms_set_chunk_ts(g._h, seq, 9.25)
    assert g.oldest_ts == 9.25
    assert g.shard_depth(0) == 1 and g.shard_depth(1) == 1


# -- (d) BLS header screen ----------------------------------------------------

class _Reg:
    """Registry-shaped stub: the screen reads V, pop_ok, quarantined,
    powers only."""

    def __init__(self, V=6):
        self.V = V
        self.pop_ok = np.zeros(V, bool)
        self.pop_ok[:4] = True
        self.quarantined = np.zeros(V, bool)
        self.quarantined[2] = True
        self.powers = np.ones(V, np.int64)


def _bls_wire(rng, n, V, hostile=True):
    inst = rng.integers(0, I + (2 if hostile else 0), n)
    val = rng.integers(0, V + (2 if hostile else 0), n)
    shares = rng.integers(0, 256, (n, 192)).astype(np.uint8)
    w = pack_bls_wire(inst, val, rng.integers(0, 3, n),
                      rng.integers(0, 2, n),
                      rng.integers(0, 3 if hostile else 2, n),
                      rng.integers(0, 4, n), shares)
    return w + (b"\xff" * 7 if hostile else b"")


def test_bls_screen_matches_twin_and_python_fold():
    rng = np.random.default_rng(5)
    reg = _Reg()
    wire = _bls_wire(rng, 32, reg.V)
    codes = bls_screen(wire, I, reg.V, reg.pop_ok, reg.quarantined)
    np.testing.assert_array_equal(
        codes, jna.bls_screen(wire, I, reg.V, reg.pop_ok,
                              reg.quarantined))
    inst, val, _h, _r, typ, _v, _s = unpack_bls_wire(wire)
    assert len(codes) == len(inst) and set(codes.tolist()) == set(range(5))
    ta = BlsClassTable(reg, I, clock=make_clock())
    tb = BlsClassTable(reg, I, clock=make_clock())
    tb.native_screen = True
    for k in range(6):
        w = _bls_wire(rng, int(rng.integers(2, 12)), reg.V,
                      hostile=(k % 2 == 0))
        assert ta.fold(w, decode=False) == tb.fold(w, decode=False), k
    assert ta.counters == tb.counters
    assert sorted(ta.classes) == sorted(tb.classes)
    for key in ("bls_malformed", "bls_unknown_validator",
                "bls_pop_missing", "bls_quarantined", "bls_shares_folded"):
        assert ta.counters[key] > 0, key


# -- (e) the phase drain --------------------------------------------------------

IP, VP = 4, 8
SEEDS = fx.deterministic_seeds(VP)
PUBKEYS = fx.validator_pubkeys(SEEDS)


def _state(lut, heights, lane_floor=0, max_votes=1 << 20, cls=PhaseBuildState):
    return cls(heights=np.asarray(heights, np.int64),
               base_round=np.zeros(IP, np.int64), window=4,
               slot_lut=np.asarray(lut, np.int64), pubkeys=PUBKEYS,
               n_validators=VP, lane_floor=lane_floor,
               max_votes=max_votes, phase_offset=1)


def _drain(q, wire, st):
    q.submit(wire)
    q.phase_state = lambda: st
    return q.drain()


def _python_build(cols, lut, heights, lane_floor=0):
    """The port's own device-verify build of the same rows against the
    same window and slot table."""
    bat = VoteBatcher(IP, VP, n_slots=4, device="cpu")
    bat.sync_device(np.zeros(IP, np.int64), np.asarray(heights, np.int64))
    for i in range(IP):
        for v in lut[i]:
            if v >= 0:
                bat.slots.slot_for(i, int(v))
    bat.add_arrays(cols.instance, cols.validator, cols.height,
                   cols.round_, cols.typ, cols.value, cols.signatures,
                   verified=cols.verified, digest=cols.digest)
    return bat, bat.build_phases_device(PUBKEYS, phase_offset=1,
                                        lane_floor=lane_floor)


def _wire(h, values, classes=(0, 1), forge=7, round_=0):
    """Both classes of height h, signed; `values[i]` is instance i's
    value (-1 nil), validator `forge` signing with its neighbour's key."""
    values = np.asarray(values, np.int64)
    inst_v = np.repeat(values, VP)
    out = b""
    for typ in classes:
        cols = None
        for v in np.unique(values):
            c = fx.full_mesh_cols(IP, VP, SEEDS, h, typ, int(v),
                                  round_=round_, forge_validator=forge)
            if cols is None:
                cols = [x.copy() for x in c]
            sel = inst_v == v
            for x, y in zip(cols, c):
                x[sel] = y[sel]
        out += pack_wire_votes(*cols)
    return out


def _same_build(ph, bat, built):
    phases, lanes = built
    assert lanes is not None and ph.n_phases == len(phases)
    for p, (vp, n) in enumerate(phases):
        assert int(ph.counts[p]) == n
        assert int(ph.typ[p]) == int(vp.typ[0]) and ph.round_ == int(
            vp.round[0])
        assert torch.equal(ph.slots[p], vp.slots)
        assert torch.equal(ph.mask[p], vp.mask)
    for f in ("pub", "sig", "blocks", "phase_idx", "inst", "val", "real"):
        a, b = getattr(ph, f), getattr(lanes, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("case", ["fresh", "interned", "nil", "floor"])
def test_phase_drain_equals_build_phases_device(case):
    lut = np.full((IP, 4), -1, np.int64)
    values = [5, 6, 5, 9]
    floor = 0
    if case == "interned":
        lut[:, 0] = 3
        lut[:, 1] = [5, 6, 5, 9]
    elif case == "nil":
        values = [5, -1, 6, -1]
    elif case == "floor":
        floor = 2 * IP * VP + 5
    wire = _wire(0, values)
    q = NativeAdmissionQueue(IP, 256, instance_cap=64, cache=VerifiedCache())
    cols = _drain(q, wire, _state(lut, np.zeros(IP), lane_floor=floor))
    ph = cols.native_phases
    assert ph is not None and q.phase_fill == 1
    assert ph.n_lanes == 2 * IP * VP and ph.n_pad == max(ph.n_lanes, floor)
    bat, built = _python_build(cols, lut, np.zeros(IP), lane_floor=floor)
    _same_build(ph, bat, built)
    np.testing.assert_array_equal(cols.digest[ph.lane_rows],
                                  bat.last_build_keys[0])


@pytest.mark.parametrize("case", ["multi_round", "dup_cell", "two_values",
                                  "full_row", "stale", "preverified",
                                  "too_many"])
def test_phase_drain_bails_where_python_splits(case):
    lut = np.full((IP, 4), -1, np.int64)
    heights = np.zeros(IP)
    max_votes = 1 << 20
    wire = _wire(0, [5] * IP, classes=(0,))
    cache = None
    if case == "multi_round":
        wire += _wire(0, [5] * IP, classes=(1,), round_=1)
    elif case == "dup_cell":
        wire += _wire(0, [5] * IP, classes=(0,))
    elif case == "two_values":
        wire += _wire(0, [6] * IP, classes=(1,))
    elif case == "full_row":
        lut[2] = [1, 2, 3, 4]
    elif case == "stale":
        heights = np.ones(IP)
    elif case == "too_many":
        max_votes = IP * VP - 1
    elif case == "preverified":
        cache = VerifiedCache()
        digs = np.stack([np.frombuffer(hashlib.sha256(
            wire[k * REC_SIZE:(k + 1) * REC_SIZE]).digest(), np.uint8)
            for k in range(2)])
        cache.insert(digs, np.zeros(2, np.int64), np.zeros(2, np.int64))
    q = NativeAdmissionQueue(IP, 256, instance_cap=64, cache=cache)
    cols = _drain(q, wire, _state(lut, heights, max_votes=max_votes))
    assert cols.native_phases is None and len(cols) == len(wire) // REC_SIZE
    assert (q.phase_bail, q.phase_fill) == (
        (0, 0) if case == "too_many" else (1, 0))


def test_twin_phase_drain_agrees_on_its_lanes_and_departs_as_recorded():
    """Where the twin's drain fills, its first n_lanes lanes, phases and
    slots equal the port's; on a value not yet in the table the twin
    bails and the port fills; and with the pre-sync table the twin's
    pipeline passes at a height advance (value 6 in slot 1 at height 0)
    the twin gives value 6 slot 1 at height 1, where the Python build,
    after the sync resets the row, gives it slot 0 — as the port does
    with the table `native_phase_state` hands it."""
    wire = _wire(1, [6] * IP)
    lut = np.full((IP, 4), -1, np.int64)
    lut[:, :2] = [5, 6]                 # interned: both fill
    port = _drain(NativeAdmissionQueue(IP, 256, instance_cap=64), wire,
                  _state(lut, np.ones(IP)))
    twin = _drain(jna.NativeAdmissionQueue(IP, 256, instance_cap=64), wire,
                  _state(lut, np.ones(IP), lane_floor=1,
                         cls=JPhaseBuildState))
    pp, tp = port.native_phases, twin.native_phases
    n = pp.n_lanes
    assert tp.n_lanes == n and tp.n_pad >= n and pp.n_pad == n
    np.testing.assert_array_equal(pp.slots.numpy(), tp.slots)
    np.testing.assert_array_equal(pp.mask.numpy(), tp.mask)
    for f in ("pub", "sig", "phase_idx", "inst", "val", "real"):
        np.testing.assert_array_equal(getattr(pp, f).numpy(),
                                      getattr(tp, f)[:n], err_msg=f)
    np.testing.assert_array_equal(pp.blocks.numpy().view(np.uint32),
                                  tp.blocks[:n])
    np.testing.assert_array_equal(pp.lane_rows, tp.lane_rows)
    assert int(pp.slots[0, 0, 0]) == 1

    # the same height-1 rows against the table as the sync leaves it:
    # the port fills with slot 0 (== the Python build); the twin bails
    fresh = np.full((IP, 4), -1, np.int64)
    port = _drain(NativeAdmissionQueue(IP, 256, instance_cap=64), wire,
                  _state(fresh, np.ones(IP)))
    twin = _drain(jna.NativeAdmissionQueue(IP, 256, instance_cap=64), wire,
                  _state(fresh, np.ones(IP), lane_floor=1,
                         cls=JPhaseBuildState))
    assert twin.native_phases is None
    _bat, built = _python_build(port, fresh, np.ones(IP))
    _same_build(port.native_phases, _bat, built)
    assert int(port.native_phases.slots[0, 0, 0]) == 0
    # ... so the twin's slot 1 from the pre-sync table is not the
    # Python build's slot 0
    assert int(tp.slots[0, 0, 0]) == 1 != int(built[0][0][0].slots[0, 0])


# -- (f) the signed service, native on == off ---------------------------------

RUNG = 1 << (2 * IP * VP - 1).bit_length()


def _service(box, native=False, shards=1):
    d = DeviceDriver(IP, VP, advance_height=True, defer_collect=True,
                     device="cpu")
    bat = VoteBatcher(IP, VP, n_slots=4, device="cpu")
    svc = VoteService(
        d, bat, PUBKEYS, capacity=16 * IP * VP, target_votes=2 * IP * VP,
        max_delay_s=0.0, native_admission=native, native_shards=shards,
        ladder=ShapeLadder.plan(IP, VP, min_rung=RUNG, hbm_bytes=16 << 30),
        window_predictor=lambda: (np.zeros(IP, np.int64),
                                  np.full(IP, box["h"], np.int64)))
    stream = []
    real = d.step_async

    def recording(phases, lanes=None, exts=None, tick=None):
        stream.append(([tuple(t.clone() for t in p) for p in phases],
                       None if lanes is None
                       else tuple(t.clone() for t in lanes)))
        return real(phases, lanes, exts, tick=tick)

    d.step_async = recording
    return svc, d, stream


def test_signed_service_native_on_equals_off_and_sharded():
    runs = {}
    for key, kw in (("off", {}), ("native", {"native": True}),
                    ("shards", {"native": True, "shards": 2})):
        box = {"h": 0}
        svc, d, stream = _service(box, **kw)
        polled = []
        for h in range(2):
            box["h"] = h
            assert svc.submit(_wire(h, [7] * IP)).accepted == 2 * IP * VP
            svc.pump()
            polled += svc.poll_decisions()
        rep = svc.drain()
        runs[key] = (svc, d, stream, polled + rep["final_decisions"], rep)
    _, d0, s0, dec0, rep0 = runs["off"]
    assert rep0["native_phase_builds"] == 0
    assert rep0["decisions_total"] == 2 * IP
    assert rep0["rejected_signature_device"] == 2 * 2 * IP
    for key in ("native", "shards"):
        svc, d, s, dec, rep = runs[key]
        assert rep["native_phase_builds"] == 2, key
        assert rep["native_admission"]["phase_fill"] == 2
        assert [tuple(x) for x in dec] == [tuple(x) for x in dec0]
        assert len(s) == len(s0) == 2
        for (pa, la), (pb, lb) in zip(s, s0):
            assert len(pa) == len(pb)
            for x, y in zip(pa, pb):
                assert all(torch.equal(u, w) for u, w in zip(x, y)), key
            assert all(torch.equal(u, w) for u, w in zip(la, lb)), key
        for part in ("state", "tally"):
            for a, b in zip(getattr(d, part), getattr(d0, part)):
                assert torch.equal(a, b), (key, part)
        for k in ("decisions_total", "rejected_signature_device",
                  "dispatched_batches", "dispatched_votes", "queue",
                  "offladder_builds"):
            assert rep[k] == rep0[k], (key, k)
        assert rep["metrics"]["serve_native_phase_builds"] == 2
    assert runs["shards"][4]["native_admission"]["n_shards"] == 2


def test_service_native_option_checks():
    d = DeviceDriver(IP, VP, device="cpu")
    bat = VoteBatcher(IP, VP, n_slots=4, device="cpu")
    lad = ShapeLadder.plan(IP, VP, min_rung=RUNG, hbm_bytes=16 << 30)
    with pytest.raises(ValueError, match="native_shards"):
        VoteService(d, bat, None, ladder=lad, native_shards=0)
    with pytest.raises(ValueError, match="requires native_admission"):
        VoteService(d, bat, None, ladder=lad, native_shards=2)
    with pytest.raises(ValueError, match="not divisible"):
        VoteService(d, bat, None, ladder=lad, native_admission=True,
                    native_shards=3)
    # unsigned, or without a predictor: plain drains, never a fill
    svc = VoteService(d, bat, None, ladder=lad, native_admission=True)
    assert svc.pipeline.native_phase_state() is None


# -- (g) the evidence log at the adopt site -----------------------------------

def test_adopt_logs_batch_and_key_table_together(monkeypatch):
    def oracle(b, pubkeys):
        from agnes_tpu_torch.bridge.ingest import vote_messages_np

        msgs = vote_messages_np(b.height, b.round, b.typ, b.value)
        return np.array([ref.verify(bytes(pubkeys[v]), m.tobytes(),
                                    bytes(s))
                         for v, m, s in zip(b.validator, msgs, b.signature)])

    lut = np.full((IP, 4), -1, np.int64)
    bat = VoteBatcher(IP, VP, n_slots=4, device="cpu")
    monkeypatch.setattr(bat, "_verify", oracle)
    bat.sync_device(np.zeros(IP, np.int64), np.zeros(IP, np.int64))

    def adopt(wire, pk):
        q = NativeAdmissionQueue(IP, 256, instance_cap=64)
        cols = _drain(q, wire, _state(bat.slots.dense.copy(),
                                      np.zeros(IP)))
        assert cols.native_phases is not None
        return bat.adopt_native_phases(cols, cols.native_phases, pk)

    adopt(_wire(0, [5] * IP, classes=(0,)), PUBKEYS)
    assert bat.decode_slot(0, 0) == 5
    # validator 3 signs a second value in instance 1's prevote class
    c = list(fx.full_mesh_cols(1, VP, SEEDS, 0, 0, 8))
    c[0][:] = 1
    bat.add_arrays(*[x[3:4] for x in c])
    bat.build_phases_device(PUBKEYS, phase_offset=1)
    first, second = bat.signed_evidence(1, 3)
    assert (first.value, second.value) == (5, 8)
    assert len(bat._log) == len(bat._log_pk) == 2
    assert bat._log_pk[0] is PUBKEYS
    bat.clear_log()
    assert bat._log == [] and bat._log_pk == []
    assert bat.signed_evidence(1, 3) is None
    other = PUBKEYS[::-1].copy()
    adopt(_wire(0, [5] * IP, classes=(1,), forge=None), other)
    assert len(bat._log) == len(bat._log_pk) == 1
    assert bat._log_pk[0] is other
