"""The port's C++ ingest loop (`agnes_tpu_torch.bridge.NativeIngestLoop`)
against the JAX package's (`agnes_tpu.bridge.NativeIngestLoop`), on the
CPU.

Unsigned scenarios (the twin suite's, `tests/test_native_ingest.py`):
the same wire bytes go into both loops through the same tick protocol,
and every build's phases (round, class, count, slots, mask, height),
the host events, `decode_slot`, the counters, the evidence records and
the snapshot leaves come out equal, leaf for leaf.  The signed loop
(device="cpu": the plain verify) is held against the port's
`VoteBatcher.build_phases(pubkeys)` and, lane for lane, against the RFC
8032 oracle; the JAX twin's signed loop would compile a fused verify,
so it is not driven here.  Then the wrapper screens, the evidence join
over a native loop and the loop's checkpoint.
"""

import ctypes

import numpy as np
import pytest
import torch

from agnes_tpu.bridge import NativeIngestLoop as JLoop
from agnes_tpu.bridge.evidence import collect_device_evidence as j_collect
from agnes_tpu.utils.checkpoint import save_native_loop as j_save
from agnes_tpu_torch.bridge import evidence as tev
from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
from agnes_tpu_torch.bridge.native_ingest import (NativeIngestLoop,
                                                  _lib, pack_wire_votes)
from agnes_tpu_torch.core import native
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.utils import checkpoint as tck
from tests.torch_threads import one_torch_thread  # noqa: F401

PV, PC = 0, 1


def _port(I, V, n_slots=4, W=4, **kw):
    return NativeIngestLoop(I, V, n_slots=n_slots, n_rounds=W,
                            device="cpu", **kw)


def _twin(I, V, n_slots=4, W=4, **kw):
    return JLoop(I, V, n_slots=n_slots, n_rounds=W, **kw)


def _phases_np(phases):
    """[(VotePhase, n)] of either package -> comparable numpy copies (on
    the CPU a twin phase's arrays may alias the C++ buffer that a later
    emit reuses)."""
    return [(int(np.asarray(p.round)[0]), int(np.asarray(p.typ)[0]), n,
             np.array(p.slots), np.array(p.mask), np.array(p.height))
            for p, n in phases]


def _assert_phases(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        assert x[:3] == y[:3]
        for u, w in zip(x[3:], y[3:]):
            np.testing.assert_array_equal(u, w)


def _wire(inst, val, h, rnd, typ, value, sigs=None):
    return pack_wire_votes(*(np.asarray(c) for c in
                             (inst, val, h, rnd, typ, value)), sigs)


def _z(n):
    return np.zeros(n, np.int64)


def _full(n, x):
    return np.full(n, x, np.int64)


def _dense(I, V, typ=PV, value=7, h=0, rnd=0):
    n = I * V
    return _wire(np.repeat(np.arange(I), V), np.tile(np.arange(V), I),
                 _full(n, h), _full(n, rnd), _full(n, typ), _full(n, value))


def _random_stream(seed, I, V, n, h=0):
    rng = np.random.default_rng(seed)
    return _wire(rng.integers(0, I, n), rng.integers(0, V, n), _full(n, h),
                 rng.integers(0, 2, n), rng.integers(0, 2, n),
                 rng.integers(-1, 3, n))


def _fuzz_steps(seed, I, V):
    """Several ticks of hostile mixed traffic across syncs: every round
    of the window and beyond it, past rounds, stale and next heights,
    malformed fields, equivocations and replays."""
    rng = np.random.default_rng(seed)
    steps = []
    base, hts = _z(I), _z(I)
    for _ in range(4):
        n = 40
        rnd = base[0] + rng.integers(-2, 7, n)
        wire = _wire(rng.integers(-1, I + 1, n), rng.integers(0, V + 1, n),
                     hts[0] + rng.integers(-1, 2, n), rnd,
                     rng.integers(0, 3, n), rng.integers(-2, 4, n))
        steps += [("push", wire), ("build",), ("events",)]
        base = base + rng.integers(0, 3, I)
        hts = hts + rng.integers(0, 2, I)
        steps.append(("sync", base.copy(), hts.copy()))
    return steps + [("build",), ("events",)]


def _scenarios():
    """(name, (I, V, n_slots, W, held_cap), steps)."""
    I8, V16 = 8, 16
    sync = ("sync",)
    s = []
    s.append(("honest_dense_tick", (I8, V16, 4, 4, None),
              [("push", _dense(I8, V16)), ("build",)]))
    s.append(("layering_and_dedup", (4, 8, 4, 4, None), [
        ("push", _wire([0, 0, 0, 0, 0, 1, 1, 2, 0], [2, 2, 3, 3, 4, 5, 5,
                                                     6, 2], _z(9),
                       [0, 0, 0, 0, 0, 1, 1, 0, 0],
                       [PV, PV, PV, PV, PV, PC, PC, PV, PV],
                       [7, 9, 7, 7, -1, 8, 8, -1, 7])), ("build",)]))
    s.append(("mixed_value_two_class_intern_order", (4, 4, 4, 4, None), [
        ("push", _wire([0, 0, 1, 1], [0, 1, 2, 3], _z(4), _z(4),
                       [PV, PC, PV, PC], [9, 3, 5, 2])), ("build",)]))
    s.append(("malformed_and_stale_screen", (4, 4, 4, 4, None), [
        ("push", _wire([0, 99, 1, 2, 3], [0, 1, 99, 2, 3],
                       [0, 0, 0, 5, 0], _z(5), [PV, PV, PV, PV, 9],
                       _full(5, 7))), ("build",)]))
    s.append(("future_holdback_and_rotation_reentry", (2, 4, 4, 4, None), [
        ("push", _wire(_z(4), np.arange(4), _z(4), _full(4, 6),
                       _full(4, PV), _full(4, 7))), ("build",),
        sync + (_full(2, 4), _z(2)), ("build",)]))
    s.append(("past_round_host_fallback_events", (2, 4, 4, 4, None), [
        sync + (np.array([2, 0]), _z(2)),
        ("push", _wire(_z(3), np.arange(3), _z(3), np.ones(3), _full(3, PC),
                       _full(3, 9))), ("build",), ("events",),
        ("events",)]))
    s.append(("slot_overflow_spills_to_host", (1, 8, 2, 4, None), [
        ("push", _wire(_z(8), np.arange(8), _z(8), _z(8), _full(8, PV),
                       [10, 10, 20, 20, 30, 30, 40, 40])), ("build",)]))
    s.append(("height_advance_resets_slots", (2, 4, 2, 4, None), [
        ("push", _wire([0], [0], [0], [0], [PV], [10])), ("build",),
        sync + (_z(2), np.array([1, 0])),
        ("push", _wire([0], [0], [1], [0], [PV], [50])), ("build",)]))
    s.append(("early_next_height_vote_survives_sync", (2, 4, 4, 4, None), [
        ("push", _wire(_z(3), np.arange(3), np.ones(3), _z(3),
                       _full(3, PV), _full(3, 7))),
        sync + (_z(2), np.ones(2, np.int64)), ("build",)]))
    n = 12
    s.append(("held_cap_bounds_future_flood", (2, 4, 4, 4, 5), [
        ("push", _wire(np.arange(n) % 2, (np.arange(n) // 2) % 4, _z(n),
                       _full(n, 9), _full(n, PV), _full(n, 7))),
        ("build",), sync + (_full(2, 6), _z(2)), ("build",)]))
    wire = _random_stream(12, 4, 8, 64)
    s.append(("push_unchunked", (4, 8, 4, 4, None),
              [("push", wire), ("build",)]))
    s.append(("push_chunking", (4, 8, 4, 4, None), [
        ("push", wire[lo * 96:hi * 96])
        for lo, hi in ((0, 7), (7, 40), (40, 64))] + [("build",)]))
    bad = _wire([0], [99], [0], [0], [PV], [7])
    eqv = _wire([0, 0], [2, 2], [0, 0], [0, 0], [PV, PV], [9, 11])
    s.append(("push_async_parity", (4, 8, 4, 4, None), [
        ("push_async", _dense(4, 8)), ("push_async", bad),
        ("push_async", eqv), ("build",)]))
    s.append(("push_async_backlog_then_flush", (2, 4, 4, 4, None),
              [sync + (_z(2), _z(2))] + [
        ("push_async", _wire([0, 1], [k % 4, (k + 1) % 4], [0, 0], [0, 0],
                             [PV, PV], [7, 7])) for k in range(50)]
        + [("flush",), ("build",)]))
    s.append(("push_after_push_async_keeps_arrival_order",
              (1, 4, 4, 4, None), [
        ("push_async", _wire([0], [2], [0], [0], [PV], [9])),
        ("push", _wire([0], [2], [0], [0], [PV], [11])), ("build",)]))
    s.append(("mixed_ticks_with_powers", (2, 4, 4, 4, None), [
        ("push", _dense(2, 4, PV, 5)), ("push", _dense(2, 4, PC, 5)),
        ("build",), sync + (_z(2), np.ones(2, np.int64)),
        ("push", _dense(2, 4, PV, 6, h=1)),
        ("push", _wire([0, 1], [1, 1], [1, 1], [0, 0], [PV, PV], [8, 8])),
        ("build",)]))
    for seed in (1, 2):
        s.append((f"fuzz_{seed}", (3, 5, 2, 3, 16), _fuzz_steps(seed, 3, 5)))
    return s


SCENARIOS = _scenarios()


def _run(loop, steps):
    """Drive one loop through the steps; every build's phases and every
    host-event drain, in order."""
    out = []
    for op, *args in steps:
        if op in ("push", "push_async"):
            getattr(loop, op)(args[0])
        elif op == "sync":
            loop.sync_device(*args)
        elif op == "flush":
            loop.flush()
            assert loop.async_depth == 0
        elif op == "build":
            out.append(("build", _phases_np(loop.build_phases())))
        else:
            out.append(("events", loop.drain_host_events()))
    return out


def _final(loop, I, V, n_slots):
    """The loop's end state: counters, slot decode, evidence records by
    cell, the exported snapshot leaves."""
    ev = {}
    for i in range(I):
        for v in range(V):
            e = loop.signed_evidence(i, v)
            if e is not None:
                ev[(i, v)] = (e[0].tobytes(), e[1].tobytes())
    return (loop.counters,
            [[loop.decode_slot(i, s) for s in range(n_slots)]
             for i in range(I)], ev, loop.export_state())


def _make_pair(dims, powers=None):
    I, V, n_slots, W, held_cap = dims
    return (_port(I, V, n_slots, W, held_cap=held_cap, powers=powers),
            _twin(I, V, n_slots, W, held_cap=held_cap, powers=powers))


@pytest.mark.parametrize("name,dims,steps", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_unsigned_scenario_matches_twin(name, dims, steps):
    I, V, n_slots, _, _ = dims
    powers = (np.arange(1, V + 1, dtype=np.int64)
              if name == "mixed_ticks_with_powers" else None)
    port, twin = _make_pair(dims, powers)
    a, b = _run(port, steps), _run(twin, steps)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (kind, x), (_, y) in zip(a, b):
        if kind == "build":
            _assert_phases(x, y)
        else:
            assert x == y
    fa, fb = _final(port, I, V, n_slots), _final(twin, I, V, n_slots)
    assert fa[:3] == fb[:3]
    assert fa[3].keys() == fb[3].keys()
    for k in fa[3]:
        np.testing.assert_array_equal(fa[3][k], fb[3][k], err_msg=k)
    assert port.held_cap == twin.held_cap


def test_scenarios_exercise_their_paths():
    """The scenarios reach what they are named for (on the port; the
    twin is equal by the parity test)."""
    out = {}
    for name, dims, steps in SCENARIOS:
        loop = _make_pair(dims)[0]
        out[name] = (_run(loop, steps), loop.counters)
    c = out["malformed_and_stale_screen"][1]
    assert (c["rejected_malformed"], c["dropped_stale_height"]) == (3, 1)
    assert out["past_round_host_fallback_events"][0][1] == (
        "events", [(0, 0, 1, 9)])
    assert out["slot_overflow_spills_to_host"][1]["overflow_votes"] == 4
    c = out["held_cap_bounds_future_flood"][1]
    assert c["dropped_held_overflow"] == 7 and c["held"] == 0
    assert len(out["layering_and_dedup"][0][0][1]) >= 2
    assert out["push_async_backlog_then_flush"][1]["log"] == 100
    _assert_phases(out["push_chunking"][0][0][1],
                   out["push_unchunked"][0][0][1])
    assert out["early_next_height_vote_survives_sync"][0][0][1][0][2] == 3


def test_double_buffer_stability():
    """A build's phases stay intact while the next two builds fill both
    C++ buffer sets (each phase was copied out of its view), and the
    raw view of an emit stays put across the next emit."""
    I, V = 2, 2
    loop = _port(I, V)
    loop.push(_wire([0], [0], [0], [0], [PV], [7]))
    first = loop.build_phases()
    kept = _phases_np(first)
    L = _lib()

    def raw_view():
        rnd, typ, nv = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
        sp = ctypes.POINTER(ctypes.c_int32)()
        mp = ctypes.POINTER(ctypes.c_uint8)()
        L.ag_ing_phase(loop._h, 0, ctypes.byref(rnd), ctypes.byref(typ),
                       ctypes.byref(nv), ctypes.byref(sp), ctypes.byref(mp))
        return np.ctypeslib.as_array(sp, shape=(I, V))

    view = raw_view()
    snap = view.copy()
    loop.push(_wire([1], [1], [0], [0], [PC], [8]))
    loop.build_phases()
    np.testing.assert_array_equal(view, snap)
    loop.push(_wire([0, 1], [1, 0], [0, 0], [0, 0], [PV, PV], [9, 9]))
    loop.build_phases()
    _assert_phases(_phases_np(first), kept)


def test_push_async_concurrent_with_ticks():
    """A producer thread streams wire through push_async while this
    thread runs builds: nothing is lost or duplicated (every well-formed
    record lands in the evidence log once) and every distinct cell is
    emitted at least once."""
    import sys
    import threading

    I, V, batches, n = 2, 8, 200, 16
    loop = _port(I, V)
    loop.sync_device(_z(I), _z(I))

    def producer():
        rng = np.random.default_rng(7)
        for _ in range(batches):
            loop.push_async(_wire(rng.integers(0, I, n),
                                  rng.integers(0, V, n), _z(n), _z(n),
                                  _full(n, PV), _full(n, 7)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=producer)
        t.start()
        emitted = sum(k for _ in range(40) for _, k in loop.build_phases())
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    loop.flush()
    emitted += sum(k for _, k in loop.build_phases())
    assert I * V <= emitted <= batches * n, emitted
    c = loop.counters
    assert (c["log"], c["rejected_malformed"], c["dropped_stale_height"],
            loop.async_depth) == (batches * n, 0, 0, 0)


# --- the signed loop ------------------------------------------------------

I_S, V_S, FORGER, EQUIVOCATOR = 2, 4, 3, 1


@pytest.fixture(scope="module")
def signed():
    """Keys, and a tick where validator 1 double-signs (7 then 9) in
    instance 0, validator 3 signs with validator 0's key everywhere."""
    seeds = [bytes([i + 1]) * 32 for i in range(V_S)]
    pubkeys = np.stack([np.frombuffer(native.pubkey(s), np.uint8)
                        for s in seeds])
    inst = np.array([0, 0, 0, 0, 0, 1, 1, 1, 1], np.int64)
    val = np.array([0, 1, 1, 2, 3, 0, 1, 2, 3], np.int64)
    n = len(inst)
    h, rnd, typ = _z(n), _z(n), _full(n, PV)
    value = np.array([7, 7, 9, 7, 7, 7, 7, 7, 7], np.int64)
    msgs = vote_messages_np(h, rnd, typ, value)
    sigs = np.stack([np.frombuffer(native.sign(
        seeds[0] if val[k] == FORGER else seeds[val[k]],
        msgs[k].tobytes()), np.uint8) for k in range(n)])
    return dict(seeds=seeds, pubkeys=pubkeys,
                cols=(inst, val, h, rnd, typ, value, sigs), msgs=msgs)


def test_signed_loop_matches_batcher_and_oracle(signed):
    pubkeys, cols = signed["pubkeys"], signed["cols"]
    loop = _port(I_S, V_S, pubkeys=pubkeys)
    loop.push(_wire(*cols))
    bat = VoteBatcher(I_S, V_S, n_slots=4, device="cpu")
    bat.add_arrays(*cols)
    _assert_phases(_phases_np(loop.build_phases()),
                   _phases_np(bat.build_phases(pubkeys)))
    oracle = np.array([ref.verify(bytes(pubkeys[v]), m.tobytes(), s.tobytes())
                       for v, m, s in zip(cols[1], signed["msgs"], cols[6])])
    assert oracle.tolist() == (cols[1] != FORGER).tolist()
    assert loop.counters["rejected_signature"] == bat.rejected_signature \
        == int((~oracle).sum()) == I_S
    # the evidence log holds exactly the lanes the oracle accepts
    log = loop.export_state()["log"]
    want = np.frombuffer(_wire(*cols), np.uint8).reshape(-1, 96)[oracle]
    np.testing.assert_array_equal(log, want)
    r1, r2 = loop.signed_evidence(0, EQUIVOCATOR)
    for r in (r1, r2):
        assert native.verify(bytes(pubkeys[EQUIVOCATOR]),
                             vote_messages_np(*(np.array([x]) for x in (
                                 0, 0, PV, int.from_bytes(r[24:32].tobytes(),
                                                          "little"))))[0]
                             .tobytes(), r[32:96].tobytes())
    assert loop.signed_evidence(0, FORGER) is None
    assert loop.signed_evidence(0, 0) is None


def test_wrapper_screens():
    with pytest.raises(ValueError):
        _port(2, 4, pubkeys=np.zeros((3, 32), np.uint8))
    with pytest.raises(ValueError):
        _port(2, 4, pubkeys=np.zeros((4, 31), np.uint8))
    with pytest.raises(ValueError):
        _port(2, 4, powers=np.ones(3, np.int64))
    _port(2, 4, pubkeys=np.zeros((4, 32), np.uint8),
          powers=np.ones(4, np.int64))
    for dims in ((-1, 4, 4), (4, 4, 0), (2**40, 2**40, 4)):
        with pytest.raises(ValueError):
            _port(dims[0], dims[1], n_slots=dims[2])
    for cap in (0, -3):
        with pytest.raises(ValueError):
            _port(2, 4, held_cap=cap)
    loop = _port(8, 4)
    with pytest.raises(ValueError):
        loop.sync_device(_z(1), _z(8))
    with pytest.raises(ValueError):
        loop.sync_device(_z(8), _z(3))
    with pytest.raises(ValueError):
        loop.set_validators(pubkeys=np.zeros((4, 32), np.uint8))
    with pytest.raises(ValueError):
        loop.set_validators(powers=np.ones(3, np.int64))


def test_signed_loop_refuses_missing_verdicts():
    loop = _port(2, 4, pubkeys=np.zeros((4, 32), np.uint8))
    loop.push(_wire([0], [0], [0], [0], [PV], [7]))
    L = _lib()
    assert L.ag_ing_stage(loop._h) == 1
    assert L.ag_ing_apply_verdicts(loop._h, None) == -1
    with pytest.raises(RuntimeError):
        loop._apply_and_emit(1, None)


def test_import_state_freshness():
    one = _wire([0], [1], [0], [0], [PV], [7])
    live = _port(1, 4)
    live.sync_device(_z(1), _z(1))
    live.push(one)
    live.build_phases()
    for st in (live.export_state(), _port(1, 4).export_state()):
        with pytest.raises(RuntimeError, match="fresh"):
            live.import_state(st)
    assert live.counters["log"] == 1
    pushed = _port(1, 4)
    pushed.push(one)
    with pytest.raises(RuntimeError, match="fresh"):
        pushed.import_state(_port(1, 4).export_state())
    bad = live.export_state()
    bad["log"] = np.zeros(96 * 3, np.uint8)
    with pytest.raises(ValueError):
        _port(1, 4).import_state(bad)


def test_cuda_loop_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        NativeIngestLoop(2, 4, n_slots=4)


# --- the evidence join over a native loop ------------------------------------


def test_evidence_join_over_native_loop_matches_twin(signed):
    """Signed wire through an unsigned loop of each package (the twin's
    signed loop would compile a JAX verify): the join returns the
    twin's proofs, field for field, and every proof verifies."""
    pubkeys, cols = signed["pubkeys"], signed["cols"]
    port, twin = _port(I_S, V_S), _twin(I_S, V_S)
    for loop in (port, twin):
        loop.push(_wire(*cols))
        loop.build_phases()
    flags = np.zeros((I_S, V_S), bool)
    flags[0, EQUIVOCATOR] = flags[0, 0] = flags[1, 2] = True
    got, want = (tev.collect_device_evidence(torch.from_numpy(flags), port),
                 j_collect(flags, twin))

    def fields(r):
        return (r.instance, r.validator) + tuple(
            (w.instance, w.validator, w.height, w.round, int(w.typ),
             w.value, w.signature) for w in (r.first, r.second))

    assert [fields(r) for r in got] == [fields(r) for r in want]
    assert [(r.instance, r.validator) for r in got] == [(0, EQUIVOCATOR)]
    assert {got[0].first.value, got[0].second.value} == {7, 9}
    assert tev.verify_evidence(got[0], bytes(pubkeys[EQUIVOCATOR]))
    assert not tev.verify_evidence(got[0], bytes(pubkeys[0]))


# --- the loop's checkpoint ---------------------------------------------------


def _ckpt_stream(I, V):
    """Two ticks around a height advance, an equivocation, past rounds
    with weighted powers, a held vote; then the tail fed after the
    snapshot."""
    head = [("push", _dense(I, V, PV, 7)),
            ("push", _wire([0, 0], [1, 1], [0, 0], [0, 0], [PV, PV],
                           [9, 9])),
            ("push", _wire([1], [2], [0], [6], [PV], [7])), ("build",),
            ("sync", np.array([0, 2]), np.array([1, 0]))]
    tail = [("push", _dense(I, V, PC, 7)),
            ("push", _wire([1, 1, 1], [0, 1, 3], [0, 0, 0], [1, 1, 1],
                           [PC, PC, PC], [5, 5, 5])),
            ("push", _dense(I, V, PV, 4, h=1)[:96 * V]), ("build",),
            ("events",)]
    return head, tail


def test_checkpoint_leaves_match_twin(tmp_path):
    """save_native_loop writes the twin's .npz leaves for the same
    stream, and each package's snapshot loads in the other's."""
    I, V = 2, 4
    powers = np.array([5, 4, 1, 1], np.int64)
    head, _ = _ckpt_stream(I, V)
    port, twin = _make_pair((I, V, 4, 4, 99), powers)
    _run(port, head)
    _run(twin, head)
    pa, pb = str(tmp_path / "port.npz"), str(tmp_path / "twin.npz")
    tck.save_native_loop(port, pa)
    j_save(twin, pb)
    with np.load(pa) as za, np.load(pb) as zb:
        assert sorted(za.files) == sorted(zb.files) == sorted(
            ["meta", "powers", "slots", "log", "counters", "heights",
             "base_round"])
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    from agnes_tpu.utils.checkpoint import load_native_loop as j_load

    cross = tck.load_native_loop(pb, device="cpu")
    back = j_load(pa)
    fc, fb = _final(cross, I, V, 4), _final(back, I, V, 4)
    assert fc[:3] == fb[:3]
    assert fc[1:3] == _final(port, I, V, 4)[1:3]
    assert cross.held_cap == back.held_cap == 99


def test_restored_loop_emits_what_the_uninterrupted_loop_emits(tmp_path,
                                                                signed):
    I, V = 2, 4
    powers = np.array([5, 4, 1, 1], np.int64)
    head, tail = _ckpt_stream(I, V)
    loop = _port(I, V, powers=powers, held_cap=99)
    _run(loop, head)
    p = str(tmp_path / "loop.npz")
    tck.save_native_loop(loop, p)
    fresh = tck.load_native_loop(p, device="cpu")
    assert fresh.held_cap == 99 and fresh.device.type == "cpu"
    a, b = _run(loop, tail), _run(fresh, tail)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (kind, x), (_, y) in zip(a, b):
        if kind == "build":
            _assert_phases(x, y)
        else:
            assert x == y
    assert a[-1][0] == "events" and (1, 0, 1, 5) in a[-1][1]
    fa, fb = _final(loop, I, V, 4), _final(fresh, I, V, 4)
    # the held vote is in flight (not snapshotted) and re-arrives from
    # peers; everything else is the same
    assert fa[0]["held"] == 1 and fb[0]["held"] == 0
    fa[0].pop("held"), fb[0].pop("held")
    assert fa[:3] == fb[:3]
    # a signed snapshot needs its pubkey table back
    sl = _port(I_S, V_S, pubkeys=signed["pubkeys"])
    sl.push(_wire(*signed["cols"]))
    sl.build_phases()
    ps = str(tmp_path / "signed.npz")
    tck.save_native_loop(sl, ps)
    with pytest.raises(ValueError):
        tck.load_native_loop(ps, device="cpu")
    back = tck.load_native_loop(ps, pubkeys=signed["pubkeys"], device="cpu")
    assert back.signed_evidence(0, EQUIVOCATOR) is not None
    assert back.counters["rejected_signature"] == I_S
