"""Port differential: the serve plane (`agnes_tpu_torch.serve`) on the CPU,
I = 3 instances x V = 4 validators.

(a) an unsigned deployment: the port's VoteService against the JAX
    VoteService over three heights, with a held future-round burst and
    a stale batch — decisions, the drain report's counters and every
    state and tally leaf equal (the JAX side compiles only its unsigned
    sequence);
(b) signed, validator 1 forged in the prevote class: two served heights
    equal the port's offline `step_seq_signed` leaf for leaf, and the JAX
    unsigned sequence over the rows the RFC 8032 oracle accepts (the
    pre-masked reference of tests/test_torch_signed_step.py);
(c) the dedup cache: a duplicate class rides the unsigned stream with no
    signed dispatch, decisions and leaves equal the run without a cache,
    and a dispatch with a forged lane caches nothing;
(d) the no-op ticks: an idle pump, an all-held and an all-stale batch, an
    all-rejected submit, a drain of an empty service;
(e) a dispatch that raises puts every staged build back;
(f) warmup arms the retrace tripwire: a dispatch at an unwarmed phase
    count raises RetraceError and counts `retrace_unexpected`, while a
    signed build keeps its exact lane count and passes on the rung that
    holds it;
(g) `slow`: the signed serve against the JAX VoteService itself (a fused
    verify compile).

Every comparison is exact.
"""

import numpy as np
import pytest

from agnes_tpu.bridge.ingest import VoteBatcher as JBatcher
from agnes_tpu.crypto import ed25519_ref as jref
from agnes_tpu.harness.device_driver import DeviceDriver as JDriver
from agnes_tpu.serve import ShapeLadder as JLadder
from agnes_tpu.serve import VoteService as JService
from agnes_tpu_torch import convert
from agnes_tpu_torch.analysis.retrace import RetraceError
from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
from agnes_tpu_torch.harness import device_driver as tdd
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.serve import ShapeLadder, VoteService
from agnes_tpu_torch.utils.flightrec import FlightRecorder
from agnes_tpu_torch.utils.metrics import RETRACE_UNEXPECTED
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PV, PC = 0, 1
I, V, VALUE, FORGED = 3, 4, 7, 1
N = I * V
RUNG = 1 << (2 * N - 1).bit_length()        # one full tick's lanes
HBM = 16 << 30
SEEDS = fx.deterministic_seeds(V)
PUBKEYS = fx.validator_pubkeys(SEEDS)
REPORT_KEYS = ("decisions_total", "decided_instances", "held_flushed",
               "held_remaining", "late_quorums",
               "rejected_signature_device", "queue", "noop_ticks",
               "host_fallback_builds", "offladder_builds",
               "dispatched_batches", "dispatched_votes",
               "preverified_builds", "preverified_votes", "bls_votes")


def _cols(h, typ, forge=None, round_=0):
    c = list(fx.full_mesh_cols(I, V, SEEDS, h, typ, VALUE,
                               forge_validator=forge))
    c[3] = np.full(N, round_, np.int64)
    return c


def _wire(h, classes=(PV, PC), forge=None, round_=0, signed=True):
    out = b""
    for typ in classes:
        c = _cols(h, typ, forge if typ == PV else None, round_)
        out += pack_wire_votes(*(c if signed else c[:6]))
    return out


def _predictor(box):
    return lambda: (np.zeros(I, np.int64),
                    np.full(I, box["h"], np.int64))


def _port(pubkeys=None, box=None, ladder=None, audit=False, **kw):
    d = DeviceDriver(I, V, advance_height=True, defer_collect=True,
                     device="cpu", audit=audit)
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    kw.setdefault("capacity", 8 * N)
    svc = VoteService(
        d, bat, pubkeys, target_votes=2 * N, max_delay_s=0.0,
        ladder=ladder or ShapeLadder.plan(I, V, min_rung=RUNG,
                                          hbm_bytes=HBM),
        window_predictor=_predictor(box) if box is not None else None,
        **kw)
    return svc, d, bat


def _same_leaves(t_drv, j_state, j_tally):
    for part, jt in (("state", j_state), ("tally", j_tally)):
        for name, a, b in zip(jt._fields, jt,
                              convert.to_numpy(getattr(t_drv, part))):
            np.testing.assert_array_equal(np.asarray(a), b,
                                          err_msg=f"{part}.{name}")


def _same_stats(t, j):
    for f in ("decided", "decision_value", "decision_round"):
        np.testing.assert_array_equal(getattr(t.stats, f),
                                      getattr(j.stats, f), err_msg=f)
    assert t.stats.decisions_total == j.stats.decisions_total


def _drive(svc, box, ticks):
    """[(height, wire)] -> one submit + pump a tick, a poll after the
    second; returns every polled decision and the drain report."""
    polled = []
    for k, (h, wire) in enumerate(ticks):
        box["h"] = h
        svc.submit(wire)
        svc.pump()
        if k == 1:
            polled += svc.poll_decisions()
    rep = svc.drain()
    return polled + rep["final_decisions"], rep


# -- (a) unsigned: port VoteService == JAX VoteService -----------------------

def test_unsigned_service_matches_jax():
    ticks = [(0, _wire(0, signed=False)),
             (1, _wire(1, signed=False)
              + _wire(1, classes=(PV,), round_=6, signed=False)),  # held
             (2, _wire(2, signed=False)
              + _wire(0, classes=(PC,), signed=False)),            # stale
             (2, _wire(2, classes=(PV,), round_=5, signed=False))]  # held
    tbox, jbox = {"h": 0}, {"h": 0}
    tsvc, td, tbat = _port(box=tbox)
    jd = JDriver(I, V, advance_height=True, defer_collect=True)
    jbat = JBatcher(I, V, n_slots=4)
    jsvc = JService(jd, jbat, None, capacity=8 * N, target_votes=2 * N,
                    max_delay_s=0.0,
                    ladder=JLadder.plan(I, V, min_rung=RUNG,
                                        hbm_bytes=HBM),
                    window_predictor=_predictor(jbox), donate=False)
    tdec, trep = _drive(tsvc, tbox, ticks)
    jdec, jrep = _drive(jsvc, jbox, ticks)
    assert [tuple(x) for x in tdec] == [tuple(x) for x in jdec]
    assert len(tdec) == I and {x.value_id for x in tdec} == {VALUE}
    for k in REPORT_KEYS:
        assert trep[k] == jrep[k], k
    assert trep["decisions_total"] == 3 * I
    assert trep["held_flushed"] == N and trep["noop_ticks"] >= 1
    assert tbat.dropped_stale_height == jbat.dropped_stale_height > 0
    _same_leaves(td, jd.state, jd.tally)
    _same_stats(td, jd)
    for k in ("serve_submitted", "serve_admitted", "serve_batches",
              "serve_votes_dispatched", "serve_decisions"):
        assert trep["metrics"][k] == jrep["metrics"][k], k


# -- (b) signed: served == offline port == JAX pre-masked --------------------

def _oracle_rows(h, typ, forge):
    """The rows of one class the RFC 8032 oracle accepts."""
    c = _cols(h, typ, forge)
    msg = vote_messages_np(*[np.full(1, x, np.int64)
                             for x in (h, 0, typ, VALUE)])[0].tobytes()
    ok = np.array([jref.verify(bytes(PUBKEYS[v]), msg, bytes(s))
                   for v, s in zip(c[1], c[6])])
    return [x[ok] for x in c[:6]]


def test_signed_serve_matches_offline_and_jax_premasked():
    box = {"h": 0}
    svc, d, bat = _port(PUBKEYS, box)
    flight = FlightRecorder()
    svc.driver.flightrec = flight
    dec, rep = _drive(svc, box, [(h, _wire(h, forge=FORGED))
                                 for h in range(2)])
    assert rep["decisions_total"] == 2 * I
    assert rep["rejected_signature_device"] == 2 * I
    assert {x.value_id for x in dec} == {VALUE} and len(dec) == I
    assert rep["dispatched_batches"] == 2
    assert flight.counts()["dispatch"] == 2

    off = DeviceDriver(I, V, advance_height=True, device="cpu")
    obat = VoteBatcher(I, V, n_slots=4, device="cpu")
    jd = JDriver(I, V, advance_height=True)
    jbat = JBatcher(I, V, n_slots=4)
    for h in range(2):
        for b in (obat, jbat):
            b.sync_device(np.zeros(I, np.int64), np.full(I, h, np.int64))
        for typ in (PV, PC):
            obat.add_arrays(*_cols(h, typ, FORGED if typ == PV else None))
            jbat.add_arrays(*_oracle_rows(h, typ,
                                          FORGED if typ == PV else None))
        phases, lanes = obat.build_phases_device(PUBKEYS, phase_offset=1,
                                                 lane_floor=RUNG)
        off.step_seq_signed([off.empty_phase()] + [p for p, _ in phases],
                            lanes)
        jd.step_seq([jd.empty_phase()] + [p for p, _ in jbat.build_phases()])
    _same_leaves(d, convert.to_numpy(off.state), convert.to_numpy(off.tally))
    _same_stats(d, off)
    assert off.rejected_signature_device == rep["rejected_signature_device"]
    _same_leaves(d, jd.state, jd.tally)
    _same_stats(d, jd)


# -- (c) dedup ----------------------------------------------------------------

def _count_signed(monkeypatch):
    calls = {"n": 0}
    inner = tdd.consensus_step_seq_signed

    def counted(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)

    monkeypatch.setattr(tdd, "consensus_step_seq_signed", counted)
    return calls


def test_dedup_rides_unsigned_and_never_caches_a_forged_batch(monkeypatch):
    calls = _count_signed(monkeypatch)
    pv, pc = _wire(0, classes=(PV,)), _wire(0, classes=(PC,))
    runs = {}
    for cached in (True, False):
        box = {"h": 0}
        svc, d, _ = _port(PUBKEYS, box, dedup_cache=cached or None)
        n0 = calls["n"]
        for w in (pv, pv, pc):
            res = svc.submit(w)
            svc.pump()
            svc.pump()
            svc.poll_decisions()
        runs[cached] = (svc, d, calls["n"] - n0, res)
    svc, d, signed_calls, _ = runs[True]
    assert signed_calls == 2                 # the copy rode unsigned
    assert runs[False][2] == 3
    assert svc.pipeline.preverified_votes == N
    assert svc.pipeline.preverified_builds == 1
    assert svc.metrics.counters["serve_cache_hits"] == N
    assert len(svc.cache) == 2 * N
    _same_leaves(d, convert.to_numpy(runs[False][1].state),
                 convert.to_numpy(runs[False][1].tally))
    _same_stats(d, runs[False][1])
    assert d.stats.decided.all()

    # a forged dispatch caches nothing; its bytes stay uncached
    box = {"h": 1}
    svc.pipeline.window_predictor = _predictor(box)
    forged = _wire(1, classes=(PV,), forge=FORGED)
    assert svc.submit(forged).pre_verified == 0
    svc.pump()
    svc.pump()
    svc.poll_decisions()
    assert svc.cache.counters["insert_skipped_rejected"] == 1
    assert len(svc.cache) == 2 * N - svc.cache.counters["pruned_height"]
    from agnes_tpu_torch.serve.queue import _record_digests
    dig = _record_digests(forged, np.arange(N))
    assert not svc.cache.lookup(dig).any()


# -- (d) the no-op ticks ------------------------------------------------------

def test_noop_ticks():
    svc, d, bat = _port(capacity=64)
    for _ in range(3):
        assert svc.pump() == {"batch_votes": 0, "dispatched": 0,
                              "staged": False}
    n = 4
    svc.submit(pack_wire_votes(np.zeros(n), np.arange(n), np.zeros(n),
                               np.full(n, 50), np.zeros(n),
                               np.full(n, 7)))          # all future
    out = svc.pump()
    assert out["batch_votes"] == n and not out["staged"]
    assert bat.held_votes == n and svc.pipeline.noop_ticks == 1
    svc.submit(pack_wire_votes(np.zeros(n), np.arange(n), np.full(n, 99),
                               np.zeros(n), np.zeros(n), np.full(n, 7)))
    out = svc.pump()                                     # all stale
    assert not out["staged"] and bat.dropped_stale_height == n
    assert d.stats.steps == 0
    rep = svc.drain()
    assert rep["held_remaining"] == n and rep["held_flushed"] == 0
    assert rep["dispatched_batches"] == 0 and d.stats.steps == 0

    svc, d, _ = _port(capacity=2, instance_cap=1)
    res = svc.submit(pack_wire_votes(np.zeros(6), np.arange(6) % V,
                                     np.zeros(6), np.zeros(6),
                                     np.zeros(6), np.full(6, 7)))
    assert res.accepted == 1 and res.rejected == 5
    svc.queue.drain()
    assert svc.pump()["batch_votes"] == 0 and d.stats.steps == 0
    assert svc.metrics.snapshot()["serve_rejected_fairness"] == 5
    # a draining service refuses everything, truncated tail malformed
    rep = svc.drain()
    assert rep["decisions_total"] == 0 and rep["dispatched_votes"] == 0
    res = svc.submit(pack_wire_votes([0], [0], [0], [0], [0], [7]) + b"x")
    assert (res.accepted, res.rejected_overflow,
            res.rejected_malformed) == (0, 1, 1)


# -- (e) a failed dispatch loses nothing --------------------------------------

def test_dispatch_failure_restores_staged_builds():
    svc, d, _ = _port(PUBKEYS, {"h": 0},
                      ladder=ShapeLadder.plan(I, V, max_votes=16,
                                              min_rung=8, hbm_bytes=HBM))
    calls = {"n": 0}

    def flaky(phases, lanes=None, exts=None, tick=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient dispatch error")

    d.step_async = flaky
    svc.submit(_wire(0))
    # the whole 24-vote tick at once: the max_rung=16 cap splits it
    assert svc.pipeline.stage(svc.queue.drain())
    assert len(svc.pipeline._staged) == 2
    with pytest.raises(RuntimeError):
        svc.pipeline.dispatch_staged()
    assert len(svc.pipeline._staged) == 2
    assert svc.pipeline.dispatched_votes == 0
    assert svc.pipeline.dispatch_staged() == 2 * N
    assert svc.pipeline.dispatched_batches == 2
    assert svc.pipeline.offladder_builds == 0


# -- (f) warmup arms the retrace tripwire -------------------------------------

def test_warmup_arms_the_retrace_tripwire():
    box = {"h": 0}
    svc, d, _ = _port(PUBKEYS, box, audit=True)
    flight = FlightRecorder()
    svc.driver.flightrec = flight
    assert svc.pipeline.warmup(n_phases=3) == 1
    assert svc.pipeline.warmed_keys == {("signed", 3, RUNG)}
    assert d.sentinel.armed
    # a prevote-only batch builds entry + 1 class: P = 2, never warmed
    svc.submit(_wire(0, classes=(PV,)))
    svc.pump()
    with pytest.raises(RetraceError):
        svc.pump()
    assert d.sentinel.metrics.counters[RETRACE_UNEXPECTED] == 1
    assert flight.counts()["retrace_unexpected"] == 1
    assert len(svc.pipeline._staged) == 1          # nothing lost
    assert d.stats.steps == 0


def test_signed_builds_keep_their_lane_count():
    """No padding lane: a prevote-only build dispatches its N lanes, and
    the armed tripwire keys them on the rung that holds them."""
    flight = FlightRecorder()
    svc, d, _ = _port(PUBKEYS, {"h": 0}, audit=True, flightrec=flight)
    assert svc.pipeline.warmup(n_phases=(2, 3)) == 2
    assert d.sentinel.rungs == (RUNG,)
    assert [d.sentinel.lane_key(n) for n in (1, N, RUNG, RUNG + 1)] == \
        [RUNG, RUNG, RUNG, RUNG + 1]
    svc.submit(_wire(0, classes=(PV,), forge=FORGED))
    svc.pump()
    (opened,) = flight.tail(kind="tick_open")
    assert (opened["lanes"], opened["rung"]) == (N, RUNG)
    svc.pump()
    (sent,) = flight.tail(kind="dispatch")
    assert (sent["lanes"], sent["phases"]) == (N, 2)
    assert d.sentinel.report()["unexpected"] == 0
    rep = svc.drain()
    assert rep["rejected_signature_device"] == I
    assert rep["offladder_builds"] == 0


# -- (g) slow: the signed serve against the JAX VoteService -------------------

@pytest.mark.slow
def test_signed_serve_matches_jax_service():
    ticks = [(h, _wire(h, forge=FORGED)) for h in range(3)]
    tbox, jbox = {"h": 0}, {"h": 0}
    tsvc, td, _ = _port(PUBKEYS, tbox)
    jd = JDriver(I, V, advance_height=True, defer_collect=True)
    jsvc = JService(jd, JBatcher(I, V, n_slots=4), PUBKEYS,
                    capacity=8 * N, target_votes=2 * N, max_delay_s=0.0,
                    ladder=JLadder.plan(I, V, min_rung=RUNG,
                                        hbm_bytes=HBM),
                    window_predictor=_predictor(jbox), donate=False)
    tdec, trep = _drive(tsvc, tbox, ticks)
    jdec, jrep = _drive(jsvc, jbox, ticks)
    assert [tuple(x) for x in tdec] == [tuple(x) for x in jdec]
    for k in REPORT_KEYS:
        assert trep[k] == jrep[k], k
    _same_leaves(td, jd.state, jd.tally)
    _same_stats(td, jd)
