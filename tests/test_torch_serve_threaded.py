"""Port: the threaded serve host (`agnes_tpu_torch.serve.threaded`) on the
CPU, the cases of the JAX package's tests/test_serve_threaded.py on the
port: the inbox bounds, no vote lost or duplicated under concurrent
submits, decisions polled exactly once, a late submit refused by
`drain`, a loop failure failing closed, exact `Metrics` counts under
concurrency, the instrumented lock order, the busy gauges, and, over the
native admission queue (single and sharded), the admission lock elided
with every record counted.

The device dispatch is stubbed (the machinery under test is the host
threading layer), so nothing here runs a step.  Every wait has a
deadline of at most 10 s, and every thread is a daemon joined with a
timeout.
"""

import threading
import time

import numpy as np
import pytest

from agnes_tpu_torch.analysis import lockcheck
from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.bridge.native_ingest import REC_SIZE, pack_wire_votes
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.serve import (
    Inbox,
    ShapeLadder,
    ThreadedVoteService,
    VoteService,
    threaded_service,
)
from agnes_tpu_torch.utils.metrics import (
    SERVE_DISPATCH_BUSY_FRAC,
    SERVE_INBOX_DROPPED,
    SERVE_SUBMIT_BUSY_FRAC,
    Metrics,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V = 4, 8
DEADLINE_S = 10.0


def _wait(pred, what="condition"):
    t_end = time.monotonic() + DEADLINE_S
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _threads(target, n):
    ts = [threading.Thread(target=target, args=(k,), daemon=True)
          for k in range(n)]
    for t in ts:
        t.start()
    return ts


def _join(ts):
    for t in ts:
        t.join(timeout=DEADLINE_S)
    assert not any(t.is_alive() for t in ts), "a thread did not finish"


def _kw(**kw):
    kw.setdefault("ladder", ShapeLadder.plan(I, V, min_rung=8,
                                             hbm_bytes=1 << 30))
    kw.setdefault("capacity", 4 * I * V)
    kw.setdefault("target_votes", 8)
    kw.setdefault("max_delay_s", 0.0)
    return kw


def _stub(d):
    """Replace the device dispatch with a recorder: votes counted off
    the phase masks (what the card would tally for honest unsigned
    traffic)."""
    dispatched = []

    def stub(phases, lanes=None, exts=None, tick=None):
        dispatched.append(sum(int(p.mask.sum()) for p in phases))

    d.step_async = stub
    return dispatched


def _stubbed_service(**kw):
    d = DeviceDriver(I, V, device="cpu")
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    svc = VoteService(d, bat, None, **_kw(**kw))
    return svc, d, _stub(d)


def _vote(inst, val, value=7):
    return pack_wire_votes([inst], [val], [0], [0], [0], [value])


# -- inbox ----------------------------------------------------------------------

def test_inbox_bounded_fifo_and_dropped():
    box = Inbox(2)
    assert box.put(b"a") and box.put(b"b")
    assert not box.put(b"c")            # full: fail closed, counted
    assert box.dropped == 1 and box.enqueued == 2
    assert box.get() == b"a" and box.get() == b"b"
    assert box.get(timeout=0.01) is None
    box.close()
    assert not box.put(b"d") and box.dropped == 2
    with pytest.raises(ValueError):
        Inbox(0)


def test_drain_flushes_inbox_residue():
    """A blob the inbox accepted before the close reaches admission even
    if no loop ever ran."""
    svc, d, _ = _stubbed_service()
    tsvc = ThreadedVoteService(svc)             # threads never started
    assert tsvc.submit(_vote(0, 0))
    rep = tsvc.drain()
    assert rep["dispatched_votes"] == 1
    assert rep["inbox"]["depth_at_drain"] == 0 and tsvc.inbox.closed
    assert not tsvc.submit(b"\x00" * REC_SIZE)


# -- conservation ---------------------------------------------------------------

@pytest.mark.parametrize("native", [False, True])
def test_concurrent_submits_lose_and_duplicate_nothing(native):
    """Submitter threads race the loops; every admitted vote is
    dispatched exactly once (the dispatched phase-mask cells sum to the
    admitted count)."""
    svc, d, dispatched = _stubbed_service(native_admission=native)
    tsvc = ThreadedVoteService(svc, idle_wait_s=0.0005,
                               gauge_interval_s=0.01).start()
    n_threads, per_thread = 4, 8           # one vote per (I, V) cell

    def submitter(t):
        for k in range(per_thread):
            c = t * per_thread + k
            assert tsvc.submit(_vote(c // V, c % V))

    _join(_threads(submitter, n_threads))
    total = n_threads * per_thread
    _wait(lambda: svc.pipeline.dispatched_votes >= total, "dispatch")
    rep = tsvc.drain(timeout_s=DEADLINE_S)
    assert rep["dispatched_votes"] == sum(dispatched) == total
    assert rep["inbox"]["enqueued"] == total
    assert rep["inbox"]["dropped"] == 0
    assert rep["metrics"]["serve_admitted"] == total
    assert svc.pipeline.offladder_builds == 0
    assert d.stats.steps == 0


def test_poll_decisions_exactly_once():
    svc, d, _ = _stubbed_service()

    def deciding(phases, lanes=None, exts=None, tick=None):
        d.stats.decided[:] = True          # the card latched everyone
        d.stats.decision_value[:] = 0
        d.stats.decision_round[:] = 0
        d.stats.decisions_total = I

    d.step_async = deciding
    tsvc = ThreadedVoteService(svc, idle_wait_s=0.0005).start()
    z = np.zeros(I)
    assert tsvc.submit(pack_wire_votes(np.arange(I), z, z, z, z,
                                       np.full(I, 7)))
    _wait(lambda: svc.pipeline.dispatched_votes >= I, "the dispatch")
    decs = tsvc.poll_decisions()
    assert len(decs) == I and all(x.value_id == 7 for x in decs)
    assert tsvc.poll_decisions() == []
    rep = tsvc.drain(timeout_s=DEADLINE_S)
    assert rep["final_decisions"] == [] and rep["decisions_total"] == I


def test_drain_refuses_late_submits_and_reports_gauges():
    svc, d, _ = _stubbed_service()
    tsvc = ThreadedVoteService(svc, idle_wait_s=0.0005,
                               gauge_interval_s=0.005).start()
    assert tsvc.submit(_vote(0, 0))
    _wait(lambda: svc.pipeline.dispatched_votes >= 1, "dispatch")
    time.sleep(0.03)                       # let a gauge window pass
    rep = tsvc.drain(timeout_s=DEADLINE_S)
    assert not tsvc.submit(b"\x00" * REC_SIZE)
    assert svc.metrics.counters[SERVE_INBOX_DROPPED] >= 1
    snap = rep["metrics"]
    assert SERVE_SUBMIT_BUSY_FRAC in snap
    assert 0.0 <= snap[SERVE_DISPATCH_BUSY_FRAC] <= 1.0


def test_loop_failure_fails_closed():
    svc, d, _ = _stubbed_service()

    def boom(phases, lanes=None, exts=None, tick=None):
        raise RuntimeError("synthetic launch failure")

    d.step_async = boom
    tsvc = ThreadedVoteService(svc, idle_wait_s=0.0005).start()
    tsvc.submit(_vote(0, 0))
    _wait(lambda: tsvc.failure is not None, "the loop failure")
    assert not tsvc.submit(_vote(1, 0))        # fail closed
    rep = tsvc.drain(timeout_s=DEADLINE_S)
    assert "synthetic launch failure" in rep["thread_failure"]
    assert rep["metrics"]["serve_thread_failures"] == 1
    assert tsvc._busy_inflight == {"submit": None, "dispatch": None}


# -- metrics --------------------------------------------------------------------

def test_metrics_concurrent_counts_are_exact():
    m = Metrics()
    n_threads, per_thread = 8, 5000

    def worker(t):
        for k in range(per_thread):
            m.count("x")
            if k % 100 == 0:
                m.gauge(f"g{t}", float(k))
                m.count(f"c{t}")

    ts = _threads(worker, n_threads)
    for _ in range(20):                    # a concurrent scraper
        m.interval_rates()
        m.snapshot()
        time.sleep(0.001)
    _join(ts)
    assert m.counters["x"] == n_threads * per_thread
    assert all(m.counters[f"c{t}"] == per_thread // 100
               for t in range(n_threads))
    assert m.snapshot()["x"] == n_threads * per_thread


# -- lock order -----------------------------------------------------------------

def test_lock_order_instrumented():
    """A concurrent submit / dispatch / poll / drain run over
    instrumented locks: every acquisition respects admission -> device,
    none is a bare acquire."""
    svc, d, dispatched = _stubbed_service(dedup_cache=None)
    tsvc = ThreadedVoteService(svc, idle_wait_s=0.0005)
    state = lockcheck.instrument(tsvc)         # before start()
    assert isinstance(tsvc._admission, lockcheck.InstrumentedLock)
    tsvc.start()
    for k in range(I * V):
        w = _vote(k // V, k % V)
        _wait(lambda: tsvc.submit(w), "the inbox")
    _wait(lambda: sum(dispatched) == I * V, "every vote dispatched")
    tsvc.poll_decisions()
    rep = tsvc.drain(timeout_s=DEADLINE_S)
    assert rep["thread_failure"] is None
    assert state.violations == [], state.violations
    assert state.acquisitions > 0
    # the checker bites: device then admission, and a bare acquire
    bad = lockcheck.LockOrderState()
    adm = lockcheck.InstrumentedLock("_admission", 0, bad, strict=False)
    dev = lockcheck.InstrumentedLock("_device", 1, bad, strict=False)
    with dev, adm:
        pass
    adm.acquire()
    adm.release()
    assert len(bad.violations) == 2


def test_busy_gauges_attribute_inflight_spans_and_clamp():
    """A loop inside one long call is busy for every window the call
    spans, and the first sample after it never publishes the whole span
    into one short window."""

    class _Svc:                            # threads never started
        queue = object()
        metrics = Metrics()

    t = {"now": 100.0}
    tsvc = ThreadedVoteService(_Svc(), clock=lambda: t["now"])
    g = _Svc.metrics.gauges
    tsvc.sample_busy_gauges()
    with tsvc._busy_mu:
        tsvc._busy_inflight["dispatch"] = t["now"]
    for k in range(3):
        t["now"] += 1.0
        tsvc.sample_busy_gauges()
        assert g[SERVE_DISPATCH_BUSY_FRAC] == pytest.approx(1.0), k
        assert g[SERVE_SUBMIT_BUSY_FRAC] == pytest.approx(0.0), k
    t["now"] += 1.0
    with tsvc._busy_mu:
        tsvc._busy_totals["dispatch"] += t["now"] - 100.0
        tsvc._busy_inflight["dispatch"] = None
    t["now"] += 1.0
    tsvc.sample_busy_gauges()              # window [103, 105]
    assert g[SERVE_DISPATCH_BUSY_FRAC] == pytest.approx(0.5)
    assert tsvc.busy_seconds()["dispatch"] == pytest.approx(4.0)


# -- native admission: the admission lock elided ---------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_native_admission_elides_the_lock_and_conserves(shards):
    """Producer threads through the threaded host over the native queue
    (single or two shards): the submit and close paths never take the
    admission lock (drain's quiescent section takes it once), and every
    record is counted: submitted == admitted + rejected, admitted ==
    drained + evicted, per shard too."""
    d = DeviceDriver(I, V, device="cpu")
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    _stub(d)
    tsvc = threaded_service(d, bat, None, native_admission=True,
                            native_shards=shards, inbox_capacity=4096,
                            idle_wait_s=1e-4, **_kw(capacity=32,
                                                    instance_cap=6))
    svc = tsvc.service
    assert tsvc._native and svc.queue.native
    # instrument() must precede start(); threaded_service started the
    # loops, so count admission acquisitions through a wrapper instead
    acquired = {"n": 0}
    inner = tsvc._admission

    class _Counting:
        def __enter__(self):
            acquired["n"] += 1
            return inner.__enter__()

        def __exit__(self, *exc):
            return inner.__exit__(*exc)

    tsvc._admission = _Counting()
    rng = np.random.default_rng(4)
    wires = [pack_wire_votes(rng.integers(0, I + 1, 6),
                             rng.integers(0, V, 6), np.zeros(6),
                             np.zeros(6), rng.integers(0, 2, 6),
                             np.full(6, 7)) + (b"\x01" if k % 3 == 0
                                               else b"")
             for k in range(12)]

    def producer(t):
        for k in range(12):
            assert tsvc.submit(wires[(t + k) % len(wires)])

    _join(_threads(producer, 4))
    _wait(lambda: tsvc.inbox.depth == 0, "the inbox drained")
    before = acquired["n"]
    rep = tsvc.drain(timeout_s=DEADLINE_S)
    assert before == 0 and acquired["n"] == 1
    assert rep["thread_failure"] is None and rep["inbox"]["dropped"] == 0
    q = rep["queue"]
    n_rec = sum(len(wires[(t + k) % 12]) // REC_SIZE
                + (len(wires[(t + k) % 12]) % REC_SIZE > 0)
                for t in range(4) for k in range(12))
    assert q["submitted"] == n_rec
    assert q["submitted"] == (q["admitted"] + q["rejected_overflow"]
                              + q["rejected_fairness"]
                              + q["rejected_malformed"])
    assert q["admitted"] == q["drained"] + q["evicted"]
    assert q["rejected_malformed"] > 0
    assert rep["metrics"]["serve_submitted"] == n_rec
    assert rep["native_admission"]["depth"] == 0
    if shards > 1:
        parts = rep["native_admission"]["shards"]
        assert len(parts) == shards
        for c in parts:
            assert c["admitted"] == c["drained"] + c["evicted"] + c["depth"]
        for key in ("submitted", "admitted", "drained"):
            assert sum(c[key] for c in parts) == q[key]
    assert SERVE_SUBMIT_BUSY_FRAC in svc.metrics.gauges
