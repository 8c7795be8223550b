"""Port differential: the serve plane's observability against the JAX
package's: `Histogram` / `Metrics` (quantiles, snapshots, `json_line`,
Prometheus buckets) from the same records under a frozen clock, heartbeat
files written by each package read and validated by the other's helpers
(and the same post-mortem), and `/metrics` servers on 127.0.0.1 port 0
answering the same exposition.  Host only; every comparison is exact.
"""

import time
import urllib.request

import numpy as np
import pytest

from agnes_tpu.utils import flightrec as jfr
from agnes_tpu.utils import metrics as jm
from agnes_tpu.utils import metrics_http as jh
from agnes_tpu_torch.utils import flightrec as tfr
from agnes_tpu_torch.utils import metrics as tm
from agnes_tpu_torch.utils import metrics_http as th


def _records(seed=7, n=500):
    rng = np.random.RandomState(seed)
    vals = np.exp(rng.uniform(-20, 12, n))
    vals[:5] = [0.0, -1.0, 1e-9, 1e7, 2.0 ** 16]      # edges and clamps
    return vals, rng.randint(1, 5, n)


def _fill(mod, monkeypatch):
    monkeypatch.setattr(time, "perf_counter", lambda: 10.0)
    m = mod.Metrics(_t0=0.0)
    vals, ns = _records()
    for k, (v, n) in enumerate(zip(vals, ns)):
        m.observe(mod.SERVE_E2E_DECISION_S, float(v), int(n))
        m.count("serve_admitted", int(n))
        if k % 3 == 0:
            m.histogram(mod.SERVE_DISPATCH_WALL_S).record(float(v))
    m.gauge("serve_queue_depth", 17)
    m.count(mod.RETRACE_UNEXPECTED, 0)
    return m


def test_metrics_match_jax(monkeypatch):
    t, j = _fill(tm, monkeypatch), _fill(jm, monkeypatch)
    for q in (0.01, 0.5, 0.9, 0.99, 1.0):
        for name in t.hists:
            assert t.hists[name].quantile(q) == j.hists[name].quantile(q)
    for name in t.hists:
        assert t.hists[name].snapshot() == j.hists[name].snapshot()
        assert t.hists[name].prom_buckets() == j.hists[name].prom_buckets()
    assert t.snapshot() == j.snapshot()
    assert t.json_line() == j.json_line()
    assert t.snapshot(window=True) == j.snapshot(window=True)
    assert t.interval_rates() == j.interval_rates()
    # merge is element-wise in both
    th_, jh_ = tm.Histogram("x"), jm.Histogram("x")
    th_.merge(t.hists[tm.SERVE_E2E_DECISION_S])
    jh_.merge(j.hists[jm.SERVE_E2E_DECISION_S])
    assert th_.snapshot() == jh_.snapshot()
    for name in ("SERVE_ADMIT_WAIT_S", "SERVE_BATCH_CLOSE_AGE_S",
                 "SERVE_SETTLE_WALL_S", "BLS_PAIRING_WALL_S",
                 "BLS_DEVICE_PAIRING_DISPATCHES", "RETRACE_UNEXPECTED",
                 "ANALYSIS_ENTRIES_AUDITED", "COMPILE_MS_PREFIX",
                 "SERVE_INBOX_DEPTH", "SERVE_SUBMIT_BUSY_FRAC"):
        assert getattr(tm, name) == getattr(jm, name), name
    # the serve names the twin's service uses (those of the native
    # admission front end wait with it)
    from agnes_tpu.serve import service as jservice
    names = [n for n in dir(jservice)
             if n.startswith("SERVE_") and "NATIVE" not in n]
    assert len(names) > 20
    for name in names:
        assert getattr(tm, name) == getattr(jservice, name), name


def _trail(mod, path, metrics_mod, monkeypatch):
    rec = mod.FlightRecorder(capacity=3)
    for k in range(5):
        rec.event("tick_open", tick=k)
    rec.event("dispatch", tick=4)
    m = _fill(metrics_mod, monkeypatch)
    m.gauge("compile_ms_ed25519_verify", 1234.5)
    m.count("bls_device_pairing_dispatches", 2)
    hb = mod.Heartbeat(str(path), interval_s=0.5, recorder=rec,
                       sources=[lambda: m.snapshot(window=True,
                                                   window_key="hb"),
                                lambda: 1 / 0])
    hb.beat()
    hb.beat()
    return hb


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_heartbeat_read_by_the_other_package(tmp_path, monkeypatch,
                                             writer):
    path = tmp_path / "hb.ndjson"
    wmod, mmod = ((tfr, tm) if writer == "port" else (jfr, jm))
    hb = _trail(wmod, path, mmod, monkeypatch)
    assert hb.source_errors == 2
    with open(path, "a") as f:
        f.write('{"v": 2, "kind": "hb", "seq": "x"}\n{"trunc')
    t_lines, t_bad = tfr.read_heartbeat(str(path))
    j_lines, j_bad = jfr.read_heartbeat(str(path))
    assert t_lines == j_lines and t_bad == j_bad
    assert len(t_lines) == 2 and len(t_bad) == 2
    for line in t_lines:
        assert tfr.validate_heartbeat_line(line) == []
        assert jfr.validate_heartbeat_line(line) == []
    assert t_lines[-1]["events"] == {"tick_open": 5, "dispatch": 1}
    assert t_lines[-1]["events_dropped"] == 3
    now = t_lines[-1]["t"] + 30.0
    assert tfr.render_postmortem(str(path), now=now) == \
        jfr.render_postmortem(str(path), now=now)
    assert "STALE" in tfr.render_postmortem(str(path), now=now)
    assert tfr.last_line_age_s(str(path), now=now) == \
        jfr.last_line_age_s(str(path), now=now) == 30.0
    for bad in ({"v": 3, "kind": "hb", "seq": 0, "t": 1.0, "pid": 1,
                 "uptime_s": 0.0},
                {"v": 2, "kind": "hb", "seq": True, "t": 1.0, "pid": 1,
                 "uptime_s": 0.0, "host_id": "a"}, [1]):
        assert tfr.validate_heartbeat_line(bad) == \
            jfr.validate_heartbeat_line(bad) != []


def _scrape(mod, metrics):
    srv = mod.MetricsServer(metrics, host="127.0.0.1", port=0,
                            extra_sources=(lambda: {"compile_ms_x": 3.5},
                                           lambda: 1 / 0))
    port = srv.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            return r.headers["Content-Type"], r.read().decode()
    finally:
        srv.stop()


def test_metrics_http_matches_jax(monkeypatch):
    t, j = _fill(tm, monkeypatch), _fill(jm, monkeypatch)
    t_ct, t_body = _scrape(th, t)
    j_ct, j_body = _scrape(jh, j)
    assert t_ct == j_ct == th.CONTENT_TYPE
    assert t_body == j_body
    parsed = th.parse_prometheus(t_body)
    assert parsed == jh.parse_prometheus(j_body)
    assert parsed["compile_ms_x"] == 3.5
    assert parsed['serve_submit_to_decision_s_bucket{le="+Inf"}'] == \
        t.hists[tm.SERVE_E2E_DECISION_S].n
    assert th.render_prometheus(t) == jh.render_prometheus(j)


def test_attach_to_driver_counts_and_is_idempotent():
    from agnes_tpu_torch.harness.device_driver import DeviceDriver

    d = DeviceDriver(3, 4, advance_height=True, device="cpu")
    m = tm.attach_to_driver(d)
    assert tm.attach_to_driver(d) is m          # no second wrapper
    d.run_honest_round()
    assert m.counters[tm.VOTES_INGESTED] == 2 * 3 * 4
    assert m.counters[tm.DECISIONS] == 3
    assert m.gauges[tm.EQUIVOCATIONS] == 0
    m2 = tm.Metrics()
    assert tm.attach_to_driver(d, m2) is m2
    d.run_honest_round()
    assert m2.counters[tm.VOTES_INGESTED] == 2 * 3 * 4
    assert m.counters[tm.VOTES_INGESTED] == 2 * 3 * 4
