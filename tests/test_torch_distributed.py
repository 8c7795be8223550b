"""Port differential: the pod's process-free layer against the JAX twin.

`agnes_tpu_torch.distributed` (topology, the coordinator, the pod
post-mortem) held in process against `agnes_tpu.distributed` on inputs
made with numpy from a seed: HostPlan ranges, translation and errors;
the decision frame byte for byte and its unpacking record for record;
the wire rebase byte for byte; StragglerMonitor's straggler, dead and
never-self verdicts under one injected clock; `plan_digest`; the
single-process coordinator; an agree() divergence through a stubbed
transport; the ranked header of the pod post-mortem.  Then the serve
pipeline's refusal of a multi-rank mesh without a coordinator, a pod
of one process (a one-rank gloo world in process) served end to end
through DistributedDriver and HostShard, and the spawner's bounds: it
stops every worker at the first failure, and a worker dies with the
process that spawned it.  Last the twin's parameters: HostShard's
coordinator, monitor, ages and clock (its monitor's verdicts against the
twin's StragglerMonitor), DistributedDriver's `mesh` and
`lockstep_check`, and `spawn_pod`'s hosts of `devices_per_host` devices,
`hb_interval` and -1 heights against the twin's launches.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from agnes_tpu import distributed as jd
from agnes_tpu.distributed import pod as jpod
from agnes_tpu.utils import flightrec as jfr
from agnes_tpu_torch import distributed as td
from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
from agnes_tpu_torch.distributed import pod as tpod
from agnes_tpu_torch.utils import flightrec as tfr
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEED = 20261018


def _raises_both(fn_t, fn_j, err_t, err_j):
    with pytest.raises(err_t):
        fn_t()
    with pytest.raises(err_j):
        fn_j()


# -- HostPlan -----------------------------------------------------------------

@pytest.mark.parametrize("n_hosts,per", [(1, 5), (2, 3), (4, 3), (8, 16)])
def test_host_plan_equals_twin(n_hosts, per):
    rng = np.random.RandomState(SEED + n_hosts)
    n = n_hosts * per
    tp, jp = td.HostPlan(n_hosts, n), jd.HostPlan(n_hosts, n)
    assert tp.local_instances == jp.local_instances == per
    ids = rng.randint(0, n, size=64)
    local = rng.randint(0, per, size=64)
    for h in range(n_hosts):
        assert tp.instance_range(h) == jp.instance_range(h)
        np.testing.assert_array_equal(tp.to_local(h, ids), jp.to_local(h, ids))
        np.testing.assert_array_equal(tp.to_global(h, local),
                                      jp.to_global(h, local))
        np.testing.assert_array_equal(tp.owned_mask(h, ids),
                                      jp.owned_mask(h, ids))
    assert [tp.owner_of(int(i)) for i in ids] == \
        [jp.owner_of(int(i)) for i in ids]


def test_host_plan_errors_equal_twin():
    for args in ((3, 10), (0, 4), (2, 0)):
        _raises_both(lambda: td.HostPlan(*args), lambda: jd.HostPlan(*args),
                     td.PodConfigError, jd.PodConfigError)
    tp, jp = td.HostPlan(2, 4), jd.HostPlan(2, 4)
    _raises_both(lambda: tp.instance_range(2), lambda: jp.instance_range(2),
                 td.PodConfigError, jd.PodConfigError)
    _raises_both(lambda: tp.owner_of(4), lambda: jp.owner_of(4),
                 td.PodConfigError, jd.PodConfigError)
    assert issubclass(td.PodConfigError, ValueError)


# -- decision frames and the wire rebase ---------------------------------------

def _decisions(rng, n, host_id):
    values = rng.randint(-1, 9, n)
    values[:1] = -1                          # a nil decision first
    return (host_id, rng.randint(0, 1 << 20, n), values,
            rng.randint(0, 4, n), rng.randint(0, 1000, n))


@pytest.mark.parametrize("n,cap", [(0, 3), (1, 1), (5, 8), (64, 64)])
def test_decision_frame_byte_for_byte(n, cap):
    rng = np.random.RandomState(SEED + n)
    args = _decisions(rng, n, 3)
    t = td.pack_decision_frame(*args, cap)
    j = jd.pack_decision_frame(*args, cap)
    assert t.dtype == np.uint8 and len(t) == td.frame_capacity_bytes(cap)
    np.testing.assert_array_equal(t, j)
    assert td.frame_capacity_bytes(cap) == jd.frame_capacity_bytes(cap)


def test_decision_frames_unpack_record_for_record():
    rng = np.random.RandomState(SEED)
    cap = 6
    frames = np.stack([td.pack_decision_frame(*_decisions(rng, n, h), cap)
                       for h, n in enumerate((6, 0, 3, 1))])
    got = td.unpack_decision_frames(frames)
    want = jd.unpack_decision_frames(frames)
    assert len(got) == 10
    assert [dataclasses.astuple(d) for d in got] == \
        [dataclasses.astuple(d) for d in want]
    assert [d.host for d in got] == [0] * 6 + [2] * 3 + [3]
    assert any(d.value_id is None for d in got)        # nil decisions
    # over capacity, and a count the frame cannot hold
    _raises_both(lambda: td.pack_decision_frame(*_decisions(rng, 3, 0), 2),
                 lambda: jd.pack_decision_frame(*_decisions(rng, 3, 0), 2),
                 td.PodConfigError, jd.PodConfigError)
    bad = frames[0].copy()
    bad[0:4] = np.uint32(99).reshape(1).view(np.uint8)
    _raises_both(lambda: td.unpack_decision_frame(bad),
                 lambda: jd.unpack_decision_frame(bad),
                 td.PodConfigError, jd.PodConfigError)


@pytest.mark.parametrize("offset,tail", [(-5, b""), (7, b"trunc"),
                                         (0, b"x" * 95)])
def test_rebase_wire_byte_for_byte(offset, tail):
    rng = np.random.RandomState(SEED + offset)
    n = 9
    w = pack_wire_votes(rng.randint(5, 100, n), rng.randint(0, 8, n),
                        rng.randint(0, 50, n), rng.randint(0, 4, n),
                        rng.randint(0, 2, n), rng.randint(-1, 9, n),
                        rng.randint(0, 256, (n, 64)).astype(np.uint8))
    got = td.rebase_wire_instances(w + tail, offset)
    assert got == jd.rebase_wire_instances(w + tail, offset)
    assert got[len(got) - len(tail):] == tail


# -- liveness -----------------------------------------------------------------

def test_straggler_monitor_equals_twin():
    """One script of beats and clock steps on both monitors: the same
    straggler lists, the same dead hosts (never self), the same raise."""
    rng = np.random.RandomState(SEED)
    clk = {"t": 100.0}
    kw = dict(dead_after_s=30.0, straggler_after_s=5.0,
              clock=lambda: clk["t"])
    t, j = td.StragglerMonitor(4, 1, **kw), jd.StragglerMonitor(4, 1, **kw)
    for step in range(40):
        clk["t"] += float(rng.uniform(0, 6))
        who = rng.randint(-1, 4)
        if step % 3 == 0:
            host = None if who < 0 else int(who)
            t.beat(host)
            j.beat(host)
        assert t.stragglers() == j.stragglers()
        assert t.dead() == j.dead() and 1 not in t.dead()
        assert t.ages() == j.ages()
        if t.dead():
            _raises_both(t.check, j.check, td.DeadHostError,
                         jd.DeadHostError)
        else:
            assert t.check() == j.check()
    clk["t"] += 1000.0
    assert t.dead() == j.dead() == [0, 2, 3]
    t.beat(None)
    assert t.check() == []
    _raises_both(lambda: td.StragglerMonitor(2, 0, dead_after_s=1.0,
                                             straggler_after_s=5.0),
                 lambda: jd.StragglerMonitor(2, 0, dead_after_s=1.0,
                                             straggler_after_s=5.0),
                 td.PodConfigError, jd.PodConfigError)


# -- the coordinator ----------------------------------------------------------

def test_plan_digest_equals_twin():
    tags = [("e", (1,), ((2, 3), "int32")), ("e", (1,), ((2, 4), "int32")),
            ("warmup", (3,), 512, 1000, 1024, (1 << 20,), (), (), True,
             True), ()]
    got = [tpod.plan_digest(x) for x in tags]
    assert got == [jpod.plan_digest(x) for x in tags]
    assert len(set(got)) == len(got) and all(len(g) == 16 for g in got)


def test_single_process_coordinator_degenerates():
    clk = {"t": 0.0}
    m = td.StragglerMonitor(2, 0, dead_after_s=30, straggler_after_s=5,
                            clock=lambda: clk["t"])
    c = td.PodCoordinator(n_processes=1, process=0, monitor=m)
    c.agree(("entry", (1, 2), ((3,), "torch.int32")))
    c.barrier("warmup_enter", ("plan",))
    clk["t"] = 100.0
    out = c.allgather_bytes(np.arange(4, dtype=np.uint8))
    np.testing.assert_array_equal(out, [[0, 1, 2, 3]])
    assert c.agrees == 2 and c.barriers == 1 and c.gathered_frames == 1
    assert m.check() == []                   # the gather beat everyone


def test_agree_divergence_names_the_process():
    other = np.frombuffer(tpod.plan_digest(("other", "plan")), np.uint8)

    class Stub(td.PodCoordinator):
        def allgather_bytes(self, frame):
            mine = np.asarray(frame, np.uint8)
            return np.stack([mine, mine, other, mine])

    rec = tfr.FlightRecorder()
    c = Stub(n_processes=4, process=1, flightrec=rec)
    with pytest.raises(td.PodDivergenceError) as e:
        c.agree(("entry", (3,), "sig"))
    assert "process(es) [2]" in str(e.value)
    assert rec.last("pod_divergence")["differing"] == [2]
    with pytest.raises(td.PodDivergenceError):
        c.barrier("warmup_enter", ("plan",))
    assert c.agrees == 0 and c.barriers == 0

    class Same(td.PodCoordinator):
        def allgather_bytes(self, frame):
            return np.stack([np.asarray(frame, np.uint8)] * 4)

    assert Same(n_processes=4, process=0).agree(("e",)) == \
        tpod.plan_digest(("e",))


# -- the pod post-mortem ------------------------------------------------------

def test_pod_postmortem_header_equals_twin(tmp_path):
    now = time.time()
    paths = []
    for host, age in ((0, 500.0), (1, 2.0), (2, 40.0)):
        p = str(tmp_path / f"hb{host}.ndjson")
        rec = {"v": 2, "kind": "hb", "seq": 3, "t": now - age, "pid": 1,
               "uptime_s": 9.0, "interval_s": 1.0, "host_id": host,
               "process_index": host}
        with open(p, "w") as f:
            f.write(json.dumps(rec) + "\n")
        paths.append(p)
    paths += [str(tmp_path / "gone"), str(tmp_path / "empty")]
    open(paths[-1], "w").close()
    head = [tfr.render_pod_postmortem(paths, now=now).split("\n\n")[0],
            jfr.render_pod_postmortem(paths, now=now).split("\n\n")[0]]
    assert head[0] == head[1]
    lines = head[0].splitlines()[1:]
    assert len(lines) == 5
    assert "UNREADABLE" in lines[0] and "no valid lines" in lines[1]
    assert [ln.split(":")[0].strip() for ln in lines[2:]] == \
        ["host 0", "host 2", "host 1"]       # oldest last beat first
    assert "STALE" in lines[2] and "fresh" in lines[4]


# -- the serve pipeline and a pod of one ---------------------------------------

def test_pipeline_refuses_multi_rank_mesh_without_coordinator():
    from agnes_tpu_torch.serve import ShapeLadder
    from agnes_tpu_torch.serve.pipeline import ServePipeline

    mesh = SimpleNamespace(mesh=torch.arange(2).reshape(1, 2))
    ladder = ShapeLadder(rungs=(64,))
    drv = SimpleNamespace(mesh=mesh, coordinator=None)
    with pytest.raises(NotImplementedError, match="coordinator"):
        ServePipeline(drv, None, None, ladder)
    drv.coordinator = td.PodCoordinator(n_processes=2, process=0)
    assert ServePipeline(drv, None, None, ladder).dense
    one = SimpleNamespace(mesh=SimpleNamespace(
        mesh=torch.zeros((1, 1), dtype=torch.int64)))
    assert ServePipeline(one, None, None, ladder).dense


@pytest.fixture
def pod_of_one(tmp_path):
    """A one-rank gloo pod in this process, torn down after the test."""
    tpod.initialize_pod(f"file://{tmp_path}/rendezvous", 1, 0,
                        device_type="cpu")
    try:
        yield
    finally:
        tpod.shutdown_pod()


def test_pod_of_one_serves_through_host_shard(pod_of_one):
    """DistributedDriver + HostShard on a 1 x (1 x 1) pod: the global
    wire is all this host's, validator 3 forged in both classes, two
    heights decide, each dispatch's host-wide rejected count is read
    after collect, the coordinator's gathers stay local (one process),
    the single-process surfaces refuse."""
    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.distributed.smoke import signatures, wire_height
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.serve import ShapeLadder

    I, V = 2, 4
    d = td.DistributedDriver(I, V, advance_height=True, defer_collect=True,
                             audit=True, device="cpu")
    assert (d.n_hosts, d.per_host, d.host, d.process_index, d.I,
            d.global_I) == (1, 1, 0, 0, 2, 2)
    assert d._local_shape() == (2, 4)
    box = {"h": 0}
    seeds = fx.deterministic_seeds(V)
    shard = td.HostShard(
        d, VoteBatcher(I, V, n_slots=4, device="cpu"),
        fx.validator_pubkeys(seeds), target_votes=2 * I * V,
        max_delay_s=1e9,
        ladder=ShapeLadder.plan_dense(I, V, min_rung=16, hbm_bytes=1 << 34),
        window_predictor=lambda: (np.zeros(I, np.int64),
                                  np.full(I, box["h"], np.int64)))
    assert d.coordinator is shard.coordinator
    assert shard.warmup(n_phases=(3,)) == 1
    sigs = signatures(seeds, 1, 7, 3)
    for h in range(2):
        box["h"] = h
        assert shard.submit(wire_height(I, V, seeds, h, 7, sigs)).accepted \
            == 2 * I * V
        while shard.pipeline.dispatched_votes < 2 * I * V * (h + 1):
            shard.pump()
    view = d.last_step_rejects
    with pytest.raises(RuntimeError, match="after collect"):
        view.sum()
    new = shard.poll_pod_decisions()
    assert int(view.sum()) == 2 * I
    rep = shard.drain()
    assert d.rejected_signature_device == 2 * 2 * I
    assert [(p.instance, p.host, p.height, p.round, p.value_id)
            for p in new] == [(0, 0, 0, 0, 7), (1, 0, 0, 0, 7)]
    assert d.stats.decisions_total == 2 * I
    assert rep["pod"]["foreign_rejects"] == 0
    assert rep["pod"]["pod_decisions"] == I
    assert shard.coordinator.gathered_frames == 2   # local: one process
    for call in (lambda: d.step(), lambda: d.step_seq([]),
                 lambda: d.step_seq_signed([], None),
                 lambda: d.step_seq_signed_dense([], None),
                 lambda: d.run_heights_fused(1),
                 lambda: d.set_proposer_table(np.ones((I, 4), bool), 1)):
        with pytest.raises(NotImplementedError):
            call()


def test_divergence_with_a_recorder_departs_from_the_twin():
    """The twin's agree() names its event field `kind`, which collides
    with FlightRecorder.event's own parameter: with a recorder attached
    (HostShard attaches the service's) a divergence raises TypeError
    there instead of PodDivergenceError.  The port records the event
    (field `plan`) and raises PodDivergenceError."""
    def stubbed(cls, pkg):
        class Stub(cls):
            def allgather_bytes(self, frame):
                other = np.frombuffer(pkg.plan_digest(("other",)), np.uint8)
                return np.stack([np.asarray(frame, np.uint8), other])
        return Stub

    j = stubbed(jpod.PodCoordinator, jpod)(n_hosts=2, host=0,
                                           flightrec=jfr.FlightRecorder())
    with pytest.raises(TypeError, match="kind"):
        j.agree(("entry",))
    rec = tfr.FlightRecorder()
    t = stubbed(tpod.PodCoordinator, tpod)(n_processes=2, process=0,
                                           flightrec=rec)
    with pytest.raises(td.PodDivergenceError):
        t.agree(("entry",), kind="dispatch")
    assert rec.last("pod_divergence")["plan"] == "dispatch"


# -- the spawner's bounds ---------------------------------------------------------

def test_pod_run_stops_every_worker_at_the_first_failure(tmp_path):
    """A worker that fails ends the wait at once, long before the
    deadline: its peers (here one that would sleep two minutes, as a
    rank stuck in a collective would) are killed and say why."""
    from agnes_tpu_torch.distributed.smoke import PodRun

    def job(tag, code):
        paths = {"json": str(tmp_path / f"{tag}.json"),
                 "log": str(tmp_path / f"{tag}.log")}
        log = open(paths["log"], "w")
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                stderr=log)
        return {"tag": tag, "mode": "pod", "proc": proc, "log": log,
                "paths": paths}

    jobs = [job("pod0", "import time; time.sleep(120)"),
            job("pod1", "import sys; sys.exit(3)")]
    t0 = time.monotonic()
    res = PodRun(jobs, timeout_s=120.0).wait()
    assert time.monotonic() - t0 < 60.0
    assert not res["killed"] and res["failed_first"] == "pod1"
    assert res["paths"]["pod1"]["rc"] == 3
    assert res["paths"]["pod0"]["rc"] < 0               # killed
    assert "killed after pod1 failed" in res["pod"][0]["error"]
    assert "rc=3" in res["pod"][1]["error"]


def _orphan_fate(worker: str, wait_s: float) -> str:
    """Run `worker` (Python source that prints "ready" once set up) as
    the grandchild of a subreaper; its parent exits once it is ready.
    Returns how it ended within `wait_s`: "killed" (SIGKILL), "exited
    <status>" or "survived".  The subreaper adopts the orphan, so
    whatever ends it is the worker's own doing, whatever the machine
    does with orphans."""
    spawner = ("import subprocess, sys; p = subprocess.Popen("
               f"[sys.executable, '-c', {worker!r}], stdout=subprocess.PIPE,"
               " stderr=subprocess.DEVNULL, text=True); assert"
               " p.stdout.readline().strip() == 'ready'; print(p.pid,"
               " flush=True)")
    reaper = f"""
import ctypes, os, subprocess, sys, time
assert ctypes.CDLL(None).prctl(36, 1, 0, 0, 0) == 0  # PR_SET_CHILD_SUBREAPER
out = subprocess.run([sys.executable, "-c", {spawner!r}],
                     capture_output=True, text=True, timeout=120)
assert out.returncode == 0, out.stderr
pid = int(out.stdout.split()[-1])
deadline = time.monotonic() + {wait_s!r}
while time.monotonic() < deadline:
    done, status = os.waitpid(pid, os.WNOHANG)
    if done:
        print("killed" if os.WIFSIGNALED(status)
              and os.WTERMSIG(status) == 9 else f"exited {{status}}")
        break
    time.sleep(0.05)
else:
    os.kill(pid, 9)
    os.waitpid(pid, 0)
    print("survived")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", reaper], cwd=root,
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    return out.stdout.split("\n")[-2]


def test_worker_dies_with_its_parent():
    """`_die_with_parent` (what every worker's main() runs first) ties a
    worker's life to its spawner's: when the spawner dies, the worker is
    killed; a worker without it outlives its spawner."""
    sleep = "print('ready', flush=True); import time; time.sleep(120)"
    tied = ("from agnes_tpu_torch.distributed.smoke import "
            "_die_with_parent; _die_with_parent(); " + sleep)
    assert _orphan_fate(tied, 30.0) == "killed"
    assert _orphan_fate(sleep, 2.0) == "survived"


# -- the twin's parameters -----------------------------------------------------

class _Service:
    """The slice of VoteService that HostShard and ElasticShard build
    touches; records what the shard passed."""

    def __init__(self, driver, batcher, pubkeys, **kw):
        from agnes_tpu_torch.utils.metrics import Metrics

        self.kw = kw
        self.metrics = Metrics()
        self.flightrec = kw.get("flightrec")


def _stub_driver(n_hosts=2, host=0, n_instances=8, V=4):
    return SimpleNamespace(plan=td.HostPlan(n_hosts, n_instances),
                           host=host, n_hosts=n_hosts, per_host=1,
                           global_I=n_instances, V=V, coordinator=None)


@pytest.fixture
def stub_service(monkeypatch):
    import agnes_tpu_torch.serve as serve

    monkeypatch.setattr(serve, "VoteService", _Service, raising=False)


def test_host_shard_ages_a_peer_as_the_twin_monitor(stub_service):
    """HostShard(coordinator=, dead_after_s=, straggler_after_s=, clock=):
    the coordinator it is given gets its monitor, the clock reaches the
    service, and over one script of beats and clock steps its monitor's
    verdicts are the twin's StragglerMonitor's with the same ages."""
    clk = {"t": 50.0}

    def clock():
        return clk["t"]

    d = _stub_driver()
    coord = td.PodCoordinator(n_processes=2, process=0)
    shard = td.HostShard(d, None, None, coordinator=coord,
                         dead_after_s=20.0, straggler_after_s=4.0,
                         clock=clock, max_delay_s=1.0)
    assert shard.coordinator is coord is d.coordinator
    assert coord.monitor is shard.monitor
    assert shard.service.kw == {"clock": clock, "max_delay_s": 1.0}
    j = jd.StragglerMonitor(2, 0, dead_after_s=20.0, straggler_after_s=4.0,
                            clock=clock)
    t = shard.monitor
    for step, dt in enumerate([1.0, 3.5, 1.0, 6.0, 2.0, 12.0, 1.0]):
        clk["t"] += dt
        if step == 2:
            t.beat(1)
            j.beat(1)
        assert (t.stragglers(), t.dead(), t.ages()) == \
            (j.stragglers(), j.dead(), j.ages())
    assert t.dead() == [1]
    _raises_both(t.check, j.check, td.DeadHostError, jd.DeadHostError)


def test_host_shard_defaults_and_a_given_monitor(stub_service):
    """The defaults are the twin's ages (60 s dead, 10 s straggler) on
    time.monotonic; a given monitor is used as is and handed to a given
    coordinator that has none."""
    d = _stub_driver()
    shard = td.HostShard(d, None, None,
                         coordinator=td.PodCoordinator(n_processes=2,
                                                       process=0))
    m = shard.monitor
    assert (m.dead_after_s, m.straggler_after_s, m._clock) == \
        (60.0, 10.0, time.monotonic)
    assert shard.service.kw == {"clock": time.monotonic}
    mine = td.StragglerMonitor(2, 0)
    coord = td.PodCoordinator(n_processes=2, process=0)
    shard = td.HostShard(d, None, None, coordinator=coord, monitor=mine)
    assert shard.monitor is mine and coord.monitor is mine
    theirs = td.StragglerMonitor(2, 0)
    coord = td.PodCoordinator(n_processes=2, process=0, monitor=theirs)
    shard = td.HostShard(d, None, None, coordinator=coord, monitor=mine)
    assert coord.monitor is theirs


def test_driver_mesh_and_lockstep_switch(pod_of_one):
    """DistributedDriver(mesh=, lockstep_check=) on a one-rank gloo pod:
    a pod mesh of the driver's shape is taken as given and one of
    another raises; with the switch off `_agree` skips the coordinator,
    as the twin's does."""
    from agnes_tpu_torch.parallel.mesh import make_pod_mesh

    mesh = make_pod_mesh(1, 1, device_type="cpu")
    d = td.DistributedDriver(2, 4, mesh=mesh, device="cpu")
    assert d.pod_mesh is mesh and d.lockstep_check
    with pytest.raises(ValueError, match="pod mesh"):
        td.DistributedDriver(2, 4, mesh=mesh, per_host=2, device="cpu")

    class Coord:
        n_processes = 2

        def __init__(self):
            self.tags = []

        def agree(self, tag):
            self.tags.append(tag)

    for switch, n in ((True, 1), (False, 0)):
        c = Coord()
        d = td.DistributedDriver(2, 4, coordinator=c, lockstep_check=switch,
                                 device="cpu")
        d._agree("entry", (1,), ())
        assert len(c.tags) == n and d.lockstep_check is switch


def test_spawn_pod_launches_the_twins_pod(monkeypatch, tmp_path):
    """spawn_pod with the twin's arguments and defaults (2 hosts of 2
    devices, n_val 2, `hb_interval`, -1 for no leave / rejoin) launches
    one rank a twin device, each told the twin's heartbeat interval and
    cycle; no process is started (subprocess.Popen is stubbed)."""
    from agnes_tpu.distributed import smoke as js
    from agnes_tpu_torch.distributed import smoke as ts

    cmds = {"agnes_tpu.distributed.smoke": [],
            "agnes_tpu_torch.distributed.smoke": []}

    def popen(cmd, **kw):
        cmds[cmd[cmd.index("-m") + 1]].append(cmd)
        return SimpleNamespace(poll=lambda: 0, wait=lambda timeout=None: 0,
                               returncode=0, kill=lambda: None)

    monkeypatch.setattr(ts.subprocess, "Popen", popen)   # both modules'
    kw = dict(out_dir=str(tmp_path), heartbeat=True, hb_interval=0.25,
              elastic=True)
    js.spawn_pod(**kw)
    res = ts.spawn_pod(device="cpu", **kw)
    assert len(res["pod"]) == 4 and all("error" in r for r in res["pod"])

    def flag(cmd, name):
        return cmd[cmd.index(name) + 1]

    twin = cmds["agnes_tpu.distributed.smoke"]
    port = cmds["agnes_tpu_torch.distributed.smoke"]
    assert len(port) == len(twin) * int(flag(twin[0], "--devices-per-host"))
    for cmd in port:
        assert (flag(cmd, "--n-processes"), flag(cmd, "--per-host"),
                flag(cmd, "--n-val")) == ("4", "2", "2")
        for name in ("--hb-interval", "--leave-height", "--rejoin-height",
                     "--instances", "--validators", "--heights"):
            assert flag(cmd, name) == flag(twin[0], name), name
    assert flag(port[0], "--leave-height") == "-1"
    assert ts.check_cycle(2, -1, -1) is False
    assert ts.elastic_launches(2, -1, -1) == [2, 2, 2]
    assert ts.elastic_launches(4, 2, 3) == [2, 2, 2, 3, 2]
    with pytest.raises(ValueError):
        ts.check_cycle(4, 2, -1)
