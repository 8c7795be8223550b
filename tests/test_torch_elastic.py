"""Port differential: ElasticShard's surfaces that need no world, the
monitor's recovery half, the live-membership budget, the pipeline's
padding primitives, and a one-rank elastic pod in process.

* the routing surface (`submit` holds records only for departed homes,
  `_take_reroute` sends to the static home, `_ingest_reroute` takes in
  its block and holds strays again), on `ElasticShard.__new__` reduced
  to what the screen touches, as the twin's own test does, held against
  the twin's shard record for record;
* StragglerMonitor's readmission path under one injected clock, with and
  without a membership attached, against the twin's; heartbeat trails
  as evidence;
* `mesh_local_shape` / `ShapeLadder.plan_dense` / `DistributedDriver.
  _local_shape` with `n_live`, against the twin's;
* `pad_staged_to` / `stage_padding` on a CPU `ServePipeline`: a padded
  build steps to the unpadded one's state, tally and rejected count, on
  warmup's shapes (the armed tripwire passes it), and `warmup_covers`
  refuses an unwarmed P;
* a one-rank gloo elastic pod (a `file://` rendezvous) served through
  `tick`;
* the twin's parameters on a real ElasticShard of a two-host pod over a
  stub driver and service: `reroute_capacity` / `max_slots` (held and
  dropped records against the twin's routing shard), `rejoin_holddown_
  ticks` (against the twin's MembershipEpoch), `membership` (checked
  against the pod) and `clock`; and `tick(now)` on the one-rank pod.
"""

import numpy as np
import pytest
import torch

from agnes_tpu.distributed import elastic as je
from agnes_tpu.distributed import membership as jm
from agnes_tpu.distributed import topology as jt
from agnes_tpu_torch.bridge.native_ingest import REC_SIZE
from agnes_tpu_torch.distributed import elastic as te
from agnes_tpu_torch.distributed import membership as tm
from agnes_tpu_torch.distributed import topology as tt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEED = 20261018
PKGS = {"port": (tm, te, tt), "twin": (jm, je, jt)}


# -- the routing surface ------------------------------------------------------

class _SinkService:
    """The slice of VoteService the front-door screen touches."""

    def __init__(self):
        self.got = []
        self.flightrec = None

        class _M:
            @staticmethod
            def count(*a, **k):
                pass

        self.metrics = _M()

    def submit(self, b):
        self.got.append(bytes(b))


def _rec(inst):
    r = np.zeros(REC_SIZE, np.uint8)
    r[0:4] = np.asarray([inst], np.uint32).view(np.uint8)
    r[4:] = np.random.RandomState(inst).randint(0, 256, REC_SIZE - 4)
    return r


def _routing_shard(pkg, host, membership, per=3, cap=64):
    """An ElasticShard reduced to its routing surface (plan, lo / hi,
    membership, service and the counters)."""
    _m, el, top = PKGS[pkg]
    sh = el.ElasticShard.__new__(el.ElasticShard)
    sh.n_hosts = membership.view.n_hosts
    sh.host = host
    sh.plan = top.HostPlan(sh.n_hosts, sh.n_hosts * per)
    sh.lo, sh.hi = host * per, (host + 1) * per
    sh.membership = membership
    sh.service = _SinkService()
    sh.reroute_capacity = cap * REC_SIZE
    sh._held = []
    sh.foreign_rejects = sh.adopted_held = sh.held_dropped = 0
    sh.reroute_sent = sh.reroute_received = sh.reroute_reheld = 0
    return sh


def _departed(pkg, n_hosts, per, *left):
    ep = PKGS[pkg][0].MembershipEpoch(n_hosts, n_hosts * per)
    for h in left:
        ep.note_leave(h)
    ep.boundary()
    return ep


def _held(sh):
    """Held records as one [n, REC_SIZE] array (the port keeps blocks,
    the twin rows)."""
    if not sh._held:
        return np.zeros((0, REC_SIZE), np.uint8)
    return np.concatenate([np.asarray(b).reshape(-1, REC_SIZE)
                           for b in sh._held])


def _ids(raw):
    rec = np.frombuffer(raw, np.uint8).reshape(-1, REC_SIZE)
    return [int(x) for x in tt.wire_instance_ids(rec)]


def _counters(sh):
    return (sh.foreign_rejects, sh.adopted_held, sh.held_dropped,
            sh.reroute_sent, sh.reroute_received, sh.reroute_reheld)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


def test_submit_holds_departed_homes_only(pkg):
    ep = _departed(pkg, 4, 3, 2)
    assert ep.view.ranges == {0: (0, 4), 1: (4, 8), 3: (8, 12)}
    sh = _routing_shard(pkg, 1, ep)
    sh.submit(b"".join(_rec(i).tobytes() for i in (3, 6, 7, 8)))
    assert sh.adopted_held == 2 and len(_held(sh)) == 2
    assert sh.foreign_rejects == 1
    assert _ids(sh.service.got[0]) == [0]      # rebased onto the host


def test_submit_rejects_live_homes_in_owned_range(pkg):
    ep = _departed(pkg, 4, 3, 2, 3)
    assert ep.view.ranges == {0: (0, 6), 1: (6, 12)}
    sh = _routing_shard(pkg, 0, ep)
    sh.submit(b"".join(_rec(i).tobytes() for i in (3, 4, 5)))
    assert sh.adopted_held == 0 and len(_held(sh)) == 0
    assert sh.foreign_rejects == 3
    sh1 = _routing_shard(pkg, 1, ep)
    sh1.submit(b"".join(_rec(i).tobytes() for i in (6, 8, 9, 11)))
    assert sh1.adopted_held == 4 and sh1.foreign_rejects == 0


def test_take_reroute_targets_static_home_not_epoch_owner(pkg):
    ep = _departed(pkg, 4, 3, 2, 3)
    sh = _routing_shard(pkg, 1, ep)
    sh._hold(np.stack([_rec(6), _rec(10)]))
    ep.note_join(2)
    ep.boundary()
    assert _ids(sh._take_reroute(ep.view)) == [6]
    assert sh.reroute_sent == 1 and len(_held(sh)) == 1


def test_ingest_reroute_absorbs_static_block_and_reholds_strays(pkg):
    raw = b"".join(_rec(i).tobytes() for i in (6, 7, 0))
    sh2 = _routing_shard(pkg, 2, _departed(pkg, 4, 3, 3))
    sh2._ingest_reroute(raw)
    assert sh2.reroute_received == 2 and sh2.reroute_reheld == 0
    assert _ids(sh2.service.got[0]) == [0, 1]
    ep3 = _departed(pkg, 4, 3, 3)
    assert ep3.view.ranges[2] == (8, 12)
    sh = _routing_shard(pkg, 2, ep3)
    sh._ingest_reroute(_rec(10).tobytes())
    assert sh.reroute_received == 0
    assert sh.reroute_reheld == 1 and len(_held(sh)) == 1


@pytest.mark.parametrize("k", range(5))
def test_routing_equals_twin_record_for_record(k):
    """A seeded membership, gossip, capacity and re-route on both
    packages' shards: the same counters, the same bytes to the local
    service, the same held records in the same order, the same
    re-routed bytes."""
    rng = np.random.RandomState(SEED + k)
    n_hosts, per = int(rng.randint(2, 6)), int(rng.choice([2, 3, 4]))
    n = n_hosts * per
    away = [int(h) for h in rng.choice(n_hosts, rng.randint(1, n_hosts),
                                       replace=False)]
    if n % (n_hosts - len(away)):
        away = away[:1] if n % (n_hosts - 1) == 0 else []
    host = int(rng.randint(0, n_hosts))
    cap = int(rng.randint(1, 12))
    recs = [_rec(int(i)) for i in rng.randint(0, n + 2, 24)]
    back = [int(h) for h in away if rng.rand() < 0.6]
    out = {}
    for name in PKGS:
        ep = _departed(name, n_hosts, per, *away)
        sh = _routing_shard(name, host, ep, per=per, cap=cap)
        sh.submit(b"".join(r.tobytes() for r in recs[:16]) + b"tail")
        held = _held(sh).copy()
        for h in back:
            ep.note_join(h)
        view = ep.prospective() or ep.view
        sent = sh._take_reroute(view)
        sh._ingest_reroute(b"".join(r.tobytes() for r in recs[16:]))
        out[name] = (_counters(sh), sh.service.got, held.tobytes(),
                     sent, _held(sh).tobytes())
    assert out["port"] == out["twin"]


# -- the monitor's recovery half ----------------------------------------------

def _monitors(n_hosts, host, clk):
    kw = dict(dead_after_s=30.0, straggler_after_s=5.0,
              clock=lambda: clk["t"])
    return (tt.StragglerMonitor(n_hosts, host, **kw),
            jt.StragglerMonitor(n_hosts, host, **kw))


def test_monitor_dead_verdict_recovers_and_counts():
    clk = {"t": 100.0}
    for m in _monitors(2, 0, clk):
        clk["t"] = 100.0
        m.beat(None)
        clk["t"] = 140.0
        assert m.dead() == [1]
        m.beat(1)                             # fresh evidence clears it
        assert m.dead() == [] and m.check() == []
        assert m.readmissions == 1
        m.beat(1)                             # a live beat is not one
        assert m.readmissions == 1


def test_monitor_fail_closed_without_membership():
    clk = {"t": 0.0}
    t, j = _monitors(2, 0, clk)
    clk["t"] = 40.0
    with pytest.raises(tt.DeadHostError):
        t.check()
    with pytest.raises(jt.DeadHostError):
        j.check()
    assert t.membership is None and t.readmissions == 0


def test_monitor_with_membership_degrades_to_intents():
    clk = {"t": 0.0}
    for m, mod in zip(_monitors(2, 0, clk), (tm, jm)):
        clk["t"] = 0.0
        m.beat(None)
        ep = mod.MembershipEpoch(2, 8)
        m.attach_membership(ep)
        clk["t"] = 40.0
        assert m.check() == []                # degrades, no raise
        assert ep.pending() == (0b10, 0)      # leave latched once
        m.check()
        assert ep.pending() == (0b10, 0)
        ep.boundary()
        assert ep.view.alive == (0,)
        m.beat(1)                             # resumed evidence: join
        assert m.readmissions == 1 and ep.pending() == (0, 0b10)
        rep = ep.boundary()
        assert rep.joined == (1,) and ep.readmissions == 1


@pytest.mark.parametrize("k", range(4))
def test_monitor_recovery_script_equals_twin(k):
    """One seeded script of beats, clock steps and checks on both
    monitors, each with its package's membership attached: the same
    verdicts, readmissions and latched intents after every step."""
    rng = np.random.RandomState(SEED + 10 + k)
    clk = {"t": 50.0}
    n_hosts = int(rng.randint(2, 5))
    t, j = _monitors(n_hosts, 0, clk)
    et, ej = tm.MembershipEpoch(n_hosts, 12), jm.MembershipEpoch(n_hosts,
                                                                 12)
    t.attach_membership(et)
    j.attach_membership(ej)
    for _ in range(60):
        clk["t"] += float(rng.uniform(0, 20))
        op = rng.randint(0, 4)
        if op == 0:
            who = int(rng.randint(-1, n_hosts))
            t.beat(None if who < 0 else who)
            j.beat(None if who < 0 else who)
        elif op == 1:
            assert t.check() == j.check()
        elif op == 2:
            a, b = et.boundary(), ej.boundary()
            assert (a is None) == (b is None)
        assert t.dead() == j.dead() and t.stragglers() == j.stragglers()
        assert t.readmissions == j.readmissions
        assert et.pending() == ej.pending()
        assert et.view.alive == ej.view.alive
    assert t.readmissions > 0


def test_heartbeat_trails_are_evidence(tmp_path):
    """observe_heartbeat_files: a fresh trail readmits a dead peer and
    latches its join on both packages; a missing trail or a None path is
    no evidence."""
    from agnes_tpu_torch.utils.flightrec import Heartbeat

    path = str(tmp_path / "hb1.ndjson")
    Heartbeat(path, host_id=1).beat()
    clk = {"t": 0.0}
    out = []
    for m, mod in zip(_monitors(3, 0, clk), (tm, jm)):
        clk["t"] = 0.0
        m.beat(None)
        ep = mod.MembershipEpoch(3, 6)
        m.attach_membership(ep)
        clk["t"] = 100.0
        m.check()
        ep.boundary()
        m.observe_heartbeat_files(
            [None, path, str(tmp_path / "missing.ndjson"), path])
        out.append((m.dead(), m.readmissions, ep.pending(), ep.view.alive))
    assert out[0] == out[1] == ([2], 1, (0, 0b010), (0,))


# -- the live-membership budget -----------------------------------------------

class _TwinMesh:
    def __init__(self, **shape):
        self.shape = shape


class _PortMesh:
    def __init__(self, **shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


@pytest.mark.parametrize("shape,args", [
    (dict(slice=2, data=1, val=2), (4, 4, 2, None)),
    (dict(slice=2, data=1, val=2), (8, 4, 2, 1)),
    (dict(slice=2, data=1, val=2), (8, 4, 2, 3)),
    (dict(slice=2, data=1, val=2), (8, 4, 2, 0)),
    (dict(slice=4, data=2, val=1), (24, 6, 4, 2)),
    (dict(slice=4, data=2, val=1), (24, 6, 4, 3)),
    (dict(data=2, val=2), (8, 4, 1, None)),
])
def test_mesh_local_shape_live_membership_equals_twin(shape, args):
    from agnes_tpu.utils import budget as jb
    from agnes_tpu_torch.utils import budget as tb

    n, v, hosts, live = args
    got = [None, None]
    for k, (mod, mesh) in enumerate(((tb, _PortMesh(**shape)),
                                     (jb, _TwinMesh(**shape)))):
        try:
            got[k] = mod.mesh_local_shape(mesh, n, v, n_hosts=hosts,
                                          n_live=live)
        except ValueError as e:
            got[k] = ("ValueError", "live membership" in str(e))
    assert got[0] == got[1]


def test_plan_dense_replans_for_live_membership():
    from agnes_tpu.serve.batcher import ShapeLadder as JL
    from agnes_tpu_torch.serve.batcher import ShapeLadder as TL

    hbm = 1 << 34
    for L in (TL, JL):
        static = L.plan_dense(8, 4, local_shape=(4, 2), n_hosts=2,
                              min_rung=4, hbm_bytes=hbm)
        shrunk = L.plan_dense(8, 4, local_shape=(4, 2), n_hosts=2,
                              n_live=1, min_rung=4, hbm_bytes=hbm)
        assert shrunk.max_rung == 2 * static.max_rung
        with pytest.raises(ValueError, match="live membership"):
            L.plan_dense(8, 4, n_hosts=2, n_live=3)
        with pytest.raises(ValueError, match="repartition evenly"):
            L.plan_dense(9, 3, local_shape=(3, 3), n_hosts=3, n_live=2,
                         min_rung=4, hbm_bytes=hbm)
    assert TL.plan_dense(8, 4, local_shape=(4, 2), n_hosts=2, n_live=1,
                         min_rung=4, hbm_bytes=hbm).rungs == \
        JL.plan_dense(8, 4, local_shape=(4, 2), n_hosts=2, n_live=1,
                      min_rung=4, hbm_bytes=hbm).rungs


@pytest.mark.parametrize("n_live", [None, 1, 2, 3])
def test_driver_local_shape_with_live_hosts_equals_twin(n_live):
    """DistributedDriver._local_shape(n_live=) on a 2 x (1 x 2) pod: the
    figure a rank holds does not change with the membership, and an
    uneven live count raises, as the twin's does."""
    from agnes_tpu.distributed.driver import DistributedDriver as JD
    from agnes_tpu_torch.distributed.driver import DistributedDriver as TD

    t = TD.__new__(TD)
    t.pod_mesh, t.I, t.V, t.n_hosts = (_PortMesh(slice=2, data=1, val=2),
                                       6, 4, 2)
    j = JD.__new__(JD)
    j.mesh, j.I, j.V, j.n_hosts = _TwinMesh(slice=2, data=1, val=2), 6, 4, 2
    got = []
    for drv in (t, j):
        try:
            got.append(drv._local_shape(n_live=n_live))
        except ValueError as e:
            got.append(str(e))
    assert got[0] == got[1]
    if n_live != 3:
        assert got[0] == (6, 2)


# -- the pipeline's padding primitives ----------------------------------------

I, V, HBM = 2, 4, 16 << 30
PV, PC = 0, 1


def _pipeline(audit=False):
    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve import ShapeLadder
    from agnes_tpu_torch.serve.pipeline import ServePipeline

    seeds = fx.deterministic_seeds(V)
    d = DeviceDriver(I, V, advance_height=True, defer_collect=True,
                     device="cpu", hbm_budget_bytes=HBM, audit=audit)
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    pipe = ServePipeline(
        d, bat, fx.validator_pubkeys(seeds),
        ShapeLadder.plan_dense(I, V, min_rung=16, hbm_bytes=HBM),
        window_predictor=lambda: (np.zeros(I, np.int64),
                                  np.zeros(I, np.int64)), dense=True)
    return d, bat, pipe, seeds


def test_padded_build_steps_to_the_unpadded_state_on_warmed_shapes():
    from agnes_tpu_torch.analysis.retrace import RetraceError
    from agnes_tpu_torch.harness import fixtures as fx

    da, ba, pa, seeds = _pipeline(audit=True)
    db, bb, pb, _ = _pipeline()
    assert pa.warmup(n_phases=(2, 3), arm=True) == 2
    assert pa.warmup_covers("dense_signed", 2)
    assert pa.warmup_covers("dense_signed", 3)
    assert not pa.warmup_covers("dense_signed", 4)
    assert not pa.warmup_covers("unsigned", 2)
    assert not pa.warmup_covers("signed", 3, 16)
    cols = fx.full_mesh_cols(I, V, seeds, 0, PV, 7, forge_validator=1)
    for bat, pipe in ((ba, pa), (bb, pb)):
        bat.add_arrays(*cols)
        assert pipe.stage(None, sync=False)
        assert len(pipe._staged) == 1
    st = pa._staged[0]
    assert len(st.phases) + 1 == 2 and st.lanes.sig.shape[0] == 1
    assert pa.pad_staged_to(st, 2) == 0
    assert pa.pad_staged_to(st, 3) == 1
    assert (pa.padded_phases, pa.pad_builds) == (1, 0)
    zero = dict(sig=((2, I, V, 64), torch.int32),
                blocks=((2, I, V, 1, 32), torch.int32),
                pub=((V, 32), torch.int32))
    for name, (shape, dtype) in zero.items():
        x = getattr(st.lanes, name)
        assert (tuple(x.shape), x.dtype) == (shape, dtype), name
    assert not st.lanes.sig[1].any() and not st.lanes.blocks[1].any()
    assert pa.dispatch_staged() == pb.dispatch_staged() == I * V
    rej = (pa.driver.last_step_rejects, pb.driver.last_step_rejects)
    da.collect()
    db.collect()
    np.testing.assert_array_equal(rej[0].numpy(), rej[1].numpy())
    assert int(rej[0].sum()) == I                    # validator 1 forged
    for a, b in zip(list(da.state) + list(da.tally),
                    list(db.state) + list(db.tally)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert da.rejected_signature_device == db.rejected_signature_device
    # a build of padding alone: warmup's shape, no rejected lane
    pa.stage_padding(3)
    pad = pa._staged[-1]
    assert pad.n_votes == 0 and pa.pad_builds == 1
    for name, (shape, dtype) in zero.items():
        x = getattr(pad.lanes, name)
        assert (tuple(x.shape), x.dtype) == (shape, dtype), name
    pa.dispatch_staged()
    da.collect()
    assert da.rejected_signature_device == I
    # an unwarmed P trips the armed sentinel before any launch
    pa.stage_padding(4)
    with pytest.raises(RetraceError):
        pa.dispatch_staged()
    with pytest.raises(ValueError):
        pa.stage_padding(0)


# -- a one-rank elastic pod in process ----------------------------------------

@pytest.fixture
def pod_of_one(tmp_path):
    from agnes_tpu_torch.distributed import pod as tpod

    tpod.initialize_pod(f"file://{tmp_path}/rendezvous", 1, 0,
                        device_type="cpu")
    try:
        yield
    finally:
        tpod.shutdown_pod()


def test_elastic_pod_of_one_serves_through_ticks(pod_of_one):
    """ElasticShard on a 1 x (1 x 1) pod: one height split over two
    negotiated ticks, validator 3 forged, decisions gathered through the
    elastic frame; a lone host's leave is a no-op boundary (the pod never
    partitions to nobody); the report's elastic section."""
    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.distributed import DistributedDriver, ElasticShard
    from agnes_tpu_torch.distributed.smoke import signatures, wire_range
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.serve import ShapeLadder

    d = DistributedDriver(I, V, advance_height=True, defer_collect=True,
                          audit=True, device="cpu", hbm_budget_bytes=HBM)
    seeds = fx.deterministic_seeds(V)
    kw = dict(target_votes=2 * I * V, max_delay_s=1e9,
              ladder=ShapeLadder.plan_dense(I, V, min_rung=16,
                                            hbm_bytes=HBM),
              window_predictor=lambda: (np.zeros(I, np.int64),
                                        np.zeros(I, np.int64)))
    shard = ElasticShard(d, VoteBatcher(I, V, n_slots=4, device="cpu"),
                         fx.validator_pubkeys(seeds), **kw)
    assert shard.monitor.membership is shard.membership and shard.serving
    assert shard.reroute_capacity == 4 * I * V * REC_SIZE
    assert shard.warmup(n_phases=(2, 3)) == 2
    sigs = signatures(seeds, 0, 7, 3)
    res = [shard.tick(boundary=True)]
    for typ in (PV, PC):
        shard.submit(wire_range(I, V, seeds, 0, 0, I, (typ,), sigs))
        res.append(shard.tick())
    assert [r["dispatched"] for r in res] == [0, I * V, I * V]
    assert [r["padded"] for r in res] == [0, 0, 0]
    assert shard.announce_leave() is True
    res.append(shard.tick(boundary=True))     # a lone host: no-op
    assert not res[-1]["boundary"] and res[-1]["epoch"] == 0
    assert shard.membership.pending() == (0, 0) and shard.serving
    lad = shard.replan_ladder(min_rung=16, hbm_bytes=HBM)
    assert lad.rungs == ShapeLadder.plan_dense(
        I, V, n_hosts=1, n_live=1, min_rung=16, hbm_bytes=HBM).rungs
    rep = shard.drain()
    ela = rep["pod"]["elastic"]
    assert d.stats.decisions_total == I
    assert d.rejected_signature_device == 2 * I
    assert [(p.instance, p.host, p.height, p.value_id)
            for p in shard.pod_decisions] == [(0, 0, 0, 7), (1, 0, 0, 7)]
    assert ela["negotiation_ticks"] == ela["negotiations"] == 4
    assert (ela["epoch"], ela["alive"], ela["boundaries"],
            ela["padded_slots"], ela["held_pending"]) == (0, [0], 0, 0, 0)
    assert shard.coordinator.negotiations == 4
    snap = shard.metrics.snapshot()
    assert snap["pod_membership_epoch"] == 0


# -- the twin's parameters -----------------------------------------------------

class _Service(_SinkService):
    """The VoteService an ElasticShard builds, reduced to the screen's
    slice (metrics, flight recorder, submit)."""

    def __init__(self, driver, batcher, pubkeys, **kw):
        from agnes_tpu_torch.utils.metrics import Metrics

        super().__init__()
        self.kw = kw
        self.metrics = Metrics()


def _two_host_shard(monkeypatch, per=3, **kw):
    """A real ElasticShard of host 0 in a pod of two hosts, built over a
    stub driver and a stub service (no process group, no device)."""
    from types import SimpleNamespace

    import agnes_tpu_torch.serve as serve
    from agnes_tpu_torch.distributed import pod as tpod

    monkeypatch.setattr(serve, "VoteService", _Service, raising=False)
    d = SimpleNamespace(plan=tt.HostPlan(2, 2 * per), host=0, n_hosts=2,
                        per_host=1, global_I=2 * per, V=4, coordinator=None)
    return te.ElasticShard(d, None, None,
                           coordinator=tpod.PodCoordinator(2, 0), **kw)


def test_reroute_capacity_drops_as_the_twin_routing_shard(monkeypatch):
    """ElasticShard(reroute_capacity=64 * REC_SIZE, max_slots=5): the
    frame is sized from both, and with host 1 departed the screen holds
    64 of its 100 records and drops the rest, counter for counter and
    record for record with the twin's routing shard of the same capacity
    (tests/test_elastic.py's)."""
    sh = _two_host_shard(monkeypatch, reroute_capacity=64 * REC_SIZE,
                         max_slots=5)
    assert sh.frame_bytes == te.elastic_frame_capacity(5, 3, 64 * REC_SIZE)
    assert sh.announce_leave(1)
    assert sh.membership.boundary() is not None
    j = _routing_shard("twin", 0, _departed("twin", 2, 3, 1), cap=64)
    wire = np.concatenate([_rec(3 + k % 3) for k in range(100)]).tobytes()
    for s in (sh, j):
        s.submit(wire)
        s.submit(wire[:10 * REC_SIZE])
    assert _counters(sh) == _counters(j)
    assert (sh.adopted_held, sh.held_dropped) == (64, 46)
    np.testing.assert_array_equal(_held(sh), _held(j))


@pytest.mark.parametrize("holddown", [0, 3])
def test_rejoin_holddown_holds_as_the_membership_epoch(monkeypatch,
                                                       holddown):
    """ElasticShard(rejoin_holddown_ticks=) builds the membership with
    that holddown: a departed host's rejoin is deferred tick for tick as
    the twin's MembershipEpoch defers it."""
    sh = _two_host_shard(monkeypatch, rejoin_holddown_ticks=holddown)
    j = jm.MembershipEpoch(2, 6, rejoin_holddown_ticks=holddown)
    assert sh.announce_leave(1) == j.note_leave(1)
    assert (sh.membership.boundary() is None) == (j.boundary() is None)
    got = []
    for _ in range(holddown + 2):
        sh.membership.note_tick()
        j.note_tick()
        got.append((sh.announce_join(1), j.note_join(1)))
    assert [a for a, _ in got] == [b for _, b in got]
    assert [a for a, _ in got].index(True) == max(holddown - 1, 0)
    assert sh.membership.deferred_joins == j.deferred_joins


def test_membership_must_match_the_pod(monkeypatch):
    """A given membership is used as is when it covers the pod's hosts
    and instances, and refused (MembershipError) otherwise, as the twin
    refuses it; the clock reaches the service and the tick."""
    ep = tm.MembershipEpoch(2, 6)

    def clock():
        return 7.0

    sh = _two_host_shard(monkeypatch, membership=ep, clock=clock)
    assert sh.membership is ep and sh.monitor.membership is ep
    assert sh.service.kw["clock"] is clock and sh._clock is clock
    for bad in (tm.MembershipEpoch(3, 6), tm.MembershipEpoch(2, 8)):
        with pytest.raises(tm.MembershipError, match="does not match"):
            _two_host_shard(monkeypatch, membership=bad)


def test_tick_reads_its_first_argument_as_now(pod_of_one):
    """`tick(now=None, boundary=False)`: the twin's `shard.tick(t)` is a
    plain tick started at t (the port once read t as `boundary`).  On a
    one-rank gloo pod a latched leave stays pending through `tick(t)`,
    whose wall runs from t on the shard's clock, and a boundary tick
    then settles it."""
    import inspect

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.distributed import DistributedDriver, ElasticShard
    from agnes_tpu_torch.serve import ShapeLadder

    for cls in (je.ElasticShard, ElasticShard):
        bound = inspect.signature(cls.tick).bind(None, 5.0)
        bound.apply_defaults()
        assert dict(bound.arguments, self=None) == {
            "self": None, "now": 5.0, "boundary": False}
    clk = {"t": 100.0}
    d = DistributedDriver(I, V, advance_height=True, defer_collect=True,
                          device="cpu", hbm_budget_bytes=HBM)
    shard = ElasticShard(
        d, VoteBatcher(I, V, 4, device="cpu"), None,
        clock=lambda: clk["t"], target_votes=2 * I * V, max_delay_s=1e9,
        ladder=ShapeLadder.plan_dense(I, V, min_rung=16, hbm_bytes=HBM))
    assert shard.announce_leave()
    res = shard.tick(90.0)
    assert not res["boundary"] and res["negotiation_wall_s"] == 10.0
    assert shard.membership.pending() == (1, 0)
    res = shard.tick(boundary=True)
    assert res["negotiation_wall_s"] == 0.0
    assert shard.membership.pending() == (0, 0) and shard.serving
    assert shard.negotiation_ticks == 2
