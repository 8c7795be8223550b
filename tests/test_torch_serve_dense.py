"""Port differential: the serve plane's dense dispatch mode, on the CPU.

(a) `ShapeLadder.plan_dense` equals the JAX twin's (rungs and refusals)
    over a grid, with the twin's verify workspace;
(b) `ServePipeline(dense=True)` at I = 4 x V = 8, two signed heights
    with validator 1 forged in the prevote class, equals the lane-mode
    pipeline and the offline dense path (`build_phases_device_dense` ->
    `step_seq_signed_dense`) leaf for leaf;
(c) a `VoteService` whose driver sits on a one-rank `gloo` mesh (a
    `file://` rendezvous, no network) plans the dense ladder, takes the
    dense mode, warms one shape a phase count and serves the same
    heights equal to (b), with the tripwire armed;
(d) the native adopt branch is off in dense mode: no phase state for the
    drain, no adopted build, the same stream;
(e) a driver on a mesh of several ranks is refused (ROADMAP §1 item 6),
    and a mesh larger than the world raises the twin's ValueError.
"""

import functools
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from agnes_tpu.serve import batcher as jbatcher
from agnes_tpu.utils import budget as jbudget
from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.parallel import make_hierarchical_mesh, make_mesh
from agnes_tpu_torch.serve import ShapeLadder, VoteService
from agnes_tpu_torch.serve import batcher as tbatcher
from agnes_tpu_torch.serve.pipeline import ServePipeline
from agnes_tpu_torch.serve.queue import AdmissionQueue
from agnes_tpu_torch.utils import budget as tbudget
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PV, PC = 0, 1
I, V, VALUE, FORGED = 4, 8, 7, 1
N = I * V
HBM = 16 << 30
HEIGHTS = 2
SEEDS = fx.deterministic_seeds(V)
PUBKEYS = fx.validator_pubkeys(SEEDS)
GIB = 1 << 30


# -- (a) plan_dense against the twin ------------------------------------------

@pytest.fixture
def twin_workspace(monkeypatch):
    """The port's plan_dense with the twin's verify workspace a lane."""
    monkeypatch.setattr(tbatcher, "plan_dense_verify", functools.partial(
        tbudget.plan_dense_verify,
        workspace_lane_bytes=jbudget.VERIFY_WORKSPACE_LANE_BYTES))


@pytest.mark.parametrize("args,kw", [
    ((4, 8), {"hbm_bytes": HBM, "min_rung": 16}),
    ((1024, 1000), {"hbm_bytes": 80 * GIB}),
    ((10_000, 1000), {"hbm_bytes": 80 * GIB}),
    ((10_000, 1000), {"hbm_bytes": 16 * GIB}),
    ((10_000, 1000), {"hbm_bytes": 16 * GIB, "local_shape": (5000, 500)}),
    ((1024, 1000), {"hbm_bytes": 80 * GIB, "max_votes": 100_000,
                    "min_rung": 1000}),
    ((1024, 1000), {"hbm_bytes": 80 * GIB, "n_classes": 1}),
    ((1024, 1000), {"hbm_bytes": 80 * GIB, "n_hosts": 4}),
    ((1024, 1000), {"hbm_bytes": 80 * GIB, "n_hosts": 4, "n_live": 2}),
], ids=["small", "signed-height", "north-star-80", "north-star-16",
        "north-star-local", "capped", "one-class", "pod", "pod-live"])
def test_plan_dense_equals_twin(twin_workspace, args, kw):
    t = ShapeLadder.plan_dense(*args, **kw)
    j = jbatcher.ShapeLadder.plan_dense(*args, **kw)
    assert t.rungs == j.rungs and t.rungs


@pytest.mark.parametrize("args,kw,err", [
    ((10_000, 1000), {"hbm_bytes": 4 * GIB}, "BudgetError"),
    ((20_000, 1000), {"hbm_bytes": 8 * GIB}, "BudgetError"),
    ((1022, 1000), {"hbm_bytes": 80 * GIB, "n_hosts": 4}, "ValueError"),
    ((1024, 1000), {"hbm_bytes": 80 * GIB, "n_hosts": 2, "n_live": 3},
     "ValueError"),
    ((1020, 1000), {"hbm_bytes": 80 * GIB, "n_hosts": 4, "n_live": 8},
     "ValueError"),
], ids=["north-star-4gib", "twice-north-star-8gib", "uneven-hosts",
        "live-above-hosts", "live-outside"])
def test_plan_dense_refusals_equal_twin(twin_workspace, args, kw, err):
    for mod in (tbatcher, jbatcher):
        with pytest.raises(getattr(mod, err, None) or ValueError):
            mod.ShapeLadder.plan_dense(*args, **kw)


# -- the signed traffic ----------------------------------------------------------

def _cols(h, typ):
    return fx.full_mesh_cols(I, V, SEEDS, h, typ, VALUE,
                             forge_validator=FORGED if typ == PV else None)


def _wire(h):
    return b"".join(pack_wire_votes(*_cols(h, typ)) for typ in (PV, PC))


def _predictor(box):
    return lambda: (np.zeros(I, np.int64), np.full(I, box["h"], np.int64))


def _driver(**kw):
    return DeviceDriver(I, V, advance_height=True, defer_collect=True,
                        device="cpu", hbm_budget_bytes=HBM, **kw)


def _leaves(d):
    state, tally = d.state_copies()
    return [x.clone() for x in list(state) + list(tally)]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.equal(y)
    for f in ("decided", "decision_value", "decision_round"):
        np.testing.assert_array_equal(getattr(a.stats, f),
                                      getattr(b.stats, f), err_msg=f)
    for f in ("decisions_total", "votes_ingested", "steps"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f
    assert a.rejected_signature_device == b.rejected_signature_device


def _serve_pipeline(dense):
    box = {"h": 0}
    d = _driver()
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    pipe = ServePipeline(d, bat, PUBKEYS,
                         ShapeLadder.plan(I, V, min_rung=2 * N,
                                          hbm_bytes=HBM),
                         window_predictor=_predictor(box), dense=dense)
    q = AdmissionQueue(I, 4 * N)
    for h in range(HEIGHTS):
        box["h"] = h
        assert q.submit(_wire(h)).accepted == 2 * N
        pipe.pump(q.drain(2 * N))
    pipe.pump(None)
    pipe.settle()
    return pipe, d


@pytest.fixture(scope="module")
def offline_dense():
    d = DeviceDriver(I, V, advance_height=True, device="cpu")
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    for h in range(HEIGHTS):
        bat.sync_device(np.zeros(I, np.int64), np.full(I, h, np.int64))
        for typ in (PV, PC):
            bat.add_arrays(*_cols(h, typ))
        phases, dense = bat.build_phases_device_dense(PUBKEYS)
        assert dense is not None
        d.step_seq_signed_dense([d.empty_phase()] + [p for p, _ in phases],
                                dense)
    assert d.all_decided() and d.rejected_signature_device == HEIGHTS * I
    return d


def test_dense_pipeline_equals_lane_pipeline_and_offline(offline_dense):
    pipe, d = _serve_pipeline(dense=True)
    lane_pipe, ld = _serve_pipeline(dense=False)
    assert pipe.dense and not lane_pipe.dense
    assert pipe.dispatched_batches == lane_pipe.dispatched_batches == HEIGHTS
    assert pipe.offladder_builds == pipe.host_fallback_builds == 0
    _same(d, ld)
    _same(d, offline_dense)
    assert d.stats.decisions_total == HEIGHTS * I


# -- (c)-(d) a VoteService over a one-rank gloo mesh ---------------------------

@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("gloo") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=1, rank=0)
    try:
        yield make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _mesh_service(mesh, **kw):
    box = {"h": 0}
    d = _driver(mesh=mesh, audit=True)
    svc = VoteService(d, VoteBatcher(I, V, n_slots=4, device="cpu"),
                      PUBKEYS, target_votes=2 * N, max_delay_s=0.0,
                      window_predictor=_predictor(box), **kw)
    return svc, d, box


def _serve(svc, box):
    for h in range(HEIGHTS):
        box["h"] = h
        svc.submit(_wire(h))
        svc.pump()
    return svc.drain()


def test_service_on_a_one_rank_mesh_takes_the_dense_ladder(mesh):
    svc, d, _ = _mesh_service(mesh)
    assert d._local_shape() == (I, V)
    assert svc.ladder == ShapeLadder.plan_dense(I, V, local_shape=(I, V),
                                                hbm_bytes=HBM)
    assert svc.pipeline.dense
    # a budget the lane ladder cannot meet at its smallest rung, which the
    # dense plan meets: only plan_dense gives this service a ladder
    small = 100_000
    with pytest.raises(tbudget.BudgetError):
        ShapeLadder.plan(I, V, hbm_bytes=small)
    d2 = DeviceDriver(I, V, device="cpu", mesh=mesh, hbm_budget_bytes=small)
    svc2 = VoteService(d2, VoteBatcher(I, V, n_slots=4, device="cpu"),
                       PUBKEYS)
    assert svc2.ladder.rungs and svc2.pipeline.dense


def test_dense_warmup_one_key_a_phase_count_then_serve(mesh, offline_dense):
    svc, d, box = _mesh_service(mesh)
    assert svc.pipeline.warmup() == 2
    assert svc.pipeline.warmed_keys == {("dense_signed", 2),
                                        ("dense_signed", 3)}
    assert d.sentinel.armed and d.stats.steps == 0
    rep = _serve(svc, box)
    assert d.sentinel.report()["unexpected"] == 0
    assert rep["decisions_total"] == HEIGHTS * I
    assert rep["rejected_signature_device"] == HEIGHTS * I
    _same(d, offline_dense)


def test_native_adopt_branch_is_off_in_dense_mode(mesh, offline_dense):
    svc, d, box = _mesh_service(mesh, native_admission=True)
    assert svc.pipeline.native_phase_state() is None
    lane = ServePipeline(_driver(), VoteBatcher(I, V, n_slots=4,
                                                device="cpu"),
                         PUBKEYS, svc.ladder, window_predictor=lambda: (
                             np.zeros(I, np.int64), np.zeros(I, np.int64)))
    assert lane.native_phase_state() is not None     # the lane mode's
    rep = _serve(svc, box)
    assert svc.pipeline.native_phase_builds == 0
    assert rep["decisions_total"] == HEIGHTS * I
    _same(d, offline_dense)


def test_a_multi_rank_mesh_is_refused():
    driver = types.SimpleNamespace(
        mesh=types.SimpleNamespace(mesh=torch.arange(4).reshape(2, 2)))
    with pytest.raises(NotImplementedError, match="item 6"):
        ServePipeline(driver, None, PUBKEYS, ShapeLadder(rungs=(16,)))


def test_a_mesh_larger_than_the_world_is_refused(mesh):
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_mesh(2, 2, device_type="cpu")
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        make_hierarchical_mesh(2, 2, 2, device_type="cpu")
