"""Port differential: the driver's remainder (`agnes_tpu_torch.harness.
device_driver.DeviceDriver`) against the JAX `DeviceDriver`.

Against the twin, leaf for leaf and stat for stat: `run_heights`,
`set_proposer_table` (and its refusal of a table the device would index
wrongly), `equivocators_detected`, `step_async(lanes=None)` + `collect`,
and `_resolve_lane_chunk` for None, 0, negative and positive row counts
and "auto" at an explicit budget.  On the port alone (the twin's signed
step compiles a fused verify): a signed `step_async` + `collect` equals
`step_seq_signed`, "auto" under a forced small budget (4 chunks) equals
the unchunked run, "auto" on the CPU without a budget raises, a dense
`step_async` + `collect` equals `step_seq_signed_dense`, and
`state_copies` are independent of the live state.
"""

import functools

import numpy as np
import pytest

from agnes_tpu.harness.device_driver import DeviceDriver as JDriver
from agnes_tpu.utils import budget as jbudget
from agnes_tpu_torch import convert
from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.harness import device_driver as tdd
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.types import VoteType
from agnes_tpu_torch.utils import budget as tbudget
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V, FORGED, VALUE = 4, 4, 1, 7


def _same_driver(t, j):
    """Every state and tally leaf and every stat equal."""
    for part in ("state", "tally"):
        jt = getattr(j, part)
        for name, a, b in zip(jt._fields, jt,
                              convert.to_numpy(getattr(t, part))):
            np.testing.assert_array_equal(np.asarray(a), b,
                                          err_msg=f"{part}.{name}")
    for f in ("votes_ingested", "steps", "decisions_total"):
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    for f in ("decided", "decision_value", "decision_round"):
        np.testing.assert_array_equal(getattr(t.stats, f),
                                      getattr(j.stats, f), err_msg=f)


def _pair(**kw):
    return (DeviceDriver(I, V, device="cpu", **kw), JDriver(I, V, **kw))


def test_run_heights_matches_jax():
    t, j = _pair(advance_height=True)
    t.run_heights(2, slot=2)
    j.run_heights(2, slot=2)
    _same_driver(t, j)
    assert (t.state.height == 2).all() and t.stats.decisions_total == 2 * I
    with pytest.raises(ValueError):
        DeviceDriver(I, V, device="cpu").run_heights(1)


def test_proposer_table_matches_jax():
    flags = np.zeros((I, 4), bool)
    flags[:, ::2] = True                 # rounds 0, 2: period 2
    flags[1] = False                     # instance 1 never proposes
    t, j = _pair()
    t.set_proposer_table(flags, rotation_period=2)
    j.set_proposer_table(flags, rotation_period=2)
    # the round-entry step: instance 1 waits for a proposal, the others
    # propose (a PROPOSAL message in its stage)
    props = [(np.asarray(m.tag) == 2).any(axis=0).tolist()
             for m in (convert.to_numpy(t.step()), j.step())]
    assert props == [[True, False, True, True]] * 2
    for d in (t, j):
        d.step(phase=d.phase(0, VoteType.PREVOTE, 1))
        d.step(phase=d.phase(0, VoteType.PRECOMMIT, 1))
    _same_driver(t, j)
    # a round-varying table whose width is not a multiple of the
    # period: the twin asserts, the port raises ValueError
    with pytest.raises(AssertionError):
        j.set_proposer_table(flags, rotation_period=3)
    with pytest.raises(ValueError):
        t.set_proposer_table(flags, rotation_period=3)
    # a row-constant table is exact under any period
    const = np.ones((I, 4), bool)
    t.set_proposer_table(const, rotation_period=3)
    j.set_proposer_table(const, rotation_period=3)
    np.testing.assert_array_equal(t.proposer_flag.numpy(),
                                  np.asarray(j.proposer_flag))


def test_equivocators_detected_matches_jax():
    t, j = _pair()
    for d in (t, j):
        d.step()
        d.run_equivocation_phase(0, VoteType.PREVOTE, 1, 2, frac=0.5)
    assert t.equivocators_detected().tolist() == \
        np.asarray(j.equivocators_detected()).tolist() == [2] * I
    _same_driver(t, j)


def test_step_async_unsigned_matches_jax():
    t, j = _pair(advance_height=True)
    for _ in range(2):                   # two heights, queued
        for d, kw in ((t, {}), (j, {"donate": False})):
            d.step_async([d.empty_phase(),
                          d.phase(0, VoteType.PREVOTE, 1),
                          d.phase(0, VoteType.PRECOMMIT, 1)], **kw)
    # nothing is read back before collect
    assert t.stats.votes_ingested == 0 and not t.stats.decided.any()
    assert t.last_step_rejects is None
    t.collect()
    j.collect()
    _same_driver(t, j)
    assert t.stats.decisions_total == 2 * I
    assert t.block_until_ready() is t


@pytest.mark.parametrize("knob", [None, 0, -3, 1, 2, 3, 5, 100])
@pytest.mark.parametrize("n_lanes", [0, 8, 12, 32])
def test_resolve_lane_chunk_matches_jax(knob, n_lanes):
    t = DeviceDriver(I, V, device="cpu", verify_chunk=knob)
    j = JDriver(I, V, verify_chunk=knob)
    assert t._resolve_lane_chunk(n_lanes) == j._resolve_lane_chunk(n_lanes)


@pytest.mark.parametrize("room", [3, 100, 10**6])
@pytest.mark.parametrize("n_lanes", [32, 1000, 4096])
def test_resolve_auto_matches_jax_at_its_workspace(monkeypatch, room,
                                                  n_lanes):
    """With the twin's workspace constant the port's "auto" tile is the
    twin's; with the port's own it is the port's plan.  The budget
    leaves room for `room` lanes of the twin's workspace."""
    hbm = int((n_lanes * 512 + room * jbudget.VERIFY_WORKSPACE_LANE_BYTES)
              / 0.9) + 1
    t = DeviceDriver(I, V, device="cpu", verify_chunk="auto",
                     hbm_budget_bytes=hbm)
    j = JDriver(I, V, verify_chunk="auto", hbm_budget_bytes=hbm)
    own = tbudget.plan_lane_verify(n_lanes, hbm_bytes=hbm)
    assert t._resolve_lane_chunk(n_lanes) == (own.tile if own.chunked
                                              else None)
    monkeypatch.setattr(tdd, "plan_lane_verify", functools.partial(
        tbudget.plan_lane_verify,
        workspace_lane_bytes=jbudget.VERIFY_WORKSPACE_LANE_BYTES))
    t2 = DeviceDriver(I, V, device="cpu", verify_chunk="auto",
                      hbm_budget_bytes=hbm)
    assert t2._resolve_lane_chunk(n_lanes) == j._resolve_lane_chunk(n_lanes)


def test_auto_on_the_cpu_needs_a_budget():
    d = DeviceDriver(I, V, device="cpu", verify_chunk="auto")
    assert d._resolve_lane_chunk(0) is None
    with pytest.raises(ValueError, match="hbm_budget_bytes"):
        d._resolve_lane_chunk(32)


# --- the signed paths, on the port alone -------------------------------------

@pytest.fixture(scope="module")
def signed():
    """The phases and lanes of one signed height (both classes, the
    validator FORGED forged in both), built once."""
    seeds = fx.deterministic_seeds(V)
    pubkeys = fx.validator_pubkeys(seeds)
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    for typ in (0, 1):
        bat.add_arrays(*fx.full_mesh_cols(I, V, seeds, 0, typ, VALUE,
                                          forge_validator=FORGED))
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
    return [p for p, _ in phases], lanes


@pytest.fixture(scope="module")
def reference(signed):
    """The unchunked, collected step_seq_signed run of `signed`."""
    phases, lanes = signed
    ref = DeviceDriver(I, V, advance_height=True, device="cpu")
    ref.step_seq_signed([ref.empty_phase()] + phases, lanes)
    assert ref.all_decided() and ref.rejected_signature_device == 2 * I
    return ref


def _same_port(a, b):
    for part in ("state", "tally"):
        for x, y in zip(getattr(a, part), getattr(b, part)):
            assert x.equal(y), part
    assert a.rejected_signature_device == b.rejected_signature_device
    for f in ("votes_ingested", "steps", "decisions_total"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f
    for f in ("decided", "decision_value", "decision_round"):
        np.testing.assert_array_equal(getattr(a.stats, f),
                                      getattr(b.stats, f), err_msg=f)


def test_signed_step_async_and_forced_auto_equal_step_seq_signed(
        signed, reference):
    phases, lanes = signed
    ref = reference

    d = DeviceDriver(I, V, advance_height=True, device="cpu")
    d.step_async([d.empty_phase()] + phases, lanes)
    assert d.stats.votes_ingested == 0 and d.rejected_signature_device == 0
    assert int(d.last_step_rejects) == 2 * I
    d.collect()
    _same_port(d, ref)
    assert d.stats.votes_ingested == 2 * I * (V - 1)

    # "auto" under a budget that leaves room for 8 of the 32 lanes a
    # chunk: 4 verify calls, the same verdicts
    n = int(lanes.pub.shape[0])
    ws = tbudget.VERIFY_WORKSPACE_LANE_BYTES
    hbm = int((n * 512 + 10 * ws) / 0.9) + 1
    c = DeviceDriver(I, V, advance_height=True, device="cpu",
                     verify_chunk="auto", hbm_budget_bytes=hbm)
    assert c._resolve_lane_chunk(n) == 8
    assert tbudget.plan_lane_verify(n, hbm_bytes=hbm).n_chunks == 4
    c.step_seq_signed([c.empty_phase()] + phases, lanes)
    _same_port(c, ref)


def test_deferred_signed_step_settles_at_collect(signed, reference):
    phases, lanes = signed
    ref = reference
    d = DeviceDriver(I, V, advance_height=True, device="cpu",
                     defer_collect=True, verify_chunk=2)   # 8-lane chunks
    d.step_seq_signed([d.empty_phase()] + phases, lanes)
    assert not d.stats.decided.any() and d.stats.steps == 3
    assert d.all_decided()               # collects
    _same_port(d, ref)


def test_step_async_dense_equals_step_seq_signed_dense():
    seeds = fx.deterministic_seeds(V)
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    for typ in (0, 1):
        bat.add_arrays(*fx.full_mesh_cols(I, V, seeds, 0, typ, VALUE,
                                          forge_validator=FORGED))
    phases, dense = bat.build_phases_device_dense(fx.validator_pubkeys(seeds))
    phases = [p for p, _ in phases]
    ref = DeviceDriver(I, V, advance_height=True, device="cpu")
    ref_msgs = ref.step_seq_signed_dense([ref.empty_phase()] + phases, dense)
    assert ref.all_decided() and ref.rejected_signature_device == 2 * I

    d = DeviceDriver(I, V, advance_height=True, device="cpu")
    msgs = d.step_async([d.empty_phase()] + phases, dense)
    # nothing is read back before collect; the rejects stay [I] on the card
    assert d.stats.votes_ingested == 0 and not d.stats.decided.any()
    assert d.last_step_rejects.tolist() == [2] * I
    d.collect()
    _same_port(d, ref)
    for a, b in zip(msgs, ref_msgs):
        assert a.equal(b)
    assert d.stats.votes_ingested == 2 * I * (V - 1)


def test_state_copies_are_independent():
    d = DeviceDriver(I, V, advance_height=True, device="cpu")
    state, tally = d.state_copies()
    d.run_heights_fused(1)
    assert (d.state.height == 1).all() and (state.height == 0).all()
    state.round[0] = 7
    assert d.state.round[0] == 0
    for a, b in zip(tally, d.tally):
        assert a.data_ptr() != b.data_ptr()

