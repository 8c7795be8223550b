"""Port differential: the fused consensus step (`agnes_tpu_torch.device
.step`) against `agnes_tpu.device.step`, leaf for leaf — one step on
`__graft_entry__._example_args`, step sequences on the driver schedules
(honest, nil round, equivocation), fused honest heights, and the port's
DeviceDriver against the JAX DeviceDriver on its canned schedules.  The
port's state starts from `convert.state_from_jax` / `tally_from_jax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _example_args
from agnes_tpu.core.state_machine import EventTag
from agnes_tpu.device import step as js
from agnes_tpu.harness.device_driver import DeviceDriver as JDriver
from agnes_tpu.types import NIL_ID, VoteType
from agnes_tpu_torch import convert
from agnes_tpu_torch.device import step as ts
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V = 8, 8


def _np(tree):
    return [np.asarray(x) for x in tree]


def _port_args(jargs):
    """JAX (state, tally, ext, phase, powers, total, pflag, pval) ->
    the port's, through numpy."""
    state, tally, ext, phase, *rest = jargs
    t = lambda x: convert.array_from_jax(x, "cpu")  # noqa: E731
    return (convert.state_from_jax(_np(state), "cpu"),
            convert.tally_from_jax(_np(tally), "cpu"),
            ts.ExtEvent(*[t(x) for x in ext]),
            ts.VotePhase(*[t(x) for x in phase]),
            *[t(x) for x in rest])


def _assert_outputs(jout, tout):
    for part in ("state", "tally", "msgs"):
        jt, tt = getattr(jout, part), convert.to_numpy(getattr(tout, part))
        for name, j, t in zip(jt._fields, jt, tt):
            np.testing.assert_array_equal(np.asarray(j), t,
                                          err_msg=f"{part}.{name}")
            assert t.dtype == np.asarray(j).dtype, f"{part}.{name}"


@pytest.mark.parametrize("advance_height", [False, True])
def test_consensus_step_example_args(advance_height):
    jargs = _example_args(I, V)
    jout = js.consensus_step_jit(*jargs, advance_height=advance_height)
    tout = ts.consensus_step(*_port_args(jargs),
                             advance_height=advance_height)
    _assert_outputs(jout, tout)


def _schedule(name):
    """(driver, [(ext, phase)] * 5) for a JAX driver schedule."""
    d = JDriver(I, V, proposer_is_self=name != "nil_round",
                advance_height=True)
    none, empty = d.ext(), d.empty_phase()
    PV, PC = VoteType.PREVOTE, VoteType.PRECOMMIT
    if name == "honest":
        seq = [(none, empty), (none, d.phase(0, PV, 1)),
               (none, d.phase(0, PC, 1)), (none, empty), (none, empty)]
    elif name == "nil_round":
        seq = [(none, empty),
               (d.ext(int(EventTag.TIMEOUT_PROPOSE), 0), empty),
               (none, d.phase(0, PV, NIL_ID)),
               (none, d.phase(0, PC, NIL_ID)),
               (d.ext(int(EventTag.TIMEOUT_PRECOMMIT), 0), empty)]
    else:  # equivocation: half the validators re-vote another value
        seq = [(none, empty), (none, d.phase(0, PV, 1)),
               (none, d.phase(0, PV, 2, frac=0.5)),
               (none, d.phase(0, PC, 1)), (none, empty)]
    return d, seq


@pytest.mark.parametrize("name", ["honest", "nil_round", "equivocation"])
def test_consensus_step_seq_schedules(name):
    d, seq = _schedule(name)
    exts = jax.tree.map(lambda *xs: jnp.stack(xs), *[e for e, _ in seq])
    phases = jax.tree.map(lambda *xs: jnp.stack(xs), *[p for _, p in seq])
    jargs = (d.state, d.tally, exts, phases, d.powers, d.total,
             d.proposer_flag, d.propose_value)
    jout = js.consensus_step_seq_jit(*jargs, advance_height=True)
    tout = ts.consensus_step_seq(*_port_args(jargs), advance_height=True)
    _assert_outputs(jout, tout)
    tags = np.asarray(jout.msgs.tag)
    if name == "honest":
        assert (np.asarray(jout.state.height) == 1).all()
    if name == "nil_round":
        assert (np.asarray(jout.state.round) == 1).all()
    if name == "equivocation":
        assert np.asarray(jout.tally.equiv).sum() == I * V // 2
    assert tags.shape == (5, ts.N_STAGES, I)


@pytest.mark.parametrize("frac", [1.0, 0.75])
def test_honest_heights(frac):
    d = JDriver(I, V, advance_height=True)
    voters = jnp.arange(V) < int(np.floor(frac * V + 0.5))
    slots = (jnp.where(voters[None, :], 1, -1).astype(jnp.int32)
             * jnp.ones((I, 1), jnp.int32))
    mask = jnp.broadcast_to(voters[None, :], (I, V))
    jargs = (d.state, d.tally, slots, mask, d.powers, d.total,
             d.proposer_flag, d.propose_value)
    jout = js.honest_heights_jit(*jargs, heights=2)
    state, tally, *rest = jargs
    t = lambda x: convert.array_from_jax(x, "cpu")  # noqa: E731
    tout = ts.honest_heights(convert.state_from_jax(_np(state), "cpu"),
                             convert.tally_from_jax(_np(tally), "cpu"),
                             *[t(x) for x in rest], heights=2)
    _assert_outputs(jout, tout)
    assert (np.asarray(jout.state.height) == 2).all()


def _drive(d, scenario):
    if scenario == "honest":
        d.run_honest_round(0, slot=1)
    elif scenario == "nil_then_proposed":
        d.run_nil_round(0)
        d.run_proposed_round(1, slot=2)
    elif scenario == "equivocation":
        d.step()
        d.run_equivocation_phase(0, VoteType.PREVOTE, 1, 2, frac=0.5)
        d.step(phase=d.phase(0, VoteType.PRECOMMIT, 1))
    elif scenario == "weighted":
        # validator 0 alone holds more than 1/3: the other 7 fall short
        d.set_validators(np.array([4] + [1] * (V - 1)))
        d.step()
        d.step(phase=d.phase(0, VoteType.PREVOTE, 1, offset=1))
        d.step(phase=d.phase(0, VoteType.PREVOTE, 1, frac=0.125))
        d.step(phase=d.phase(0, VoteType.PRECOMMIT, 1))
    else:  # fused heights, then the same sequence as one step_seq
        d.run_heights_fused(2)
        d.step_seq([d.empty_phase(), d.phase(0, VoteType.PREVOTE, 1),
                    d.phase(0, VoteType.PRECOMMIT, 1)])


@pytest.mark.parametrize("scenario", ["honest", "nil_then_proposed",
                                      "equivocation", "weighted",
                                      "heights"])
def test_driver_schedules_vs_jax_driver(scenario):
    """The port's DeviceDriver against the JAX DeviceDriver on the canned
    schedules: final state and tally leaf for leaf, and the collected
    decision stats."""
    kw = dict(proposer_is_self=scenario != "nil_then_proposed",
              advance_height=scenario in ("honest", "heights"))
    jd, td = JDriver(I, V, **kw), DeviceDriver(I, V, device="cpu", **kw)
    _drive(jd, scenario)
    _drive(td, scenario)
    for part in ("state", "tally"):
        jt, tt = getattr(jd, part), convert.to_numpy(getattr(td, part))
        for name, j, t in zip(jt._fields, jt, tt):
            np.testing.assert_array_equal(np.asarray(j), t,
                                          err_msg=f"{part}.{name}")
    for f in ("steps", "votes_ingested", "decisions_total"):
        assert getattr(td.stats, f) == getattr(jd.stats, f), f
    for f in ("decided", "decision_value", "decision_round"):
        np.testing.assert_array_equal(getattr(td.stats, f),
                                      getattr(jd.stats, f), err_msg=f)
    assert td.all_decided() == jd.all_decided()
