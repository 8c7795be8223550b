"""Port differential: the bridge's densify (`agnes_tpu_torch.bridge
.ingest.VoteBatcher.build_phases`, unsigned) against the JAX package's
`VoteBatcher`, phase for phase and counter for counter, on seeded
hostile traffic: malformed rows, stale heights, duplicates and
equivocations (layered phases), several rounds and values per build,
slot overflow spilling to the host tally, future rounds held back until
`sync_device` rotates the window, and past rounds tallied on the host
(a late precommit quorum surfacing through `drain_host_events`).
"""

import numpy as np
import pytest

from agnes_tpu.bridge.ingest import VoteBatcher as JBatcher
from agnes_tpu_torch.bridge.ingest import VoteBatcher
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V, S = 6, 5, 2


def _traffic(rng, heights, base, n=70):
    inst = rng.randint(-1, I + 1, n)
    ic = np.clip(inst, 0, I - 1)
    val = rng.randint(0, V + 1, n)
    height = heights[ic] + (rng.rand(n) < 0.1)
    round_ = base[ic] + rng.randint(-1, 6, n)
    typ = rng.choice([0, 1, 1, 0, 2], n)
    value = rng.choice([-1, -3, 3, 3, 9, 11, 2**31], n)
    return inst, val, height, np.maximum(round_, 0), typ, value


def _late_quorum(heights, base):
    """Every validator precommits value 3 in instance 0's previous
    round: lands in the host tally once the window has moved past it."""
    r = int(base[0]) - 1
    return ([0] * V, list(range(V)), [int(heights[0])] * V, [r] * V,
            [1] * V, [3] * V)


def _same_phases(tp, jp):
    assert [n for _, n in tp] == [n for _, n in jp]
    for (t, _), (j, _) in zip(tp, jp):
        for name, a, b in zip(t._fields, t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_build_phases_vs_jax_bridge(seed):
    rng = np.random.RandomState(seed)
    tb = VoteBatcher(I, V, n_slots=S, device="cpu")
    jb = JBatcher(I, V, n_slots=S)
    powers = rng.randint(1, 4, V)
    tb.set_validators(powers)
    jb.set_validators(powers)
    heights = np.zeros(I, np.int64)
    base = np.zeros(I, np.int64)
    n_phases = n_events = n_held = 0
    for tick in range(5):
        cols = _traffic(rng, heights, base)
        tb.add_arrays(*cols)
        jb.add_arrays(*cols)
        if tick >= 2:
            late = _late_quorum(heights, base)
            tb.add_arrays(*late)
            jb.add_arrays(*late)
        tp, jp = tb.build_phases(), jb.build_phases()
        _same_phases(tp, jp)
        n_phases += len(tp)
        for f in ("rejected_malformed", "overflow_votes",
                  "dropped_stale_height", "dropped_held_overflow"):
            assert getattr(tb, f) == getattr(jb, f), f
        assert tb._held_n == jb.held_votes
        events = tb.drain_host_events()
        assert events == jb.drain_host_events()
        n_events += len(events)
        n_held = max(n_held, tb._held_n)
        # the device plane moved on: rotate windows, advance some heights
        base = base + rng.randint(0, 2, I)
        heights = heights + (rng.rand(I) < 0.2)
        tb.sync_device(base, heights)
        jb.sync_device(base, heights)
        for i in range(I):
            for s in range(S):
                assert tb.decode_slot(i, s) == jb.decode_slot(i, s)
    assert n_phases > 5 and n_events > 0 and n_held > 0
    assert tb.overflow_votes > 0
    assert tb.rejected_malformed > 0 and tb.dropped_stale_height > 0


def test_positional_heights_read_as_the_twin_reads_them():
    """The twin's fourth positional parameter is `heights`: the port once
    took `n_rounds` there, so `VoteBatcher(I, V, S, heights)` silently
    ran a window of `heights` rounds from height 0.  Both packages now
    read the same arguments the same way, and a build at those heights
    drops the same stale votes."""
    heights = np.array([2, 0, 1, 3, 2, 2], np.int64)
    tb = VoteBatcher(I, V, S, heights, device="cpu")
    jb = JBatcher(I, V, S, heights)
    assert (tb.W, jb.W) == (4, 4)
    np.testing.assert_array_equal(tb.heights, jb.heights)
    rng = np.random.RandomState(7)
    cols = list(_traffic(rng, heights, np.zeros(I, np.int64)))
    cols[2] = np.maximum(cols[2] - (rng.rand(len(cols[2])) < 0.4), 0)
    tb.add_arrays(*cols)
    jb.add_arrays(*cols)
    _same_phases(tb.build_phases(), jb.build_phases())
    assert tb.dropped_stale_height == jb.dropped_stale_height > 0


@pytest.mark.parametrize("held_cap", [None, 9])
def test_constructor_state_equals_twin(held_cap):
    """`heights`, `n_rounds`, `powers`, `held_cap`, `verify_mode` and
    `msm_leaf`, passed positionally in the twin's order, set the state
    the twin's do; future rounds past the cap are dropped as the twin
    drops them."""
    powers = np.array([3, 1, 2, 1, 1], np.int64)
    args = (I, V, S, np.ones(I, np.int64), 2, powers, held_cap, "lanes", 8)
    tb, jb = VoteBatcher(*args, device="cpu"), JBatcher(*args)
    for f in ("I", "V", "W", "held_cap", "verify_mode", "msm_leaf"):
        assert getattr(tb, f) == getattr(jb, f), f
    np.testing.assert_array_equal(tb.powers, jb.powers)
    np.testing.assert_array_equal(tb.heights, jb.heights)
    n = 40
    cols = (np.arange(n) % I, np.arange(n) % V, np.ones(n, np.int64),
            np.arange(n) % 7, np.zeros(n, np.int64), np.full(n, 3))
    tb.add_arrays(*cols)
    jb.add_arrays(*cols)
    _same_phases(tb.build_phases(), jb.build_phases())
    assert tb._held_n == jb.held_votes > 0
    assert tb.dropped_held_overflow == jb.dropped_held_overflow
    for bad in (dict(held_cap=0), dict(verify_mode="batch"),
                dict(msm_leaf=1)):
        with pytest.raises(ValueError):
            JBatcher(I, V, S, **bad)
        with pytest.raises(ValueError):
            VoteBatcher(I, V, S, device="cpu", **bad)
