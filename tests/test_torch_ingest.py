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
