"""Port differential: the batched device state machine
(`agnes_tpu_torch.device.state_machine.apply_batch`) against the JAX
`agnes_tpu.device.state_machine.apply_batch`, leaf for leaf, on the
exhaustive Step x Event x guard enumeration of tests/test_device_sm.py,
on the MAX_ROUND edge, and on a seeded random fuzz of states/events.
"""

import numpy as np
import pytest

from agnes_tpu.core.state_machine import EventTag, Step
from agnes_tpu.device.encoding import (
    DeviceEvent as JEvent,
    DeviceState as JState,
    encode_event,
    encode_state,
    stack_pytree,
)
from agnes_tpu.device.state_machine import apply_batch as jax_apply
from agnes_tpu.types import MAX_ROUND
from agnes_tpu_torch.convert import array_from_jax, to_numpy
from agnes_tpu_torch.device.encoding import DeviceEvent, DeviceState
from agnes_tpu_torch.device.encoding import stack_pytree as port_stack
from agnes_tpu_torch.device.state_machine import apply_batch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_device_sm import _cases


def _run_both(state_np: JState, event_np: JEvent):
    js, jm = jax_apply(state_np, event_np)
    ts, tm = apply_batch(
        DeviceState(*[array_from_jax(x, "cpu") for x in state_np]),
        DeviceEvent(*[array_from_jax(x, "cpu") for x in event_np]))
    return (js, jm), (to_numpy(ts), to_numpy(tm))


def _assert_same(jax_out, port_out):
    for j_tree, t_tree in zip(jax_out, port_out):
        for name, j, t in zip(j_tree._fields, j_tree, t_tree):
            np.testing.assert_array_equal(np.asarray(j), t, err_msg=name)
            assert t.dtype == np.int32, name


def test_exhaustive_differential_vs_jax():
    cases = list(_cases())
    assert len(cases) > 5000
    st = stack_pytree([encode_state(s) for (s, _, _) in cases])
    ev = stack_pytree([encode_event(r, e) for (_, r, e) in cases])
    # the port's host stacker lays the batch out identically
    for ours, theirs in ((port_stack([encode_state(s) for s, _, _ in cases]),
                          st),
                         (port_stack([encode_event(r, e) for _, r, e in cases]),
                          ev)):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32
    _assert_same(*_run_both(st, ev))


def test_round_edge_at_max_round():
    """TimeoutPrecommit / RoundSkip at the top of the rounds domain:
    the clamp before +1 must keep int32 from wrapping, as in JAX."""
    n = 6
    i32 = lambda v: np.full(n, v, np.int32)  # noqa: E731
    tags = np.array([EventTag.TIMEOUT_PRECOMMIT, EventTag.ROUND_SKIP,
                     EventTag.PRECOMMIT_VALUE, EventTag.TIMEOUT_PRECOMMIT,
                     EventTag.ROUND_SKIP, EventTag.NEW_ROUND], np.int32)
    rounds = np.array([MAX_ROUND, MAX_ROUND, MAX_ROUND, MAX_ROUND - 1,
                       MAX_ROUND - 1, MAX_ROUND], np.int32)
    st = JState(round=rounds.copy(), step=i32(int(Step.PREVOTE)),
                locked_round=i32(-1), locked_value=i32(-1),
                valid_round=i32(-1), valid_value=i32(-1), height=i32(3))
    st = st._replace(round=np.where(tags == EventTag.ROUND_SKIP,
                                    rounds - 1, rounds).astype(np.int32))
    ev = JEvent(tag=tags, round=rounds, value=i32(5), pol_round=i32(-1))
    _assert_same(*_run_both(st, ev))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_fuzz_vs_jax(seed):
    rng = np.random.RandomState(seed)
    n = 4000

    def r(lo, hi):
        return rng.randint(lo, hi, n).astype(np.int32)

    st = JState(round=r(0, 4), step=r(0, 5), locked_round=r(-1, 4),
                locked_value=r(-1, 4), valid_round=r(-1, 4),
                valid_value=r(-1, 4), height=r(0, 3))
    ev = JEvent(tag=r(-1, 13), round=r(0, 5), value=r(-1, 4),
                pol_round=r(-2, 4))
    _assert_same(*_run_both(st, ev))
