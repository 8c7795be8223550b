"""The device tally's quorum products near the int32 limit: the port
against the host oracle (`core.round_votes`, Python integers), with the
JAX twin's result on the same input beside it.

The twin computes `3 * w > 2 * total` and `3 * w_skip > total` in int32
and wraps: a single validator of power 715,827,883 never reaches quorum,
and at a total of 2^31 - 1 one third of the stake decides.  The port
compares in int64 (`agnes_tpu_torch/device/tally.py`) and refuses a
power table whose total does not fit int32.  Both drivers run the same
schedules at I = 2 instances on the CPU.
"""

import numpy as np
import pytest

from agnes_tpu.harness.device_driver import DeviceDriver as JDriver
from agnes_tpu_torch.core.round_votes import (ThreshKind, VoteCount,
                                              is_one_third)
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.types import VoteType
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I = 2
VALUE = 1
POWER_1 = 715_827_883                       # 3 * POWER_1 > 2^31
MAX_TABLE = [715_827_882] * 3 + [1]         # total 2^31 - 1


def _pair(powers):
    jd = JDriver(I, len(powers))
    td = DeviceDriver(I, len(powers), device="cpu")
    for d in (jd, td):
        d.set_validators(np.asarray(powers))
    return jd, td


def _oracle_decides(powers, voters) -> bool:
    """Whether `voters`' precommits for VALUE reach quorum by the
    host oracle (their prevotes reach it exactly when these do)."""
    count = VoteCount(total=int(sum(powers)))
    th = None
    for v in voters:
        th = count.add(VALUE, int(powers[v]))
    return th is not None and th.kind == ThreshKind.VALUE


def _vote(d, typ, offset, frac):
    d.step(phase=d.phase(0, typ, VALUE, frac=frac, offset=offset))


@pytest.mark.parametrize("powers,offset,frac", [
    ([POWER_1], 0, 1.0),                    # one validator holds it all
    (MAX_TABLE, 0, 0.25),                   # one third of 2^31 - 1
    (MAX_TABLE, 0, 1.0),                    # every validator of 2^31 - 1
])
def test_quorum_near_int32_matches_oracle(powers, offset, frac):
    voters = range(offset, offset + round(frac * len(powers)))
    want = _oracle_decides(powers, voters)
    jd, td = _pair(powers)
    for d in (jd, td):
        d.step()
        _vote(d, VoteType.PREVOTE, offset, frac)
        _vote(d, VoteType.PRECOMMIT, offset, frac)
    assert td.stats.decided.tolist() == [want] * I
    if want:
        assert td.stats.decision_value.tolist() == [VALUE] * I
    # the twin's int32 products: wrong on the first two tables
    twin = jd.stats.decided.tolist()
    if frac < 1.0 or len(powers) == 1:
        assert twin == [not want] * I, "the twin's int32 quorum wrapped"
    else:
        assert twin == [want] * I


def test_round_skip_near_int32_matches_oracle():
    """Validators 2 and 3 (715,827,883 of 2^31 - 1) prevote round 1:
    more than a third, so the oracle skips to round 1; the twin's
    `3 * w_skip` wraps negative and stays in round 0."""
    voters = [2, 3]
    assert is_one_third(sum(MAX_TABLE[v] for v in voters), sum(MAX_TABLE))
    jd, td = _pair(MAX_TABLE)
    for d in (jd, td):
        d.step()
        d.step(phase=d.phase(1, VoteType.PREVOTE, VALUE, frac=0.5, offset=2))
    assert td.state.round.tolist() == [1] * I
    assert np.asarray(jd.state.round).tolist() == [0] * I


@pytest.mark.parametrize("powers", [[2**31 - 1, 1], [2**30] * 2, [-1, 5],
                                    [2**31, 0]])
def test_power_table_beyond_int32_refused(powers):
    td = DeviceDriver(I, len(powers), device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        td.set_validators(np.asarray(powers, np.int64))
    td.set_validators(np.asarray([2**31 - 2, 1][:len(powers)], np.int64))
    assert int(td.total) == 2**31 - 1
