"""Port differential: the host state machine (`agnes_tpu_torch.core.
state_machine.apply`) against the JAX package's jax-free twin, and the
port's host <-> device codecs (`agnes_tpu_torch.device.encoding`).

The space is `tests/test_device_sm.py`'s exhaustive Step x EventTag x
guard enumeration (rounds, lock/valid configurations, pol_round
validity, values), plus the edge of the rounds domain (MAX_ROUND) and
the edge of the value-id domain.  On every case the port's `apply` must
return the twin's State and Message field for field; the port's batched
device state machine, reached through the port's codecs, must agree
with the port's host `apply`; and the codecs must equal the twin's leaf
for leaf.
"""

import dataclasses
import itertools

import numpy as np
import torch

from agnes_tpu.core import state_machine as jsm
from agnes_tpu.device import encoding as jenc
from agnes_tpu_torch.core import state_machine as sm
from agnes_tpu_torch.device import encoding as enc
from agnes_tpu_torch.device.state_machine import apply_batch
from agnes_tpu_torch.types import MAX_ROUND
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_device_sm import _cases

MAX_VALUE = 2**31 - 1


def _edge_cases():
    """States at the top of the rounds domain, events one round either
    side of them, values at both ends of the id domain."""
    for step, tag, s_round, value, lock in itertools.product(
            jsm.Step, jsm.EventTag, (MAX_ROUND - 1, MAX_ROUND),
            (0, MAX_VALUE - 1), (None, (MAX_ROUND - 1, MAX_VALUE - 1))):
        state = jsm.State(
            height=1, round=s_round, step=step,
            locked=jsm.RoundValue(*lock) if lock else None,
            valid=jsm.RoundValue(*lock) if lock else None)
        for r in sorted({s_round - 1, s_round, min(s_round + 1, MAX_ROUND)}):
            yield state, r, jsm.Event(tag, value=value,
                                      pol_round=min(r, MAX_ROUND - 1))


CASES = list(_cases()) + list(_edge_cases())


def _port_rv(rv):
    return None if rv is None else sm.RoundValue(rv.round, rv.value)


def _port_state(s: jsm.State) -> sm.State:
    return sm.State(height=s.height, round=s.round, step=sm.Step(int(s.step)),
                    locked=_port_rv(s.locked), valid=_port_rv(s.valid))


def _port_event(e: jsm.Event) -> sm.Event:
    return sm.Event(sm.EventTag(int(e.tag)), value=e.value,
                    pol_round=e.pol_round)


def _fields(x):
    """A frozen dataclass (or None) as nested tuples; the enums of both
    packages are IntEnums, so equal codes compare equal."""
    return None if x is None else dataclasses.astuple(x)


def test_apply_equals_the_twin_on_the_enumerated_space():
    assert len(CASES) > 5000
    mismatches = []
    for s, r, ev in CASES:
        want_s, want_m = jsm.apply(s, r, ev)
        got_s, got_m = sm.apply(_port_state(s), r, _port_event(ev))
        assert type(got_s) is sm.State
        if (_fields(got_s), _fields(got_m)) != (_fields(want_s),
                                                 _fields(want_m)):
            mismatches.append((s, r, ev))
    assert not mismatches, f"{len(mismatches)} cases, first {mismatches[:3]}"


def _device_apply(states, events):
    """The port's batched device state machine on host-encoded cases."""
    st = enc.stack_pytree([enc.encode_state(s) for s in states])
    ev = enc.stack_pytree([enc.encode_event(r, e) for r, e in events])
    out_s, out_m = apply_batch(
        enc.DeviceState(*[torch.from_numpy(x) for x in st]),
        enc.DeviceEvent(*[torch.from_numpy(x) for x in ev]))
    return ([x.numpy() for x in out_s], [x.numpy() for x in out_m])


def test_device_plane_agrees_with_host_apply_through_the_codecs():
    states = [_port_state(s) for s, _, _ in CASES]
    events = [(r, _port_event(e)) for _, r, e in CASES]
    os_, om = _device_apply(states, events)
    bad = 0
    for i, (s, (r, e)) in enumerate(zip(states, events)):
        want_s, want_m = sm.apply(s, r, e)
        got_s = enc.decode_state(enc.DeviceState(*[x[i] for x in os_]))
        got_m = enc.decode_message(enc.DeviceMessage(*[x[i] for x in om]))
        bad += (got_s, got_m) != (want_s, want_m)
    assert bad == 0, f"{bad} cases where device != host"


def test_codecs_equal_the_twin_leaf_for_leaf():
    states = [_port_state(s) for s, _, _ in CASES]
    events = [(r, _port_event(e)) for _, r, e in CASES]
    for (js, r, je), s, (_, e) in zip(CASES, states, events):
        for mine, theirs in ((enc.encode_state(s), jenc.encode_state(js)),
                             (enc.encode_event(r, e),
                              jenc.encode_event(r, je))):
            assert mine._fields == theirs._fields
            for a, b in zip(mine, theirs):
                assert a.dtype == np.int32 and a == b
    # the decoders on the device plane's outputs (numpy rows and tensors)
    os_, om = _device_apply(states, events)
    for i in range(0, len(CASES), 7):
        row_s = [x[i] for x in os_]
        row_m = [x[i] for x in om]
        want_s = jenc.decode_state(jenc.DeviceState(*row_s))
        assert _fields(enc.decode_state(enc.DeviceState(*row_s))) == \
            _fields(want_s)
        assert _fields(enc.decode_state(
            enc.DeviceState(*[torch.tensor(x) for x in row_s]),
            height=5)) == _fields(dataclasses.replace(want_s, height=5))
        assert _fields(enc.decode_message(enc.DeviceMessage(*row_m))) == \
            _fields(jenc.decode_message(jenc.DeviceMessage(*row_m)))
