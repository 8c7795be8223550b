"""Integer encodings of State/Event/Message for the device plane.

Twin of `agnes_tpu.device.encoding`: the enum codes are the canonical
ones from `core.state_machine`; this module defines the tensor layout
(every leaf `torch.int32`, one element per instance) and the one rule
the whole port follows for placement: entry points take `device=`,
default "cuda", and raise when that card is absent — nothing quietly
falls back to the CPU (`resolve_device`).

Layout decisions (unchanged from the JAX twin):

* `Option<RoundValue>` (locked/valid, state_machine.rs:29-30) flattens
  to a (round, value) int pair with round == -1 meaning None.
* Nil values (`Option<Value>::None`, lib.rs:26) are value id -1 (NIL_ID).
* A Message flattens to (tag, round, value, aux) where aux carries the
  proposal's pol_round, the vote's type, or the timeout's step; tag
  NONE encodes Rust's Option::None return (state_machine.rs:174).

The host <-> device codecs (`encode_state`, `decode_state`,
`encode_event`, `decode_message`) are the twin's: the encoders give
numpy int32 scalars (cheap, no device dispatch; `stack_pytree` batches
them and `convert` moves them over), the decoders read one instance's
leaves as numpy scalars or 0-d / one-element tensors on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from agnes_tpu_torch.core import state_machine as sm
from agnes_tpu_torch.types import NIL_ID, Vote, VoteType

I32 = torch.int32


def resolve_device(device) -> torch.device:
    """The port's placement rule: a CUDA device must exist when asked
    for (no silent CPU fallback); "cpu" must be asked for explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available;"
            " pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def full(shape, value: int, device, dtype=I32) -> torch.Tensor:
    """`torch.full` with the dtype pinned (a bare Python int would make
    it int64)."""
    return torch.full(shape, value, dtype=dtype, device=device)


class DeviceState(NamedTuple):
    """Per-instance consensus state; every leaf is an int32 [I] tensor.

    `height` mirrors State.height (state_machine.rs:25): the transition
    function never reads it, but the height-advance stage increments it
    when installing the next instance after a decision."""

    round: torch.Tensor
    step: torch.Tensor
    locked_round: torch.Tensor   # -1 = not locked
    locked_value: torch.Tensor
    valid_round: torch.Tensor    # -1 = no valid value
    valid_value: torch.Tensor
    height: torch.Tensor

    @classmethod
    def new(cls, batch_shape: Tuple[int, ...] = (), height: int = 0,
            device="cuda") -> "DeviceState":
        """Fresh instances at round 0, NewRound (state_machine.rs:35-43)."""
        dev = resolve_device(device)
        return cls(round=full(batch_shape, 0, dev),
                   step=full(batch_shape, 0, dev),
                   locked_round=full(batch_shape, -1, dev),
                   locked_value=full(batch_shape, -1, dev),
                   valid_round=full(batch_shape, -1, dev),
                   valid_value=full(batch_shape, -1, dev),
                   height=full(batch_shape, height, dev))


class DeviceEvent(NamedTuple):
    """An event plus the round it belongs to (the `round` argument of
    apply, state_machine.rs:183)."""

    tag: torch.Tensor
    round: torch.Tensor
    value: torch.Tensor      # NIL_ID when the tag carries no value
    pol_round: torch.Tensor  # PROPOSAL only; -1 otherwise


class DeviceMessage(NamedTuple):
    tag: torch.Tensor
    round: torch.Tensor
    value: torch.Tensor  # NIL_ID = nil vote / no value
    aux: torch.Tensor    # pol_round | vote type | timeout step


# ---------------------------------------------------------------------------
# Host <-> device conversion (tests, checkpointing)
# ---------------------------------------------------------------------------


def encode_state(s: sm.State) -> DeviceState:
    """Host State -> numpy int32 leaves (no device dispatch)."""
    def rv(x):
        return (x.round, x.value) if x is not None else (-1, -1)

    lr, lv = rv(s.locked)
    vr, vv = rv(s.valid)
    a = np.int32
    return DeviceState(a(s.round), a(int(s.step)), a(lr), a(lv), a(vr),
                       a(vv), a(s.height))


def decode_state(d: DeviceState, height: Optional[int] = None) -> sm.State:
    """One instance's leaves -> host State (`height` overrides the
    leaf's)."""
    g = int
    locked = (sm.RoundValue(g(d.locked_round), g(d.locked_value))
              if g(d.locked_round) >= 0 else None)
    valid = (sm.RoundValue(g(d.valid_round), g(d.valid_value))
             if g(d.valid_round) >= 0 else None)
    h = g(d.height) if height is None else height
    return sm.State(height=h, round=g(d.round), step=sm.Step(g(d.step)),
                    locked=locked, valid=valid)


def encode_event(round: int, ev: sm.Event) -> DeviceEvent:
    """Host (round, Event) -> numpy int32 leaves."""
    a = np.int32
    value = ev.value if ev.value is not None else NIL_ID
    return DeviceEvent(a(int(ev.tag)), a(round), a(value), a(ev.pol_round))


def decode_message(m: DeviceMessage) -> Optional[sm.Message]:
    """One instance's message leaves -> host Message (None for tag
    NONE)."""
    tag = sm.MsgTag(int(m.tag))
    rnd, val, aux = int(m.round), int(m.value), int(m.aux)
    if tag == sm.MsgTag.NONE:
        return None
    if tag == sm.MsgTag.NEW_ROUND:
        return sm.Message.new_round(rnd)
    if tag == sm.MsgTag.PROPOSAL:
        return sm.Message.proposal_msg(rnd, val, aux)
    if tag == sm.MsgTag.VOTE:
        value = None if val == NIL_ID else val
        vote = Vote(typ=VoteType(aux), round=rnd, value=value)
        return sm.Message(sm.MsgTag.VOTE, round=rnd, vote=vote)
    if tag == sm.MsgTag.TIMEOUT:
        return sm.Message.timeout_msg(rnd, sm.TimeoutStep(aux))
    return sm.Message.decision_msg(rnd, val)


def stack_pytree(items):
    """Stack a list of same-type NamedTuples of scalars into one NamedTuple
    of [n] numpy int32 arrays (host side; `convert` moves them over)."""
    t = type(items[0])
    return t(*[np.asarray([getattr(e, f) for e in items], dtype=np.int32)
               for f in t._fields])


def stack_tuples(items):
    """Stack a list of same-type NamedTuples of tensors along a new
    leading axis (the port's `jax.tree.map(jnp.stack, ...)`)."""
    t = type(items[0])
    return t(*[torch.stack([getattr(e, f) for e in items])
               for f in t._fields])
