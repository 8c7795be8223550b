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
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

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
