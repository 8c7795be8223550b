"""Carry state across from the JAX package, as numpy arrays.

`state_from_jax` / `tally_from_jax` turn the leaves of a JAX
`DeviceState` / `TallyState` (any sequence of array-likes in field
order, e.g. `[np.asarray(x) for x in jax_state]`) into the port's
tensors; `array_from_jax` does the same for `powers`, `proposer_flag`
and the other loose arrays.  `bls_registry_from_jax` carries a JAX
`BlsKeyRegistry`'s state into the port's lane registry, so both lanes
run over the same keys.  `to_numpy` is the inverse the differential
tests compare with.  No JAX import is needed: numpy is the interchange.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from agnes_tpu_torch.device.encoding import DeviceState, resolve_device
from agnes_tpu_torch.device.tally import TallyState

_DTYPES = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32}


def array_from_jax(x, device="cuda") -> torch.Tensor:
    """One int32 or bool array -> a tensor of the same dtype on
    `device` (other dtypes are refused: the device plane is int32/bool)."""
    a = np.asarray(x)
    if a.dtype not in _DTYPES:
        raise TypeError(f"expected int32 or bool, got {a.dtype}")
    # copy: arrays fetched from JAX are read-only views
    return torch.from_numpy(np.array(a)).to(resolve_device(device))


def state_from_jax(np_leaves: Sequence, device="cuda") -> DeviceState:
    return DeviceState(*[array_from_jax(x, device) for x in np_leaves])


def tally_from_jax(np_leaves: Sequence, device="cuda") -> TallyState:
    return TallyState(*[array_from_jax(x, device) for x in np_leaves])


def to_numpy(tree):
    """A tensor or NamedTuple of tensors -> the same with numpy leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return type(tree)(*[to_numpy(x) for x in tree])


def bls_registry_from_jax(reg):
    """A JAX `serve.bls_lane.BlsKeyRegistry` (any object with its
    attributes) -> the port's registry with the same state: compressed
    keys, decompressed points (plain Python ints), packed limbs, powers,
    PoP flags, strikes, quarantine flags and epoch, copied as numpy."""
    from agnes_tpu_torch.serve.bls_lane import BlsKeyRegistry

    return BlsKeyRegistry.from_state(
        reg.pk_bytes, reg.pk_points, np.asarray(reg.pk_limbs),
        np.asarray(reg.powers), np.asarray(reg.pop_ok),
        np.asarray(reg.forged_strikes), np.asarray(reg.quarantined),
        reg.epoch)
