"""Join device equivocation flags to slashable signed evidence (twin of
`agnes_tpu.bridge.evidence`).

The device tally flags double-signers as a dense [instances, validators]
bool plane (`DeviceDriver.tally.equiv`).  A flag alone proves nothing to
a third party; the proof is the two conflicting signed votes, which the
ingestion bridge retains (`VoteBatcher._log`).  `collect_device_evidence`
sweeps the flags and pulls each flagged validator's conflicting pair in
one walk of the log (`VoteBatcher.signed_evidence_many`), and
`verify_evidence` is the third party's check of one record.

Waiting for a later slice: the native ingest loop's bridge (its raw
96-byte records), ROADMAP §1 item 4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from agnes_tpu_torch.bridge.ingest import (VoteBatcher, WireVote,
                                           vote_messages_np)
from agnes_tpu_torch.crypto import ed25519_ref


@dataclass(frozen=True)
class DeviceEvidence:
    """One device-detected double-sign with its slashable proof."""

    instance: int
    validator: int
    first: WireVote
    second: WireVote


def collect_device_evidence(flags, bridge: VoteBatcher
                            ) -> List[DeviceEvidence]:
    """Sweep a device equivocation plane and return the signed proofs,
    one record per flagged (instance, validator) in row-major order.

    `flags` is the [I, V] bool plane `DeviceDriver.tally.equiv` (a
    tensor on any device, or an array); `bridge` is the VoteBatcher
    that fed the device and so holds the retained votes.  Flagged cells
    whose conflicting votes are no longer in the log, or were ingested
    without signatures, are skipped: they prove nothing to a third
    party."""
    if not isinstance(bridge, VoteBatcher):
        raise TypeError(f"collect_device_evidence takes a VoteBatcher, "
                        f"not {type(bridge).__name__}")
    f = flags.cpu().numpy() if isinstance(flags, torch.Tensor) \
        else np.asarray(flags)
    inst, val = np.nonzero(f)
    pairs = bridge.signed_evidence_many(inst, val)
    out: List[DeviceEvidence] = []
    for i, v in zip(inst.tolist(), val.tolist()):
        pair = pairs.get((i, v))
        if pair is None:
            continue
        a, b = pair
        if a.signature is None or b.signature is None:
            continue
        out.append(DeviceEvidence(i, v, a, b))
    return out


def verify_evidence(ev: DeviceEvidence, pubkey: bytes) -> bool:
    """Third-party check of one evidence record: both votes are by the
    same validator for the same (height, round, class) with different
    values, and both signatures verify under `pubkey` (RFC 8032,
    `crypto/ed25519_ref.py`)."""
    a, b = ev.first, ev.second
    if (a.height, a.round, int(a.typ)) != (b.height, b.round, int(b.typ)):
        return False
    if a.value == b.value or a.signature is None or b.signature is None:
        return False
    for v in (a, b):
        msg = vote_messages_np(
            np.asarray([v.height]), np.asarray([v.round]),
            np.asarray([int(v.typ)]),
            np.asarray([-1 if v.value is None else v.value]))[0]
        if not ed25519_ref.verify(pubkey, msg.tobytes(), v.signature):
            return False
    return True
