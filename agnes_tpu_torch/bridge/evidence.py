"""Join device equivocation flags to slashable signed evidence (twin of
`agnes_tpu.bridge.evidence`).

The device tally flags double-signers as a dense [instances, validators]
bool plane (`DeviceDriver.tally.equiv`).  A flag alone proves nothing to
a third party; the proof is the two conflicting signed votes, which the
ingestion bridges retain (`VoteBatcher._log`, the C++ loop's block log
behind `NativeIngestLoop`).  `collect_device_evidence` sweeps the flags
and pulls each flagged validator's conflicting pair: from a VoteBatcher
in one walk of its log (`signed_evidence_many`), from a native loop one
cell at a time (`signed_evidence`, two raw 96-byte wire records each,
turned into WireVotes here).  `verify_evidence` is the third party's
check of one record, through the host verifier (`crypto.host_verify`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Union

import numpy as np
import torch

from agnes_tpu_torch.bridge.ingest import (VoteBatcher, WireVote,
                                           vote_messages_np)
from agnes_tpu_torch.bridge.native_ingest import NativeIngestLoop
from agnes_tpu_torch.crypto import host_verify
from agnes_tpu_torch.types import VoteType


@dataclass(frozen=True)
class DeviceEvidence:
    """One device-detected double-sign with its slashable proof."""

    instance: int
    validator: int
    first: WireVote
    second: WireVote


def _wire_from_record(rec: np.ndarray) -> WireVote:
    """Packed 96-byte wire record -> WireVote (the C++ loop's evidence
    format; layout at the top of core/native/ingest.cpp)."""
    b = rec.tobytes()
    value = int.from_bytes(b[24:32], "little")
    return WireVote(
        instance=int.from_bytes(b[0:4], "little"),
        validator=int.from_bytes(b[4:8], "little"),
        height=int.from_bytes(b[8:16], "little", signed=True),
        round=int.from_bytes(b[16:20], "little", signed=True),
        typ=VoteType(b[20]),
        value=value if b[21] & 1 else None,
        signature=b[32:96])


def collect_device_evidence(flags,
                            bridge: Union[VoteBatcher, NativeIngestLoop]
                            ) -> List[DeviceEvidence]:
    """Sweep a device equivocation plane and return the signed proofs,
    one record per flagged (instance, validator) in row-major order.

    `flags` is the [I, V] bool plane `DeviceDriver.tally.equiv` (a
    tensor on any device, or an array); `bridge` is the VoteBatcher or
    NativeIngestLoop that fed the device and so holds the retained
    votes.  Flagged cells whose conflicting votes are no longer in the
    log, or were ingested without signatures, are skipped: they prove
    nothing to a third party."""
    if not isinstance(bridge, (VoteBatcher, NativeIngestLoop)):
        raise TypeError(f"collect_device_evidence takes a VoteBatcher or "
                        f"a NativeIngestLoop, not {type(bridge).__name__}")
    f = flags.cpu().numpy() if isinstance(flags, torch.Tensor) \
        else np.asarray(flags)
    inst, val = np.nonzero(f)
    if isinstance(bridge, VoteBatcher):
        pairs = bridge.signed_evidence_many(inst, val)
    else:
        pairs = {}
        for i, v in zip(inst.tolist(), val.tolist()):
            rec = bridge.signed_evidence(i, v)
            if rec is not None:
                pairs[(i, v)] = tuple(_wire_from_record(r) for r in rec)
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
    values, and both signatures verify under `pubkey` (RFC 8032, the
    host verifier `crypto.host_verify`)."""
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
        if not host_verify(pubkey, msg.tobytes(), v.signature):
            return False
    return True
