"""Canonical signing byte layouts (copy of `agnes_tpu.crypto.encoding`).

Layout (little-endian integers):

  vote:     type(1) | height(8) | round(4) | value(32)      = 45 bytes
  proposal: 0x50(1) | height(8) | round(4) | pol_round(4)
            | value(32)                                     = 49 bytes

R(32) || A(32) || M(45) = 109 bytes pads to exactly ONE SHA-512 block,
so batched verification costs a single compression per signature.
Every signer, verifier and packer of the port goes through these
functions: the executor's host signer, the fixtures and the bridge's
packer agree on bytes by construction.
"""

from __future__ import annotations

VOTE_MSG_LEN = 45
PROPOSAL_MSG_LEN = 49
PROPOSAL_TAG = 0x50

# nil votes sign the all-ones value field.  Value ids are < 2^31, so
# 2^256-1 can never collide with a real id.
NIL_WIRE = (1 << 256) - 1


def vote_signing_bytes(height: int, round: int, typ: int,
                       value: int | None) -> bytes:
    """Canonical 45-byte vote message (None value = nil -> all-ones)."""
    v = NIL_WIRE if value is None else int(value)
    return (bytes([int(typ)])
            + int(height).to_bytes(8, "little")
            + int(round).to_bytes(4, "little", signed=True)
            + v.to_bytes(32, "little"))


def proposal_signing_bytes(height: int, round: int, pol_round: int,
                           value: int) -> bytes:
    """Canonical 49-byte proposal message."""
    return (bytes([PROPOSAL_TAG])
            + int(height).to_bytes(8, "little")
            + int(round).to_bytes(4, "little", signed=True)
            + int(pol_round).to_bytes(4, "little", signed=True)
            + int(value).to_bytes(32, "little"))
