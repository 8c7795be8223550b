"""Domain types for the consensus engine.

Reference parity: src/lib.rs:1-45 defines `Value` (an empty placeholder
struct, lib.rs:3-4), `Proposal {round, value, pol_round}` (lib.rs:9-13),
`VoteType {Prevote, Precommit}` (lib.rs:16-19) and
`Vote {typ, round, value: Option<Value>}` (lib.rs:23-27).

Design decisions for the TPU build (SURVEY.md §2.1):

* **Value is a 31-bit integer id.** The reference's `Value {}` is an empty
  placeholder ("TODO: it should probably be a Trait", lib.rs:2).  On device a
  value must be a fixed-width lane, so the framework agrees on int32 value
  *ids*; arbitrary payloads live in a host-side table keyed by id
  (`bridge.ValueTable`).  `NIL` (python `None` at the API surface, -1 on
  device) is a nil vote — the reference's `Option<Value>::None`.

* **Votes carry identity and signatures.**  The reference deliberately omits
  height, validator address and signature from `Vote` (SURVEY.md §2.1 "notably
  absent") — that surface is exactly what this framework adds: `validator` is
  an index into the ValidatorSet, `signature` a 64-byte Ed25519 signature over
  the canonical vote encoding (`crypto.encoding.vote_signing_bytes`).  Both are
  optional so the pure core remains testable without crypto, preserving the
  reference's decoupling argument (README.md:8-14).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

# Nil vote marker (reference: Option<Value>::None, lib.rs:26).
NIL = None

# Device-side encoding of NIL; value ids must be in [0, 2**31 - 1).
NIL_ID = -1

# Framework-wide rounds domain: [-1, MAX_ROUND], shared by every plane
# (wire screen core/executor.py, int32 device encoding, int64 oracle
# and C++ core).  Round arithmetic SATURATES at MAX_ROUND on all
# planes so they stay bit-for-bit even at the representable edge: a
# round-skip chain parks at MAX_ROUND (and the instance can still
# commit there — PrecommitValue has no round guard, spec line 49)
# instead of wrapping in int32 while widening in int64.
MAX_ROUND = 2**31 - 1


class VoteType(enum.IntEnum):
    """Reference parity: src/lib.rs:16-19."""

    PREVOTE = 0
    PRECOMMIT = 1


@dataclass(frozen=True, slots=True)
class Proposal:
    """A proposed value for a round.

    `pol_round` is -1 or the last round the value got a polka
    (reference: src/lib.rs:6-13).
    """

    round: int
    value: int
    pol_round: int = -1


@dataclass(frozen=True, slots=True)
class Vote:
    """A vote for a value (or nil) in a round.

    Reference parity: src/lib.rs:21-38.  `validator`/`height`/`signature`
    are additions of this framework (see module docstring).
    """

    typ: VoteType
    round: int
    value: Optional[int]  # None = nil vote
    validator: Optional[int] = None
    height: Optional[int] = None
    signature: Optional[bytes] = None

    @classmethod
    def new_prevote(cls, round: int, value: Optional[int], **kw) -> "Vote":
        """Reference parity: Vote::new_prevote, src/lib.rs:30-33."""
        return cls(VoteType.PREVOTE, round, value, **kw)

    @classmethod
    def new_precommit(cls, round: int, value: Optional[int], **kw) -> "Vote":
        """Reference parity: Vote::new_precommit, src/lib.rs:35-38."""
        return cls(VoteType.PRECOMMIT, round, value, **kw)
