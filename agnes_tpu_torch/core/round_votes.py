"""Vote tally for one round: weights, quorum thresholds, equivocation.

Reference parity: src/round_votes.rs (133 LoC).  The quorum predicate,
threshold priority order, and the Any-threshold definition are kept
exactly:

* `is_quorum(v, total) = 3*v > 2*total` — strictly more than 2/3 of the
  *fixed total* voting power, not of votes seen (round_votes.rs:31-33,
  total fixed at construction :36-44);
* threshold priority Value > Nil > Any > Init (round_votes.rs:58-66);
* `Any` is quorum of **all** weight seen, value + nil buckets together
  (round_votes.rs:62).

Two documented limitations of the reference are fixed here, not copied
(SURVEY.md §2.3 "known limitations to fix"):

1. **Per-value buckets.**  The reference accumulates all non-nil weight
   into a single bucket, conflating distinct values (round_votes.rs:50-54,
   TODOs :14, :51).  Here each distinct value id gets its own bucket; the
   reported Value threshold is for the highest-weight value that actually
   has a quorum.

2. **Per-validator deduplication / equivocation detection.**  The
   reference double-counts a re-sent vote (round_votes.rs:48-56; its own
   test at :120-122 exercises this).  Here, when votes carry a validator
   index, a validator's weight counts at most once per (round, vote type):
   a duplicate of the same vote is ignored, and a *conflicting* vote for a
   different value is recorded as equivocation evidence (the double-sign /
   slashing surface, BASELINE config 5) — the first vote keeps counting.
   Votes without a validator index (the pure-core test path, matching the
   reference's identity-free Vote, lib.rs:23-27) are never deduplicated,
   preserving reference behavior exactly.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from agnes_tpu_torch.types import Vote, VoteType


class ThreshKind(enum.IntEnum):
    INIT = 0   # no quorum
    ANY = 1    # quorum of votes, but not for one value
    NIL = 2    # quorum for nil
    VALUE = 3  # quorum for a specific value


@dataclass(frozen=True, slots=True)
class Thresh:
    """Quorum threshold reached by a vote class
    (reference: round_votes.rs:21-28)."""

    kind: ThreshKind
    value: Optional[int] = None

    @classmethod
    def init(cls) -> "Thresh":
        return cls(ThreshKind.INIT)

    @classmethod
    def any(cls) -> "Thresh":
        return cls(ThreshKind.ANY)

    @classmethod
    def nil(cls) -> "Thresh":
        return cls(ThreshKind.NIL)

    @classmethod
    def for_value(cls, v: int) -> "Thresh":
        return cls(ThreshKind.VALUE, v)


def is_quorum(value: int, total: int) -> bool:
    """True iff value > (2/3) * total (reference: round_votes.rs:31-33)."""
    return 3 * value > 2 * total


def is_one_third(value: int, total: int) -> bool:
    """True iff value > (1/3) * total — the RoundSkip trigger
    ("+1/3 votes from a higher round", reference state_machine.rs:106)."""
    return 3 * value > total


@dataclass(frozen=True, slots=True)
class Equivocation:
    """Double-sign evidence: one validator, two conflicting votes of the
    same type in the same round.  No reference analogue (the reference has
    no validator identity); this is BASELINE config 5's slashing surface."""

    height: int
    round: int
    typ: VoteType
    validator: int
    first_value: Optional[int]
    second_value: Optional[int]


@dataclass
class VoteCount:
    """Tally of one vote class (prevotes or precommits) for one round.

    Reference parity: round_votes.rs:12-67, with per-value buckets
    (fix 1 above).  `total` is the total voting power of the validator
    set, fixed at construction.
    """

    total: int
    nil: int = 0
    weights: Dict[int, int] = field(default_factory=dict)  # value id -> weight

    def add(self, value: Optional[int], weight: int) -> Thresh:
        """Accumulate `weight` for `value` (None = nil) and return the
        highest threshold now reached, priority Value > Nil > Any > Init
        (reference: round_votes.rs:48-67)."""
        if value is None:
            self.nil += weight
        else:
            self.weights[value] = self.weights.get(value, 0) + weight
        return self.thresh()

    def value_weight(self, value: Optional[int]) -> int:
        if value is None:
            return self.nil
        return self.weights.get(value, 0)

    def seen_weight(self) -> int:
        """Total weight seen across all buckets (nil included)."""
        return self.nil + sum(self.weights.values())

    def quorum_value(self) -> Optional[int]:
        """The highest-weight value with a quorum, if any.  At most one
        value can have >2/3, so the tie-break (highest weight, then
        smallest value id) only matters in adversarial >total-weight
        streams (identity-free votes); it is deterministic and mirrored
        by the C++ core's ascending-id map iteration."""
        best = None
        best_w = -1
        for v, w in self.weights.items():
            if is_quorum(w, self.total) and (
                    w > best_w or (w == best_w and v < best)):
                best, best_w = v, w
        return best

    def thresh(self) -> Thresh:
        qv = self.quorum_value()
        if qv is not None:
            return Thresh.for_value(qv)
        if is_quorum(self.nil, self.total):
            return Thresh.nil()
        if is_quorum(self.seen_weight(), self.total):
            return Thresh.any()
        return Thresh.init()

    def clone(self) -> "VoteCount":
        """Shallow-bucket copy (state-space branching surface)."""
        return VoteCount(self.total, self.nil, dict(self.weights))


@dataclass
class RoundVotes:
    """All votes for a single (height, round): a prevote tally, a precommit
    tally, and the per-validator dedup/equivocation record
    (reference: round_votes.rs:73-98 + SURVEY.md §2.3 fix 2)."""

    height: int
    round: int
    total: int
    prevotes: VoteCount = None  # type: ignore[assignment]
    precommits: VoteCount = None  # type: ignore[assignment]
    # (validator, typ) -> (value, weight) of their first (counted) vote
    seen: Dict[Tuple[int, VoteType], Tuple[Optional[int], int]] = field(default_factory=dict)
    equivocations: List[Equivocation] = field(default_factory=list)
    # (validator, typ) pairs already flagged — one evidence record per pair
    _flagged: set = field(default_factory=set)
    # weight from identity-free votes, per vote type (reference-parity path)
    _anon_weight: Dict[VoteType, int] = field(default_factory=dict)

    def __post_init__(self):
        if self.prevotes is None:
            self.prevotes = VoteCount(self.total)
        if self.precommits is None:
            self.precommits = VoteCount(self.total)

    def _count(self, typ: VoteType) -> VoteCount:
        return self.prevotes if typ == VoteType.PREVOTE else self.precommits

    def add_vote(self, vote: Vote, weight: int) -> Thresh:
        """Add a vote; returns the highest threshold of that vote's class
        (reference: round_votes.rs:92-97).  Dedup/equivocation only when
        the vote carries a validator index (see module docstring)."""
        count = self._count(vote.typ)
        if vote.validator is not None:
            key = (vote.validator, vote.typ)
            if key in self.seen:
                prior, _w = self.seen[key]
                if prior != vote.value and key not in self._flagged:
                    # one evidence record per (validator, type); redeliveries
                    # of the conflicting vote don't grow the list
                    self._flagged.add(key)
                    self.equivocations.append(Equivocation(
                        self.height, self.round, vote.typ, vote.validator,
                        prior, vote.value))
                return count.thresh()  # duplicate or conflict: not counted
            self.seen[key] = (vote.value, weight)
        else:
            self._anon_weight[vote.typ] = self._anon_weight.get(vote.typ, 0) + weight
        return count.add(vote.value, weight)

    def clone(self) -> "RoundVotes":
        """One-level copy: every container is duplicated, the leaves
        (Vote values, Equivocation records) are frozen and shared —
        the state-space branching surface (analysis/modelcheck.py)."""
        rv = RoundVotes(self.height, self.round, self.total,
                        prevotes=self.prevotes.clone(),
                        precommits=self.precommits.clone(),
                        seen=dict(self.seen),
                        equivocations=list(self.equivocations),
                        _flagged=set(self._flagged),
                        _anon_weight=dict(self._anon_weight))
        return rv

    def skip_weight(self) -> int:
        """Weight of distinct voters seen in this round — the +1/3
        RoundSkip trigger on rounds above the current one (reference
        state_machine.rs:106 names the event; detection is absent there).
        With validator identity each voter counts once regardless of vote
        type; identity-free weight contributes the larger single class so a
        both-types voter is not double-counted.  Mixed streams combine
        both contributions."""
        by_validator: Dict[int, int] = {}
        for (v, _t), (_val, w) in self.seen.items():
            by_validator[v] = max(by_validator.get(v, 0), w)
        anon = max(self._anon_weight.get(VoteType.PREVOTE, 0),
                   self._anon_weight.get(VoteType.PRECOMMIT, 0))
        return sum(by_validator.values()) + anon
