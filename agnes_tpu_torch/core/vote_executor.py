"""Event producer: votes in, state-machine events out (copy of
`agnes_tpu.core.vote_executor`).

Reference parity: src/vote_executor.rs (37 LoC).  `VoteExecutor` adds a
vote to the tally and maps the resulting (vote type, threshold) pair to a
state-machine event via the table at vote_executor.rs:26-36.  There is
still no "PrecommitNil" event, but one cell deviates deliberately: a
precommit-NIL quorum maps to PRECOMMIT_ANY (the reference maps it to no
event at all, which starves the spec line 47 timeout and stalls the
round on a pure-nil precommit quorum — see :func:`to_event`).

Two reference TODOs completed here (SURVEY.md §2.4):

* **Multi-round.**  The reference tracks round 0 only (vote_executor.rs:9,
  :14 "TODO more rounds").  `HeightVotes` keeps a `RoundVotes` per round,
  created on first vote for that round — this is also the `HeightVotes {}`
  placeholder of consensus_executor.rs:5 made real.

* **Edge-triggered events.**  The reference re-emits the threshold event on
  every vote after a quorum is crossed (recomputed each add,
  vote_executor.rs:20-23); at 10k-instance scale re-firing is wasted work
  (SURVEY.md §2.4).  With ``edge_triggered=True`` an event fires only on
  the add that first crosses its threshold.  Edge-triggering alone would
  be a liveness bug, though: a threshold that fires while the state
  machine is in a step that ignores it (e.g. POLKA_VALUE arriving before
  the delayed proposal, state still at Propose) would be consumed and
  never re-fire.  The reference's level-triggered re-fire masks this; an
  edge-triggered consumer MUST call :meth:`threshold_events` to re-query
  reached thresholds whenever the machine's (round, step) changes — the
  ConsensusExecutor does exactly that.  The default is ``False``
  (reference semantics, safe for naive consumers).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from agnes_tpu_torch.core import state_machine as sm
from agnes_tpu_torch.core.round_votes import (
    Equivocation,
    RoundVotes,
    Thresh,
    ThreshKind,
    is_one_third,
)
from agnes_tpu_torch.types import Vote, VoteType


def to_event(typ: VoteType, thresh: Thresh) -> Optional[sm.Event]:
    """Map a (vote type, threshold) pair to a state-machine event
    (reference: vote_executor.rs:26-36).

    One deliberate deviation: the reference maps (Precommit, Nil) to no
    event (vote_executor.rs:33, "spec handles +2/3 precommit-nil via
    TimeoutPrecommit").  But TimeoutPrecommit is only ever *scheduled* by
    PrecommitAny (spec line 47, which counts precommits "for *" — nil
    included), and the tally's Nil-over-Any priority
    (round_votes.rs:58-66) shadows Any whenever the quorum is pure nil —
    so in the reference a pure-nil precommit quorum produces no event at
    all and the round stalls.  Here (Precommit, Nil) maps to
    PRECOMMIT_ANY: still no "PrecommitNil" event (parity), and the spec's
    timeout path actually triggers."""
    if thresh.kind == ThreshKind.INIT:
        return None
    if typ == VoteType.PREVOTE:
        if thresh.kind == ThreshKind.ANY:
            return sm.Event.polka_any()
        if thresh.kind == ThreshKind.NIL:
            return sm.Event.polka_nil()
        return sm.Event.polka_value(thresh.value)
    # precommits
    if thresh.kind in (ThreshKind.ANY, ThreshKind.NIL):
        return sm.Event.precommit_any()
    return sm.Event.precommit_value(thresh.value)


@dataclass
class HeightVotes:
    """Per-round tallies for one height — the realization of the
    `HeightVotes {}` placeholder (consensus_executor.rs:5)."""

    height: int
    total: int
    rounds: Dict[int, RoundVotes] = field(default_factory=dict)

    def round(self, r: int) -> RoundVotes:
        rv = self.rounds.get(r)
        if rv is None:
            rv = self.rounds[r] = RoundVotes(self.height, r, self.total)
        return rv

    def equivocations(self) -> List[Equivocation]:
        out: List[Equivocation] = []
        for rv in self.rounds.values():
            out.extend(rv.equivocations)
        return out

    def clone(self) -> "HeightVotes":
        """Per-round deep-enough copy (state-space branching)."""
        return HeightVotes(self.height, self.total,
                           {r: rv.clone() for r, rv in self.rounds.items()})


@dataclass
class VoteExecutor:
    """Adds votes, produces events (reference: vote_executor.rs:6-23)."""

    height: int
    total_weight: int
    edge_triggered: bool = False
    votes: HeightVotes = None  # type: ignore[assignment]
    # (round, produced-event tag, value) already emitted — edge-trigger
    # record.  Keyed on the EVENT, not the threshold kind: ANY and NIL
    # precommit thresholds both produce PRECOMMIT_ANY, which must fire at
    # most once per round (spec line 47 "for the first time").
    _emitted: Set[Tuple[int, sm.EventTag, Optional[int]]] = field(
        default_factory=set)
    # rounds for which RoundSkip was already emitted
    _skipped: Set[int] = field(default_factory=set)

    def __post_init__(self):
        if self.votes is None:
            self.votes = HeightVotes(self.height, self.total_weight)

    def clone(self) -> "VoteExecutor":
        """State-space branching copy; edge-trigger records included."""
        return VoteExecutor(self.height, self.total_weight,
                            self.edge_triggered, self.votes.clone(),
                            set(self._emitted), set(self._skipped))

    def apply(self, vote: Vote, weight: int) -> Optional[sm.Event]:
        """Add the vote to its round's tally; return the event its class's
        threshold maps to, if any (reference: vote_executor.rs:20-23).

        Votes stamped with a different height are ignored — the reference
        has no height on votes at all (lib.rs:23-27); here a cross-height
        vote must not count toward this height's quorums."""
        if vote.height is not None and vote.height != self.height:
            return None
        thresh = self.votes.round(vote.round).add_vote(vote, weight)
        event = to_event(vote.typ, thresh)
        if event is None or not self.edge_triggered:
            return event
        key = (vote.round, event.tag, event.value)
        if key in self._emitted:
            return None
        self._emitted.add(key)
        return event

    def threshold_events(self, round: int) -> List[sm.Event]:
        """Events for every threshold *currently* reached in `round` —
        the re-query path an edge-triggered consumer must call after the
        state machine changes (round, step), so a threshold consumed in a
        step that ignored it is not lost (see module docstring)."""
        rv = self.votes.rounds.get(round)
        if rv is None:
            return []
        events = []
        for typ, count in ((VoteType.PREVOTE, rv.prevotes),
                           (VoteType.PRECOMMIT, rv.precommits)):
            ev = to_event(typ, count.thresh())
            if ev is not None:
                events.append(ev)
        return events

    def check_round_skip(self, current_round: int) -> Optional[int]:
        """Return the lowest round r > current_round that has accumulated
        more than 1/3 of total weight, if any — the RoundSkip trigger
        (state_machine.rs:106/210; detection absent in the reference).
        Each qualifying round fires at most once."""
        for r in sorted(self.votes.rounds):
            if r <= current_round or r in self._skipped:
                continue
            if is_one_third(self.votes.round(r).skip_weight(), self.total_weight):
                self._skipped.add(r)
                return r
        return None
