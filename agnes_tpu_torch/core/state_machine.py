"""The pure Tendermint consensus state machine (copy of
`agnes_tpu.core.state_machine`; the port imports nothing of the JAX
package).

This module must stay **semantically identical** to the reference
(src/state_machine.rs, 346 LoC) and to its JAX-package twin: it is the
oracle the port's device plane (`device/state_machine.py`, reached
through the codecs of `device/encoding.py`) is differentially tested
against, and the machine every host node of the port runs
(`core/executor.py`).  Commented numbers refer to line numbers in the
spec paper, arXiv 1807.04938, exactly as the reference annotates them
(src/state_machine.rs:182).

The machine is a pure function: `apply(state, round, event) ->
(state', message | None)`.  No I/O, no signatures, no timers: the
consumer resolves proposer-ness, proposal validity and quorum
thresholds into Events before calling apply (reference README.md:36-49);
in the port that consumer is the device plane (`agnes_tpu_torch.device`)
plus the host driver (`agnes_tpu_torch.core.executor`).

The enum codes are THE canonical encoding shared by every plane: the
device state machine, the tally's event table (`device/tally.py`) and
the JAX and C++ twins.

Reference-parity subtleties deliberately preserved (SURVEY.md §2.2):

* the lock/unlock rule on receiving a proposal (state_machine.rs:239-244);
* `PrecommitValue` commits from **any** round — no current-round guard
  (state_machine.rs:211, spec line 49); only Commit step absorbs first;
* `schedule_timeout_prevote`/`_precommit` do NOT advance the step
  (state_machine.rs:287-295);
* `precommit` sets both locked and valid; `set_valid_value` (Precommit
  step) sets only valid and emits nothing (state_machine.rs:261-264,
  304-306);
* `TimeoutPrecommit` moves to round+1, `RoundSkip` jumps to the event's
  (strictly higher) round; both emit `NewRound` (state_machine.rs:314-316);
* proposing reuses the valid value and its round when set, else the
  consumer-supplied value with pol_round -1 (state_machine.rs:222-229);
* `Decision` carries the **event's** round, while the state's round field
  is left untouched by `commit` (state_machine.rs:320-322).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional, Tuple

from agnes_tpu_torch.types import MAX_ROUND, Proposal, Vote

# ---------------------------------------------------------------------------
# Enums — the integer codes here are THE canonical encoding, shared verbatim
# by the device plane (device/encoding.py) and the twins.
# ---------------------------------------------------------------------------


class Step(enum.IntEnum):
    """Step of consensus within a round (reference: state_machine.rs:14-21)."""

    NEW_ROUND = 0
    PROPOSE = 1
    PREVOTE = 2
    PRECOMMIT = 3
    COMMIT = 4


class EventTag(enum.IntEnum):
    """The 13 input events (reference: state_machine.rs:96-110)."""

    NEW_ROUND = 0            # start a new round, not as proposer
    NEW_ROUND_PROPOSER = 1   # start a new round and propose value
    PROPOSAL = 2             # complete proposal received (pol_round, value)
    PROPOSAL_INVALID = 3     # invalid proposal received
    POLKA_ANY = 4            # +2/3 prevotes for anything
    POLKA_NIL = 5            # +2/3 prevotes for nil
    POLKA_VALUE = 6          # +2/3 prevotes for value
    PRECOMMIT_ANY = 7        # +2/3 precommits for anything
    PRECOMMIT_VALUE = 8      # +2/3 precommits for value
    ROUND_SKIP = 9           # +1/3 votes from a higher round
    TIMEOUT_PROPOSE = 10     # timeout waiting for proposal
    TIMEOUT_PREVOTE = 11     # timeout waiting for prevotes
    TIMEOUT_PRECOMMIT = 12   # timeout waiting for precommits


class TimeoutStep(enum.IntEnum):
    """Which step a timeout is for (reference: state_machine.rs:158-163)."""

    PROPOSE = 0
    PREVOTE = 1
    PRECOMMIT = 2


class MsgTag(enum.IntEnum):
    """Output message kinds (reference: state_machine.rs:118-124).

    NONE is the device encoding for Rust's Option::None.
    """

    NONE = 0
    NEW_ROUND = 1
    PROPOSAL = 2
    VOTE = 3
    TIMEOUT = 4
    DECISION = 5


# ---------------------------------------------------------------------------
# Events / Messages
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class Event:
    """A tagged input event; only some tags carry a payload."""

    tag: EventTag
    value: Optional[int] = None    # NEW_ROUND_PROPOSER / PROPOSAL / POLKA_VALUE / PRECOMMIT_VALUE
    pol_round: int = -1            # PROPOSAL only

    # -- constructors (mirror reference event variants) --
    @classmethod
    def new_round(cls):
        return cls(EventTag.NEW_ROUND)

    @classmethod
    def new_round_proposer(cls, value: int):
        return cls(EventTag.NEW_ROUND_PROPOSER, value=value)

    @classmethod
    def proposal(cls, pol_round: int, value: int):
        return cls(EventTag.PROPOSAL, value=value, pol_round=pol_round)

    @classmethod
    def proposal_invalid(cls):
        return cls(EventTag.PROPOSAL_INVALID)

    @classmethod
    def polka_any(cls):
        return cls(EventTag.POLKA_ANY)

    @classmethod
    def polka_nil(cls):
        return cls(EventTag.POLKA_NIL)

    @classmethod
    def polka_value(cls, value: int):
        return cls(EventTag.POLKA_VALUE, value=value)

    @classmethod
    def precommit_any(cls):
        return cls(EventTag.PRECOMMIT_ANY)

    @classmethod
    def precommit_value(cls, value: int):
        return cls(EventTag.PRECOMMIT_VALUE, value=value)

    @classmethod
    def round_skip(cls):
        return cls(EventTag.ROUND_SKIP)

    @classmethod
    def timeout_propose(cls):
        return cls(EventTag.TIMEOUT_PROPOSE)

    @classmethod
    def timeout_prevote(cls):
        return cls(EventTag.TIMEOUT_PREVOTE)

    @classmethod
    def timeout_precommit(cls):
        return cls(EventTag.TIMEOUT_PRECOMMIT)


@dataclass(frozen=True, slots=True)
class Timeout:
    """Reference parity: state_machine.rs:150-155."""

    round: int
    step: TimeoutStep


@dataclass(frozen=True, slots=True)
class RoundValue:
    """A value together with the round it was locked/valid/decided at
    (reference: state_machine.rs:7-11)."""

    round: int
    value: int


@dataclass(frozen=True, slots=True)
class Message:
    """Output of the state machine (reference: state_machine.rs:115-124):
    proposals/votes to sign and broadcast, timeouts to schedule, round
    switches, and the decision."""

    tag: MsgTag
    round: int = 0
    proposal: Optional[Proposal] = None
    vote: Optional[Vote] = None
    timeout: Optional[Timeout] = None
    decision: Optional[RoundValue] = None

    # -- constructors (reference: state_machine.rs:127-148) --
    @classmethod
    def new_round(cls, round: int) -> "Message":
        return cls(MsgTag.NEW_ROUND, round=round)

    @classmethod
    def proposal_msg(cls, round: int, value: int, pol_round: int) -> "Message":
        return cls(MsgTag.PROPOSAL, round=round,
                   proposal=Proposal(round, value, pol_round))

    @classmethod
    def prevote(cls, round: int, value: Optional[int]) -> "Message":
        return cls(MsgTag.VOTE, round=round, vote=Vote.new_prevote(round, value))

    @classmethod
    def precommit(cls, round: int, value: Optional[int]) -> "Message":
        return cls(MsgTag.VOTE, round=round, vote=Vote.new_precommit(round, value))

    @classmethod
    def timeout_msg(cls, round: int, step: TimeoutStep) -> "Message":
        return cls(MsgTag.TIMEOUT, round=round, timeout=Timeout(round, step))

    @classmethod
    def decision_msg(cls, round: int, value: int) -> "Message":
        return cls(MsgTag.DECISION, round=round,
                   decision=RoundValue(round, value))


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class State:
    """Consensus state for one (height) instance
    (reference: state_machine.rs:23-31).

    Immutable: every transition returns a fresh State — the purity
    invariant the device plane relies on (functional array updates).
    Height never changes; a decision ends the instance and the driver
    starts a new State at the next height (reference README.md:43-44).
    """

    height: int
    round: int = 0
    step: Step = Step.NEW_ROUND
    locked: Optional[RoundValue] = None
    valid: Optional[RoundValue] = None

    @classmethod
    def new(cls, height: int) -> "State":
        """Fresh state at round 0, NewRound (state_machine.rs:35-43)."""
        return cls(height=height)

    # -- pure helpers (reference: state_machine.rs:46-89) --

    def set_round(self, round: int) -> "State":
        """Back to NewRound at `round` (state_machine.rs:46-52)."""
        return replace(self, round=round, step=Step.NEW_ROUND)

    def next_step(self) -> "State":
        """NewRound→Propose→Prevote→Precommit, saturating
        (state_machine.rs:58-66)."""
        nxt = {
            Step.NEW_ROUND: Step.PROPOSE,
            Step.PROPOSE: Step.PREVOTE,
            Step.PREVOTE: Step.PRECOMMIT,
        }.get(self.step, self.step)
        return replace(self, step=nxt)

    def commit_step(self) -> "State":
        """Terminal Commit step (state_machine.rs:70-75)."""
        return replace(self, step=Step.COMMIT)

    def set_locked(self, value: int) -> "State":
        """Lock `value` at the current round (state_machine.rs:78-82)."""
        return replace(self, locked=RoundValue(self.round, value))

    def set_valid(self, value: int) -> "State":
        """Record `value` as valid at the current round
        (state_machine.rs:85-89)."""
        return replace(self, valid=RoundValue(self.round, value))

    def valid_vr(self, vr: int) -> bool:
        """Is `vr` a plausible pol_round for this round?
        (state_machine.rs:170-172)."""
        return -1 <= vr < self.round

    def apply(self, round: int, event: Event) -> Tuple["State", Optional[Message]]:
        return apply(self, round, event)


# ---------------------------------------------------------------------------
# Transition function
# ---------------------------------------------------------------------------


def apply(s: State, round: int, event: Event) -> Tuple[State, Optional[Message]]:
    """Transition the machine: returns (new state, output message or None).

    `round` is the round the event belongs to; most transitions require it
    to equal the state's current round (`eqr`, reference
    state_machine.rs:184).  The arm order below matters and matches the
    reference match expression (state_machine.rs:185-213) exactly —
    in particular Commit-step absorption comes before the step-agnostic
    arms, and `PRECOMMIT_VALUE` carries no round guard.
    """
    eqr = s.round == round
    step, tag = s.step, event.tag
    E = EventTag

    # From NewRound. Event must be for current round. (state_machine.rs:186-188)
    if step == Step.NEW_ROUND and tag == E.NEW_ROUND_PROPOSER and eqr:
        return _propose(s, event.value)                      # 11/14
    if step == Step.NEW_ROUND and tag == E.NEW_ROUND and eqr:
        return _schedule_timeout_propose(s)                  # 11/20

    # From Propose. Event must be for current round. (state_machine.rs:190-193)
    if step == Step.PROPOSE and tag == E.PROPOSAL and eqr and s.valid_vr(event.pol_round):
        return _prevote(s, event.pol_round, event.value)     # 22, 28
    if step == Step.PROPOSE and tag == E.PROPOSAL_INVALID and eqr:
        return _prevote_nil(s)                               # 22/25, 28/31
    if step == Step.PROPOSE and tag == E.TIMEOUT_PROPOSE and eqr:
        return _prevote_nil(s)                               # 57

    # From Prevote. Event must be for current round. (state_machine.rs:195-199)
    if step == Step.PREVOTE and tag == E.POLKA_ANY and eqr:
        return _schedule_timeout_prevote(s)                  # 34
    if step == Step.PREVOTE and tag == E.POLKA_NIL and eqr:
        return _precommit_nil(s)                             # 44
    if step == Step.PREVOTE and tag == E.POLKA_VALUE and eqr:
        return _precommit(s, event.value)                    # 36/37
    if step == Step.PREVOTE and tag == E.TIMEOUT_PREVOTE and eqr:
        return _precommit_nil(s)                             # 61

    # From Precommit. Event must be for current round. (state_machine.rs:201-202)
    if step == Step.PRECOMMIT and tag == E.POLKA_VALUE and eqr:
        return _set_valid_value(s, event.value)              # 36/42

    # From Commit. No more state transitions. (state_machine.rs:204-205)
    if step == Step.COMMIT:
        return s, None

    # From all other steps. Various round guards. (state_machine.rs:207-211)
    if tag == E.PRECOMMIT_ANY and eqr:
        return _schedule_timeout_precommit(s)                # 47
    if tag == E.TIMEOUT_PRECOMMIT and eqr:
        # the framework rounds domain is [-1, MAX_ROUND] (types.py):
        # saturate the skip target there so the int64 oracle and
        # the int32 device plane stay bit-for-bit at the edge — a
        # screened-in round of MAX_ROUND must not widen to 2**31 here
        # while wrapping negative on device
        return _round_skip(s, min(round + 1, MAX_ROUND))     # 65
    if tag == E.ROUND_SKIP and s.round < round:
        return _round_skip(s, round)                         # 55
    if tag == E.PRECOMMIT_VALUE:                             # no round guard!
        return _commit(s, round, event.value)                # 49

    return s, None


# -- transition actions (reference: state_machine.rs:216-322) --


def _propose(s: State, v: int) -> Tuple[State, Optional[Message]]:
    """We are the proposer: propose the valid value if one exists, else `v`
    (state_machine.rs:222-229, spec 11/14)."""
    s = s.next_step()
    if s.valid is not None:
        value, pol_round = s.valid.value, s.valid.round
    else:
        value, pol_round = v, -1
    return s, Message.proposal_msg(s.round, value, pol_round)


def _prevote(s: State, vr: int, proposed: int) -> Tuple[State, Optional[Message]]:
    """Complete proposal received: prevote it unless locked on a different
    value at a round > vr (state_machine.rs:237-246, spec 22, 28)."""
    s = s.next_step()
    if s.locked is None:
        value = proposed                      # not locked, prevote the value
    elif s.locked.round <= vr:
        value = proposed                      # unlock and prevote
    elif s.locked.value == proposed:
        value = proposed                      # already locked on this value
    else:
        value = None                          # locked on other value: nil
    return s, Message.prevote(s.round, value)


def _prevote_nil(s: State) -> Tuple[State, Optional[Message]]:
    """Invalid proposal or propose timeout (state_machine.rs:250-253)."""
    s = s.next_step()
    return s, Message.prevote(s.round, None)


def _precommit(s: State, v: int) -> Tuple[State, Optional[Message]]:
    """Polka for a value: lock it, mark valid, precommit it
    (state_machine.rs:261-264, spec 36)."""
    s = s.set_locked(v).set_valid(v).next_step()
    return s, Message.precommit(s.round, v)


def _precommit_nil(s: State) -> Tuple[State, Optional[Message]]:
    """Polka for nil or prevote timeout (state_machine.rs:268-271, spec 44/61)."""
    s = s.next_step()
    return s, Message.precommit(s.round, None)


def _schedule_timeout_propose(s: State) -> Tuple[State, Optional[Message]]:
    """Not the proposer: wait for a proposal (state_machine.rs:278-281)."""
    s = s.next_step()
    return s, Message.timeout_msg(s.round, TimeoutStep.PROPOSE)


def _schedule_timeout_prevote(s: State) -> Tuple[State, Optional[Message]]:
    """Polka for any: schedule prevote timeout; the step does NOT advance
    (state_machine.rs:287-289, spec 34)."""
    return s, Message.timeout_msg(s.round, TimeoutStep.PREVOTE)


def _schedule_timeout_precommit(s: State) -> Tuple[State, Optional[Message]]:
    """+2/3 precommits for any: schedule precommit timeout; no step change
    (state_machine.rs:293-295, spec 47)."""
    return s, Message.timeout_msg(s.round, TimeoutStep.PRECOMMIT)


def _set_valid_value(s: State, v: int) -> Tuple[State, Optional[Message]]:
    """Polka after we already precommitted: record valid, emit nothing
    (state_machine.rs:304-306, spec 36/42)."""
    return s.set_valid(v), None


def _round_skip(s: State, r: int) -> Tuple[State, Optional[Message]]:
    """Precommit timeout or +1/3 from a higher round: move to round `r`
    (state_machine.rs:314-316, spec 65/55)."""
    return s.set_round(r), Message.new_round(r)


def _commit(s: State, r: int, v: int) -> Tuple[State, Optional[Message]]:
    """+2/3 precommits for a value: decide it.  Note the state's round field
    is untouched and the Decision carries the event's round
    (state_machine.rs:320-322, spec 49)."""
    return s.commit_step(), Message.decision_msg(r, v)
