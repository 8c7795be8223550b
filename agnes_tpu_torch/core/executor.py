"""The consensus executor: the completed top-level driver (twin of
`agnes_tpu.core.executor`).

The reference's `ConsensusExecutor` is a skeleton whose every output
reaction is a stub (consensus_executor.rs:24-49: "check if we're the
proposer" :31-33, "sign the proposal; call execute" :34-37, "sign the
vote; call execute" :38-41, "schedule the timeout" :42-44, "update the
state" :45-47), with empty `HeightVotes {}`/`ValidatorSet {}`
placeholders (:5-6) and weight hardcoded to 1 (:62-63).  This module
fills every stub:

  * proposer selection — the shared `ProposerRotation` sequence;
  * signing — Ed25519 over the canonical encodings (crypto.encoding),
    by the port's host signer `crypto.host_sign` / `host_verify` (the
    C++ core of `core/native.py`, one signer with no fallback: a failed
    g++ build raises); RFC 8032 signatures are deterministic, so the
    outbox is the twin's byte for byte;
  * signature verification + real voting-power weights on inbound
    votes (consensus_executor.rs:57 "TODO check validity", :62-63);
  * timeout scheduling — a virtual-time `TimerWheel` with the classic
    round-escalating durations (the consumer owns the clock, reference
    README.md:46-49: the driver advances time and feeds expirations
    back in);
  * re-entrant execution — self-produced proposals/votes loop back
    through `execute` exactly like peer messages (the intent of the
    "call execute" comments, :36, :40);
  * decision handling + height advance (README.md:43-44: a decision
    ends the instance; the driver starts the next height);
  * multi-height bookkeeping — one `VoteExecutor` (real `HeightVotes`)
    per height, late votes for decided heights dropped.

The executor is deliberately sans-I/O: outbound wire messages land in
`outbox` (the network consumer drains it), timers in the wheel.  That
keeps the reference's testability argument intact (README.md:8-14) —
the harness drives N executors with a toy router and no real network.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from agnes_tpu_torch.core import state_machine as sm
from agnes_tpu_torch.core.validators import ProposerRotation, ValidatorSet
from agnes_tpu_torch.core.vote_executor import VoteExecutor
from agnes_tpu_torch.crypto import encoding
from agnes_tpu_torch.crypto import host_sign as _sign
from agnes_tpu_torch.crypto import host_verify as _verify
from agnes_tpu_torch.types import MAX_ROUND, Proposal, Vote


# wire field bounds: value ids are 31-bit (types.py), rounds live in
# the shared framework domain [-1, types.MAX_ROUND] every plane
# saturates at — the screen and the saturation MUST move together
_MAX_VALUE = 2**31 - 1
_MAX_ROUND = MAX_ROUND


def _valid_value(v: Optional[int]) -> bool:
    return v is None or 0 <= v <= _MAX_VALUE


def _valid_round(r: int, allow_neg1: bool = False) -> bool:
    lo = -1 if allow_neg1 else 0
    return lo <= r <= _MAX_ROUND


def epoch_boundary_at(epochs, height: int) -> Optional[int]:
    """Largest epoch boundary <= `height`, or None when the genesis
    set applies — THE boundary rule every plane shares (executor
    tallies, the checker's config-derived monitors, the device
    replay's set_validators install path).  `epochs` is any
    height-keyed mapping (or None/empty)."""
    best = None
    for boundary in epochs or ():
        if boundary <= height and (best is None or boundary > best):
            best = boundary
    return best


# --- wire messages (the executor's inbound alphabet,
# consensus_executor.rs:16-20, plus the identity/signature surface) ---------


@dataclass(frozen=True, slots=True)
class WireProposal:
    height: int
    round: int
    value: int
    pol_round: int
    proposer: int                      # validator index
    signature: Optional[bytes] = None


@dataclass(frozen=True, slots=True)
class WireTimeout:
    height: int
    round: int
    step: sm.TimeoutStep


WireMessage = object  # WireProposal | Vote | WireTimeout


# --- timer wheel ------------------------------------------------------------


@dataclass(order=True)
class _TimerEntry:
    deadline: float
    seq: int
    timeout: WireTimeout = field(compare=False)


class TimerWheel:
    """Virtual-time timeout scheduler.  The driver advances `now` and
    feeds expired timeouts back into the executor — timeouts are just
    injected events, exactly the reference's testing philosophy
    (state_machine.rs:107-109, SURVEY.md §4)."""

    def __init__(self):
        self._heap: List[_TimerEntry] = []
        self._seq = 0
        self.now = 0.0

    def schedule(self, at: float, timeout: WireTimeout) -> None:
        heapq.heappush(self._heap, _TimerEntry(at, self._seq, timeout))
        self._seq += 1

    def advance(self, to: float) -> List[WireTimeout]:
        """Move the clock forward; pop every timeout due by `to`."""
        self.now = max(self.now, to)
        due = []
        while self._heap and self._heap[0].deadline <= self.now:
            due.append(heapq.heappop(self._heap).timeout)
        return due

    def next_deadline(self) -> Optional[float]:
        return self._heap[0].deadline if self._heap else None

    # -- single-step scheduler surface (model checker, harness.simulator
    # step mode): under the asynchronous abstraction a scheduled timer
    # may fire at ANY point, so deadlines stop mattering and the wheel
    # becomes a pending-timeout multiset an external scheduler pops.

    def pending(self) -> List[WireTimeout]:
        """Every scheduled-but-unfired timeout (deadline-order-free)."""
        return [e.timeout for e in self._heap]

    def remove(self, timeout: WireTimeout) -> bool:
        """Remove ONE pending entry equal to `timeout` (the scheduler
        is about to fire it by hand); False if none pending.  Rebuilds
        the heap list rather than mutating it in place, so clones that
        still share the list (see `clone`) are unaffected."""
        for k, e in enumerate(self._heap):
            if e.timeout == timeout:
                rest = self._heap[:k] + self._heap[k + 1:]
                heapq.heapify(rest)
                self._heap = rest
                return True
        return False

    def clone(self) -> "TimerWheel":
        """O(pending) copy for state-space branching: entries are never
        mutated after push, so a shallow list copy suffices (`remove`
        replaces the list, `schedule` pushes onto the clone's own)."""
        w = TimerWheel.__new__(TimerWheel)
        w._heap = list(self._heap)
        w._seq = self._seq
        w.now = self.now
        return w


@dataclass(frozen=True)
class TimeoutConfig:
    """Round-escalating timeout durations (virtual units): the classic
    Tendermint schedule base + delta * round."""

    propose: float = 3.0
    prevote: float = 1.0
    precommit: float = 1.0
    delta: float = 0.5

    def duration(self, step: sm.TimeoutStep, round: int) -> float:
        base = {sm.TimeoutStep.PROPOSE: self.propose,
                sm.TimeoutStep.PREVOTE: self.prevote,
                sm.TimeoutStep.PRECOMMIT: self.precommit}[step]
        return base + self.delta * round


# --- the executor -----------------------------------------------------------

# proposer schedule window: rounds >= this reuse the slot modulo the
# window (the rotation sequence needs a bounded (height, round) grid)
ROUNDS_WINDOW = 16


@dataclass
class Decision:
    height: int
    round: int
    value: int


@dataclass(frozen=True, slots=True)
class DecisionCert:
    """The quorum a decision rested on, captured AT decide time.

    `_decide` discards the live `VoteExecutor` (the tally dies with the
    height), so anything that wants to audit "no decision without +2/3
    precommit weight" after the fact — the model checker's quorum
    monitor (the twin's analysis/modelcheck.py) — must read the weight before it
    is gone.  `weight` is the precommit weight this node had counted
    for (round, value) at the instant it decided; `total` the set's
    total power.  A legitimate decision satisfies 3*weight > 2*total.
    """

    height: int
    round: int
    value: int
    weight: int
    total: int


class ConsensusExecutor:
    """One node's host driver (the completed consensus_executor.rs).

    Parameters
    ----------
    vset : the validator set (shared by all nodes).
    index : this node's validator index in the (sorted) set, or None
        for an observer that only follows.
    seed : Ed25519 seed for signing own messages (required with index).
    get_value : height -> value id to propose (the mempool stand-in;
        reference leaves value sourcing to the consumer).
    is_valid : value id -> bool (proposal validity, the :57 TODO).
    epochs : optional validator-set epoch schedule — {boundary_height:
        (power, ...)} in set (sorted) index order.  At every height h
        the tally weights/totals come from the epoch with the largest
        boundary <= h (the vset's genesis powers below the first
        boundary) — the host-plane mirror of the device plane's
        ``set_validators`` height-boundary contract
        (harness/device_driver.py).  Identities (pubkeys, and hence
        the proposer rotation) are epoch-invariant here: a power of 0
        models removal, exactly like the device's static [V] table.
    """

    def __init__(self, vset: ValidatorSet, index: Optional[int],
                 seed: Optional[bytes],
                 get_value: Callable[[int], int],
                 is_valid: Callable[[int], bool] = lambda v: True,
                 timeout_config: TimeoutConfig = TimeoutConfig(),
                 start_height: int = 0,
                 verify_signatures: bool = True,
                 epochs: Optional[Dict[int, Tuple[int, ...]]] = None):
        self.vset = vset
        self.index = index
        self.seed = seed
        self.get_value = get_value
        self.is_valid = is_valid
        self.tcfg = timeout_config
        self.verify_signatures = verify_signatures
        self.epochs = epochs

        self.height = start_height
        self.state = sm.State.new(start_height)
        self.votes = self._new_votes(start_height)
        self.wheel = TimerWheel()
        self.outbox: List[WireMessage] = []
        self.decisions: List[Decision] = []
        self.decided: Dict[int, Decision] = {}
        # slashing evidence archived across heights (the per-height
        # VoteExecutor is replaced on decision; evidence must survive)
        self.evidence: List[object] = []
        # quorum certificates, one per decision (audit surface — see
        # DecisionCert; appended by _decide, never read by the core)
        self.decision_certs: List[DecisionCert] = []

        self._rotation = ProposerRotation(vset)
        self._proposer_cache: Dict[Tuple[int, int], int] = {}
        self._rotation_pos = (start_height, 0)
        # set by prefill_proposers(): a frozen cache may be SHARED by
        # clone() (the memo is a pure function of (height, round), but
        # the rotation cursor behind it is not clone-divergence-safe)
        self._proposer_frozen = False
        self._started = False

    # -- tally construction / weighting (subclass seams) --------------------

    def epoch_powers(self, height: int) -> Optional[Tuple[int, ...]]:
        """The per-validator power vector live at `height` under the
        epoch schedule, or None when the genesis (vset) powers apply.
        Pure in (epochs, height) — the stale-epoch mutant overrides
        the lookup height to model a node that keeps tallying against
        the previous set after a boundary."""
        best = epoch_boundary_at(self.epochs, height)
        return None if best is None else self.epochs[best]

    def epoch_total(self, height: int) -> int:
        pw = self.epoch_powers(height)
        return self.vset.total_power if pw is None else sum(pw)

    def _new_votes(self, height: int) -> VoteExecutor:
        """The per-height tally, denominated in the power total of the
        validator-set epoch live at `height`.  A seam so doctored
        executors (the model checker's mutation registry,
        the twin's analysis/modelcheck.py) can install a miscounting tally
        without copying the height-advance logic."""
        return VoteExecutor(height=height,
                            total_weight=self.epoch_total(height),
                            edge_triggered=True)

    def _vote_weight(self, v: Vote) -> int:
        """Voting power an identified inbound vote counts with — from
        the epoch live at the node's CURRENT height (votes for other
        heights never reach the tally, _on_vote's height screen).  The
        weight-blind mutant overrides this (and `_new_votes`) to count
        heads instead of power — the committee-weight bug class the
        quorum-cert monitor exists to catch."""
        pw = self.epoch_powers(self.height)
        if pw is not None:
            return pw[v.validator]
        return self.vset[v.validator].voting_power

    # -- proposer schedule --------------------------------------------------

    def proposer(self, height: int, round: int) -> int:
        """Proposer index for (height, round): the global rotation
        sequence walked in (height, round % window) lexicographic
        order, cached; identical across all nodes and the device
        proposer table."""
        key = (height, round % ROUNDS_WINDOW)
        while key not in self._proposer_cache:
            assert not self._proposer_frozen, (
                f"proposer cache frozen but {key} missed — raise the "
                f"prefill_proposers height bound")
            h, r = self._rotation_pos
            self._proposer_cache[(h, r)] = self._rotation.step()
            self._rotation_pos = (h, r + 1) if r + 1 < ROUNDS_WINDOW \
                else (h + 1, 0)
        return self._proposer_cache[key]

    def prefill_proposers(self, max_height: int) -> None:
        """Materialize the proposer schedule for every (height ≤
        max_height, round-window slot) and FREEZE the cache.  After
        this the memo is read-only, so `clone()` shares it (and the
        now-inert rotation cursor) across every branch of a state-space
        exploration — a miss past the bound asserts instead of silently
        corrupting the shared cursor."""
        for h in range(self.height, max_height + 1):
            for r in range(ROUNDS_WINDOW):
                self.proposer(h, r)
        self._proposer_frozen = True

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Enter the current height's round 0 (the consumer kick-off the
        reference leaves implicit)."""
        if self._started:
            return
        self._started = True
        self._enter_round(0)

    def _enter_round(self, round: int) -> None:
        """Feed the NewRound/NewRoundProposer event for `round`
        (consensus_executor.rs:31-33 made real)."""
        if self.index is not None and \
                self.proposer(self.height, round) == self.index:
            ev = sm.Event.new_round_proposer(self.get_value(self.height))
        else:
            ev = sm.Event.new_round()
        self._apply_event(round, ev)

    # -- inbound ------------------------------------------------------------

    def execute(self, msg: WireMessage) -> None:
        """Process one wire message (consensus_executor.rs:24-49)."""
        if not self._started:
            self.start()
        if isinstance(msg, WireProposal):
            self._on_proposal(msg)
        elif isinstance(msg, Vote):
            self._on_vote(msg)
        elif isinstance(msg, WireTimeout):
            self._on_timeout(msg)
        else:
            raise TypeError(f"unknown wire message {msg!r}")

    def _on_proposal(self, p: WireProposal) -> None:
        if p.height != self.height:
            return
        if not (_valid_round(p.round) and _valid_value(p.value)
                and _valid_round(p.pol_round, allow_neg1=True)
                and 0 <= p.proposer < len(self.vset)):
            return  # malformed fields must not crash or tally
        ok = True
        if self.verify_signatures:
            expected = self.proposer(p.height, p.round)
            ok = (p.proposer == expected and p.signature is not None
                  and _verify(
                      self.vset[p.proposer].public_key,
                      encoding.proposal_signing_bytes(
                          p.height, p.round, p.pol_round, p.value),
                      p.signature))
        if ok and self.is_valid(p.value):
            self._apply_event(p.round, sm.Event.proposal(p.pol_round,
                                                         p.value))
        else:
            self._apply_event(p.round, sm.Event.proposal_invalid())

    def _on_vote(self, v: Vote) -> None:
        if v.height is not None and v.height != self.height:
            return
        # field sanity before anything touches signing-byte encoders:
        # Byzantine peers must not be able to crash the node with
        # out-of-range integers (value ids are 31-bit, types.py)
        if not _valid_round(v.round) or not _valid_value(v.value):
            return
        weight = 1
        if v.validator is not None:
            if not (0 <= v.validator < len(self.vset)):
                return
            if self.verify_signatures:
                if v.signature is None or not _verify(
                        self.vset[v.validator].public_key,
                        encoding.vote_signing_bytes(
                            self.height, v.round, int(v.typ), v.value),
                        v.signature):
                    return  # forged or unsigned: never reaches the tally
            weight = self._vote_weight(v)
        elif self.verify_signatures:
            # identity-free votes are a test-only surface (reference
            # parity in the pure core); a verifying executor must drop
            # them — weight-1 anonymous votes would forge quorums
            return
        event = self.votes.apply(v, weight)
        if event is not None:
            self._apply_event(v.round, event)
        skip = self.votes.check_round_skip(self.state.round)
        if skip is not None:
            self._apply_event(skip, sm.Event.round_skip())

    def _on_timeout(self, t: WireTimeout) -> None:
        if t.height != self.height:
            return
        ev = {sm.TimeoutStep.PROPOSE: sm.Event.timeout_propose,
              sm.TimeoutStep.PREVOTE: sm.Event.timeout_prevote,
              sm.TimeoutStep.PRECOMMIT: sm.Event.timeout_precommit}[t.step]()
        self._apply_event(t.round, ev)

    # -- core loop ----------------------------------------------------------

    def _apply_event(self, round: int, event: sm.Event) -> None:
        before = (self.state.round, self.state.step)
        self.state, msg = self.state.apply(round, event)
        if msg is not None:
            self._react(msg)
        after = (self.state.round, self.state.step)
        if after != before and self.state.step != sm.Step.COMMIT:
            self._requery(after)

    def _requery(self, pos: Tuple[int, int]) -> None:
        """Re-deliver thresholds already reached that the new (round,
        step) can now consume — the edge-trigger liveness companion
        (vote_executor.py module docstring)."""
        round = pos[0]
        for ev in self.votes.threshold_events(round):
            self._apply_event(round, ev)

    def _react(self, msg: sm.Message) -> None:
        """The five reactions, un-stubbed (consensus_executor.rs:30-48)."""
        tag = msg.tag
        if tag == sm.MsgTag.NEW_ROUND:
            self._enter_round(msg.round)
        elif tag == sm.MsgTag.PROPOSAL:
            self._broadcast_proposal(msg.proposal)
        elif tag == sm.MsgTag.VOTE:
            self._broadcast_vote(msg.vote)
        elif tag == sm.MsgTag.TIMEOUT:
            t = WireTimeout(self.height, msg.timeout.round,
                            msg.timeout.step)
            self.wheel.schedule(
                self.wheel.now + self.tcfg.duration(msg.timeout.step,
                                                    msg.timeout.round), t)
        elif tag == sm.MsgTag.DECISION:
            self._decide(msg.decision)

    def _broadcast_proposal(self, p: Proposal) -> None:
        sig = None
        if self.seed is not None:
            sig = _sign(self.seed, encoding.proposal_signing_bytes(
                self.height, p.round, p.pol_round, p.value))
        wire = WireProposal(self.height, p.round, p.value, p.pol_round,
                            self.index, sig)
        self.outbox.append(wire)
        self.execute(wire)          # re-entrant self-delivery (:36)

    def _broadcast_vote(self, v: Vote) -> None:
        sig = None
        if self.seed is not None:
            sig = _sign(self.seed, encoding.vote_signing_bytes(
                self.height, v.round, int(v.typ), v.value))
        wire = Vote(typ=v.typ, round=v.round, value=v.value,
                    validator=self.index, height=self.height, signature=sig)
        self.outbox.append(wire)
        self.execute(wire)          # re-entrant self-delivery (:40)

    def _decide(self, d: sm.RoundValue) -> None:
        """Record the decision and advance to the next height
        (README.md:43-44)."""
        dec = Decision(self.height, d.round, d.value)
        self.decisions.append(dec)
        self.decided[self.height] = dec
        # capture the quorum certificate BEFORE the tally is replaced
        # (DecisionCert docstring): the precommit weight counted for
        # the decided (round, value) at this instant
        rv = self.votes.votes.rounds.get(d.round)
        weight = rv.precommits.value_weight(d.value) if rv else 0
        self.decision_certs.append(DecisionCert(
            self.height, d.round, d.value, weight,
            self.epoch_total(self.height)))
        # dedup: a restart restores live-height evidence into the archive,
        # and peers redelivering the same votes would re-detect it here
        seen = set(self.evidence)
        self.evidence.extend(e for e in self.votes.votes.equivocations()
                             if e not in seen)
        self.height += 1
        self.state = sm.State.new(self.height)
        self.votes = self._new_votes(self.height)
        self._enter_round(0)

    # -- evidence ------------------------------------------------------------

    def all_equivocations(self) -> List[object]:
        """Archived evidence from decided heights plus the live height's
        (deduplicated — after a restart the archive already holds the
        restored live records)."""
        seen = set(self.evidence)
        return self.evidence + [e for e in self.votes.votes.equivocations()
                                if e not in seen]

    # -- sleepy participation (TOB-SVD churn model) --------------------------

    def on_wake(self) -> None:
        """Hook fired when the network wakes this node from a sleepy-
        churn nap (harness/simulator.py ("w", j) action).  A correct
        node does NOTHING here: its state machine position, lock, and
        tally survived the nap untouched, and the gossip layer replays
        the traffic it missed as ordinary deliveries.  The seam exists
        for the model checker's churn-blind mutant — a node that
        treats wake as a reboot (re-entering round 0, shredding its
        lock) regresses (height, round, step) and the monotonicity
        monitor catches it."""

    # -- timers -------------------------------------------------------------

    def advance_time(self, to: float) -> None:
        """Drive the clock; expired timeouts re-enter via execute."""
        for t in self.wheel.advance(to):
            self.execute(t)

    def timer_live(self, t: WireTimeout) -> bool:
        """Can this pending timeout still take effect if fired?

        Sound in one direction only: True may still be a no-op fire,
        but False is a PROOF of no-op — height/round/step are all
        monotone (height by _decide, round within a height by
        _round_skip, step within a round by next_step/commit), and
        every timeout arm in state_machine.apply carries an `eqr`
        guard plus (for propose/prevote) a step guard.  The model
        checker uses this both to prune dead fire-actions and to drop
        dead timers from the canonical state, so states differing only
        in inert wheel residue merge."""
        if t.height != self.height or t.round != self.state.round:
            return False
        step = self.state.step
        if t.step == sm.TimeoutStep.PROPOSE:
            return step <= sm.Step.PROPOSE
        if t.step == sm.TimeoutStep.PREVOTE:
            return step <= sm.Step.PREVOTE
        return step < sm.Step.COMMIT        # PRECOMMIT: step-agnostic arm

    # -- state-space surface (the model checker, twin analysis/modelcheck.py)

    def clone(self) -> "ConsensusExecutor":
        """O(live state) copy for state-space branching.

        Immutable/deterministic members (vset, config callables, the
        frozen State, wire messages) are shared; every mutable
        container is copied one level deep — deep enough because the
        leaves (Vote, Equivocation, Decision, DecisionCert, State) are
        all frozen or append-only.  The proposer memo is shared ONLY
        when frozen by prefill_proposers (see there).  Subclass-safe
        for method-override doctored executors (the modelcheck
        mutation registry); a subclass adding mutable attributes must
        extend this."""
        cls = type(self)
        n = cls.__new__(cls)
        n.vset = self.vset
        n.index = self.index
        n.seed = self.seed
        n.get_value = self.get_value
        n.is_valid = self.is_valid
        n.tcfg = self.tcfg
        n.verify_signatures = self.verify_signatures
        n.epochs = self.epochs
        n.height = self.height
        n.state = self.state
        n.votes = self.votes.clone()
        n.wheel = self.wheel.clone()
        n.outbox = list(self.outbox)
        n.decisions = list(self.decisions)
        n.decided = dict(self.decided)
        n.evidence = list(self.evidence)
        n.decision_certs = list(self.decision_certs)
        if self._proposer_frozen:
            n._rotation = self._rotation
            n._proposer_cache = self._proposer_cache
        else:
            # rebuild an equivalent cursor: the rotation is a pure
            # deterministic sequence and each cache entry consumed
            # exactly one step, so re-stepping a fresh rotation
            # len(cache) times lands it where the original's is
            n._rotation = ProposerRotation(self.vset)
            for _ in range(len(self._proposer_cache)):
                n._rotation.step()
            n._proposer_cache = dict(self._proposer_cache)
        n._rotation_pos = self._rotation_pos
        n._proposer_frozen = self._proposer_frozen
        n._started = self._started
        return n

    def canonical_state(self, perm: Optional[List[int]] = None) -> tuple:
        """A canonical, hashable, int-only summary of everything that
        can influence this node's FUTURE behavior — the model checker's
        dedup key.  Deliberately excluded: outbox/decisions history
        (drained/duplicated elsewhere), decision_certs (audit log,
        checked per transition), the proposer memo (pure function),
        wheel deadlines and dead timers (the asynchronous abstraction:
        any pending live timer may fire at any point, so only the SET
        of live (round, step) timers matters).  None-valued vote
        values encode as -2 (NIL_ID is -1, real ids >= 0).

        `perm` (old validator index -> new index) relabels every
        embedded validator index — the symmetry-reduction surface
        (harness/simulator.Network.mc_canonical carries the soundness
        contract).  Voting-power weights relabel for free: they live
        in value-keyed buckets, and the group construction only
        permutes equal-power validators."""
        def _v(x):
            return -2 if x is None else x

        def _p(x):
            return x if perm is None else perm[x]

        hv = self.votes.votes
        rounds = []
        for r in sorted(hv.rounds):
            rv = hv.rounds[r]
            rounds.append((
                r,
                rv.prevotes.nil,
                tuple(sorted(rv.prevotes.weights.items())),
                rv.precommits.nil,
                tuple(sorted(rv.precommits.weights.items())),
                tuple(sorted((_p(val), int(t), _v(v), w)
                             for (val, t), (v, w) in rv.seen.items())),
                tuple(sorted((int(t), w)
                             for t, w in rv._anon_weight.items())),
                tuple(sorted((_p(e.validator), int(e.typ),
                              _v(e.first_value), _v(e.second_value))
                             for e in rv.equivocations)),
            ))
        lock = (self.state.locked.round, self.state.locked.value) \
            if self.state.locked else None
        valid = (self.state.valid.round, self.state.valid.value) \
            if self.state.valid else None
        return (
            self.height,
            self.state.round,
            int(self.state.step),
            lock,
            valid,
            tuple(rounds),
            tuple(sorted((r, int(tag), _v(v))
                         for r, tag, v in self.votes._emitted)),
            tuple(sorted(self.votes._skipped)),
            tuple(sorted((h, d.round, d.value)
                         for h, d in self.decided.items())),
            tuple(sorted((e.height, e.round, int(e.typ), _p(e.validator),
                          _v(e.first_value), _v(e.second_value))
                         for e in self.evidence)),
            tuple(sorted({(t.round, int(t.step))
                          for t in self.wheel.pending()
                          if self.timer_live(t)})),
        )
