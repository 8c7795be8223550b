"""In-memory multi-node network simulation (host plane; twin of
`agnes_tpu.harness.simulator`).

Drives N `ConsensusExecutor` nodes with a toy router: no sockets, no
threads, a virtual clock — multi-node consensus exercised exactly the
way the reference argues it should be (README.md:8-14: shrink the
object graph; timeouts are injected events).  Byzantine behaviors are
router policies + misbehaving signers layered on honest nodes:

  silent        drops every outbound message (crash fault)
  equivocator   additionally signs and sends a conflicting vote for a
                different value to every peer (double-sign; feeds the
                slashing surface, BASELINE config 5)
  nil_flood     replaces own votes with nil votes (liveness attack)

Network faults are router policies too: `partition(groups)` HOLDS
BACK every message crossing a group boundary (the consumer's gossip
layer retransmits once connectivity returns, so a partition delays
rather than destroys — README.md:46-49 leaves transport to the
consumer) and `heal()` delivers the held traffic.  A side without
+2/3 power cannot decide while split (nodes stall exactly where
Tendermint stalls: Prevote with no PolkaAny means no timeout), and
after heal the mixed nil/value prevotes drive PolkaAny ->
TimeoutPrevote -> PrecommitAny -> TimeoutPrecommit -> a fresh round
where the reunited quorum decides — the classic liveness-recovery
scenario, no cluster required.

Signing goes through the port's host signer `crypto.host_sign` (the
C++ core, the executor's one signer), so a network's outboxes are the
twin's byte for byte.
The single-step scheduler surface (`enable_step_mode`, `mc_*`,
`run_schedule`) is the model checker's; the port's corpus replay
drives `run_schedule`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace as dc_replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from agnes_tpu_torch.core.executor import (
    ConsensusExecutor,
    TimeoutConfig,
    WireProposal,
    WireTimeout,
    epoch_boundary_at,
)
from agnes_tpu_torch.core.round_votes import Equivocation
from agnes_tpu_torch.core.state_machine import TimeoutStep
from agnes_tpu_torch.core.validators import Validator, ValidatorSet
from agnes_tpu_torch.crypto import ed25519_ref as ed
from agnes_tpu_torch.crypto import host_sign as _sign
from agnes_tpu_torch.crypto.encoding import vote_signing_bytes
from agnes_tpu_torch.types import Vote

BEHAVIORS = ("honest", "silent", "equivocator", "nil_flood")


@functools.lru_cache(maxsize=64)
def _cached_pubkey(seed: bytes) -> bytes:
    """Seeds here are tiny deterministic test vectors; the pure-Python
    keypair derivation costs ~ms each, and the model checker builds
    THOUSANDS of Networks (one per delta-debug probe) — memoize."""
    return ed.keypair(seed)[1]


@dataclass
class NodeSpec:
    behavior: str = "honest"
    power: int = 1


@dataclass
class Network:
    """N executors + router.  `specs[i].behavior` picks the fault model
    for node i (indices are into the address-sorted validator set)."""

    n: int = 4
    specs: Optional[Sequence[NodeSpec]] = None
    timeout_config: TimeoutConfig = field(default_factory=TimeoutConfig)
    get_value: Callable[[int], int] = lambda h: 100 + h
    verify_signatures: bool = True
    # model-checking knobs: skip Ed25519 entirely (the checker explores
    # consensus logic, not crypto — every vote still carries identity,
    # delivery stays index-trusted with verify_signatures=False), and
    # swap in a doctored executor class (the mutation-test surface)
    sign_messages: bool = True
    executor_cls: type = ConsensusExecutor
    # validator-set epoch schedule: {boundary_height: (power, ...)} in
    # ORIGINAL (pre-sort) index order, like `specs`; re-indexed to the
    # sorted set here and handed to every executor.  Powers below the
    # first boundary come from the specs (genesis) set.  Identities
    # and the proposer rotation are epoch-invariant (power 0 models
    # removal — the device plane's static-[V]-table contract,
    # device_driver.set_validators).
    epochs: Optional[Dict[int, Sequence[int]]] = None

    def __post_init__(self):
        assert self.sign_messages or not self.verify_signatures, \
            "unsigned networks cannot verify signatures"
        specs = list(self.specs or [NodeSpec() for _ in range(self.n)])
        assert len(specs) == self.n
        seeds = [bytes([i + 1]) * 32 for i in range(self.n)]
        keyed = sorted(zip([_cached_pubkey(s) for s in seeds], seeds,
                           range(self.n)))
        # specs are re-indexed to sorted order so specs[i] matches node i
        self.specs = [specs[orig] for _, _, orig in keyed]
        self.seeds = [seed for _, seed, _ in keyed]
        self.vset = ValidatorSet(
            [Validator(pk, self.specs[i].power)
             for i, (pk, _, _) in enumerate(keyed)])
        if self.epochs is not None:
            for h, pw in self.epochs.items():
                assert len(pw) == self.n, (h, pw)
            self.epochs = {
                int(h): tuple(pw[orig] for _, _, orig in keyed)
                for h, pw in sorted(self.epochs.items())}
        self.nodes: List[ConsensusExecutor] = [
            self.executor_cls(
                self.vset, index=i,
                seed=self.seeds[i] if self.sign_messages else None,
                get_value=self.get_value,
                timeout_config=self.timeout_config,
                verify_signatures=self.verify_signatures,
                epochs=self.epochs)
            for i in range(self.n)]
        self._delivered = [0] * self.n
        self.dropped = 0
        self._group: Optional[List[int]] = None   # node -> partition id
        self._held_cross: List = []               # (target, msg) queue
        self.held_partition = 0
        self._step_mode = False

    # -- validator-set epochs ------------------------------------------------

    def epoch_powers_at(self, height: int) -> Tuple[int, ...]:
        """The TRUE per-validator (sorted-index) power vector live at
        `height` under the epoch schedule — computed from the config,
        never through an executor, so the model checker's monitors can
        hold a doctored (stale-epoch) executor against the real set."""
        best = epoch_boundary_at(self.epochs, height)
        if best is None:
            return tuple(v.voting_power for v in self.vset)
        return self.epochs[best]

    def epoch_total_at(self, height: int) -> int:
        return sum(self.epoch_powers_at(height))

    # -- fault models -------------------------------------------------------

    def _outbound(self, i: int, msg) -> List[object]:
        """Apply node i's behavior to an outbound message."""
        b = self.specs[i].behavior
        if b == "silent":
            self.dropped += 1
            return []
        if b == "equivocator" and isinstance(msg, Vote) \
                and msg.value is not None:
            other = msg.value + 1_000_000
            sig = _sign(self.seeds[i], vote_signing_bytes(
                msg.height, msg.round, int(msg.typ), other)) \
                if self.sign_messages else None
            evil = dc_replace(msg, value=other, signature=sig)
            return [msg, evil]
        if b == "nil_flood" and isinstance(msg, Vote):
            sig = _sign(self.seeds[i], vote_signing_bytes(
                msg.height, msg.round, int(msg.typ), None)) \
                if self.sign_messages else None
            return [dc_replace(msg, value=None, signature=sig)]
        return [msg]

    # -- network faults -----------------------------------------------------

    def partition(self, *groups: Sequence[int]) -> None:
        """Split the network: messages between different groups are
        held back until `heal()`.  Every node must appear in exactly
        one group (sorted-set indices, like `specs`)."""
        gmap = [-1] * self.n
        for g, members in enumerate(groups):
            for i in members:
                assert gmap[i] == -1, f"node {i} in two groups"
                gmap[i] = g
        assert -1 not in gmap, "every node must be in a group"
        self._group = gmap

    def heal(self) -> None:
        """Restore connectivity and deliver the held cross-partition
        traffic (gossip retransmission)."""
        self._group = None
        held, self._held_cross = self._held_cross, []
        for j, msg in held:
            self.nodes[j].execute(msg)

    def partition_heal_drill(self, *groups: Sequence[int],
                             stall_iters: int = 30) -> int:
        """The canonical quorum-less-split liveness drill (shared by
        config 6 and the harness tests): partition into `groups` (none
        with +2/3 power), prove nobody decides the current height
        (only run_until's exhaustion counts as the stall — any other
        assert surfaces), heal, converge, and return the earliest
        decision round — asserted >= 1, since a real stall means the
        round-0 quorum never assembled."""
        h = min(n.height for n in self.nodes)
        self.partition(*groups)
        stalled = False
        try:
            self.run_until(lambda: self.decided(h), max_iters=stall_iters)
        except AssertionError as e:
            assert "predicate" in str(e), e
            stalled = True
        assert stalled and not any(h in n.decided for n in self.nodes)
        self.heal()
        self.run_until(lambda: self.decided(h))
        assert len(set(self.decisions(h))) == 1
        heal_round = min(n.decided[h].round for n in self.nodes)
        assert heal_round >= 1, heal_round
        return int(heal_round)

    # -- driving ------------------------------------------------------------

    def start(self) -> None:
        for node in self.nodes:
            node.start()

    def step_router(self) -> bool:
        """Deliver every pending outbox message; True if any moved."""
        assert not self._step_mode, \
            "step-mode networks are driven via mc_apply/run_schedule"
        progress = False
        for i, node in enumerate(self.nodes):
            while self._delivered[i] < len(node.outbox):
                msg = node.outbox[self._delivered[i]]
                self._delivered[i] += 1
                progress = True
                for out in self._outbound(i, msg):
                    for j, other in enumerate(self.nodes):
                        if j == i:
                            continue
                        if (self._group is not None
                                and self._group[i] != self._group[j]):
                            self._held_cross.append((j, out))
                            self.held_partition += 1
                            continue
                        other.execute(out)
        return progress

    def advance_time(self, to: float) -> None:
        for i, node in enumerate(self.nodes):
            if self.specs[i].behavior != "silent":
                node.advance_time(to)

    def run_until(self, pred: Callable[[], bool], max_iters: int = 500,
                  time_step: float = 5.0) -> None:
        """Route until `pred()`; when the network quiesces without
        progress, advance the virtual clock (fires timeouts).  The
        clock resumes from the furthest node wheel, not 0 — a second
        run_until must not burn its budget re-advancing through time
        the first one already covered."""
        t = max((n.wheel.now for n in self.nodes), default=0.0)
        for _ in range(max_iters):
            if pred():
                return
            if not self.step_router():
                t += time_step
                self.advance_time(t)
                if not self.step_router() and pred():
                    return
        raise AssertionError("network did not reach the predicate")

    def honest_nodes(self) -> List[ConsensusExecutor]:
        return [n for i, n in enumerate(self.nodes)
                if self.specs[i].behavior != "silent"]

    def decided(self, height: int) -> bool:
        return all(height in n.decided for n in self.honest_nodes())

    def decisions(self, height: int) -> List[int]:
        return [n.decided[height].value for n in self.honest_nodes()]

    def equivocations(self) -> Dict[int, List[Equivocation]]:
        """Evidence collected per honest node index (all heights)."""
        out = {}
        for i, n in enumerate(self.nodes):
            if self.specs[i].behavior == "silent":
                continue
            ev = n.all_equivocations()
            if ev:
                out[i] = ev
        return out

    # ======================================================================
    # Single-step scheduler mode (the model checker's surface,
    # twin analysis/modelcheck.py).
    #
    # In step mode the router stops auto-delivering: outbound traffic is
    # drained into per-(src, dst) FIFO channels (per-link FIFO order, the
    # standard asynchronous-network assumption) and an external scheduler
    # picks ONE atomic action at a time:
    #
    #   ("d", i, j)             deliver the head of channel i->j
    #   ("t", j, h, r, step)    fire node j's pending (h, r, step) timeout
    #                           (the asynchronous abstraction: a scheduled
    #                           timer may expire at ANY point, so deadline
    #                           values stop mattering)
    #   ("p",)                  split into the configured partition groups
    #   ("h",)                  heal the partition
    #   ("s", j)                node j falls asleep (TOB-SVD sleepy churn:
    #                           deliveries to it hold, its timers freeze;
    #                           bounded by the churn budget)
    #   ("w", j)                node j wakes (held traffic becomes
    #                           deliverable again, timers thaw, and the
    #                           node's on_wake hook fires)
    #
    # Every action is followed by a deterministic re-route of all outboxes,
    # so the post-action state is a pure function of (initial config,
    # action sequence) — the determinism `run_schedule` and the regression
    # corpus rely on.  A partition HOLDS cross-group channels (delivery
    # disabled, nothing dropped) exactly like the classic router's
    # held-until-heal policy, just at delivery rather than routing time.
    # ======================================================================

    def enable_step_mode(self, partition_groups=None, max_height: int = 1,
                         max_partition_cycles: int = 1,
                         churn_budget: int = 0,
                         churnable=None) -> None:
        """Switch the router into externally-scheduled single-step mode
        (before `start()`).  `partition_groups` is the one partition
        shape the ("p",) action applies, or None to disable it.
        `churn_budget` bounds the sleepy-churn alphabet the way the
        partition cycle cap bounds ("p",): at most that many ("s", j)
        sleep actions are ever enabled (wakes are free — each sleep
        admits at most one), so the explored schedule space stays
        finite.  `churnable` restricts which (sorted-index) nodes may
        sleep; None = every honest node (byzantine behaviors already
        own their fault models)."""
        assert not self._step_mode and not any(
            nd._started for nd in self.nodes)
        self._step_mode = True
        self._channels: Dict[Tuple[int, int], List[object]] = {}
        self._mc_partition_groups = None if partition_groups is None else \
            tuple(tuple(sorted(g)) for g in partition_groups)
        self._max_partition_cycles = max_partition_cycles
        self._partition_cycles = 0
        self._churn_budget = int(churn_budget)
        self._churn_used = 0
        self._asleep = [False] * self.n
        if churnable is None:
            self._churnable = frozenset(
                i for i in range(self.n)
                if self.specs[i].behavior == "honest")
        else:
            self._churnable = frozenset(int(i) for i in churnable)
            bad = [i for i in self._churnable if not 0 <= i < self.n]
            assert not bad, (
                f"churnable indices {bad} out of range for n={self.n}")
        # height -> set of value ids any node ever put in a WireProposal
        # (recorded pre-behavior, so a silent proposer's value counts):
        # the validity monitor's ground truth
        self._proposed: Dict[int, set] = {}
        # per target node: (validator, height, round, typ) -> values
        # delivered AND counted (vote height matched the node's live
        # height); two+ distinct values mean round_votes must have
        # surfaced equivocation evidence — the completeness monitor
        self._dv: List[Dict[Tuple[int, int, int, int], set]] = [
            {} for _ in range(self.n)]
        self._expected_ev: List[set] = [set() for _ in range(self.n)]
        for nd in self.nodes:
            nd.prefill_proposers(max_height + 2)

    def mc_start(self) -> None:
        """Start every node and route the initial burst (proposals,
        propose timeouts) into the channels."""
        assert self._step_mode
        self.start()
        self._mc_route()

    def _mc_route(self) -> None:
        """Drain every outbox through the behavior policies into the
        channels, then TRUNCATE the outboxes — in step mode history
        lives in the schedule, and clone cost must not grow with it."""
        for i, node in enumerate(self.nodes):
            for msg in node.outbox[self._delivered[i]:]:
                if isinstance(msg, WireProposal):
                    self._proposed.setdefault(msg.height,
                                              set()).add(msg.value)
                for out in self._outbound(i, msg):
                    for j in range(self.n):
                        if j != i:
                            self._channels.setdefault((i, j),
                                                      []).append(out)
            node.outbox.clear()
            self._delivered[i] = 0

    def _cross(self, i: int, j: int) -> bool:
        return (self._group is not None
                and self._group[i] != self._group[j])

    def mc_enabled(self, max_round: Optional[int] = None) -> List[tuple]:
        """Every action enabled in the current state, in canonical
        order (the determinism + partial-order-reduction key order).
        `max_round` prunes TIMEOUT_PRECOMMIT fires that would push a
        node past the round bound — rounds only ever advance off those
        fires, so this caps the explored round space."""
        assert self._step_mode
        acts: List[tuple] = []
        for (i, j), q in sorted(self._channels.items()):
            if q and not self._cross(i, j) and not self._asleep[j]:
                acts.append(("d", i, j))
        if self._group is not None:
            acts.append(("h",))
        if (self._mc_partition_groups is not None
                and self._group is None
                and self._partition_cycles < self._max_partition_cycles):
            acts.append(("p",))
        if self._churn_used < self._churn_budget:
            for j in sorted(self._churnable):
                if not self._asleep[j]:
                    acts.append(("s", j))
        for j in range(self.n):
            if self._asleep[j]:
                acts.append(("w", j))
        for j, node in enumerate(self.nodes):
            if self.specs[j].behavior == "silent" or self._asleep[j]:
                continue    # crash fault / asleep: the clock never fires
            seen = set()
            for t in node.wheel.pending():
                if not node.timer_live(t):
                    continue
                if (max_round is not None
                        and t.step == TimeoutStep.PRECOMMIT
                        and node.state.round >= max_round):
                    continue
                key = ("t", j, t.height, t.round, int(t.step))
                if key not in seen:
                    seen.add(key)
                    acts.append(key)
        return acts

    def mc_apply(self, act: tuple) -> bool:
        """Apply one action; False (state untouched) when it is not
        currently enabled — the tolerance delta-debug minimization
        leans on (a shrunk schedule stays runnable)."""
        assert self._step_mode
        kind = act[0]
        if kind == "d":
            _, i, j = act
            q = self._channels.get((i, j))
            if not q or self._cross(i, j) or self._asleep[j]:
                return False
            msg = q.pop(0)
            self._mc_track_delivery(j, msg)
            self.nodes[j].execute(msg)
        elif kind == "t":
            _, j, h, r, s = act
            t = WireTimeout(h, r, TimeoutStep(s))
            if self.specs[j].behavior == "silent" or self._asleep[j] \
                    or not self.nodes[j].wheel.remove(t):
                return False
            self.nodes[j].execute(t)
        elif kind == "s":
            _, j = act
            if (self._asleep[j] or j not in self._churnable
                    or self._churn_used >= self._churn_budget):
                return False
            self._asleep[j] = True
            self._churn_used += 1
        elif kind == "w":
            _, j = act
            if not self._asleep[j]:
                return False
            self._asleep[j] = False
            self.nodes[j].on_wake()
        elif kind == "p":
            if (self._group is not None
                    or self._mc_partition_groups is None
                    or self._partition_cycles
                    >= self._max_partition_cycles):
                return False
            self.partition(*self._mc_partition_groups)
            self._partition_cycles += 1
        elif kind == "h":
            if self._group is None:
                return False
            self._group = None      # channels become deliverable again
        else:
            raise ValueError(f"unknown action {act!r}")
        self._mc_route()
        return True

    def _mc_track_delivery(self, j: int, msg) -> None:
        if (isinstance(msg, Vote) and msg.validator is not None
                and msg.height == self.nodes[j].height):
            key = (msg.validator, msg.height, msg.round, int(msg.typ))
            vals = self._dv[j].setdefault(key, set())
            vals.add(-2 if msg.value is None else msg.value)
            if len(vals) > 1:
                self._expected_ev[j].add(key)

    # -- schedule serialization --------------------------------------------

    _ACT_NAMES = {"d": "deliver", "t": "timeout", "p": "partition",
                  "h": "heal", "s": "sleep", "w": "wake"}
    _ACT_CODES = {v: k for k, v in _ACT_NAMES.items()}

    @classmethod
    def action_to_json(cls, act: tuple) -> list:
        return [cls._ACT_NAMES[act[0]], *act[1:]]

    @classmethod
    def action_from_json(cls, a: list) -> tuple:
        return (cls._ACT_CODES[a[0]], *(int(x) for x in a[1:]))

    def run_schedule(self, actions: Sequence,
                     on_action: Optional[Callable] = None) -> List[bool]:
        """Deterministically replay a serialized schedule: start (if
        needed), then apply each action — JSON form or tuple form —
        skipping the not-currently-enabled ones.  `on_action(k, act,
        applied)` is the monitor hook.  Returns the applied flags."""
        assert self._step_mode
        if not any(nd._started for nd in self.nodes):
            self.mc_start()
        applied = []
        for k, a in enumerate(actions):
            act = self.action_from_json(a) if a[0] in self._ACT_CODES \
                else tuple(a)
            ok = self.mc_apply(act)
            applied.append(ok)
            if on_action is not None:
                on_action(k, act, ok)
        return applied

    # -- state-space branching ---------------------------------------------

    def mc_clone(self) -> "Network":
        """O(live state) copy of the whole stepped network — the
        exploration branch operation.  Shares: specs/seeds/vset/config
        (immutable after init), the partition scenario, and each
        node's frozen proposer memo (executor.clone)."""
        assert self._step_mode
        cls = type(self)
        net = cls.__new__(cls)
        net.n = self.n
        net.specs = self.specs
        net.timeout_config = self.timeout_config
        net.get_value = self.get_value
        net.verify_signatures = self.verify_signatures
        net.sign_messages = self.sign_messages
        net.executor_cls = self.executor_cls
        net.epochs = self.epochs     # post-init form: sorted-index, frozen
        net.seeds = self.seeds
        net.vset = self.vset
        net.nodes = [nd.clone() for nd in self.nodes]
        net._delivered = [0] * self.n
        net.dropped = self.dropped
        net._group = None if self._group is None else list(self._group)
        net._held_cross = []
        net.held_partition = 0
        net._step_mode = True
        net._channels = {k: list(q)
                         for k, q in self._channels.items() if q}
        net._mc_partition_groups = self._mc_partition_groups
        net._max_partition_cycles = self._max_partition_cycles
        net._partition_cycles = self._partition_cycles
        net._churn_budget = self._churn_budget
        net._churn_used = self._churn_used
        net._asleep = list(self._asleep)
        net._churnable = self._churnable
        net._proposed = {h: set(v) for h, v in self._proposed.items()}
        net._dv = [{k: set(v) for k, v in d.items()} for d in self._dv]
        net._expected_ev = [set(s) for s in self._expected_ev]
        return net

    @staticmethod
    def _canon_msg(m, perm: Optional[Sequence[int]] = None) -> tuple:
        if isinstance(m, Vote):
            v = m.validator
            if v is not None and perm is not None:
                v = perm[v]
            return (0, int(m.typ), m.round,
                    -2 if m.value is None else m.value,
                    -2 if v is None else v,
                    -2 if m.height is None else m.height)
        if isinstance(m, WireProposal):
            p = m.proposer if perm is None else perm[m.proposer]
            return (1, m.height, m.round, m.value, m.pol_round, p)
        raise TypeError(f"uncanonicalizable channel message {m!r}")

    def mc_canonical(self, perm: Optional[Sequence[int]] = None) -> tuple:
        """Canonical, int-only form of the global state: node states
        (executor.canonical_state), channel contents in per-link FIFO
        order, partition status, and the monitor trackers (included so
        two paths that agree on executor state but disagree on what
        the monitors should expect never merge).

        `perm` (old index -> new index) relabels the nodes — the
        symmetry-reduction surface (twin analysis/modelcheck.Symmetry):
        node i's state lands at position perm[i] with every embedded
        validator index rewritten, channel (i, j) becomes
        (perm[i], perm[j]).  Only sound for permutations that are true
        automorphisms of the network (equal behavior/power, proposer
        slots fixed, partition groups preserved) — the caller's
        contract, enforced by the group construction there."""
        assert self._step_mode
        if perm is None:
            nodes = tuple(nd.canonical_state() for nd in self.nodes)
            chans = tuple((i, j, tuple(self._canon_msg(m) for m in q))
                          for (i, j), q in sorted(self._channels.items())
                          if q)
            group = None if self._group is None else tuple(self._group)
            ev = tuple(tuple(sorted(s)) for s in self._expected_ev)
            asleep = tuple(self._asleep)
        else:
            by_pos = [None] * self.n
            for i, nd in enumerate(self.nodes):
                by_pos[perm[i]] = nd.canonical_state(perm)
            nodes = tuple(by_pos)
            chans = tuple(sorted(
                (perm[i], perm[j],
                 tuple(self._canon_msg(m, perm) for m in q))
                for (i, j), q in self._channels.items() if q))
            if self._group is None:
                group = None
            else:
                g = [0] * self.n
                for i in range(self.n):
                    g[perm[i]] = self._group[i]
                group = tuple(g)
            ev_pos: List[tuple] = [()] * self.n
            for i, s in enumerate(self._expected_ev):
                ev_pos[perm[i]] = tuple(sorted(
                    (perm[val], h, r, t) for (val, h, r, t) in s))
            ev = tuple(ev_pos)
            sl = [False] * self.n
            for i in range(self.n):
                sl[perm[i]] = self._asleep[i]
            asleep = tuple(sl)
        return (
            nodes,
            chans,
            group,
            self._partition_cycles,
            tuple(sorted((h, tuple(sorted(v)))
                         for h, v in self._proposed.items())),
            ev,
            asleep,
            self._churn_used,
        )

    def mc_digest(self, perm: Optional[Sequence[int]] = None) -> bytes:
        """16-byte stable digest of mc_canonical — the dedup key.
        The canonical form is pure ints/None/tuples with every
        container SORTED, serialized through `marshal` (a canonical
        byte encoding of exactly those types): no repr-format
        dependence, no dict-insertion-order sensitivity, no
        PYTHONHASHSEED sensitivity; negligible collision odds at
        corpus scale."""
        import hashlib
        import marshal

        return hashlib.blake2b(marshal.dumps(self.mc_canonical(perm), 2),
                               digest_size=16).digest()
