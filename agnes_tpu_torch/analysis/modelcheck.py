"""Exhaustive bounded model checker for the consensus core (twin of
`agnes_tpu.analysis.modelcheck`, over the port's host plane).

The reference's whole design argument is that the consensus core is
pure and I/O-free precisely so its logic can be checked without
networking or signatures (README.md:8-14) — yet without this module the
only guard on the *semantics* was a 100-random-seed fuzz
(tests/test_cross_plane.py).  TOB-SVD (arXiv 2310.11331) catalogues
exactly the class of adversarial participation/schedule corners that
sampled fuzzing misses.  This checker closes the gap for SMALL SCOPES:
it exhaustively enumerates every delivery/timeout/partition schedule of
the host plane (harness/simulator.py step mode) within explicit bounds
and checks spec-level property monitors on every reachable state.

Soundness envelope — what "exhaustive" means here
-------------------------------------------------

Exhaustive WITHIN the bounds of an `MCConfig`, nothing beyond them:

  * N nodes with a fixed behavior assignment (honest / silent /
    equivocator / nil_flood — the simulator's fault models), one
    optional partition/heal cycle;
  * schedule length <= `depth` actions;
  * rounds <= `max_round` (rounds only advance off TIMEOUT_PRECOMMIT
    fires, which the action enumerator caps);
  * heights <= `max_height` (states where every node has advanced past
    the bound stop expanding);
  * a FIXED validator-set epoch schedule (`epochs`): per-
    height-boundary power tables mirroring the device plane's
    `set_validators` contract — tallies, DecisionCerts and the quorum
    monitor are all indexed by the epoch live at the vote's height;
  * at most `churn_budget` sleepy-churn naps (TOB-SVD's
    sleepy model): ("s", j)/("w", j) actions — deliveries to an
    asleep node hold, its timers freeze, a wake releases both —
    budgeted exactly the way faults are.

Within that envelope every interleaving is covered: the explorer is a
depth-bounded DFS over the step-mode transition system with

  * canonical state hashing (`Network.mc_digest` over int-only
    canonical forms — deadline-free timers, dead-timer erasure, history
    erasure) so converging interleavings merge, and
  * partial-order reduction: deliveries/timeouts targeting DISTINCT
    nodes commute (they touch disjoint node state and disjoint channel
    heads), so after exploring independent action `a` from a state, the
    lower-ordered independent siblings already explored from that state
    are put to sleep in `a`'s subtree — the pruned interleaving's
    successor is exactly the state the sibling-first branch reaches.
    Partition/heal are global (never slept).  `por=False` disables the
    reduction; tests assert por/no-por reach the SAME state set.

Property monitors (checked on every new state / transition):

  agreement      no two nodes decide different values at a height
                 (every node runs honest executor logic — byzantine
                 behaviors are router policies — so ALL nodes count)
  validity       every decided value was carried by some WireProposal
                 of that height
  quorum         every decision's DecisionCert (core/executor.py)
                 shows +2/3 precommit weight — no decide without quorum
  monotonic      per node, (height, round, step) never decreases
  evidence       every schedule-injected equivocation pair that was
                 delivered-and-counted is surfaced by round_votes
                 (`all_equivocations`)

Any violation is delta-debug-minimized (`minimize`) to a short
schedule; `run_schedule` skips not-enabled actions, which is what makes
arbitrary ddmin subsets replayable.  A minimized counterexample is
serialized as a corpus entry (tests/corpus/*.json) and can be replayed
through the PRODUCTION device plane (`device_replay_entry`:
VoteBatcher -> fused step via harness/replay.py) so a semantic
counterexample immediately becomes a cross-plane differential case.

The checker itself is pure CPU and imports no torch: the consensus
shards run over harness/simulator.py, core/executor.py and
core/state_machine.py alone; the admission and membership models
(which import the serve plane and distributed/membership.py, and so
torch) load lazily, inside `run_scope`, `_scope_worker`, `emit_corpus`
and the CLI's `--self-test`.  `run_scope` shards configs over spawned
(never forked) workers, and the CLI honours a discovered deadline:
an exhausted budget reports a clean partial (complete=False) instead
of being killed.  `device_replay_entry` is the one path that runs the
device plane.

Mutation self-test (`self_test` / `--self-test`): doctored executors
— deciding without quorum, dropping equivocation evidence, counting
heads instead of power, tallying against the PREVIOUS validator-set
epoch, treating a wake as a reboot — must each be caught, minimized,
and must vanish when the same schedule replays on the honest
executor; violations living past a height boundary (DEEP_MUTANTS)
are walk-discovered on the doctored executor and share the same
drill.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from agnes_tpu_torch.core.executor import ConsensusExecutor
from agnes_tpu_torch.core import state_machine as sm
from agnes_tpu_torch.harness.simulator import Network, NodeSpec
from agnes_tpu_torch.types import VoteType

PROPERTIES = ("agreement", "validity", "quorum", "monotonic", "evidence")


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MCConfig:
    """One bounded-exploration task: a behavior assignment plus the
    exhaustiveness envelope.  JSON-able (spawn workers, corpus files).

    `powers` assigns per-node voting power (original-index order, like
    `behaviors`; None = all 1).  Asymmetric vectors move every +2/3
    quorum boundary (the committee-weight bug class, arXiv
    2004.12990) and the monitors check the WEIGHTED predicates
    (DecisionCert weight vs total power), so a tally that counts heads
    instead of power is a catchable bug (the weight-blind mutant).

    `epochs` is a validator-set epoch schedule:
    ((boundary_height, (power, ...)), ...) in original-index order —
    at every height the tally weights/totals come from the epoch with
    the largest boundary <= height (genesis `powers` below the first
    boundary), mirroring the device plane's `set_validators`
    height-boundary contract.  A boundary at height 0 models a set
    rotated in at genesis whose table differs from the one the
    rotation was seeded with — the cheapest scope in which a
    stale-epoch tally is a reachable, catchable bug.

    `churn_budget`/`churnable` open TOB-SVD's sleepy-participation
    schedule space (arXiv 2310.11331): ("s", j)/("w", j) actions join
    the explored alphabet, bounded exactly the way faults are — at
    most `churn_budget` sleeps, `churnable` (sorted-set indices, like
    `partition`) naming the nodes allowed to nap (None = every honest
    node).

    The three new knobs serialize ONLY when non-default so every
    pre-epoch corpus entry regenerates bit-identical."""

    name: str
    n: int = 4
    behaviors: Tuple[str, ...] = ("honest",) * 4
    depth: int = 10
    max_round: int = 1
    max_height: int = 0
    partition: Optional[Tuple[Tuple[int, ...], ...]] = None
    get_value_base: int = 100
    powers: Optional[Tuple[int, ...]] = None
    epochs: Optional[Tuple[Tuple[int, Tuple[int, ...]], ...]] = None
    churn_budget: int = 0
    churnable: Optional[Tuple[int, ...]] = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["behaviors"] = list(self.behaviors)
        d["partition"] = None if self.partition is None else \
            [list(g) for g in self.partition]
        if self.powers is not None:
            d["powers"] = list(self.powers)
        # bit-stable serialization: configs without epochs or churn produce
        # the exact JSON they always did (corpus regeneration contract)
        if self.epochs is None:
            d.pop("epochs")
        else:
            d["epochs"] = [[h, list(pw)] for h, pw in self.epochs]
        if not self.churn_budget:
            d.pop("churn_budget")
        if self.churnable is None:
            d.pop("churnable")
        else:
            d["churnable"] = list(self.churnable)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "MCConfig":
        d = dict(d)
        d["behaviors"] = tuple(d["behaviors"])
        if d.get("partition") is not None:
            d["partition"] = tuple(tuple(g) for g in d["partition"])
        if d.get("powers") is not None:
            d["powers"] = tuple(d["powers"])
        if d.get("epochs") is not None:
            d["epochs"] = tuple((int(h), tuple(pw))
                                for h, pw in d["epochs"])
        if d.get("churnable") is not None:
            d["churnable"] = tuple(d["churnable"])
        return cls(**d)

    def epochs_dict(self) -> Optional[Dict[int, Tuple[int, ...]]]:
        """The schedule as the {boundary: powers} dict Network takes."""
        return None if self.epochs is None else dict(self.epochs)


def build_network(cfg: MCConfig,
                  executor_cls: Optional[type] = None,
                  sign: bool = False,
                  verify: Optional[bool] = None,
                  start: bool = True) -> Network:
    """A step-mode Network for `cfg`.  The checker runs unsigned +
    unverified (crypto is differential-tested elsewhere; the schedule
    space is about consensus logic); corpus replay rebuilds the SAME
    config signed + verifying for production parity (sign=True)."""
    base = cfg.get_value_base
    powers = cfg.powers or (1,) * cfg.n
    net = Network(
        n=cfg.n,
        specs=[NodeSpec(behavior=b, power=p)
               for b, p in zip(cfg.behaviors, powers)],
        get_value=lambda h: base + h,
        verify_signatures=sign if verify is None else verify,
        sign_messages=sign,
        executor_cls=executor_cls or ConsensusExecutor,
        epochs=cfg.epochs_dict())
    net.enable_step_mode(partition_groups=cfg.partition,
                         max_height=cfg.max_height,
                         churn_budget=cfg.churn_budget,
                         churnable=cfg.churnable)
    if start:
        net.mc_start()
    return net


# ---------------------------------------------------------------------------
# Property monitors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Violation:
    property: str
    node: int                  # -1 for global properties
    detail: str


def _edge_snapshot(net: Network) -> list:
    """The per-node facts the transition monitors compare across one
    action: position, decision/cert counts."""
    return [((nd.height, nd.state.round, int(nd.state.step)),
             len(nd.decisions), len(nd.decision_certs))
            for nd in net.nodes]


def _edge_violations(net: Network, snap: list) -> List[Violation]:
    """Monotonicity + quorum certificates, checked on the transition
    from the state `snap` was taken in to `net`'s current state."""
    out: List[Violation] = []
    for j, nd in enumerate(net.nodes):
        pos0, n_dec0, _n_cert0 = snap[j]
        pos = (nd.height, nd.state.round, int(nd.state.step))
        if pos < pos0:
            out.append(Violation(
                "monotonic", j,
                f"(height, round, step) went {pos0} -> {pos}"))
        for i in range(n_dec0, len(nd.decisions)):
            d = nd.decisions[i]
            if i >= len(nd.decision_certs):
                out.append(Violation(
                    "quorum", j,
                    f"decision {d} recorded without a quorum "
                    f"certificate"))
                continue
            c = nd.decision_certs[i]
            epoch_total = net.epoch_total_at(d.height)
            if (c.height, c.round, c.value) != (d.height, d.round,
                                                d.value):
                out.append(Violation(
                    "quorum", j,
                    f"certificate {c} does not match decision {d}"))
            elif c.total != epoch_total:
                # epoch-indexed check: the quorum must be
                # denominated in the validator set LIVE at the vote's
                # height — a cert totalled against any other epoch is
                # the stale-epoch tally bug even if its own arithmetic
                # clears +2/3
                out.append(Violation(
                    "quorum", j,
                    f"decided {d.value} at (h={d.height}, r={d.round}) "
                    f"with a certificate denominated {c.weight}/"
                    f"{c.total} against a stale validator-set epoch "
                    f"(live epoch total: {epoch_total})"))
            elif not 3 * c.weight > 2 * c.total:
                out.append(Violation(
                    "quorum", j,
                    f"decided {d.value} at (h={d.height}, r={d.round}) "
                    f"on precommit weight {c.weight}/{c.total} "
                    f"(< +2/3)"))
    return out


def _state_violations(net: Network) -> List[Violation]:
    """Agreement, validity, evidence completeness — state predicates."""
    out: List[Violation] = []
    by_height: Dict[int, Dict[int, int]] = {}
    for j, nd in enumerate(net.nodes):
        for h, d in nd.decided.items():
            by_height.setdefault(h, {})[j] = d.value
    for h, m in sorted(by_height.items()):
        if len(set(m.values())) > 1:
            out.append(Violation(
                "agreement", -1,
                f"height {h} decided as {sorted(m.items())}"))
        proposed = net._proposed.get(h, ())
        for j, v in sorted(m.items()):
            if v not in proposed:
                out.append(Violation(
                    "validity", j,
                    f"node {j} decided unproposed value {v} at "
                    f"height {h} (proposed: {sorted(proposed)})"))
    for j, nd in enumerate(net.nodes):
        expected = net._expected_ev[j]
        if not expected:
            continue
        have = {(e.validator, e.height, e.round, int(e.typ))
                for e in nd.all_equivocations()}
        missing = expected - have
        if missing:
            out.append(Violation(
                "evidence", j,
                f"node {j} counted conflicting vote pairs "
                f"{sorted(missing)} but surfaced no equivocation "
                f"evidence for them"))
    return out


# ---------------------------------------------------------------------------
# Symmetry reduction
# ---------------------------------------------------------------------------


class SymmetryCapError(AssertionError):
    """A state escaped the envelope the symmetry group was built for
    (a node's height exceeded `h_cap` or its round exceeded
    `max_round`).  Orbit merges made under that assumption would be
    unsound, so the exploration fails LOUD instead of silently
    reporting a reduced-but-wrong state count.  The fix is a larger
    cap (more fixed proposer slots, less reduction), never ignoring
    the error."""


def relabel_action(act: tuple, perm: Sequence[int]) -> tuple:
    """An action's name under a node relabeling: deliveries carry
    (src, dst), timeouts and sleep/wake a node index; partition/heal
    are global."""
    k = act[0]
    if k == "d":
        return ("d", perm[act[1]], perm[act[2]])
    if k == "t":
        return ("t", perm[act[1]], *act[2:])
    if k in ("s", "w"):
        return (k, perm[act[1]])
    return act


@dataclasses.dataclass(frozen=True)
class Symmetry:
    """A sound node-permutation group for one MCConfig.

    Honest nodes are interchangeable — relabeling them induces a
    bisimulation — PROVIDED the permutation fixes everything the
    transition relation can tell nodes apart by:

      * behavior (byzantine policies are per-node),
      * voting power in EVERY epoch window live inside the envelope
        (weights feed every quorum predicate, per height —
        validator-set epochs make power a function of height),
      * sleepy-churn eligibility (a churnable node's enabled alphabet
        includes ("s", j); relabeling it onto a pinned-awake node
        would not be a bisimulation),
      * partition group (the ("p",) action's shape is fixed),
      * every proposer slot queryable inside the envelope: heights
        <= `h_cap`, rounds <= `max_round` (proposer identity is the
        ONE asymmetry in honest logic).  `h_cap` comes from a sound
        decision lower bound (`_decision_bound`): when the schedule
        budget cannot possibly produce a decision, no node ever
        leaves height 0 and only height-0 proposers need fixing —
        which is what makes the n=7 scopes collapse by orbits of the
        5 interchangeable non-proposers.

    `digest()` re-checks the envelope on every state (SymmetryCapError
    on escape), so the reduction is self-verifying rather than
    trusted.  Only meaningful on unsigned networks (the checker's
    build): per-node signing keys would distinguish relabeled nodes.
    """

    perms: Tuple[Tuple[int, ...], ...]     # identity first
    h_cap: int
    max_round: int

    def check(self, net: Network) -> None:
        for nd in net.nodes:
            if nd.height > self.h_cap:
                raise SymmetryCapError(
                    f"node at height {nd.height} > symmetry h_cap "
                    f"{self.h_cap}: orbit merges would be unsound")
            if nd.state.round > self.max_round:
                raise SymmetryCapError(
                    f"node at round {nd.state.round} > symmetry round "
                    f"cap {self.max_round}")

    def digest(self, net: Network) -> Tuple[bytes,
                                            Optional[Tuple[int, ...]]]:
        """(least orbit digest, canonicalizing perm or None for
        identity) — the visited key and the frame's action-name
        translation (the rec[] bookkeeping must compare actions in ONE
        labeling per orbit)."""
        self.check(net)
        best = net.mc_digest()
        best_p: Optional[Tuple[int, ...]] = None
        for p in self.perms[1:]:
            d = net.mc_digest(p)
            if d < best:
                best, best_p = d, p
        return best, best_p


def _decision_bound(net: Network, max_height: int = 0) -> int:
    """A sound LOWER bound on the schedule length of any decision:
    the decider needs q-1 delivered value-precommits (q = fewest
    validators, heaviest first, whose power clears +2/3), and each of
    those q-1 precommitters needed q-1 delivered prevotes for its
    polka — all distinct delivery actions.  Behaviors only remove
    messages, first-vote dedup blocks double counting, and sleepy
    churn only withholds deliveries, so no fault or churn schedule
    shortens this.  With validator-set epochs the quorum size varies
    per height, so the bound is the MINIMUM over every epoch live
    within the envelope (heights 0..max_height+1) — a decision at any
    reachable height needs at least its own epoch's q*(q-1).  Holds
    for the HONEST quorum rule only — a doctored executor may decide
    cheaper, so mutant explorations must not lean on it
    (build_symmetry keeps their h_cap conservative)."""
    def bound_at(height: int) -> int:
        powers = sorted(net.epoch_powers_at(height), reverse=True)
        total = sum(powers)
        acc = q = 0
        for w in powers:
            acc += w
            q += 1
            if 3 * acc > 2 * total:
                break
        return q * (q - 1)

    return min(bound_at(h) for h in range(max_height + 2))


def build_symmetry(cfg: MCConfig,
                   executor_cls: Optional[type] = None,
                   max_perms: int = 24) -> Symmetry:
    """The symmetry group for `cfg` (sorted-index space).  Buckets the
    honest, non-proposer-slot nodes by their full distinguishing
    profile and permutes within buckets; the group size is capped at
    `max_perms` (canonicalization costs one digest per perm per state)
    by fixing lowest-index members of the largest bucket first —
    deterministic, less reduction, never unsound.

    PER-EPOCH construction: interchangeable nodes must agree
    on everything the transition relation can tell them apart by in
    EVERY epoch window reachable inside the envelope — genesis power,
    the power vector of each epoch live at heights <= h_cap, partition
    group, proposer slots, and sleepy-churn eligibility (a churnable
    node and a pinned-awake one have different enabled alphabets, so
    relabeling across that line would not be a bisimulation).  The
    epoch profile is read through `Network.epoch_powers_at` — the same
    config-derived ground truth the monitors use — never through a
    (possibly doctored) executor."""
    import itertools
    import math

    net = build_network(cfg, executor_cls)
    mutant = executor_cls is not None \
        and executor_cls is not ConsensusExecutor
    if mutant or cfg.depth >= _decision_bound(net, cfg.max_height):
        h_cap = cfg.max_height + 1
    else:
        h_cap = 0            # no decision fits the budget: heights pin
    probe = net.nodes[0]
    fixed = {probe.proposer(h, r)
             for h in range(h_cap + 1)
             for r in range(cfg.max_round + 1)}
    gid: List[Optional[int]] = [None] * cfg.n
    if cfg.partition is not None:
        for g, members in enumerate(cfg.partition):
            for i in members:
                gid[i] = g
    buckets_by_key: Dict[tuple, List[int]] = {}
    for i in range(cfg.n):
        if i in fixed or net.specs[i].behavior != "honest":
            continue
        epoch_profile = tuple(net.epoch_powers_at(h)[i]
                              for h in range(h_cap + 1))
        churn_ok = (i in net._churnable) if cfg.churn_budget else None
        key = (net.specs[i].power, epoch_profile, gid[i], churn_ok)
        buckets_by_key.setdefault(key, []).append(i)
    buckets = [b for b in buckets_by_key.values() if len(b) >= 2]

    def group_size(bs):
        return math.prod(math.factorial(len(b)) for b in bs)

    while buckets and group_size(buckets) > max_perms:
        max(buckets, key=len).pop(0)
        buckets = [b for b in buckets if len(b) >= 2]

    ident = tuple(range(cfg.n))
    perms = [ident]
    for b in buckets:                      # buckets are disjoint
        perms = [_compose(p, b, order)
                 for p in perms
                 for order in itertools.permutations(b)]
    perms = [ident] + sorted(p for p in set(perms) if p != ident)
    return Symmetry(perms=tuple(perms), h_cap=h_cap,
                    max_round=cfg.max_round)


def _compose(base: Tuple[int, ...], bucket: List[int],
             order: Tuple[int, ...]) -> Tuple[int, ...]:
    p = list(base)
    for src, dst in zip(bucket, order):
        p[src] = dst
    return tuple(p)


# ---------------------------------------------------------------------------
# The explorer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Counterexample:
    config: object                 # MCConfig | admission config
    violation: Violation
    schedule: List[tuple]          # action tuples from the initial state
    minimized: Optional[List[tuple]] = None
    codec: type = Network          # owns action_to_json/from_json

    def to_json(self) -> dict:
        sched = self.minimized if self.minimized is not None \
            else self.schedule
        return {
            "config": self.config.to_json(),
            "property": self.violation.property,
            "node": self.violation.node,
            "detail": self.violation.detail,
            "schedule": [self.codec.action_to_json(a) for a in sched],
            "schedule_unminimized":
                [self.codec.action_to_json(a) for a in self.schedule],
        }


@dataclasses.dataclass
class Report:
    config: object
    states: int = 0
    transitions: int = 0
    violations: List[Counterexample] = dataclasses.field(
        default_factory=list)
    near_misses: Dict[str, list] = dataclasses.field(default_factory=dict)
    complete: bool = True
    deepest: int = 0
    seconds: float = 0.0
    # filled only when explore(collect_digests=True): the exact visited
    # key set (canonical ORBIT digests under symmetry reduction), for
    # the POR/symmetry-soundness equivalence tests
    digests: Optional[set] = None
    # filled only when explore(collect_orbit_digests=True): the orbit
    # digest of every visited state — lets an UNREDUCED run state its
    # orbit coverage for comparison against a reduced run
    orbit_digests: Optional[set] = None
    # symmetry-group size the exploration ran under (1 = unreduced)
    sym_perms: int = 1
    codec: type = Network

    def to_json(self) -> dict:
        return {
            "config": self.config.name,
            "states": self.states,
            "transitions": self.transitions,
            "violations": [c.to_json() for c in self.violations],
            "near_misses": {k: [self.codec.action_to_json(a) for a in v]
                            for k, v in self.near_misses.items()},
            "complete": self.complete,
            "deepest": self.deepest,
            "sym_perms": self.sym_perms,
            "seconds": round(self.seconds, 1),
        }


def _target(act: tuple) -> Optional[int]:
    """The node an action mutates, None for global actions."""
    if act[0] == "d":
        return act[2]
    if act[0] in ("t", "s", "w"):
        return act[1]
    return None


def _indep(a: tuple, b: tuple) -> bool:
    if a[0] in ("s", "w") and b[0] in ("s", "w"):
        # the shared churn budget couples churn actions: with one
        # sleep left in the budget, taking ("s", j) DISABLES the
        # sibling ("s", k) — the commuting diamond the sleep-set
        # argument needs never closes, so churn-churn pairs stay
        # dependent (deliveries/timeouts never touch the budget, so
        # the distinct-target rule below remains exact for them)
        return False
    ta, tb = _target(a), _target(b)
    return ta is not None and tb is not None and ta != tb


class _Frame:
    __slots__ = ("net", "digest", "depth", "snap", "todo", "idx",
                 "sleep", "cperm")

    def __init__(self, net, digest, depth, snap, todo, sleep, cperm):
        self.net = net
        self.digest = digest
        self.depth = depth
        self.snap = snap
        self.todo = todo
        self.idx = 0
        self.sleep = sleep
        self.cperm = cperm      # canonicalizing perm (None = identity)


def _expandable(net: Network, cfg: MCConfig) -> bool:
    """Height bound: stop once EVERY node is past max_height (partial
    advancement keeps exploring — laggards must still be deliverable)."""
    return any(nd.height <= cfg.max_height for nd in net.nodes)


@dataclasses.dataclass
class Domain:
    """The exhaustive engine's pluggable surface (the one DFS drives
    the consensus Network, the serve-plane admission model and the
    pod-membership model).  A system object must provide mc_clone / mc_apply /
    mc_digest; everything domain-specific — enabling, monitors, POR
    independence, bounds — arrives as hooks."""

    enabled: Callable[[object], List[tuple]]
    expandable: Callable[[object], bool]
    state_violations: Callable[[object], List[Violation]]
    edge_snapshot: Callable[[object], object]
    edge_violations: Callable[[object, object], List[Violation]]
    indep: Callable[[tuple, tuple], bool]
    near_miss: Optional[Callable[[object, list, "Report"], None]] = None
    symmetry: Optional[Symmetry] = None    # orbit-reduced visited keys
    codec: type = Network


def _explore_domain(root, cfg, dom: Domain, *,
                    por: bool = True,
                    deadline_at: Optional[float] = None,
                    max_states: Optional[int] = None,
                    stop_on_violation: bool = True,
                    collect_digests: bool = False,
                    collect_orbit_digests: bool = False,
                    orbit_sym: Optional[Symmetry] = None) -> Report:
    """Depth-bounded exhaustive DFS over `cfg`'s schedule space
    (`cfg.depth` bounds it; `deadline_at` is an absolute time.time()
    instant past which exploration stops cleanly with complete=False —
    the sentinel half of a bounded run).  Returns on the first violation
    (minimized by the caller).

    Symmetry composition (dom.symmetry): the visited key is the LEAST
    ORBIT digest, and — because different orbit members name the same
    action differently — the per-orbit explored-action bookkeeping
    (`rec[1]`, the sleep-set/state-caching repair) stores and compares
    action names translated into the orbit's canonical labeling via
    each frame's canonicalizing perm.  Concrete frames are never
    relabeled, so counterexample schedules stay root-replayable, and
    POR's sleep sets (path-local, concrete labels) compose unchanged.

    `orbit_sym` makes an UNREDUCED run also record the orbit digest of
    every visited state (Report.orbit_digests) so tests can prove the
    reduced search covers the identical orbit set."""
    t0 = time.perf_counter()
    rep = Report(config=cfg, codec=dom.codec)
    sym = dom.symmetry
    if sym is not None:
        rep.sym_perms = len(sym.perms)
    viols = dom.state_violations(root)
    if viols:
        rep.violations.append(
            Counterexample(cfg, viols[0], [], codec=dom.codec))
        rep.states = 1
        rep.complete = False        # truncated at the root
        rep.seconds = time.perf_counter() - t0
        return rep

    # visited key -> [min_depth_seen, explored action set (canonical
    # labels under symmetry)]
    visited: Dict[bytes, list] = {}
    # raw digest -> (orbit digest, canonicalizing perm): revisits of a
    # raw-identical state skip the |perms| canonicalization loop
    orbit_memo: Dict[bytes, tuple] = {}
    path: List[tuple] = []
    orbit_digests: Optional[set] = set() if orbit_sym is not None \
        else None

    def state_key(net):
        if sym is None and orbit_sym is None:
            return net.mc_digest(), None
        raw = net.mc_digest()
        hit = orbit_memo.get(raw)
        if hit is None:
            hit = orbit_memo[raw] = (sym or orbit_sym).digest(net)
        orbit, cperm = hit
        if orbit_digests is not None:
            orbit_digests.add(orbit)
        if sym is None:
            return raw, None
        return orbit, cperm

    def canon_act(act, cperm):
        return act if cperm is None else relabel_action(act, cperm)

    def make_frame(net, digest, depth, sleep, cperm):
        enabled = dom.enabled(net)
        rec = visited.get(digest)
        if rec is None:
            rec = visited[digest] = [depth, set()]
        elif depth < rec[0]:
            # shallower re-visit: the earlier subtree had less depth
            # budget — re-explore everything from here
            rec[0] = depth
            rec[1] = set()
        todo = [a for a in enabled
                if a not in sleep and canon_act(a, cperm) not in rec[1]]
        rec[1].update(canon_act(a, cperm) for a in todo)
        return _Frame(net, digest, depth, dom.edge_snapshot(net),
                      todo, sleep, cperm)

    root_digest, root_cperm = state_key(root)
    stack = [make_frame(root, root_digest, 0, frozenset(), root_cperm)]
    check_tick = 0

    while stack:
        f = stack[-1]
        if f.idx >= len(f.todo) or f.depth >= cfg.depth \
                or not dom.expandable(f.net):
            stack.pop()
            if path:
                path.pop()
            continue
        act = f.todo[f.idx]
        f.idx += 1

        check_tick += 1
        if deadline_at is not None and check_tick % 256 == 0 \
                and time.time() > deadline_at:
            rep.complete = False
            break
        if max_states is not None and len(visited) >= max_states:
            rep.complete = False
            break

        child = f.net.mc_clone()
        applied = child.mc_apply(act)
        assert applied, (act, "enabled action failed to apply")
        rep.transitions += 1
        depth = f.depth + 1
        rep.deepest = max(rep.deepest, depth)
        sched = path + [act]

        for v in dom.edge_violations(child, f.snap):
            rep.violations.append(
                Counterexample(cfg, v, sched, codec=dom.codec))
        digest, cperm = state_key(child)
        rec = visited.get(digest)
        new_state = rec is None
        if new_state:
            # register EVERY distinct state — including the depth-bound
            # frontier, which never gets a frame: states_explored must
            # count it and the monitors must not re-run per path to it
            visited[digest] = [depth, set()]
            for v in dom.state_violations(child):
                rep.violations.append(
                    Counterexample(cfg, v, sched, codec=dom.codec))
            if dom.near_miss is not None:
                dom.near_miss(child, sched, rep)
        if rep.violations and stop_on_violation:
            rep.complete = False    # truncated, not exhausted
            break

        if depth >= cfg.depth:
            continue
        needs_visit = new_state or depth < rec[0]
        sleep = None
        if not needs_visit:
            # already visited at <= this depth; only new actions (ones
            # neither explored nor slept before) warrant a re-push
            enabled = dom.enabled(child)
            sleep = _child_sleep(f, act, por, dom)
            needs_visit = any(a not in sleep
                              and canon_act(a, cperm) not in rec[1]
                              for a in enabled)
        if needs_visit:
            if sleep is None:
                sleep = _child_sleep(f, act, por, dom)
            nf = make_frame(child, digest, depth, sleep, cperm)
            if nf.todo:
                stack.append(nf)
                path.append(act)

    rep.states = len(visited)
    if collect_digests:
        rep.digests = set(visited)
    if orbit_digests is not None:
        rep.orbit_digests = orbit_digests
    elif sym is not None and collect_orbit_digests:
        # under symmetry the visited keys ARE the orbit digests — the
        # field's contract holds in both modes
        rep.orbit_digests = set(visited)
    rep.seconds = time.perf_counter() - t0
    return rep


def _child_sleep(f: "_Frame", act: tuple, por: bool,
                 dom: Domain) -> frozenset:
    """Sleep set for `act`'s subtree: lower-ordered independent actions
    already explored from `f`'s state — their both-orders diamond
    closes, so re-exploring them under `act` only re-reaches the state
    the sibling-first branch already covers (module docstring)."""
    if not por:
        return frozenset()
    explored = f.todo[:f.idx - 1]
    inherited = f.sleep
    return frozenset(
        b for b in (*explored, *inherited)
        if dom.indep(b, act) and b < act)


def _consensus_domain(cfg: MCConfig,
                      symmetry: Optional[Symmetry] = None) -> Domain:
    return Domain(
        enabled=lambda net: net.mc_enabled(max_round=cfg.max_round),
        expandable=lambda net: _expandable(net, cfg),
        state_violations=_state_violations,
        edge_snapshot=_edge_snapshot,
        edge_violations=_edge_violations,
        indep=_indep,
        near_miss=_classify_near_miss,
        symmetry=symmetry,
        codec=Network)


def explore(cfg: MCConfig,
            executor_cls: Optional[type] = None,
            por: bool = True,
            deadline_at: Optional[float] = None,
            max_states: Optional[int] = None,
            stop_on_violation: bool = True,
            collect_digests: bool = False,
            sym: bool = False,
            collect_orbit_digests: bool = False) -> Report:
    """Depth-bounded exhaustive DFS over `cfg`'s schedule space (the
    consensus domain; _explore_domain is the engine).  `sym=True`
    composes symmetry reduction with POR: states dedup on least-orbit
    digests (build_symmetry's group), cutting visited states by up to
    |group| while reaching the identical orbit set — `run_scope`
    runs with it on.  `collect_orbit_digests` makes an unreduced run
    record its orbit coverage for the equivalence tests."""
    symmetry = build_symmetry(cfg, executor_cls) if sym else None
    orbit_sym = build_symmetry(cfg, executor_cls) \
        if (collect_orbit_digests and not sym) else None
    root = build_network(cfg, executor_cls)
    return _explore_domain(
        root, cfg, _consensus_domain(cfg, symmetry), por=por,
        deadline_at=deadline_at, max_states=max_states,
        stop_on_violation=stop_on_violation,
        collect_digests=collect_digests,
        collect_orbit_digests=collect_orbit_digests,
        orbit_sym=orbit_sym)


def _classify_near_miss(net: Network, sched: List[tuple],
                        rep: Report) -> None:
    """Tag interesting first-reached states; the schedules seed the
    regression corpus (kept as-reached; corpus emission minimizes)."""
    def put(tag):
        if tag not in rep.near_misses:
            rep.near_misses[tag] = list(sched)

    if all(0 in nd.decided for nd in net.nodes):
        put("all_decided")
        if any(nd.decided[0].round >= 1 for nd in net.nodes):
            put("multi_round_decision")
        if net._partition_cycles and net._group is None:
            put("healed_then_decided")
    if any(nd.all_equivocations() for nd in net.nodes):
        put("evidence_surfaced")


# ---------------------------------------------------------------------------
# Deterministic replay + delta-debug minimization
# ---------------------------------------------------------------------------


def run_with_monitors(cfg: MCConfig, actions: Sequence,
                      executor_cls: Optional[type] = None,
                      sign: bool = False) -> Tuple[Network,
                                                   List[Violation]]:
    """Replay `actions` (tuple or JSON form; not-enabled ones skip) on
    a fresh network, running every monitor after every applied action —
    the reproduction predicate for minimization and the corpus tests."""
    net = build_network(cfg, executor_cls, sign=sign)
    viols: List[Violation] = list(_state_violations(net))
    snap = [_edge_snapshot(net)]

    def on_action(_k, _act, ok):
        if ok:
            viols.extend(_edge_violations(net, snap[0]))
            viols.extend(_state_violations(net))
        snap[0] = _edge_snapshot(net)

    net.run_schedule(actions, on_action=on_action)
    return net, viols


def reproduces(cfg: MCConfig, actions: Sequence, prop: str,
               executor_cls: Optional[type] = None) -> bool:
    _, viols = run_with_monitors(cfg, actions, executor_cls)
    return any(v.property == prop for v in viols)


def minimize_schedule(cfg: MCConfig, actions: Sequence[tuple],
                      pred: Callable[[Network, List[Violation]], bool],
                      executor_cls: Optional[type] = None) -> List[tuple]:
    """ddmin (Zeller) over the action sequence, then a greedy
    one-at-a-time pass: a short schedule whose deterministic replay
    still satisfies `pred(net, violations)`.  Replay-with-skip keeps
    every subset well-defined."""
    def pred_acts(acts: List[tuple]) -> bool:
        return pred(*run_with_monitors(cfg, acts, executor_cls))

    return _ddmin(list(actions), pred_acts)


def minimize(cfg: MCConfig, actions: Sequence[tuple], prop: str,
             executor_cls: Optional[type] = None) -> List[tuple]:
    """Shortest (under ddmin) schedule still violating `prop`."""
    return minimize_schedule(
        cfg, actions,
        lambda _net, viols: any(v.property == prop for v in viols),
        executor_cls)


def _ddmin(acts: List[tuple], pred: Callable[[List[tuple]], bool]
           ) -> List[tuple]:
    assert pred(acts), "minimize called on a non-reproducing schedule"
    n = 2
    while len(acts) >= 2:
        chunk = max(1, len(acts) // n)
        reduced = False
        for i in range(0, len(acts), chunk):
            trial = acts[:i] + acts[i + chunk:]
            if trial and pred(trial):
                acts = trial
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(acts):
                break
            n = min(len(acts), 2 * n)
    # greedy 1-minimal pass
    i = 0
    while i < len(acts):
        trial = acts[:i] + acts[i + 1:]
        if trial and pred(trial):
            acts = trial
        else:
            i += 1
    return acts


# ---------------------------------------------------------------------------
# Corpus entries (tests/corpus/*.json) + device-plane replay
# ---------------------------------------------------------------------------


def corpus_entry(name: str, cfg: MCConfig, actions: Sequence[tuple],
                 origin: str) -> dict:
    """Serialize a schedule as a regression-corpus entry, stamping the
    honest host plane's outcome (decisions + evidence counts) so the
    replay test asserts bit-stable semantics, not just liveness.
    Multi-height schedules (the epoch-boundary milestones) stamp every
    height's decision under `decided_heights`; the key is OMITTED for
    height-0-only entries so the pre-epoch corpus regenerates
    bit-identical."""
    net, viols = run_with_monitors(cfg, actions)
    entry = {
        "name": name,
        "origin": origin,
        "config": cfg.to_json(),
        "actions": [Network.action_to_json(tuple(a)) for a in actions],
        "expect": {
            "violations": sorted({v.property for v in viols}),
            "decided": {
                str(j): [nd.decided[0].round, nd.decided[0].value]
                for j, nd in enumerate(net.nodes) if 0 in nd.decided},
            "evidence": {
                str(j): len(nd.all_equivocations())
                for j, nd in enumerate(net.nodes)
                if nd.all_equivocations()},
        },
    }
    if any(h != 0 for nd in net.nodes for h in nd.decided):
        entry["expect"]["decided_heights"] = {
            str(j): {str(h): [d.round, d.value]
                     for h, d in sorted(nd.decided.items())}
            for j, nd in enumerate(net.nodes) if nd.decided}
    return entry


def load_corpus(directory: str) -> List[dict]:
    out = []
    if os.path.isdir(directory):
        for fn in sorted(os.listdir(directory)):
            if fn.endswith(".json"):
                with open(os.path.join(directory, fn)) as f:
                    out.append(json.load(f))
    return out


def replay_corpus_entry(entry: dict,
                        sign: bool = False) -> Tuple[Network,
                                                     List[Violation]]:
    """Host-plane deterministic replay of a corpus entry; asserts the
    stamped expectations (decisions, evidence, property verdicts)."""
    cfg = MCConfig.from_json(entry["config"])
    net, viols = run_with_monitors(cfg, entry["actions"], sign=sign)
    exp = entry["expect"]
    got_decided = {str(j): [nd.decided[0].round, nd.decided[0].value]
                   for j, nd in enumerate(net.nodes) if 0 in nd.decided}
    assert got_decided == exp["decided"], (
        f"{entry['name']}: decisions diverged: {got_decided} != "
        f"{exp['decided']}")
    got_ev = {str(j): len(nd.all_equivocations())
              for j, nd in enumerate(net.nodes) if nd.all_equivocations()}
    assert got_ev == exp["evidence"], (
        f"{entry['name']}: evidence diverged: {got_ev} != "
        f"{exp['evidence']}")
    if "decided_heights" in exp:
        got_hs = {str(j): {str(h): [d.round, d.value]
                           for h, d in sorted(nd.decided.items())}
                  for j, nd in enumerate(net.nodes) if nd.decided}
        assert got_hs == exp["decided_heights"], (
            f"{entry['name']}: per-height decisions diverged: "
            f"{got_hs} != {exp['decided_heights']}")
    assert sorted({v.property for v in viols}) == exp["violations"], (
        f"{entry['name']}: property verdicts diverged")
    return net, viols


def device_replay_entry(entry: dict, device="cuda") -> list:
    """Replay a corpus entry's schedule through the PRODUCTION device
    plane on `device`: run the signed host network under trace taps,
    then push each node's exact processing stream through VoteBatcher
    -> fused device step (harness/replay.py).  Returns (host net,
    [(node, {height: host Decision}, ReplayResult)]).  Weighted
    configs hand the sorted per-validator power vector to the replay
    so the device tally counts the same quorum boundaries the host
    did; EPOCH configs hand the full height->powers table — the
    replay installs each epoch through the real `set_validators`
    boundary calls (driver + batcher) as the device advances heights,
    so host == device holds THROUGH a validator-set change.  This is
    the ONLY modelcheck path that runs the device plane — imported
    lazily, never from the CLI."""
    from agnes_tpu_torch.harness.replay import replay_trace, trace_network

    cfg = MCConfig.from_json(entry["config"])
    net = build_network(cfg, sign=True, verify=True, start=False)
    powers = None
    if any(v.voting_power != 1 for v in net.vset):
        powers = net.vset.device_arrays()[1]
    epochs = None
    if net.epochs:
        # sorted-index epoch tables, exactly what the device planes eat
        epochs = {h: list(pw) for h, pw in net.epochs.items()}
    traces = trace_network(net)
    net.run_schedule(entry["actions"])
    out = []
    for j, nd in enumerate(net.nodes):
        rep = replay_trace(traces[j], n_validators=net.n, powers=powers,
                           epochs=epochs, device=device)
        out.append((j, dict(nd.decided), rep))
    return net, out


def _walk_until(cfg: MCConfig,
                pred: Callable[[Network], bool],
                seed: int, max_steps: int = 600,
                deliver_bias: Optional[float] = None,
                executor_cls: Optional[type] = None
                ) -> Optional[List[tuple]]:
    """Seeded guided random walk to a predicate state — the corpus
    generator's probe for goals DEEPER than the exhaustive bounds (a
    full 4-node decision takes ~25 deliveries; the explorer's smoke
    depth stops well short).  Deterministic given (cfg, seed).
    `deliver_bias` is the probability of considering non-delivery
    actions at all — large N needs delivery-heavy walks (uniform
    timeout churn wedges at the round cap before a quorum forms).
    `executor_cls` runs the walk on a doctored executor — the
    discovery probe for mutants whose violation lives past a height
    boundary, beyond any exhaustively explorable depth."""
    import random

    rng = random.Random(seed)
    net = build_network(cfg, executor_cls)
    sched: List[tuple] = []
    for _ in range(max_steps):
        if pred(net):
            return sched
        acts = net.mc_enabled(max_round=cfg.max_round)
        if not acts:
            return None
        if deliver_bias is not None:
            dels = [a for a in acts if a[0] == "d"]
            if dels and rng.random() > deliver_bias:
                acts = dels
        act = rng.choice(acts)
        assert net.mc_apply(act)
        sched.append(act)
    return sched if pred(net) else None


def _all_decided(net: Network) -> bool:
    return all(0 in nd.decided for nd in net.nodes)


def _all_decided_through_height_1(net: Network) -> bool:
    return all(0 in nd.decided and 1 in nd.decided for nd in net.nodes)


def _sleepy_recovery_decided(net: Network) -> bool:
    """Everyone decided, at least one real nap happened, nobody is
    still asleep (the woken node's decision proves it caught up on
    the traffic the nap withheld)."""
    return (_all_decided(net) and net._churn_used > 0
            and not any(net._asleep))


#: name -> (config, goal predicate, walk seed, deliver bias): the
#: shipped regression corpus (tests/corpus/).  Each goal is a coverage
#: milestone the cross-plane differential should replay forever: full
#: decisions under each fault model, surfaced equivocation evidence, a
#: partition/heal recovery, a multi-round decision, and an N=7
#: decision.  Seeds are the first that reach the goal; depth is unused
#: by replay (0 marks these as walk configs, not exploration bounds).
CORPUS_GOALS: Dict[str, tuple] = {
    "mc_n4_honest_decides": (
        MCConfig(name="n4_honest", depth=0, max_round=2),
        _all_decided, 1, None),
    "mc_n4_multi_round_decides": (
        MCConfig(name="n4_honest_r1", depth=0, max_round=2),
        lambda net: (_all_decided(net)
                     and any(nd.decided[0].round >= 1
                             for nd in net.nodes)), 0, None),
    "mc_n4_equivocator_evidence": (
        MCConfig(name="n4_equivocator", depth=0, max_round=2,
                 behaviors=("equivocator", "honest", "honest", "honest")),
        lambda net: (_all_decided(net)
                     and any(nd.all_equivocations()
                             for nd in net.nodes)), 3, None),
    "mc_n4_nil_flood_decides": (
        MCConfig(name="n4_nil_flood", depth=0, max_round=2,
                 behaviors=("nil_flood", "honest", "honest", "honest")),
        _all_decided, 8, None),
    "mc_n4_partition_heal_decides": (
        MCConfig(name="n4_partition_heal", depth=0, max_round=2,
                 partition=((0, 1), (2, 3))),
        lambda net: (_all_decided(net) and net._partition_cycles > 0
                     and net._group is None), 2, None),
    "mc_n7_honest_decides": (
        MCConfig(name="n7_honest", n=7, depth=0, max_round=2,
                 behaviors=("honest",) * 7),
        _all_decided, 0, 0.05),
    # weighted milestones: decisions whose +2/3 boundary
    # falls between vote counts — the heavy validator is REQUIRED for
    # any quorum (lights alone hold 3/6), so the replayed device tally
    # must weight it correctly or the decision vanishes
    "mc_n4_weighted_decides": (
        MCConfig(name="n4_weighted", depth=0, max_round=2,
                 powers=(1, 1, 1, 3)),
        _all_decided, 1, None),
    "mc_n4_weighted_evidence": (
        MCConfig(name="n4_weighted_equiv", depth=0, max_round=2,
                 behaviors=("equivocator", "honest", "honest", "honest"),
                 powers=(1, 1, 1, 3)),
        lambda net: (_all_decided(net)
                     and any(nd.all_equivocations()
                             for nd in net.nodes)), 1, None),
    # symmetry milestone: a decision in the orbit-richest smoke config
    # (n=7, five interchangeable non-proposers) — replayed forever so
    # the orbit-merged envelope keeps a deterministic deep witness
    "mc_n7_weighted_decides": (
        MCConfig(name="n7_weighted", n=7, depth=0, max_round=2,
                 behaviors=("honest",) * 7,
                 powers=(1, 1, 1, 1, 1, 2, 3)),
        _all_decided, 0, 0.05),
    # epoch milestone: decisions at height 0 (genesis
    # equal-weight set) AND height 1 (the (1, 3, 1, 1) epoch — heavy
    # validator REQUIRED for any height-1 quorum), so the device
    # replay crosses a real set_validators boundary: host == device
    # must hold through the set change or the height-1 decision
    # vanishes
    "mc_epoch_set_change_decides": (
        MCConfig(name="n4_epoch_boundary", depth=0, max_round=2,
                 max_height=1, epochs=((1, (1, 3, 1, 1)),)),
        _all_decided_through_height_1, 0, 0.1),
    # sleepy-churn milestone (TOB-SVD): a full decision on a schedule
    # carrying a real sleep/wake cycle — the serialized ("s", j)/
    # ("w", j) actions ride the corpus codec, the deterministic host
    # replay, and the device-plane trace replay forever
    "mc_churn_sleepy_recovery_decides": (
        MCConfig(name="n4_sleepy", depth=0, max_round=2,
                 churn_budget=2),
        _sleepy_recovery_decided, 0, 0.3),
}


def emit_corpus(directory: str, include_mutants: bool = True) -> List[str]:
    """(Re)generate the regression corpus: a ddmin-minimized schedule
    per CORPUS_GOALS milestone, plus the mutation self-test
    counterexamples replayed on the honest executor (they stay
    interesting as device-plane differential cases even where the
    honest host plane is clean), plus the serve-plane admission corpus
    under `directory`/admission (analysis/admission_mc.py) and the
    pod-membership corpus under `directory`/membership
    (analysis/membership_mc.py).  Deterministic; committed as
    tests/corpus/, held byte for byte by tests/test_torch_modelcheck.py
    and replayed on the card by chip_smoke.py's phase 14."""
    os.makedirs(directory, exist_ok=True)
    written = []
    for name, (cfg, pred, seed, bias) in CORPUS_GOALS.items():
        sched = _walk_until(cfg, pred, seed, max_steps=1500,
                            deliver_bias=bias)
        assert sched is not None, f"corpus goal {name} unreachable"
        sched = minimize_schedule(cfg, sched,
                                  lambda net, _v, p=pred: p(net))
        entry = corpus_entry(name, cfg, sched,
                             origin=f"emit_corpus goal walk seed={seed}, "
                                    f"ddmin-minimized")
        path = os.path.join(directory, f"{name}.json")
        with open(path, "w") as f:
            json.dump(entry, f, indent=1, sort_keys=True)
            f.write("\n")
        written.append(path)
    if include_mutants:
        for mname, r in self_test().items():
            ce = r["counterexample"]
            cfg = MCConfig.from_json(ce["config"])
            acts = [Network.action_from_json(a) for a in ce["schedule"]]
            entry = corpus_entry(
                f"mc_mut_{mname}", cfg, acts,
                origin=f"minimized {mname} mutation counterexample "
                       f"(honest replay: near-miss)")
            path = os.path.join(directory, f"mc_mut_{mname}.json")
            with open(path, "w") as f:
                json.dump(entry, f, indent=1, sort_keys=True)
                f.write("\n")
            written.append(path)
    from agnes_tpu_torch.analysis import admission_mc as am
    from agnes_tpu_torch.analysis import membership_mc as mm

    written += am.emit_admission_corpus(
        os.path.join(directory, "admission"),
        include_mutants=include_mutants)
    written += mm.emit_membership_corpus(
        os.path.join(directory, "membership"),
        include_mutants=include_mutants)
    return written


# ---------------------------------------------------------------------------
# Mutation self-test: doctored executors the monitors MUST catch
# ---------------------------------------------------------------------------


class QuorumlessExecutor(ConsensusExecutor):
    """Doctored: treats a single precommit-for-value as a +2/3 quorum
    (the classic miscounted-threshold bug).  Method-override only, so
    ConsensusExecutor.clone() stays subclass-safe."""

    def _on_vote(self, v) -> None:
        super()._on_vote(v)
        if (v.typ == VoteType.PRECOMMIT and v.value is not None
                and (v.height is None or v.height == self.height)
                and self.state.step != sm.Step.COMMIT):
            self._apply_event(v.round, sm.Event.precommit_value(v.value))


class EvidenceDroppingExecutor(ConsensusExecutor):
    """Doctored: the slashing surface goes blind — equivocations are
    tallied (first vote counts, conflicts ignored) but never reported."""

    def all_equivocations(self) -> list:
        return []


class WeightBlindExecutor(ConsensusExecutor):
    """Doctored: counts validator HEADS instead of voting power (every
    vote weighs 1 against a total of n) — the committee-weight bug
    class of arXiv 2004.12990.  On an asymmetric power vector
    where the +2/3 boundary falls between vote counts (three weight-1
    validators out of four are a head-count quorum but only 3/6 of
    the power), it decides without a real quorum; the cert monitor
    sees the counted weight against the TRUE total power and fires."""

    def _new_votes(self, height: int):
        from agnes_tpu_torch.core.vote_executor import VoteExecutor

        return VoteExecutor(height=height, total_weight=len(self.vset),
                            edge_triggered=True)

    def _vote_weight(self, v) -> int:
        return 1


class StaleEpochExecutor(ConsensusExecutor):
    """Doctored: tallies every height against the PREVIOUS validator-
    set epoch — `epoch_powers` looks one height back, so precommits
    are counted with the powers (and denominated in the total) of the
    set that was live BEFORE the boundary.  The exact bug class the
    device plane's `set_validators` height-boundary contract exists to
    prevent (harness/device_driver.py: "mid-height changes would mix
    quorum denominators").  On a config whose epoch shifts weight onto
    one validator, the light validators' old-set quorum no longer
    clears the live set's +2/3 — the epoch-indexed cert monitor sees a
    certificate denominated against the wrong epoch and fires."""

    def epoch_powers(self, height: int):
        return super().epoch_powers(height - 1)


class WakeResetExecutor(ConsensusExecutor):
    """Doctored: treats waking from a sleepy-churn nap as a REBOOT —
    fresh round-0 state for the current height, lock and valid value
    shredded, (round, step) position regressed.  The churn-blind
    recovery bug class of TOB-SVD's sleepy model (a waking validator
    must resume, not restart: restarting un-locks it and re-opens
    equivocation/agreement windows the protocol had closed).  Caught
    by the per-edge monotonicity monitor on the ("w", j) action."""

    def on_wake(self) -> None:
        self.state = sm.State.new(self.height)


#: mutant name -> (executor class, property the monitors must catch it
#: with, config the violation is reachable in).  The weight-blind
#: config puts power 3 on one validator (original index 3 -> sorted
#: index 2, the round-0 proposer under the weighted rotation): the
#: three weight-1 validators form a head-count quorum (3 of 4) that
#: holds only 3 of 6 power — the violation needs the full 11-action
#: three-light protocol, hence the deeper bound.  The stale-epoch
#: config rotates a (1, 3, 1, 1) set in AT height 0 (original index 1
#: -> sorted index 0, a pinned proposer): the genesis table the
#: rotation was seeded with is equal-weight, so a tally stuck one
#: epoch back counts three lights as 3/4 when the live set makes them
#: 3/6 — again the full three-light protocol, depth 11.  The
#: wake-reset config needs only churn_budget=1: any position-advanced
#: node that sleeps and wakes regresses immediately.
MUTANTS: Dict[str, tuple] = {
    "decide_without_quorum": (
        QuorumlessExecutor, "quorum",
        MCConfig(name="mut_quorumless", n=4,
                 behaviors=("honest",) * 4, depth=8, max_round=1)),
    "drop_equivocation_evidence": (
        EvidenceDroppingExecutor, "evidence",
        MCConfig(name="mut_evidence", n=4,
                 behaviors=("equivocator", "honest", "honest", "honest"),
                 depth=6, max_round=1)),
    "decide_weight_blind_quorum": (
        WeightBlindExecutor, "quorum",
        MCConfig(name="mut_weight_blind", n=4,
                 behaviors=("honest",) * 4, powers=(1, 1, 1, 3),
                 depth=11, max_round=1)),
    "decide_stale_epoch_quorum": (
        StaleEpochExecutor, "quorum",
        MCConfig(name="mut_stale_epoch", n=4,
                 behaviors=("honest",) * 4,
                 epochs=((0, (1, 3, 1, 1)),), depth=11, max_round=1)),
    "wake_resets_round_state": (
        WakeResetExecutor, "monotonic",
        MCConfig(name="mut_wake_reset", n=4,
                 behaviors=("honest",) * 4, churn_budget=1,
                 depth=4, max_round=1)),
}

#: Deep-mutant registry: violations that live PAST a height boundary
#: — beyond any exhaustively explorable depth (a height-0 decision
#: alone costs ~25 actions) — discovered by a seeded guided walk on
#: the doctored executor instead of the DFS, then ddmin-minimized and
#: honest-replayed exactly like the explored mutants.  name ->
#: (executor class, property, config, goal predicate, seed, bias).
#: The cross-boundary stale-epoch drill: heights decide under the
#: genesis set, then the (1, 3, 1, 1) epoch lands at height 1 and the
#: stale tally keeps counting the old equal-weight set — its
#: height-1 decision carries a cert denominated 3/4 against a live
#: total of 6.
DEEP_MUTANTS: Dict[str, tuple] = {
    "stale_epoch_across_boundary": (
        StaleEpochExecutor, "quorum",
        MCConfig(name="mut_stale_epoch_deep", n=4, depth=0, max_round=2,
                 max_height=1, epochs=((1, (1, 3, 1, 1)),)),
        lambda net: any(1 in nd.decided for nd in net.nodes), 0, 0.1),
}


def self_test(por: bool = True) -> dict:
    """Prove the monitors have teeth: each doctored executor must be
    caught, its counterexample must delta-minimize, and the minimized
    schedule must run CLEAN on the honest executor (the violation is
    the mutation's, not the checker's).  Explored mutants (MUTANTS)
    are caught by the exhaustive DFS; deep mutants (DEEP_MUTANTS,
    violations past a height boundary) by a seeded guided walk on the
    doctored executor — both then share the exact
    minimize/reproduce/honest-replay drill."""
    out = {}
    for name, (mut_cls, prop, cfg) in MUTANTS.items():
        rep = explore(cfg, executor_cls=mut_cls, por=por)
        caught = [c for c in rep.violations
                  if c.violation.property == prop]
        assert caught, (
            f"mutant {name}: no {prop} violation in "
            f"{rep.states} states")
        ce = caught[0]
        out[name] = _finish_mutant_record(
            name, mut_cls, prop, cfg, ce, states=rep.states,
            discovery="dfs")
    for name, (mut_cls, prop, cfg, goal, seed, bias) in \
            DEEP_MUTANTS.items():
        sched = _walk_until(cfg, goal, seed, max_steps=1500,
                            deliver_bias=bias, executor_cls=mut_cls)
        assert sched is not None, f"deep mutant {name}: goal unreachable"
        assert reproduces(cfg, sched, prop, executor_cls=mut_cls), (
            f"deep mutant {name}: goal state shows no {prop} violation")
        ce = Counterexample(cfg, Violation(prop, -1,
                                           f"walk-discovered {name}"),
                            list(sched))
        out[name] = _finish_mutant_record(
            name, mut_cls, prop, cfg, ce, states=len(sched),
            discovery="walk")
    return out


def _finish_mutant_record(name: str, mut_cls: type, prop: str,
                          cfg: MCConfig, ce: Counterexample,
                          states: int, discovery: str = "dfs") -> dict:
    ce.minimized = minimize(cfg, ce.schedule, prop, executor_cls=mut_cls)
    assert reproduces(cfg, ce.minimized, prop, executor_cls=mut_cls)
    _, honest_viols = run_with_monitors(cfg, ce.minimized)
    assert not honest_viols, (
        f"mutant {name}: minimized schedule also violates on the "
        f"honest executor: {honest_viols}")
    return {
        "property": prop,
        "discovery": discovery,
        # explored-state count for DFS-caught mutants; for the walk-
        # discovered deep mutants the probe has no state count, so
        # this is the walk's schedule length (see `discovery`)
        "states_to_detection": states,
        "schedule_len": len(ce.schedule),
        "minimized_len": len(ce.minimized),
        "counterexample": ce.to_json(),
    }


# ---------------------------------------------------------------------------
# Scopes + frontier-sharded workers + CLI
# ---------------------------------------------------------------------------

#: The smoke scope: the twin's CI envelope (it must EXHAUST,
#: complete=True, in minutes on two CPUs).  One
#: config per fault model plus a partition/heal drill, an N=7 shallow
#: sweep, two WEIGHTED configs whose +2/3 boundary falls
#: between vote counts (power 3 on original index 3 -> sorted index 2:
#: three weight-1 validators are a head-count majority with only 3/6
#: of the power), two validator-set EPOCH shards plus a
#: sleepy-CHURN shard; every one stays within f < n/3 by weight in
#: every live epoch.
SMOKE_SCOPE: Tuple[MCConfig, ...] = (
    MCConfig(name="n4_honest", depth=10, max_round=1),
    MCConfig(name="n4_silent", depth=11, max_round=1,
             behaviors=("silent", "honest", "honest", "honest")),
    MCConfig(name="n4_equivocator", depth=9, max_round=1,
             behaviors=("equivocator", "honest", "honest", "honest")),
    MCConfig(name="n4_nil_flood", depth=9, max_round=1,
             behaviors=("nil_flood", "honest", "honest", "honest")),
    MCConfig(name="n4_partition_heal", depth=9, max_round=1,
             partition=((0, 1), (2, 3))),
    MCConfig(name="n7_honest", n=7, behaviors=("honest",) * 7,
             depth=5, max_round=1),
    MCConfig(name="n4_weighted", powers=(1, 1, 1, 3), depth=10,
             max_round=1),
    MCConfig(name="n4_weighted_equiv", powers=(1, 1, 1, 3), depth=9,
             max_round=1,
             behaviors=("equivocator", "honest", "honest", "honest")),
    # epoch shards: validator-set epochs live inside the
    # envelope.  n4_epoch_shift rotates weight 3 onto original index 0
    # at the height-1 boundary — original 0 sorts to index 1, a PINNED
    # proposer slot, so sorted nodes {2, 3} stay interchangeable in
    # BOTH epochs and the per-epoch symmetry group is real (|G| = 2).
    # n4_epoch_genesis rotates (1, 3, 1, 1) in AT height 0 (the
    # stale-epoch mutant's scope): the live set differs from the
    # genesis table the network was seeded with from the first vote.
    MCConfig(name="n4_epoch_shift", depth=10, max_round=1,
             epochs=((1, (3, 1, 1, 1)),)),
    MCConfig(name="n4_epoch_genesis", depth=9, max_round=1,
             epochs=((0, (1, 3, 1, 1)),)),
    # churn shard: TOB-SVD sleepy participation — one sleep in
    # the budget opens ("s", j) for every honest node plus the paired
    # wake, the largest alphabet extension in the scope
    MCConfig(name="n4_churn1", depth=9, max_round=1, churn_budget=1),
)

#: The twin's recorded unreduced (por-only) visit counts on the shared
#: smoke configs, the port's own copy — the denominator-side baseline
#: for the `modelcheck_sym_orbit_reduction` metric.  These are
#: DETERMINISTIC (same config -> same visited set), and the port's
#: `explore(cfg, sym=False)` reproduces them; regenerate after any
#: semantic change to the core or the enumerator.
SYM_BASELINE_STATES: Dict[str, int] = {
    "n4_honest": 94_290,
    "n4_silent": 11_019,
    "n4_equivocator": 62_570,
    "n4_nil_flood": 50_932,
    "n4_partition_heal": 88_057,
    "n7_honest": 74_873,
    # unreduced visit counts of the epoch/churn shards —
    # the denominators of the PER-EPOCH orbit-reduction metric
    # (`modelcheck_epoch_orbit_reduction` reads only the epoch ones)
    "n4_epoch_shift": 94_290,
    "n4_epoch_genesis": 46_252,
    "n4_churn1": 164_617,
}

#: Unit-test / CLI-smoke scope: seconds, not minutes.
TINY_SCOPE: Tuple[MCConfig, ...] = (
    MCConfig(name="tiny_honest", depth=6, max_round=1),
    MCConfig(name="tiny_equivocator", depth=5, max_round=1,
             behaviors=("equivocator", "honest", "honest", "honest")),
    MCConfig(name="tiny_weighted", powers=(1, 1, 1, 3), depth=6,
             max_round=1),
    MCConfig(name="tiny_epoch", depth=6, max_round=1,
             epochs=((1, (3, 1, 1, 1)),)),
    MCConfig(name="tiny_churn", depth=5, max_round=1, churn_budget=1),
)

#: Deep scope for workstation runs: more rounds, deeper
#: schedules, a second fault in the n=7 set, a weighted n=7.
FULL_SCOPE: Tuple[MCConfig, ...] = SMOKE_SCOPE + (
    MCConfig(name="n4_honest_deep", depth=12, max_round=2),
    MCConfig(name="n4_equivocator_deep", depth=11, max_round=2,
             behaviors=("equivocator", "honest", "honest", "honest")),
    MCConfig(name="n7_two_faults", n=7, depth=6, max_round=1,
             behaviors=("equivocator", "silent", "honest", "honest",
                        "honest", "honest", "honest")),
    MCConfig(name="n7_weighted", n=7, depth=5, max_round=1,
             behaviors=("honest",) * 7, powers=(1, 1, 1, 1, 1, 2, 3)),
    MCConfig(name="n4_churn2", depth=8, max_round=1, churn_budget=2),
    MCConfig(name="n4_epoch_churn", depth=8, max_round=1,
             epochs=((1, (3, 1, 1, 1)),), churn_budget=1),
)

SCOPES = {"tiny": TINY_SCOPE, "smoke": SMOKE_SCOPE, "full": FULL_SCOPE}


def _scope_worker(task: dict) -> dict:
    """One exploration shard in a spawned interpreter: configs are
    independent, so they parallelize
    across cores; JSON-able dicts cross the process boundary.  `kind`
    routes between the consensus domain, the serve-plane admission
    domain (analysis/admission_mc.py) and the pod-membership domain
    (analysis/membership_mc.py) — same engine, same record shape."""
    if task["config"].get("kind") == "membership":
        from agnes_tpu_torch.analysis import membership_mc as mm

        cfg = mm.MembershipMCConfig.from_json(task["config"])
        rep = mm.explore_membership(cfg,
                                    deadline_at=task["deadline_at"],
                                    max_states=task.get("max_states"))
        for ce in rep.violations:
            try:
                ce.minimized = mm.minimize_membership(
                    cfg, ce.schedule, ce.violation.property)
            except AssertionError:
                ce.minimized = None
        out = rep.to_json()
        out["kind"] = "membership"
        return out
    if task["config"].get("kind") == "admission":
        from agnes_tpu_torch.analysis import admission_mc as am

        cfg = am.AdmissionMCConfig.from_json(task["config"])
        rep = am.explore_admission(cfg,
                                   deadline_at=task["deadline_at"],
                                   max_states=task.get("max_states"))
        for ce in rep.violations:
            try:
                ce.minimized = am.minimize_admission(
                    cfg, ce.schedule, ce.violation.property)
            except AssertionError:
                ce.minimized = None
        out = rep.to_json()
        out["kind"] = "admission"
        return out
    cfg = MCConfig.from_json(task["config"])
    rep = explore(cfg, por=task["por"], sym=task.get("sym", False),
                  deadline_at=task["deadline_at"],
                  max_states=task.get("max_states"))
    for ce in rep.violations:
        try:
            ce.minimized = minimize(cfg, ce.schedule,
                                    ce.violation.property)
        except AssertionError:
            ce.minimized = None     # non-deterministic repro: report raw
    out = rep.to_json()
    out["kind"] = "consensus"
    return out


def run_scope(scope: str, workers: Optional[int] = None, por: bool = True,
              deadline_at: Optional[float] = None,
              max_states: Optional[int] = None,
              sym: bool = True) -> dict:
    """Explore every config of `scope` — the consensus envelope, the
    serve-plane admission envelope (admission_mc.ADMISSION_SCOPES)
    AND the pod-membership envelope (membership_mc.MEMBERSHIP_SCOPES)
    — frontier-sharded over spawned workers; aggregate
    states/violations (the CLI record).  Consensus shards run
    symmetry-reduced by default (`sym`); the aggregate report carries
    the measured orbit reduction against the unreduced baseline
    (`SYM_BASELINE_STATES`) and the admission/membership-model state
    totals.  Workers are spawned, never forked: a torch-holding parent
    must not fork, and a consensus worker imports no torch."""
    from agnes_tpu_torch.analysis.admission_mc import ADMISSION_SCOPES
    from agnes_tpu_torch.analysis.membership_mc import MEMBERSHIP_SCOPES

    configs = SCOPES[scope]
    adm_configs = ADMISSION_SCOPES.get(scope, ())
    mem_configs = MEMBERSHIP_SCOPES.get(scope, ())
    tasks = [{"config": c.to_json(), "por": por, "sym": sym,
              "deadline_at": deadline_at, "max_states": max_states}
             for c in configs]
    tasks += [{"config": c.to_json(), "por": por,
               "deadline_at": deadline_at, "max_states": max_states}
              for c in (*adm_configs, *mem_configs)]
    t0 = time.perf_counter()
    if workers is None:
        workers = min(len(tasks), max(2, os.cpu_count() or 2))
    if workers <= 1 or len(tasks) == 1:
        results = [_scope_worker(t) for t in tasks]
    else:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")       # no forked interpreter state
        with ctx.Pool(processes=workers) as pool:
            results = pool.map(_scope_worker, tasks)
    by_name = {c.name: c for c in configs}
    report = {
        "scope": scope,
        "por": por,
        "sym": sym,
        "configs": {r["config"]: r for r in results},
        "states_explored": sum(r["states"] for r in results),
        "transitions": sum(r["transitions"] for r in results),
        "violations": sum(len(r["violations"]) for r in results),
        "complete": all(r["complete"] for r in results),
        "consensus_states": sum(r["states"] for r in results
                                if r["kind"] == "consensus"),
        "admission_states": sum(r["states"] for r in results
                                if r["kind"] == "admission"),
        "membership_states": sum(r["states"] for r in results
                                 if r["kind"] == "membership"),
        # domain splits: canonical states visited by the shards
        # carrying validator-set epochs / a sleepy-churn budget (a shard
        # can be in both)
        "epoch_states": sum(
            r["states"] for r in results if r["kind"] == "consensus"
            and by_name[r["config"]].epochs is not None),
        "churn_states": sum(
            r["states"] for r in results if r["kind"] == "consensus"
            and by_name[r["config"]].churn_budget > 0),
        "seconds": round(time.perf_counter() - t0, 1),
    }
    # measured orbit reduction on the baselined configs — overall, and
    # the PER-EPOCH slice (epoch shards only: the group there must be
    # sound in EVERY epoch window, so its measured bite is its own
    # metric).  Only meaningful where shards EXHAUSTED under symmetry.
    base = reduced = ep_base = ep_reduced = 0
    for r in results:
        if r["kind"] == "consensus" and r["complete"] and sym \
                and r["config"] in SYM_BASELINE_STATES:
            base += SYM_BASELINE_STATES[r["config"]]
            reduced += r["states"]
            if by_name[r["config"]].epochs is not None:
                ep_base += SYM_BASELINE_STATES[r["config"]]
                ep_reduced += r["states"]
    report["sym_orbit_reduction"] = \
        round(base / reduced, 2) if reduced else -1
    report["epoch_orbit_reduction"] = \
        round(ep_base / ep_reduced, 2) if ep_reduced else -1
    report["ok"] = report["violations"] == 0
    return report


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: `python -m agnes_tpu_torch.analysis.modelcheck`.  Pure
    CPU; honours the enclosing timeout budget (utils/budget.Deadline
    discovery) so a bounded caller always gets a parseable record —
    complete=False is the sentinel half of the real-value-or-sentinel
    contract."""
    import argparse

    from agnes_tpu_torch.utils.budget import Deadline

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scope", default="smoke", choices=sorted(SCOPES),
                    help="bounded exploration envelope (default: smoke)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--no-por", action="store_true",
                    help="disable partial-order reduction (debug aid)")
    ap.add_argument("--no-sym", action="store_true",
                    help="disable symmetry reduction (debug aid; the "
                         "orbit-reduction metric reads -1)")
    ap.add_argument("--self-test", action="store_true",
                    help="run the doctored-executor AND admission-"
                         "mutant self-tests")
    ap.add_argument("--emit-corpus", metavar="DIR", default=None,
                    help="(re)generate the regression corpus into DIR")
    ap.add_argument("--max-states", type=int, default=None)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="wall budget; default: discovered from "
                         "AGNES_MODELCHECK_DEADLINE_S or the enclosing "
                         "`timeout N`")
    args = ap.parse_args(argv)

    if args.deadline_s is not None:
        deadline = Deadline.after(args.deadline_s)
    else:
        deadline = Deadline.discover(
            env_var="AGNES_MODELCHECK_DEADLINE_S")
    rem = deadline.remaining()
    # leave a report-assembly margin before the enclosing kill; the
    # 1s floor only guards an already-blown budget (the sentinel path)
    deadline_at = None if deadline.at is None \
        else time.time() + max(1.0, rem - min(20.0, rem * 0.2))

    t0 = time.perf_counter()
    if args.self_test:
        from agnes_tpu_torch.analysis.admission_mc import self_test_admission
        from agnes_tpu_torch.analysis.membership_mc import (
            self_test_membership,
        )

        mut = self_test(por=not args.no_por)
        report = {"self_test": mut,
                  "self_test_admission": self_test_admission(),
                  "self_test_membership": self_test_membership(),
                  "ok": True,
                  "seconds": round(time.perf_counter() - t0, 1)}
        print(json.dumps(report, sort_keys=True), flush=True)
        return 0
    if args.emit_corpus:
        written = emit_corpus(args.emit_corpus)
        print(json.dumps({"ok": True, "corpus": written,
                          "seconds": round(time.perf_counter() - t0, 1)},
                         sort_keys=True), flush=True)
        return 0

    report = run_scope(args.scope, workers=args.workers,
                       por=not args.no_por, deadline_at=deadline_at,
                       max_states=args.max_states,
                       sym=not args.no_sym)
    from agnes_tpu_torch.utils.metrics import (
        MODELCHECK_ADMISSION_STATES,
        MODELCHECK_CHURN_STATES,
        MODELCHECK_EPOCH_ORBIT_REDUCTION,
        MODELCHECK_EPOCH_STATES,
        MODELCHECK_MEMBERSHIP_STATES,
        MODELCHECK_STATES_EXPLORED,
        MODELCHECK_SYM_ORBIT_REDUCTION,
        MODELCHECK_VIOLATIONS,
    )

    report["metrics"] = {
        MODELCHECK_STATES_EXPLORED: report["states_explored"],
        MODELCHECK_VIOLATIONS: report["violations"],
        MODELCHECK_SYM_ORBIT_REDUCTION: report["sym_orbit_reduction"],
        MODELCHECK_ADMISSION_STATES: report["admission_states"],
        MODELCHECK_MEMBERSHIP_STATES: report["membership_states"],
        MODELCHECK_EPOCH_STATES: report["epoch_states"],
        MODELCHECK_CHURN_STATES: report["churn_states"],
        MODELCHECK_EPOCH_ORBIT_REDUCTION:
            report["epoch_orbit_reduction"],
    }
    report["deadline"] = {"source": deadline.source,
                          "budget_s": None if rem == float("inf")
                          else round(rem, 1)}
    if not args.json:
        for name, r in report["configs"].items():
            status = "EXHAUSTED" if r["complete"] else "partial"
            print(f"[agnes_modelcheck] {name}: {r['states']} states / "
                  f"{r['transitions']} transitions {status} "
                  f"({r['seconds']}s), {len(r['violations'])} "
                  f"violation(s)", flush=True)
    print(json.dumps(report, sort_keys=True), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
