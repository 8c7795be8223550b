"""Pod-membership model checker (twin of
`agnes_tpu.analysis.membership_mc`, over the port's
`distributed/membership.py`).

The elastic pod's repartition protocol — leave/join intents latching
mid-epoch, the boundary repartition of `HostPlan` instance ranges, the
held-gossip re-lift onto the new partition, readmission replay — is
decision-affecting control-plane code that, like the admission layer,
would otherwise ship on unit tests and one spawned differential.  This
module closes that the same way `analysis/admission_mc.py` did: the
SAME schedule enumerator
(`modelcheck.Domain` / `_explore_domain`: depth-bounded DFS,
canonical-state dedup, ddmin minimization) over a `MembershipSystem`
that drives the REAL `distributed/membership.py` protocol object —
`MembershipEpoch`, `partition_ranges`, `validate_partition`,
`relift_ranges` are the production code under check (their
`mc_clone`/`mc_canonical` hooks are the only distributed/ additions),
with a deterministic MODEL of the traffic plane around it (per-
instance batch heights, the survivor-held gossip counts; the real
plane runs process groups and device steps, which a model state must
not pay for).

Actions (the membership schedule alphabet — the host-level sleep/wake
+ repartition actions the `host_churn` knob budgets):

  ("s", h)   host h announces leave (TOB-SVD sleepy churn at pod
             granularity; bounded by `host_churn`, and only enabled
             where the prospective live set still splits the instance
             space evenly — the honest deployment envelope, exactly
             what ElasticShard serves)
  ("w", h)   departed (or departing) host h announces rejoin
  ("d", i)   one batch of traffic for global instance i: advances its
             height while i's home host serves, is HELD by the
             adopting survivor while it is departed (bounded per
             instance by `max_height` over heights + held)
  ("b",)     one epoch boundary: latched intents apply, the partition
             recomputes (real `MembershipEpoch.boundary`), held
             batches re-lift along the transfers and replay for
             readmitted hosts

Property monitors (the repartition-soundness contract):

  partition      after EVERY state the live partition is disjoint and
                 covering — the real `validate_partition` predicate,
                 so the proof and the live boundary path police the
                 SAME invariant — and is keyed exactly off the live
                 host set
  conservation   no batch is lost across a repartition/re-lift: sent
                 == advanced heights + still-held, always (the
                 no-decision-loss half of the elastic pod's contract)
  monotonic      per-instance heights never regress across a
                 boundary (a re-lift that rolls state back would pass
                 conservation arithmetic while still losing decisions)

The mutation registry (`MEMBERSHIP_MUTANTS`) doctors one boundary
stage each — an overlapping-range repartition, a held-batch-dropping
re-lift — and `self_test_membership` proves both monitors have teeth:
caught, ddmin-minimized, minimized schedule clean on the honest
system.  Corpus entries (tests/corpus/membership/) stamp the honest
outcome and replay deterministically; the device-plane leg
(tests/test_torch_membership_mc.py) re-lifts REAL `seq_specs()` /
`dense_lane_specs()`-shaped numpy leaves along each entry's recorded
repartitions with `relift_tree` and asserts global-assembly identity.

Numpy + stdlib over distributed/membership.py; no jax and nothing of
`agnes_tpu` (asserted by test).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from agnes_tpu_torch.analysis.modelcheck import (
    Domain,
    Report,
    Violation,
    _ddmin,
    _explore_domain,
)
from agnes_tpu_torch.distributed.membership import (
    MembershipEpoch,
    MembershipError,
    partition_ranges,
    validate_partition,
)

MEMBERSHIP_PROPERTIES = ("partition", "conservation", "monotonic")


@dataclasses.dataclass(frozen=True)
class MembershipMCConfig:
    """One bounded membership-exploration task.  JSON-able (spawn
    workers, corpus files).  `host_churn` is THE knob: the
    budget of host-level leave announcements a schedule may spend
    (each may pair with a wake — the sleepy-churn alphabet)."""

    name: str
    n_hosts: int = 2
    n_instances: int = 2
    host_churn: int = 1
    max_height: int = 1        # per-instance bound on heights + held
    depth: int = 8

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = "membership"
        return d

    @classmethod
    def from_json(cls, d: dict) -> "MembershipMCConfig":
        d = dict(d)
        d.pop("kind", None)
        return cls(**d)


_ACT_NAMES = {"s": "sleep", "w": "wake", "d": "send", "b": "boundary"}
_ACT_CODES = {v: k for k, v in _ACT_NAMES.items()}


class MembershipSystem:
    """The checkable system: the real `MembershipEpoch` protocol
    object plus the modeled traffic plane (module docstring).
    Provides the engine's mc_clone / mc_apply / mc_enabled / mc_digest
    surface plus the schedule codec."""

    def __init__(self, cfg: MembershipMCConfig):
        assert cfg.n_instances % cfg.n_hosts == 0, \
            "genesis must split evenly (MembershipEpoch's own rule)"
        self.cfg = cfg
        self.epoch = MembershipEpoch(cfg.n_hosts, cfg.n_instances)
        per = cfg.n_instances // cfg.n_hosts
        #: static home host of each instance — the host whose device
        #: block serves it; while the home is departed its traffic is
        #: HELD by the adopting survivor (distributed/elastic.py)
        self.home = tuple(i // per for i in range(cfg.n_instances))
        self.heights = [0] * cfg.n_instances
        self.held = [0] * cfg.n_instances
        self.sent = 0
        self.sleeps = 0
        self.boundaries = 0

    # -- membership helpers --------------------------------------------------

    def _prospective_live(self, extra_leave: Optional[int] = None):
        alive = (set(self.epoch.view.alive)
                 - self.epoch._pending_leave
                 | self.epoch._pending_join)
        if extra_leave is not None:
            alive.discard(extra_leave)
        return alive

    def _home_serving(self, i: int) -> bool:
        return self.home[i] in self.epoch.view.alive

    # -- engine surface ------------------------------------------------------

    def mc_enabled(self) -> List[tuple]:
        acts: List[tuple] = []
        ep = self.epoch
        if self.sleeps < self.cfg.host_churn:
            for h in ep.view.alive:
                if h in ep._pending_leave:
                    continue
                live = self._prospective_live(extra_leave=h)
                # honest envelope: only even-splitting departures (an
                # uneven one fails loudly at the boundary — unit-tested
                # in tests/test_torch_elastic.py, out of model scope)
                if live and self.cfg.n_instances % len(live) == 0:
                    acts.append(("s", h))
        for h in range(self.cfg.n_hosts):
            departed = (h not in ep.view.alive
                        or h in ep._pending_leave)
            if departed and h not in ep._pending_join:
                acts.append(("w", h))
        for i in range(self.cfg.n_instances):
            if self.heights[i] + self.held[i] < self.cfg.max_height:
                acts.append(("d", i))
        if ep.pending() != (0, 0):
            acts.append(("b",))
        return acts

    def mc_apply(self, act: tuple) -> bool:
        kind = act[0]
        ep = self.epoch
        if kind == "s":
            h = act[1]
            if self.sleeps >= self.cfg.host_churn \
                    or h not in ep.view.alive \
                    or h in ep._pending_leave:
                return False
            live = self._prospective_live(extra_leave=h)
            if not live or self.cfg.n_instances % len(live):
                return False
            assert ep.note_leave(h)
            self.sleeps += 1
            return True
        if kind == "w":
            h = act[1]
            return ep.note_join(h)
        if kind == "d":
            i = act[1]
            if self.heights[i] + self.held[i] >= self.cfg.max_height:
                return False
            self.sent += 1
            if self._home_serving(i):
                self.heights[i] += 1
            else:
                self.held[i] += 1
            return True
        if kind == "b":
            if ep.pending() == (0, 0):
                return False
            rep = ep.boundary()
            if rep is not None:
                self.boundaries += 1
                self._relift_held(rep)
                self._install_view(rep)
            return True
        raise ValueError(f"unknown membership action {act!r}")

    # -- the boundary stages (the mutation seams) ----------------------------

    def _relift_held(self, rep) -> None:
        """Re-lift held batches across the repartition: batches held
        for a READMITTED host replay into its instances' heights (the
        catch-up replay, elastic.py `_ingest_reroute`); batches whose
        home is still departed STAY WITH THEIR HOLDER — a count
        no-op, and exactly what the implementation does (the holder's
        process keeps ticking even asleep, so it re-routes once the
        home returns; `_take_reroute` targets the static home, never
        the epoch owner, so no holder hand-off exists to lose them).
        The dropping mutant doctors exactly this stage."""
        for h in rep.joined:
            for i in range(self.cfg.n_instances):
                if self.home[i] == h:
                    self.heights[i] += self.held[i]
                    self.held[i] = 0

    def _install_view(self, rep) -> None:
        """Honest: nothing — `MembershipEpoch.boundary` already
        installed the real repartition.  The overlapping-range mutant
        doctors the installed view here."""

    # -- branching / dedup ---------------------------------------------------

    def mc_clone(self) -> "MembershipSystem":
        s = type(self).__new__(type(self))
        s.cfg = self.cfg
        s.epoch = self.epoch.mc_clone()
        s.home = self.home
        s.heights = list(self.heights)
        s.held = list(self.held)
        s.sent = self.sent
        s.sleeps = self.sleeps
        s.boundaries = self.boundaries
        return s

    def mc_canonical(self) -> tuple:
        # `sent` IS in the key: honest states derive it (sum of
        # heights + held, no extra states), but a lossy re-lift makes
        # it diverge — excluding it would let the mutant's post-drop
        # state dedup against an honest state reached with fewer
        # sends, hiding the violation from the new-state monitors.
        # `boundaries` is excluded for the same reason the epoch
        # counter is (membership.mc_canonical): repetition without
        # behavioral difference must merge or the space is unbounded.
        return (self.epoch.mc_canonical(), tuple(self.heights),
                tuple(self.held), self.sent, self.sleeps)

    def mc_digest(self, perm=None) -> bytes:
        import hashlib
        import marshal

        assert perm is None, "membership domain has no symmetry group"
        return hashlib.blake2b(marshal.dumps(self.mc_canonical(), 2),
                               digest_size=16).digest()

    # -- schedule codec (the Counterexample/corpus serialization) ------------

    @classmethod
    def action_to_json(cls, act: tuple) -> list:
        return [_ACT_NAMES[act[0]], *act[1:]]

    @classmethod
    def action_from_json(cls, a: list) -> tuple:
        return (_ACT_CODES[a[0]], *(int(x) for x in a[1:]))

    def run_schedule(self, actions, on_action=None) -> List[bool]:
        applied = []
        for i, a in enumerate(actions):
            act = self.action_from_json(a) if a and a[0] in _ACT_CODES \
                else tuple(a)
            ok = self.mc_apply(act)
            applied.append(ok)
            if on_action is not None:
                on_action(i, act, ok)
        return applied


# ---------------------------------------------------------------------------
# Monitors
# ---------------------------------------------------------------------------


def membership_state_violations(sys: MembershipSystem
                                ) -> List[Violation]:
    out: List[Violation] = []
    view = sys.epoch.view
    try:
        validate_partition(view.ranges, view.n_instances)
    except MembershipError as e:
        out.append(Violation(
            "partition", -1,
            f"epoch {view.epoch} partition invalid: {e}"))
    if set(view.ranges) != set(view.alive):
        out.append(Violation(
            "partition", -1,
            f"epoch {view.epoch} partition keyed off hosts "
            f"{sorted(view.ranges)} but the live set is "
            f"{list(view.alive)}"))
    have = sum(sys.heights) + sum(sys.held)
    if have != sys.sent:
        out.append(Violation(
            "conservation", -1,
            f"sent {sys.sent} != advanced {sum(sys.heights)} + held "
            f"{sum(sys.held)} — a batch was lost across a "
            f"repartition/re-lift"))
    return out


def membership_edge_snapshot(sys: MembershipSystem) -> tuple:
    return tuple(sys.heights)


def membership_edge_violations(sys: MembershipSystem,
                               snap: tuple) -> List[Violation]:
    out: List[Violation] = []
    for i, h in enumerate(sys.heights):
        if h < snap[i]:
            out.append(Violation(
                "monotonic", i,
                f"instance {i} height regressed {snap[i]} -> {h} "
                f"across a boundary — a re-lift rolled state back"))
    return out


def membership_domain() -> Domain:
    return Domain(
        enabled=lambda s: s.mc_enabled(),
        expandable=lambda s: True,
        state_violations=membership_state_violations,
        edge_snapshot=membership_edge_snapshot,
        edge_violations=membership_edge_violations,
        indep=lambda a, b: False,   # one shared partition: no POR
        near_miss=None,
        symmetry=None,
        codec=MembershipSystem)


def explore_membership(cfg: MembershipMCConfig,
                       system_cls: Optional[type] = None,
                       deadline_at: Optional[float] = None,
                       max_states: Optional[int] = None,
                       stop_on_violation: bool = True,
                       collect_digests: bool = False) -> Report:
    """Exhaustive DFS over `cfg`'s membership schedules — the same
    engine as the consensus/admission scopes."""
    root = (system_cls or MembershipSystem)(cfg)
    return _explore_domain(
        root, cfg, membership_domain(), por=False,
        deadline_at=deadline_at, max_states=max_states,
        stop_on_violation=stop_on_violation,
        collect_digests=collect_digests)


# ---------------------------------------------------------------------------
# Replay + minimization + corpus
# ---------------------------------------------------------------------------


def run_membership_with_monitors(cfg: MembershipMCConfig, actions,
                                 system_cls: Optional[type] = None
                                 ) -> Tuple[MembershipSystem,
                                            List[Violation]]:
    """Deterministic replay with every monitor after every applied
    action — the reproduction predicate for ddmin and the corpus."""
    sys_ = (system_cls or MembershipSystem)(cfg)
    viols: List[Violation] = list(membership_state_violations(sys_))
    snap = [membership_edge_snapshot(sys_)]

    def on_action(_i, _act, ok):
        if ok:
            viols.extend(membership_edge_violations(sys_, snap[0]))
            viols.extend(membership_state_violations(sys_))
        snap[0] = membership_edge_snapshot(sys_)

    sys_.run_schedule(actions, on_action=on_action)
    return sys_, viols


def membership_reproduces(cfg, actions, prop,
                          system_cls: Optional[type] = None) -> bool:
    _, viols = run_membership_with_monitors(cfg, actions, system_cls)
    return any(v.property == prop for v in viols)


def minimize_membership(cfg, actions, prop,
                        system_cls: Optional[type] = None
                        ) -> List[tuple]:
    return _ddmin(
        list(actions),
        lambda acts: membership_reproduces(cfg, acts, prop,
                                           system_cls))


def membership_corpus_entry(name: str, cfg: MembershipMCConfig,
                            actions, origin: str) -> dict:
    """Corpus entry with the honest system's outcome stamped — the
    final heights/held/partition plus EVERY applied repartition
    (old ranges -> new ranges), so the device-plane leg can re-lift
    real spec-tree-shaped leaves along the same boundary sequence."""
    sys_, viols = run_membership_with_monitors(cfg, actions)
    reparts: List[dict] = []
    # second replay to record the repartitions in order (cheap; the
    # model is tiny and the recorder must not perturb the monitors)
    rec = MembershipSystem(cfg)
    for a in actions:
        act = rec.action_from_json(a) if a and a[0] in _ACT_CODES \
            else tuple(a)
        before = rec.epoch.view
        ok = rec.mc_apply(act)
        if ok and act[0] == "b" and rec.epoch.view is not before:
            reparts.append({
                "old": sorted([h, lo, hi] for h, (lo, hi)
                              in before.ranges.items()),
                "new": sorted([h, lo, hi] for h, (lo, hi)
                              in rec.epoch.view.ranges.items()),
            })
    return {
        "kind": "membership",
        "name": name,
        "origin": origin,
        "config": cfg.to_json(),
        "actions": [MembershipSystem.action_to_json(tuple(a))
                    for a in actions],
        "expect": {
            "violations": sorted({v.property for v in viols}),
            "heights": list(sys_.heights),
            "held": list(sys_.held),
            "sent": sys_.sent,
            "alive": list(sys_.epoch.view.alive),
            "ranges": sorted([h, lo, hi] for h, (lo, hi)
                             in sys_.epoch.view.ranges.items()),
            "boundaries": sys_.boundaries,
            "readmissions": sys_.epoch.readmissions,
            "departures": sys_.epoch.departures,
            "repartitions": reparts,
        },
    }


def replay_membership_entry(entry: dict) -> Tuple[MembershipSystem,
                                                  List[Violation]]:
    cfg = MembershipMCConfig.from_json(entry["config"])
    sys_, viols = run_membership_with_monitors(cfg, entry["actions"])
    exp = entry["expect"]
    assert list(sys_.heights) == exp["heights"], entry["name"]
    assert list(sys_.held) == exp["held"], entry["name"]
    assert sys_.sent == exp["sent"], entry["name"]
    assert list(sys_.epoch.view.alive) == exp["alive"], entry["name"]
    got_ranges = sorted([h, lo, hi] for h, (lo, hi)
                        in sys_.epoch.view.ranges.items())
    assert got_ranges == [list(r) for r in exp["ranges"]], (
        f"{entry['name']}: final partition diverged")
    assert sys_.boundaries == exp["boundaries"], entry["name"]
    assert sys_.epoch.readmissions == exp["readmissions"], entry["name"]
    assert sys_.epoch.departures == exp["departures"], entry["name"]
    assert sorted({v.property for v in viols}) == exp["violations"], (
        f"{entry['name']}: property verdicts diverged")
    return sys_, viols


# ---------------------------------------------------------------------------
# Mutation self-test: doctored boundary stages the monitors MUST catch
# ---------------------------------------------------------------------------


class _OverlappingRepartitionSystem(MembershipSystem):
    """Doctored: the installed boundary view extends the lowest live
    host's range one instance into its neighbor — the classic
    off-by-one at a repartition split point.  Caught by the partition
    (disjointness) monitor via the real `validate_partition`."""

    def _install_view(self, rep) -> None:
        view = self.epoch.view
        if len(view.ranges) < 2:
            return
        ranges = dict(view.ranges)
        low = min(ranges)
        lo, hi = ranges[low]
        ranges[low] = (lo, hi + 1)
        self.epoch.view = dataclasses.replace(view, ranges=ranges)


class _DroppingReliftSystem(MembershipSystem):
    """Doctored: the readmission re-lift replays one batch short per
    held instance — held state silently truncated while moving onto
    the new partition.  Caught by the conservation monitor."""

    def _relift_held(self, rep) -> None:
        for h in rep.joined:
            for i in range(self.cfg.n_instances):
                if self.home[i] == h and self.held[i]:
                    self.heights[i] += self.held[i] - 1
                    self.held[i] = 0


#: mutant name -> (system class, property caught by, config)
MEMBERSHIP_MUTANTS: Dict[str, tuple] = {
    # sleep one of three hosts, cross the boundary: the doctored
    # two-survivor partition overlaps at the split point
    "overlapping_range_repartition": (
        _OverlappingRepartitionSystem, "partition",
        MembershipMCConfig(name="mut_overlap", n_hosts=3,
                           n_instances=6, host_churn=1, max_height=1,
                           depth=4)),
    # sleep, hold a batch, rejoin: the doctored re-lift replays one
    # batch short (sent > advanced + held)
    "relift_drops_held_batch": (
        _DroppingReliftSystem, "conservation",
        MembershipMCConfig(name="mut_drop_relift", n_hosts=2,
                           n_instances=2, host_churn=1, max_height=2,
                           depth=7)),
}


def self_test_membership() -> dict:
    """Each doctored boundary stage must be caught, its counterexample
    must ddmin-minimize, and the minimized schedule must run CLEAN on
    the honest system (the violation is the mutation's, not the
    checker's)."""
    out = {}
    for name, (sys_cls, prop, cfg) in MEMBERSHIP_MUTANTS.items():
        rep = explore_membership(cfg, system_cls=sys_cls)
        caught = [c for c in rep.violations
                  if c.violation.property == prop]
        assert caught, (
            f"membership mutant {name}: no {prop} violation in "
            f"{rep.states} states")
        ce = caught[0]
        ce.minimized = minimize_membership(cfg, ce.schedule, prop,
                                           system_cls=sys_cls)
        assert membership_reproduces(cfg, ce.minimized, prop,
                                     system_cls=sys_cls)
        _, honest = run_membership_with_monitors(cfg, ce.minimized)
        assert not honest, (
            f"membership mutant {name}: minimized schedule also "
            f"violates on the honest system: {honest}")
        out[name] = {
            "property": prop,
            "states_to_detection": rep.states,
            "schedule_len": len(ce.schedule),
            "minimized_len": len(ce.minimized),
            "counterexample": ce.to_json(),
        }
    return out


# ---------------------------------------------------------------------------
# Corpus emission (tests/corpus/membership/*.json)
# ---------------------------------------------------------------------------

#: hand-written milestone schedules (deterministic coverage witnesses
#: the spec-tree re-lift test replays): name -> (config, schedule,
#: post-condition on the honest system)
MEMBERSHIP_MILESTONES: Dict[str, tuple] = {
    # the full sleepy-churn cycle: traffic, a leave boundary, a batch
    # held for the departed home, readmission replaying it
    "mem_leave_hold_rejoin_replay": (
        MembershipMCConfig(name="mem_cycle", n_hosts=2, n_instances=2,
                           host_churn=1, max_height=2, depth=10),
        [("d", 0), ("d", 1), ("s", 1), ("b",), ("d", 1), ("d", 0),
         ("w", 1), ("b",)],
        lambda s: (s.heights == [2, 2] and not any(s.held)
                   and s.epoch.readmissions == 1
                   and s.epoch.view.alive == (0, 1))),
    # pod shrinks 3 -> 2 -> 1 live hosts and grows back to 3: every
    # intermediate partition even, both departures counted, both
    # readmissions applied at one boundary
    "mem_shrink_to_one_and_regrow": (
        MembershipMCConfig(name="mem_regrow", n_hosts=3,
                           n_instances=6, host_churn=2, max_height=1,
                           depth=12),
        [("s", 2), ("b",), ("s", 1), ("b",), ("w", 1), ("w", 2),
         ("b",)],
        lambda s: (s.epoch.view.alive == (0, 1, 2)
                   and s.epoch.departures == 2
                   and s.epoch.readmissions == 2
                   and s.epoch.view.ranges
                   == partition_ranges(6, (0, 1, 2)))),
    # an intent flap inside one epoch: leave latched then cancelled by
    # the rejoin before any boundary — the no-op boundary burns no
    # epoch and the partition never moves
    "mem_flap_cancels_before_boundary": (
        MembershipMCConfig(name="mem_flap", n_hosts=2, n_instances=2,
                           host_churn=1, max_height=1, depth=6),
        [("d", 0), ("s", 1), ("w", 1), ("b",), ("d", 1)],
        lambda s: (s.heights == [1, 1] and s.boundaries == 0
                   and s.epoch.view.epoch == 0)),
}


def emit_membership_corpus(directory: str,
                           include_mutants: bool = True) -> List[str]:
    """(Re)generate the membership regression corpus: the milestone
    schedules plus each mutant's minimized counterexample (stamped
    with the HONEST system's outcome — clean, the admission-corpus
    pattern).  Deterministic."""
    import json
    import os

    os.makedirs(directory, exist_ok=True)
    written = []
    for name, (cfg, sched, check) in MEMBERSHIP_MILESTONES.items():
        sys_, viols = run_membership_with_monitors(cfg, sched)
        assert not viols, (name, viols)
        assert check(sys_), f"milestone {name} post-condition failed"
        entry = membership_corpus_entry(
            name, cfg, sched, origin="hand-written milestone")
        path = os.path.join(directory, f"{name}.json")
        with open(path, "w") as f:
            json.dump(entry, f, indent=1, sort_keys=True)
            f.write("\n")
        written.append(path)
    if include_mutants:
        for mname, r in self_test_membership().items():
            ce = r["counterexample"]
            cfg = MembershipMCConfig.from_json(ce["config"])
            acts = [MembershipSystem.action_from_json(a)
                    for a in ce["schedule"]]
            entry = membership_corpus_entry(
                f"mem_mut_{mname}", cfg, acts,
                origin=f"minimized {mname} membership-mutant "
                       f"counterexample (honest replay: clean)")
            path = os.path.join(directory, f"mem_mut_{mname}.json")
            with open(path, "w") as f:
                json.dump(entry, f, indent=1, sort_keys=True)
                f.write("\n")
            written.append(path)
    return written


# ---------------------------------------------------------------------------
# Scopes (aggregated into the modelcheck CLI by run_scope)
# ---------------------------------------------------------------------------

MEMBERSHIP_TINY: Tuple[MembershipMCConfig, ...] = (
    MembershipMCConfig(name="mem_tiny", n_hosts=2, n_instances=2,
                       host_churn=1, max_height=1, depth=6),
)

#: the twin's CI envelope beside the consensus/admission shards: the
#: flagship shard interleaves two full churn cycles with held traffic
#: on a 3-host pod (every live-set size 3/2/1 reachable) and EXHAUSTS
#: >= 50k states
MEMBERSHIP_SMOKE: Tuple[MembershipMCConfig, ...] = (
    MembershipMCConfig(name="mem_churn2", n_hosts=3, n_instances=6,
                       host_churn=2, max_height=2, depth=12),
    MembershipMCConfig(name="mem_pair_deep", n_hosts=2,
                       n_instances=4, host_churn=2, max_height=3,
                       depth=14),
)

MEMBERSHIP_SCOPES = {"tiny": MEMBERSHIP_TINY,
                     "smoke": MEMBERSHIP_SMOKE,
                     "full": MEMBERSHIP_SMOKE}
