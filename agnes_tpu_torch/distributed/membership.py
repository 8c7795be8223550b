"""Pod membership and negotiation math: the process-free core of the
elastic pod (twin of `agnes_tpu.distributed.membership`, the port's own
copy).

Three pieces, each testable without a process group, as topology.py is
for the static pod:

* **Range repartition** — `partition_ranges` assigns contiguous global
  instance blocks to the *live* host set (sorted, an even split as
  HostPlan demands: a ragged membership is refused at plan time);
  `validate_partition` is the disjoint-and-covering invariant the live
  boundary path calls.  `relift_ranges(old, new)` is the transfer plan:
  the maximal (src host, dst host, lo, hi) global ranges that change
  owner.
* **Spec-tree re-lift** — `instance_axis_of` + `relift_tree` re-lift a
  host's tree of numpy state / tally blocks onto a new partition, driven
  by the spec tuples the sharded dispatch uses (parallel/sharded.py
  `seq_specs()` / `dense_lane_specs()`, whose instance axis is the
  token `INSTANCE_AXIS`), so the re-lift cannot disagree with the
  dispatch about which axis is the instance dimension.
* **Per-tick plan negotiation** — `TickSlot` / `merge_tick_plans`: each
  host's closed build shapes for one lockstep tick, merged to the
  per-slot max (P, rung, BLS class rung), so that honest heterogeneous
  traffic pads up onto a warmed shape instead of diverging the pod.
  Slot kinds must agree: a signed slot against an unsigned one is a
  statics divergence and fails loudly, as PodCoordinator.agree does.

`MembershipEpoch` is the protocol object.  Leave / join intents latch
mid-epoch (a departed host stops serving; the pod keeps ticking) and
apply only at epoch boundaries, where the partition recomputes, held
gossip re-routes along `relift_ranges`, and a returned host is
readmitted after a holddown counted in logical ticks (`note_tick`,
advanced by every host at the same lockstep point; departures stamped
at the boundary that applied them).  So every holddown verdict is a
function of pod-shared state: wall clocks are not consulted, since two
hosts near a threshold would disagree and diverge their pending sets.

Hosts, not processes: a pod host is `per_host` consecutive ranks
(distributed/driver.py), and every count, mask and range here is a
host's.  Numpy and the stdlib only.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Dict,
    Iterable,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from agnes_tpu_torch.distributed.topology import PodConfigError

#: the instance axis token of the port's spec tuples (parallel/sharded.py
#: `DATA`: data, or slice x data); spelled here so that this module loads
#: without torch
INSTANCE_AXIS = "data*"


class MembershipError(PodConfigError):
    """A membership or negotiation invariant the elastic pod cannot
    satisfy (an uneven repartition, tick slots of diverged kinds, ...)."""


# -- range repartition --------------------------------------------------------

def partition_ranges(n_instances: int,
                     hosts: Iterable[int]) -> Dict[int, Tuple[int, int]]:
    """Contiguous [lo, hi) global instance ranges over the sorted live
    host set.  The split must be even (HostPlan's rule: the sharded data
    axes need an exact split; a deployment picks I as a multiple of every
    pod size it means to survive)."""
    live = sorted(set(int(h) for h in hosts))
    if not live:
        raise MembershipError("cannot partition over an empty host set")
    if n_instances <= 0:
        raise MembershipError(
            f"n_instances must be >= 1: {n_instances}")
    if n_instances % len(live):
        raise MembershipError(
            f"{n_instances} instances do not repartition evenly over "
            f"{len(live)} live host(s) {live}: uneven splits are refused "
            f"(pad the deployment or change the pod size)")
    per = n_instances // len(live)
    return {h: (k * per, (k + 1) * per) for k, h in enumerate(live)}


def validate_partition(ranges: Mapping[int, Tuple[int, int]],
                       n_instances: int) -> None:
    """The disjoint-and-covering invariant: every global instance id in
    [0, n_instances) owned by exactly one host.  Raises MembershipError
    naming the first violation."""
    owned = np.zeros(n_instances, np.int64)
    for h, (lo, hi) in ranges.items():
        if not (0 <= lo <= hi <= n_instances):
            raise MembershipError(
                f"host {h} range [{lo}, {hi}) outside "
                f"[0, {n_instances})")
        owned[lo:hi] += 1
    over = np.nonzero(owned > 1)[0]
    if len(over):
        raise MembershipError(
            f"partition overlaps at instance {int(over[0])}: "
            f"{dict(ranges)}")
    gap = np.nonzero(owned == 0)[0]
    if len(gap):
        raise MembershipError(
            f"partition leaves instance {int(gap[0])} unowned: "
            f"{dict(ranges)}")


def relift_ranges(old: Mapping[int, Tuple[int, int]],
                  new: Mapping[int, Tuple[int, int]],
                  ) -> List[Tuple[int, int, int, int]]:
    """Transfer plan between two partitions of one instance space:
    [(src_host, dst_host, lo, hi)] for every maximal global range whose
    owner changed, sorted by lo.  Ranges a host owns in both partitions
    do not appear."""
    def owner_at(ranges, i):
        for h, (lo, hi) in ranges.items():
            if lo <= i < hi:
                return h
        raise MembershipError(f"instance {i} unowned in {dict(ranges)}")

    n = max((hi for _, hi in old.values()), default=0)
    out: List[Tuple[int, int, int, int]] = []
    i = 0
    while i < n:
        src, dst = owner_at(old, i), owner_at(new, i)
        j = i + 1
        while j < n and owner_at(old, j) == src \
                and owner_at(new, j) == dst:
            j += 1
        if src != dst:
            out.append((src, dst, i, j))
        i = j
    return out


# -- spec-tree re-lift --------------------------------------------------------

def instance_axis_of(spec, instance_axes: Sequence[str] = (INSTANCE_AXIS,),
                     ) -> Optional[int]:
    """The axis index of `spec` (a tuple of mesh-axis names, tuples of
    names or Nones: the port's spec tuples, or the twin's
    PartitionSpecs) sharded over any of `instance_axes`, i.e. the
    instance dimension of the leaf this spec shards.  None when the leaf
    carries none (replicated operands: powers, the pubkey table)."""
    want = set(instance_axes)
    for a, axes in enumerate(tuple(spec)):
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes or ())
        if want & set(axes_t):
            return a
    return None


def relift_tree(blocks_by_host: Mapping[int, Sequence[np.ndarray]],
                old: Mapping[int, Tuple[int, int]],
                new: Mapping[int, Tuple[int, int]],
                axes: Sequence[Optional[int]],
                ) -> Dict[int, List[np.ndarray]]:
    """Re-lift per-host state / tally leaf blocks onto a new partition:
    `blocks_by_host[h]` is host h's flat leaf list (numpy), `axes[k]` the
    instance axis of leaf k (`instance_axis_of` over the matching spec
    tree; None = replicated, copied from any host).  Returns the same
    structure keyed by the new partition's hosts.  Pure data movement
    (assemble the global leaf, re-slice it), so the old and new
    assemblies are identical by construction; both partitions are
    validated first, so a hole or an overlap fails here, not as lost
    state."""
    if not blocks_by_host:
        return {}
    n = max(hi for _, hi in old.values())
    validate_partition(old, n)
    validate_partition(new, n)
    n_leaves = len(next(iter(blocks_by_host.values())))
    out: Dict[int, List[np.ndarray]] = {h: [] for h in new}
    for k in range(n_leaves):
        ax = axes[k]
        if ax is None:
            any_host = next(iter(blocks_by_host))
            for h in new:
                out[h].append(np.asarray(
                    blocks_by_host[any_host][k]).copy())
            continue
        sample = np.asarray(next(iter(blocks_by_host.values()))[k])
        gshape = list(sample.shape)
        per_old = gshape[ax]
        gshape[ax] = n
        g = np.empty(gshape, sample.dtype)
        for h, (lo, hi) in old.items():
            blk = np.asarray(blocks_by_host[h][k])
            if blk.shape[ax] != hi - lo or hi - lo != per_old:
                raise MembershipError(
                    f"leaf {k}: host {h} block extent "
                    f"{blk.shape[ax]} != owned range {hi - lo}")
            sel = [slice(None)] * g.ndim
            sel[ax] = slice(lo, hi)
            g[tuple(sel)] = blk
        for h, (lo, hi) in new.items():
            sel = [slice(None)] * g.ndim
            sel[ax] = slice(lo, hi)
            out[h].append(g[tuple(sel)].copy())
    return out


# -- per-tick plan negotiation ------------------------------------------------

#: tick-slot kinds (small ints, stable on the wire)
KIND_DENSE_SIGNED = 1          # dense fused signed step (pod serve)
KIND_SIGNED = 2                # packed-lane signed (carries a rung)
KIND_UNSIGNED = 3              # pre-verified / unsigned sequence
KIND_NAMES = {KIND_DENSE_SIGNED: "dense_signed", KIND_SIGNED: "signed",
              KIND_UNSIGNED: "unsigned"}


class TickSlot(NamedTuple):
    """One closed build's shape, as negotiated: the step sequence's
    length P (entry included), the lane rung (0 on dense and unsigned
    builds, whose shape carries none) and the BLS class rung (0 = no BLS
    lane)."""

    kind: int
    n_phases: int
    rung: int = 0
    bls_class_rung: int = 0


def merge_tick_plans(plans: Sequence[Sequence[TickSlot]],
                     ) -> Tuple[TickSlot, ...]:
    """The pod plan of one tick: per slot position, the max of every
    contributing host's (P, rung, BLS class rung); hosts with fewer
    slots or smaller shapes pad up.  A kind mismatch at a slot is a
    statics divergence (module docstring) and raises."""
    n_slots = max((len(p) for p in plans), default=0)
    merged: List[TickSlot] = []
    for k in range(n_slots):
        slots = [TickSlot(*p[k]) for p in plans if len(p) > k]
        kinds = {s.kind for s in slots}
        if len(kinds) != 1:
            raise MembershipError(
                f"tick slot {k} kind diverged across the pod: "
                + ", ".join(sorted(KIND_NAMES.get(kd, str(kd))
                                   for kd in kinds))
                + " — mixed slot kinds are a statics divergence, not "
                  "honest heterogeneity; failing loudly")
        merged.append(TickSlot(
            kind=kinds.pop(),
            n_phases=max(s.n_phases for s in slots),
            rung=max(s.rung for s in slots),
            bls_class_rung=max(s.bls_class_rung for s in slots)))
    return tuple(merged)


# -- the membership protocol --------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MembershipView:
    """One epoch's membership: the live host set and its partition.
    Immutable: a boundary makes a new view, so a consumer may hold one
    across a tick."""

    epoch: int
    n_hosts: int                   # the pod's full host count
    n_instances: int
    alive: Tuple[int, ...]
    ranges: Mapping[int, Tuple[int, int]]

    def owner_of(self, instance: int) -> int:
        for h, (lo, hi) in self.ranges.items():
            if lo <= instance < hi:
                return h
        raise MembershipError(
            f"instance {instance} unowned in epoch {self.epoch}")

    def owned_range(self, host: int) -> Optional[Tuple[int, int]]:
        """[lo, hi) `host` owns this epoch, None while departed."""
        return self.ranges.get(int(host))

    def alive_mask(self) -> int:
        return sum(1 << h for h in self.alive)


@dataclasses.dataclass(frozen=True)
class Repartition:
    """One applied epoch boundary: the views before and after and the
    transfer plan (`relift_ranges`) between their partitions."""

    old: MembershipView
    new: MembershipView
    transfers: Tuple[Tuple[int, int, int, int], ...]
    joined: Tuple[int, ...]
    left: Tuple[int, ...]


class MembershipEpoch:
    """Leave / join intents latch mid-epoch and apply at boundaries
    (module docstring).  The rejoin holddown counts logical ticks
    (`note_tick`); the counters are plain ints the owning shard mirrors
    into its metrics."""

    def __init__(self, n_hosts: int, n_instances: int, *,
                 rejoin_holddown_ticks: int = 0):
        self.rejoin_holddown_ticks = int(rejoin_holddown_ticks)
        self.tick = 0                  # the lockstep logical clock
        view = MembershipView(
            epoch=0, n_hosts=int(n_hosts),
            n_instances=int(n_instances),
            alive=tuple(range(int(n_hosts))),
            ranges=partition_ranges(n_instances, range(int(n_hosts))))
        validate_partition(view.ranges, n_instances)
        self.view = view
        self._pending_leave: set = set()
        self._pending_join: set = set()
        #: tick of the boundary that applied each departure: a lockstep
        #: point where every host holds the same merged intents and tick,
        #: so the stamp and every holddown verdict are pod-identical
        self._left_at: Dict[int, int] = {}
        self.readmissions = 0          # rejoins applied at boundaries
        self.departures = 0
        self.deferred_joins = 0        # joins the holddown pushed back

    # -- intents (latched mid-epoch, applied at a boundary) ------------------

    def note_tick(self) -> int:
        """Advance the lockstep logical clock one elastic tick.  Every
        host calls it at the same protocol point (ElasticShard.tick,
        before intents merge), so the counter is pod-identical: a join
        latched at tick T is broadcast on the next frame, and every peer
        evaluates the (monotone) holddown at a tick >= T and latches
        too."""
        self.tick += 1
        return self.tick

    def note_leave(self, host: int) -> bool:
        """Latch a leave intent (idempotent); True when newly latched.
        The partition changes only at the next boundary."""
        host = int(host)
        if host not in self.view.alive or host in self._pending_leave:
            return False
        self._pending_leave.add(host)
        self._pending_join.discard(host)
        return True

    def note_join(self, host: int) -> bool:
        """Latch a join intent for a departed (or departing) host.  A
        join within `rejoin_holddown_ticks` of the boundary that applied
        the departure is deferred (counted, False): a flapping peer must
        stay quiet before the pod repartitions for it.  A leave latched
        but not yet applied owes no holddown: cancelling it mid-epoch
        moved no partition."""
        host = int(host)
        already = (host in self.view.alive
                   and host not in self._pending_leave)
        if already or host in self._pending_join:
            return False
        left = self._left_at.get(host)
        if left is not None and self.rejoin_holddown_ticks > 0 \
                and self.tick - left < self.rejoin_holddown_ticks:
            self.deferred_joins += 1
            return False
        self._pending_join.add(host)
        self._pending_leave.discard(host)
        return True

    def merge_intents(self, leave_mask: int, join_mask: int) -> None:
        """Fold in the intents gathered from peers' frames: the union
        keeps every host's pending sets, and so the next boundary's
        partition, identical without a second protocol."""
        for h in range(self.view.n_hosts):
            if leave_mask >> h & 1:
                self.note_leave(h)
            if join_mask >> h & 1:
                self.note_join(h)

    def pending(self) -> Tuple[int, int]:
        """(leave_mask, join_mask) of latched intents: what this host's
        next negotiation frame broadcasts."""
        return (sum(1 << h for h in self._pending_leave),
                sum(1 << h for h in self._pending_join))

    def prospective(self) -> Optional[MembershipView]:
        """The view the next boundary would produce (None = no pending
        change): what a survivor reads to pack re-routed gossip before
        the boundary applies.  A function of the latched intents only, so
        every host computes the same answer from the gathered masks."""
        alive = set(self.view.alive) - self._pending_leave \
            | self._pending_join
        if tuple(sorted(alive)) == self.view.alive:
            return None
        if not alive:
            return None                  # never partition to nobody
        return MembershipView(
            epoch=self.view.epoch + 1, n_hosts=self.view.n_hosts,
            n_instances=self.view.n_instances,
            alive=tuple(sorted(alive)),
            ranges=partition_ranges(self.view.n_instances,
                                    sorted(alive)))

    # -- model-checker hooks -------------------------------------------------

    def mc_clone(self) -> "MembershipEpoch":
        """A branchable copy for an exhaustive explorer: views are
        frozen and shared, the intent sets copied."""
        c = type(self).__new__(type(self))
        c.rejoin_holddown_ticks = self.rejoin_holddown_ticks
        c.tick = self.tick
        c.view = self.view
        c._pending_leave = set(self._pending_leave)
        c._pending_join = set(self._pending_join)
        c._left_at = dict(self._left_at)
        c.readmissions = self.readmissions
        c.departures = self.departures
        c.deferred_joins = self.deferred_joins
        return c

    def mc_canonical(self) -> tuple:
        """Dedup key: the live set, its partition and the latched
        intents.  The epoch counter, `tick` and `_left_at` are left out:
        two states that differ only in them behave alike under a
        holddown of 0, and leaving them out keeps the explored space
        finite."""
        return (self.view.alive,
                tuple(sorted((h, r) for h, r in self.view.ranges.items())),
                self.pending())

    # -- the boundary --------------------------------------------------------

    def boundary(self) -> Optional[Repartition]:
        """Apply the latched intents at an epoch boundary: repartition,
        compute the transfer plan, readmit joiners (counted), age out
        leavers.  None when nothing changed (a no-op boundary burns no
        epoch).  Every host calls it at the same lockstep point with the
        same merged intents, so every host steps to the same view."""
        new = self.prospective()
        self._pending_leave.clear()
        joined = tuple(sorted(self._pending_join))
        self._pending_join.clear()
        if new is None:
            return None
        validate_partition(new.ranges, new.n_instances)
        old = self.view
        left = tuple(sorted(set(old.alive) - set(new.alive)))
        joined = tuple(h for h in joined if h in new.alive
                       and h not in old.alive)
        rep = Repartition(
            old=old, new=new,
            transfers=tuple(relift_ranges(old.ranges, new.ranges)),
            joined=joined, left=left)
        self.view = new
        self.readmissions += len(joined)
        self.departures += len(left)
        for h in left:
            # the holddown clock starts at the boundary, a lockstep point,
            # not at note_leave; a leave cancelled before any boundary
            # aged no partition and owes none
            self._left_at[h] = self.tick
        for h in joined:
            self._left_at.pop(h, None)
        return rep
