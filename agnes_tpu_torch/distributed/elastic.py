"""The elastic pod: per-tick shape negotiation and host leave / rejoin at
epoch boundaries over the static pod (twin of
`agnes_tpu.distributed.elastic`).

The static pod (shard.py) serves only homogeneous, immortal hosts: a
deadline-closed P = 2 batch on one host against a P = 3 batch on another
is a PodDivergenceError, and a dead peer fails every later drain closed.
ElasticShard layers the membership plane of membership.py onto HostShard
so that both are survived:

* **Per-tick plan negotiation** (`ElasticShard.tick`): each host closes
  its micro-batch, stages its builds without dispatching them, and packs
  its staged shape plan (kind, P, rung, BLS class rung) into one
  fixed-size frame beside its newly latched decisions, its membership
  intents and its re-routed gossip.  One all_gather over the pod's gloo
  group (`PodCoordinator.negotiate`) exchanges the frames; the merged
  plan is the per-slot max (`merge_tick_plans`), every host pads up to
  it (`ServePipeline.pad_staged_to` / `stage_padding`: empty phases and
  all-zero dense cells change no state) and only then dispatches, so the
  dispatch agree() sees identical plans under honest heterogeneity and
  keeps its strictness for statics.  Padding lands only on shapes warmup
  launched: `warmup_covers` is asked before any dispatch, and the retrace
  sentinel stays armed behind it.
* **Leave / join at epoch boundaries**: intents (`announce_leave` /
  `announce_join`, or the attached StragglerMonitor's verdicts) latch
  mid-epoch and apply at boundaries (`tick(boundary=True)`, which callers
  pass at height edges, a lockstep point).  A departed host keeps its
  processes and keeps ticking, dispatching pure padding on its own
  (data, val) sub-mesh, so the pod-wide agree before every dispatch and
  the host's val all_reduces stay in lockstep; its instance ranges
  repartition onto the survivors.  Held gossip routes by static home
  (the host whose device block serves an instance): the epoch owner of
  a range holds records whose home is departed (bounded by the frame's
  reroute capacity; overflow is counted, dropped and logged, never a
  wedge); a record whose home is alive is never held, since the home's
  own front door serves it.  Once the home is back (its join rides the
  prospective view of the readmission boundary's own frame) the holder
  re-routes the held 96-byte records, global instance ids intact, and
  the home replays them in height order.  What still fails closed: a
  host dead to the process group itself hangs the gloo and NCCL
  collectives, which is why the monitor without a membership keeps
  raising DeadHostError.

Hosts, not processes: a host is `per_host` consecutive ranks, each with
its own ElasticShard on the same gossip.  Membership, its masks (bit h =
host h, 32 hosts at most) and `MembershipEpoch(n_hosts, ...)` count
hosts; `negotiate` returns a row a process, and only each host's first
rank's frame is unpacked: the other ranks' frames of that host must equal
it byte for byte, or the tick raises PodDivergenceError.

The frame codec is numpy only; ElasticShard's serve plumbing goes
through HostShard.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from agnes_tpu_torch.bridge.native_ingest import REC_SIZE
from agnes_tpu_torch.distributed.membership import (
    KIND_DENSE_SIGNED,
    KIND_NAMES,
    KIND_SIGNED,
    KIND_UNSIGNED,
    MembershipEpoch,
    MembershipError,
    Repartition,
    TickSlot,
    merge_tick_plans,
)
from agnes_tpu_torch.distributed.shard import HostShard
from agnes_tpu_torch.distributed.topology import (
    PodDecision,
    frame_capacity_bytes,
    shift_instances_inplace,
    unpack_decision_frame,
    wire_instance_ids,
)
from agnes_tpu_torch.utils.metrics import (
    POD_FOREIGN_REJECTS,
    POD_HOST_READMISSIONS,
    POD_MEMBERSHIP_EPOCH,
    POD_NEGOTIATION_WALL_S,
)

# -- the combined elastic frame ------------------------------------------------
#
# One fixed-size all_gather row a process a tick (all-zero padding: every
# process packs the same capacities, so the collective's shape is static):
#
#   [0:28)  header, 7 LE u32: magic 'ELA1' | host | epoch |
#           alive_mask | leave_mask | join_mask | reserved
#   [28:..) slot section: u32 n_slots + max_slots x 16-byte slots
#           (u32 kind | n_phases | rung | bls_class_rung)
#   [..:..) decision section: the static pod's decision frame, unchanged
#           (topology.pack_decision_frame: u32 count + u32 host +
#           max_decisions x 96-byte wire records)
#   [..:..) reroute section: u32 nbytes + reroute_cap raw bytes of held
#           96-byte wire records, global instance ids intact
#
# Masks are u32 bitmaps (bit h = host h), which caps the elastic pod at
# 32 hosts; the reserved word is where a wider encoding would go.

ELASTIC_MAGIC = 0x454C4131          # 'ELA1'
EHDR = 28
SLOT_BYTES = 16
MAX_POD_HOSTS = 32


class ElasticFrame(NamedTuple):
    """One host's unpacked negotiation frame."""

    host: int
    epoch: int
    alive_mask: int
    leave_mask: int
    join_mask: int
    slots: Tuple[TickSlot, ...]
    decisions: List[PodDecision]
    reroute: bytes


def elastic_frame_capacity(max_slots: int, max_decisions: int,
                           reroute_cap: int) -> int:
    """Total frame bytes for the given section capacities."""
    return (EHDR + 4 + int(max_slots) * SLOT_BYTES
            + frame_capacity_bytes(max_decisions)
            + 4 + int(reroute_cap))


def pack_elastic_frame(host: int, epoch: int, alive_mask: int,
                       leave_mask: int, join_mask: int,
                       slots: Sequence[TickSlot],
                       decision_frame: np.ndarray,
                       reroute: bytes, *,
                       max_slots: int,
                       reroute_cap: int) -> np.ndarray:
    """[frame bytes] uint8, the layout above.  `decision_frame` is
    topology.pack_decision_frame's output, embedded as it is (one
    decision codec)."""
    if len(slots) > max_slots:
        raise MembershipError(
            f"{len(slots)} tick slots exceed the negotiated frame "
            f"capacity {max_slots}")
    if len(reroute) > reroute_cap:
        raise MembershipError(
            f"{len(reroute)} reroute bytes exceed capacity "
            f"{reroute_cap}")
    if len(reroute) % REC_SIZE:
        raise MembershipError(
            f"reroute payload {len(reroute)}B is not whole "
            f"{REC_SIZE}-byte records")
    dec = np.asarray(decision_frame, np.uint8)
    frame = np.zeros(
        elastic_frame_capacity(max_slots, 0, reroute_cap)
        + len(dec) - frame_capacity_bytes(0), np.uint8)
    hdr = np.asarray([ELASTIC_MAGIC, host, epoch, alive_mask,
                      leave_mask, join_mask, 0], np.uint32)
    frame[:EHDR] = hdr.view(np.uint8)
    o = EHDR
    frame[o:o + 4] = np.asarray([len(slots)], np.uint32).view(np.uint8)
    o += 4
    if len(slots):
        frame[o:o + len(slots) * SLOT_BYTES] = np.asarray(
            [[s.kind, s.n_phases, s.rung, s.bls_class_rung]
             for s in slots], np.uint32).reshape(-1).view(np.uint8)
    o = EHDR + 4 + max_slots * SLOT_BYTES
    frame[o:o + len(dec)] = dec
    o += len(dec)
    frame[o:o + 4] = np.asarray([len(reroute)], np.uint32).view(np.uint8)
    o += 4
    if reroute:
        frame[o:o + len(reroute)] = np.frombuffer(reroute, np.uint8)
    return frame


def unpack_elastic_frame(row, max_slots: int, max_decisions: int,
                         reroute_cap: int) -> ElasticFrame:
    """Inverse of pack_elastic_frame for one gathered row."""
    row = np.asarray(row, np.uint8)
    want = elastic_frame_capacity(max_slots, max_decisions, reroute_cap)
    if len(row) != want:
        raise MembershipError(
            f"elastic frame is {len(row)}B, capacities say {want}B")
    hdr = row[:EHDR].view(np.uint32)
    if int(hdr[0]) != ELASTIC_MAGIC:
        raise MembershipError(
            f"bad elastic frame magic {int(hdr[0]):#x}")
    o = EHDR
    n_slots = int(row[o:o + 4].view(np.uint32)[0])
    if n_slots > max_slots:
        raise MembershipError(
            f"frame claims {n_slots} slots > capacity {max_slots}")
    o += 4
    words = row[o:o + n_slots * SLOT_BYTES].view(np.uint32).reshape(-1, 4)
    slots = tuple(TickSlot(*(int(x) for x in w)) for w in words)
    o = EHDR + 4 + max_slots * SLOT_BYTES
    dlen = frame_capacity_bytes(max_decisions)
    decisions = unpack_decision_frame(row[o:o + dlen])
    o += dlen
    nre = int(row[o:o + 4].view(np.uint32)[0])
    if nre > reroute_cap:
        raise MembershipError(
            f"frame claims {nre} reroute bytes > capacity "
            f"{reroute_cap}")
    o += 4
    return ElasticFrame(
        host=int(hdr[1]), epoch=int(hdr[2]),
        alive_mask=int(hdr[3]), leave_mask=int(hdr[4]),
        join_mask=int(hdr[5]), slots=slots,
        decisions=decisions, reroute=row[o:o + nre].tobytes())


# -- the elastic shard ---------------------------------------------------------

class ElasticShard(HostShard):
    """HostShard + the membership and negotiation plane (module
    docstring).  It goes wherever HostShard goes; its one new lockstep
    obligation is `tick()`: every process, serving or sleeping, calls it
    at the same protocol points (the smoke drives a fixed tick schedule a
    height), because the tick's all_gather is a pod collective.

    `membership` is the pod's MembershipEpoch (default: over every host
    of the pod, holding a readmission `rejoin_holddown_ticks` ticks); it
    must cover the pod's hosts and global instances.  A frame carries at
    most `max_slots` staged builds, and its reroute section
    `reroute_capacity` bytes (default 4 x the host's instances x V
    records).  `clock` times the ticks and goes on to HostShard.  Held
    gossip is kept as blocks of [n, REC_SIZE] uint8 rows, global
    instance ids, in arrival order."""

    def __init__(self, driver, batcher, pubkeys=None, *,
                 membership: Optional[MembershipEpoch] = None,
                 rejoin_holddown_ticks: int = 0,
                 max_slots: int = 8,
                 reroute_capacity: Optional[int] = None,
                 clock=time.monotonic,
                 **service_kwargs):
        super().__init__(driver, batcher, pubkeys, clock=clock,
                         **service_kwargs)
        if self.n_hosts > MAX_POD_HOSTS:
            raise MembershipError(
                f"elastic frame masks cap the pod at {MAX_POD_HOSTS} "
                f"hosts ({self.n_hosts} configured)")
        self.membership = membership if membership is not None else \
            MembershipEpoch(self.n_hosts, driver.global_I,
                            rejoin_holddown_ticks=rejoin_holddown_ticks)
        if (self.membership.view.n_hosts != self.n_hosts
                or self.membership.view.n_instances != driver.global_I):
            raise MembershipError(
                f"membership plane ({self.membership.view.n_hosts} hosts "
                f"x {self.membership.view.n_instances} instances) does "
                f"not match the pod ({self.n_hosts} x {driver.global_I})")
        # dead-peer verdicts degrade to leave intents from here on, and
        # resumed evidence latches the join
        self.monitor.attach_membership(self.membership)
        self.max_slots = int(max_slots)
        self.reroute_capacity = (
            int(reroute_capacity) if reroute_capacity is not None
            else 4 * self.plan.local_instances * driver.V * REC_SIZE)
        self.frame_bytes = elastic_frame_capacity(
            self.max_slots, self._frame_cap, self.reroute_capacity)
        self._held: List[np.ndarray] = []
        self._clock = clock
        self.negotiation_ticks = 0
        self.padded_slots = 0          # slots this host padded up or into
        self.adopted_held = 0          # records held for away homes
        self.held_dropped = 0          # capacity overflow (degrades)
        self.reroute_sent = 0
        self.reroute_received = 0
        self.reroute_reheld = 0        # stray re-routes held again
        self.boundaries = 0            # applied repartitions
        self._mirror_membership()

    # -- intents -------------------------------------------------------------

    def announce_leave(self, host: Optional[int] = None) -> bool:
        """Latch a leave intent (default this host: a planned drain).
        Broadcast on the next tick, applied at the next boundary."""
        return self.membership.note_leave(
            self.host if host is None else host)

    def announce_join(self, host: Optional[int] = None) -> bool:
        """Latch a rejoin intent (default this host)."""
        return self.membership.note_join(
            self.host if host is None else host)

    @property
    def serving(self) -> bool:
        """Does the current epoch assign this host any instances?"""
        return self.membership.view.owned_range(self.host) is not None

    @property
    def held_pending(self) -> int:
        """Records held for re-routing now."""
        return sum(len(b) for b in self._held)

    # -- ingress: the membership-aware front door ----------------------------

    def _alive_lut(self, view) -> np.ndarray:
        """[n_hosts] bool: is host h alive under `view`?"""
        lut = np.zeros(self.n_hosts, bool)
        lut[list(view.alive)] = True
        return lut

    def _home_of(self, inst: np.ndarray) -> np.ndarray:
        """The static home host of each global instance id (HostPlan.
        owner_of, vectorized), clipped so an out-of-range id indexes
        safely (such a record never passes the owned-range screen)."""
        return np.minimum(inst // self.plan.local_instances,
                          self.n_hosts - 1)

    def submit(self, wire_bytes):
        """The HostShard screen, elastically: records in this host's
        static block feed the local service; records this host owns this
        epoch whose static home is departed are held for re-routing
        instead of rejected; the rest are foreign as before.  A record in
        the owned range whose home is another live host is foreign, not
        held: its home's front door serves it, and holding it here would
        replay it twice."""
        buf = np.frombuffer(bytes(wire_bytes), np.uint8)
        n = len(buf) // REC_SIZE
        tail = buf[n * REC_SIZE:]
        if not n:
            return self.service.submit(tail.tobytes())
        rec = buf[:n * REC_SIZE].reshape(n, REC_SIZE)
        inst = wire_instance_ids(rec)
        mine = (inst >= self.lo) & (inst < self.hi)
        owned = self.membership.view.owned_range(self.host)
        adopt = np.zeros(n, bool)
        if owned is not None:
            vlo, vhi = owned
            home_away = ~self._alive_lut(
                self.membership.view)[self._home_of(inst)]
            adopt = (inst >= vlo) & (inst < vhi) & ~mine & home_away
        if adopt.any():
            self._hold(rec[adopt])
        foreign = int(n - mine.sum() - adopt.sum())
        self.foreign_rejects += foreign
        if foreign:
            self.service.metrics.count(POD_FOREIGN_REJECTS, foreign)
        kept = rec[mine]                     # fancy index: a new copy
        shift_instances_inplace(kept, -self.lo)
        return self.service.submit(kept.tobytes() + tail.tobytes())

    def _hold(self, rows: np.ndarray) -> None:
        free = (self.reroute_capacity // REC_SIZE - self.held_pending
                if self.reroute_capacity else 0)
        take = max(0, min(len(rows), free))
        if take:
            self._held.append(np.array(rows[:take], np.uint8))
        self.adopted_held += take
        dropped = len(rows) - take
        if dropped:
            self.held_dropped += dropped
            if self.service.flightrec is not None:
                self.service.flightrec.event(
                    "membership_hold_overflow", host=self.host,
                    dropped=dropped, epoch=self.membership.view.epoch)

    # -- the negotiation tick ------------------------------------------------

    def _slot_of(self, st) -> TickSlot:
        """The negotiated shape of one staged build."""
        n_phases = len(st.phases) + (1 if st.entry else 0)
        if st.lanes is None:
            return TickSlot(KIND_UNSIGNED, n_phases)
        if self.pipeline.dense:
            return TickSlot(KIND_DENSE_SIGNED, n_phases)
        return TickSlot(KIND_SIGNED, n_phases,
                        rung=int(st.lanes.pub.shape[0]))

    def _take_reroute(self, view) -> bytes:
        """Pop the held records whose static home is alive under `view`:
        the bytes the next frame re-routes, so that the home's own front
        door (the one peer whose `_ingest_reroute` takes them) replays
        them.  At most the capacity a tick, in arrival order; the rest go
        on later ticks.  Records whose home is still away stay held here,
        across any repartition and across this holder's own departure (a
        sleeping process keeps ticking): sending them to the epoch owner
        instead would hand them to a host whose static screen drops
        them."""
        if not self._held:
            return b""
        rec = np.concatenate(self._held)
        home = self._home_of(wire_instance_ids(rec))
        send = self._alive_lut(view)[home]
        cap = self.reroute_capacity // REC_SIZE
        over = np.nonzero(send)[0][cap:]
        send[over] = False
        self._held = [rec[~send]] if (~send).any() else []
        out = rec[send]
        self.reroute_sent += len(out)
        return out.tobytes()

    def _ingest_reroute(self, raw: bytes) -> None:
        """Take in re-routed records addressed to this host's static
        block (the readmitted owner's catch-up): global-id wire bytes,
        screened and rebased like any gossip, but fed to the local
        service directly, so they are never counted foreign.  The reroute
        section rides the gathered frame, so every host sees every
        sender's bytes: records of other static blocks are theirs and
        ignored here, except a record whose home is still departed (a
        sender's fault: honest re-routes target live homes only), which
        the current epoch owner holds again, counted and logged, rather
        than let it fall out of the protocol."""
        n = len(raw) // REC_SIZE
        if not n:
            return
        rec = np.frombuffer(raw, np.uint8)[:n * REC_SIZE].reshape(
            n, REC_SIZE)
        inst = wire_instance_ids(rec)
        mine = (inst >= self.lo) & (inst < self.hi)
        if mine.any():
            kept = rec[mine]
            shift_instances_inplace(kept, -self.lo)
            self.reroute_received += int(mine.sum())
            self.service.submit(kept.tobytes())
        if mine.all():
            return
        view = self.membership.view
        owned = view.owned_range(self.host)
        if owned is None:
            return
        stray = (~mine & (inst >= owned[0]) & (inst < owned[1])
                 & ~self._alive_lut(view)[self._home_of(inst)])
        if stray.any():
            self.reroute_reheld += int(stray.sum())
            self._hold(rec[stray])
            if self.service.flightrec is not None:
                self.service.flightrec.event(
                    "membership_reroute_rehold", host=self.host,
                    records=int(stray.sum()), epoch=view.epoch)

    def tick(self, now: Optional[float] = None,
             boundary: bool = False) -> dict:
        """One lockstep elastic tick (module docstring): close and stage,
        negotiate shapes, decisions, intents and re-routes in one
        all_gather, pad to the merged plan, dispatch.  With
        `boundary=True` (callers pass it at height edges) the latched
        intents apply after the exchange.  Every pod process calls it at
        the same protocol points, serving or sleeping: a sleeper stages
        nothing and dispatches pure padding, which keeps the pod's
        collectives in lockstep while its ranges are away.  `now` is the
        tick's start on the shard's clock (read from it when omitted);
        the tick's `negotiation_wall_s` runs from it."""
        t0 = self._clock() if now is None else now
        # the lockstep logical clock first: intents latched anywhere in
        # this tick (monitor verdicts, merged peer masks) stamp against
        # the same pod-identical counter
        self.membership.note_tick()
        self.monitor.check()           # degrades to leave intents
        # 1. close the micro-batch and stage builds, no dispatch yet
        batch = self.service.micro.flush()
        if batch is not None or self.service.batcher.pending_votes:
            self.pipeline.stage(batch)
        staged = self.pipeline._staged
        slots = tuple(self._slot_of(st) for st in staged)
        # 2. decisions + intents + (at a boundary) the prospective reroute
        dec_frame = self._local_decision_frame()
        prospective = (self.membership.prospective() if boundary
                       else None)
        reroute = self._take_reroute(
            prospective if prospective is not None
            else self.membership.view)
        leave_mask, join_mask = self.membership.pending()
        view = self.membership.view
        frame = pack_elastic_frame(
            self.host, view.epoch, view.alive_mask(),
            leave_mask, join_mask, slots, dec_frame, reroute,
            max_slots=self.max_slots, reroute_cap=self.reroute_capacity)
        # 3. one all_gather: shapes + decisions + intents + re-routes;
        #    a host's ranks must have packed the same frame
        rows = self._host_rows(self.coordinator.negotiate(frame),
                               "elastic")
        frames = [unpack_elastic_frame(
            row, self.max_slots, self._frame_cap, self.reroute_capacity)
            for row in rows]
        # 4. statics stay loud: every host in the same epoch, looking at
        #    the same membership; anything else is a protocol fault
        for f in frames:
            if (f.epoch, f.alive_mask) != (view.epoch, view.alive_mask()):
                raise MembershipError(
                    f"membership diverged: host {f.host} is at epoch "
                    f"{f.epoch}/alive={f.alive_mask:#x}, host "
                    f"{self.host} at {view.epoch}/"
                    f"{view.alive_mask():#x}")
        # 5. merge, prove the plan warmed, pad, dispatch
        merged = merge_tick_plans([f.slots for f in frames])
        for slot in merged:
            if not self.pipeline.warmup_covers(
                    KIND_NAMES.get(slot.kind, "?"), slot.n_phases,
                    slot.rung):
                raise MembershipError(
                    f"negotiated slot {slot} is outside the warmed "
                    f"shape set {sorted(self.pipeline.warmed_keys)}: "
                    f"padding must never make a new shape")
        padded = 0
        for k, slot in enumerate(merged):
            if k < len(staged):
                padded += 1 if self.pipeline.pad_staged_to(
                    staged[k], slot.n_phases) else 0
            else:
                self.pipeline.stage_padding(
                    slot.n_phases, signed=slot.kind != KIND_UNSIGNED)
                padded += 1
        self.padded_slots += padded
        dispatched = self.pipeline.dispatch_staged()
        # 6. the pod-wide decision view
        for f in frames:
            self.pod_decisions.extend(f.decisions)
        # 7. fold peer intents in, apply the boundary, then take in the
        #    re-routes (in this order: a readmitted owner's ranges are
        #    live again before its catch-up bytes reach the service)
        for f in frames:
            if f.host != self.host:
                self.membership.merge_intents(f.leave_mask, f.join_mask)
        rep: Optional[Repartition] = None
        if boundary:
            rep = self.membership.boundary()
            if rep is not None:
                self.boundaries += 1
                self._on_boundary(rep)
        for f in frames:
            if f.host != self.host and f.reroute:
                self._ingest_reroute(f.reroute)
        self.negotiation_ticks += 1
        wall = self._clock() - t0
        self.service.metrics.observe(POD_NEGOTIATION_WALL_S, wall)
        return {"dispatched": dispatched, "slots": len(merged),
                "padded": padded, "epoch": self.membership.view.epoch,
                "boundary": rep is not None,
                "negotiation_wall_s": wall}

    def _on_boundary(self, rep: Repartition) -> None:
        """An applied repartition's bookkeeping: the flight recorder's
        events, the epoch gauge, the readmission counter."""
        fr = self.service.flightrec
        if fr is not None:
            fr.event("membership_boundary", epoch=rep.new.epoch,
                     alive=list(rep.new.alive),
                     joined=list(rep.joined), left=list(rep.left))
            for src, dst, lo, hi in rep.transfers:
                fr.event("membership_relift", src=src, dst=dst,
                         lo=lo, hi=hi, epoch=rep.new.epoch)
        self._mirror_membership()

    def _mirror_membership(self) -> None:
        m = self.service.metrics
        m.gauge(POD_MEMBERSHIP_EPOCH, self.membership.view.epoch)
        have = m.counters.get(POD_HOST_READMISSIONS, 0)
        want = self.membership.readmissions
        if want > have:
            m.count(POD_HOST_READMISSIONS, want - have)

    # -- ladder replan -------------------------------------------------------

    def replan_ladder(self, **plan_kwargs):
        """Re-plan the shape ladder for the current membership: a
        shrunken pod's surviving owner serves a bigger slice, so the
        memory check and the top rung re-derive from the live count
        (ShapeLadder.plan_dense(n_live=) over the driver's
        `_local_shape(n_live=)`).  Installs and returns the new ladder;
        in dense mode rungs only pace micro-batches (the dispatch shape
        is (P, I, V)), so the warmed shape set is untouched."""
        from agnes_tpu_torch.serve.batcher import ShapeLadder

        live = len(self.membership.view.alive)
        d = self.driver
        lad = ShapeLadder.plan_dense(
            d.global_I, d.V, local_shape=d._local_shape(n_live=live),
            n_hosts=self.n_hosts, n_live=live, **plan_kwargs)
        old = self.pipeline.ladder
        if old.bls_rungs or old.bls_class_rungs:
            lad = ShapeLadder(rungs=lad.rungs, bls_rungs=old.bls_rungs,
                              bls_class_rungs=old.bls_class_rungs)
        self.pipeline.ladder = lad
        return lad

    # -- drain ---------------------------------------------------------------

    def drain(self, gather: bool = True) -> dict:
        """HostShard.drain + the elastic section of the pod report."""
        rep = super().drain(gather=gather)
        rep["pod"]["elastic"] = {
            "epoch": self.membership.view.epoch,
            "alive": list(self.membership.view.alive),
            "negotiation_ticks": self.negotiation_ticks,
            "negotiations": self.coordinator.negotiations,
            "padded_slots": self.padded_slots,
            "pad_builds": self.pipeline.pad_builds,
            "padded_phases": self.pipeline.padded_phases,
            "boundaries": self.boundaries,
            "readmissions": self.membership.readmissions,
            "monitor_readmissions": self.monitor.readmissions,
            "departures": self.membership.departures,
            "adopted_held": self.adopted_held,
            "held_dropped": self.held_dropped,
            "held_pending": self.held_pending,
            "reroute_sent": self.reroute_sent,
            "reroute_received": self.reroute_received,
            "reroute_reheld": self.reroute_reheld,
        }
        return rep
