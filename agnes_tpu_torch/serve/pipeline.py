"""Double-buffered densify/dispatch loop of the serve plane (twin of
`agnes_tpu.serve.pipeline`).

While the card runs the fused signed step of batch k
(DeviceDriver.step_async: deferred collection, nothing read back), the
host densifies batch k+1 (VoteBatcher.add_arrays -> build_phases_device,
the offline densify stages reused as they are, so streamed and offline
builds cannot diverge).  One staged slot — a FIFO when a tick stages
several capped builds — is the whole buffer discipline:

    pump(batch):
      1. DISPATCH the staged (already densified) batch     [card]
      2. DENSIFY `batch` into the staged slot              [host]

Step 2's host work overlaps step 1's device work as far as step 1's
launch returns before the card has run it.  The signed step is hundreds
of torch launches, and on an H100 at 1,024 x 1,000 the card keeps pace
with them, so the launch ends with the step and the densify finds an
idle card (PERF.md §6): the double buffer is in place, and the
overlap waits for a launch that returns at once (a captured graph of
each warmed shape).  Both steps use the current stream: the next
height's lanes and phases upload through pinned memory with
non-blocking copies queued behind the step in flight.

Window discipline: densify needs the batcher synced to the card's
(base_round, heights), and reading those back waits for the step in
flight.  Honest-path serving passes `window_predictor` (round 0, height
h) and keeps the loop free of reads; without one the pipeline reads the
window per stage, correct and serializing.

Entry phases: the offline per-height loop prepends one empty entry phase
(round entry + self-proposal) per height; the pipeline does the same
whenever the window heights advance past the last entry it dispatched
(and on every signed build), so honest streamed traffic reproduces the
offline step sequence exactly.  The entry phase is built from host
heights by a pinned non-blocking upload, never by a synchronizing copy.

Degenerate ticks (zero votes, all held, all stale) densify to nothing
and skip the dispatch: a counted no-op.

Signed builds keep their exact lane count, capped at the ladder's top
rung; the retrace tripwire keys each on the smallest rung that holds it
(analysis/retrace.py), so no padding lane does verify work.

Native adoption: behind a native admission queue
(serve/native_admission.py) the drain can already have densified a batch
into the signed step's phase planes and lane arrays, against the window
and slot table `native_phase_state` predicts.  `stage` adopts such a
build (VoteBatcher.adopt_native_phases: no add_arrays, no
build_phases_device) when the window and slot table it assumed are the
ones just synced and nothing else is pending; otherwise it builds the
plain columns the Python way.  `native_phase_builds` counts adoptions.

Dense dispatch mode (`dense=True`; the default when the driver has a
mesh, as in the twin): builds go through `build_phases_device_dense`
and dispatch the dense fused signed step, whose shape (P, I, V) is the
deployment's, so the ladder (ShapeLadder.plan_dense) only paces the
votes a micro-batch carries and warmup launches one shape per P.  The
native adopt branch is off in dense mode (its drain fills packed lanes).
Dense serving runs on one card (a driver on a one-rank mesh, or
`dense=True` over a plain driver) or on a pod host's mesh of several
ranks (distributed/): every rank runs its own pipeline over the same
host-local traffic and dispatches its block.  A driver whose mesh has
several ranks must carry a coordinator (`driver.coordinator`,
distributed/pod.py), whose agree() runs before every dispatch; without
one it is refused (NotImplementedError).

Elastic padding (distributed/elastic.py): the elastic pod negotiates
each tick's build shapes and pads every host up to the per-slot max, so
that the dispatch agree() sees one plan under honest heterogeneity.
`pad_staged_to` appends empty phases (and, on a dense signed build,
all-zero cells) to a staged build; `stage_padding` stages a build of
padding alone.  Both land only on shapes warmup launched
(`warmup_covers`), an empty phase is a state-machine no-op, and the
dense step masks padding cells out of its rejected count, so padding
changes neither the state nor the warmed shape set.  Neither waits for
the card.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from agnes_tpu_torch.device.encoding import I32, stack_tuples
from agnes_tpu_torch.device.step import (
    DenseSignedPhases,
    SignedLanes,
    VotePhase,
)
from agnes_tpu_torch.serve.batcher import ShapeLadder
from agnes_tpu_torch.serve.queue import PhaseBuildState
from agnes_tpu_torch.types import NIL_ID


@dataclass
class _StagedBatch:
    """A densified batch waiting for its dispatch."""

    phases: list               # [VotePhase]
    lanes: object              # SignedLanes | DenseSignedPhases | None
    entry: bool                # entry phase prepended?
    entry_heights: Optional[np.ndarray]
    n_votes: int
    t_first: float             # earliest admission instant
    # dedup-cache insertion candidates of a signed build: (digest
    # [N,32], instance [N], height [N]) of its real lanes, inserted at
    # settle iff the dispatch rejected zero lanes
    cache_keys: Optional[tuple] = None
    preverified: bool = False  # unsigned build of dedup-cache hits
    tick: int = 0              # monotonic lifecycle id


@dataclass
class _Inflight:
    t_first: float
    n_votes: int
    t_dispatch: float
    cache_keys: Optional[tuple] = None
    rejects: object = None     # deferred device rejected-lane count
    tick: int = 0


class ServePipeline:
    """Densify + dispatch with one staged slot (module docstring).

    Builds are capped at the ladder's top rung, and held-vote re-entry
    builds apart from the fresh batch, so every build fits under a
    warmed rung (`offladder_builds` stays 0: a regression alarm).  A
    tick can stage several builds; `dispatch_staged` queues them back
    to back."""

    def __init__(self, driver, batcher, pubkeys: Optional[np.ndarray],
                 ladder: ShapeLadder,
                 window_predictor: Optional[Callable] = None,
                 dense: Optional[bool] = None,
                 cache=None,
                 bls_lane=None,
                 tracer=None,
                 metrics=None,
                 flightrec=None,
                 clock=time.monotonic):
        """`cache` (serve/cache.VerifiedCache, shared with the
        AdmissionQueue) enables the split-rung dispatch: each tick's
        pending votes partition into a fresh stream (built signed) and a
        pre-verified stream of cache hits (built unsigned, dispatched on
        the verify-free sequence step); settle() inserts a signed
        dispatch's digests iff its verify rejected zero lanes.
        `bls_lane` (serve/bls_lane.BlsLane): closed classes are
        aggregated, pairing-checked and fed down the same unsigned
        path.  `dense` selects the dense dispatch mode (module
        docstring); None picks it when the driver has a mesh.  A driver
        on a mesh of several ranks without a coordinator raises
        NotImplementedError."""
        mesh = getattr(driver, "mesh", None)
        if (mesh is not None and mesh.mesh.numel() > 1
                and getattr(driver, "coordinator", None) is None):
            raise NotImplementedError(
                f"serving over a mesh of {mesh.mesh.numel()} ranks needs "
                f"a coordinator on the driver, which agrees every "
                f"dispatch across the ranks before it runs: serve "
                f"through the pod (ROADMAP §1 item 6: distributed."
                f"DistributedDriver under a distributed.HostShard), or "
                f"dense on one card (a one-rank mesh, or dense=True)")
        self.dense = dense if dense is not None else mesh is not None
        self.driver = driver
        self.batcher = batcher
        self.pubkeys = pubkeys          # None = unsigned deployment
        self.ladder = ladder
        self.window_predictor = window_predictor
        self.cache = cache
        self.bls_lane = bls_lane
        self.tracer = tracer
        self.flightrec = flightrec
        if getattr(driver, "sentinel", None) is not None:
            # the tripwire keys a signed dispatch on its ladder rung
            driver.sentinel.rungs = tuple(ladder.rungs)
        # a monotonic tick id per staged build, threaded through
        # dispatch and settle: the tracer's flow events and the flight
        # recorder's tick_open / tick_close name one lifecycle
        self.tick_seq = 0
        if metrics is not None:
            from agnes_tpu_torch.utils.metrics import (
                SERVE_DISPATCH_WALL_S,
                SERVE_SETTLE_WALL_S,
            )
            self._h_dispatch = metrics.histogram(SERVE_DISPATCH_WALL_S)
            self._h_settle = metrics.histogram(SERVE_SETTLE_WALL_S)
        else:
            self._h_dispatch = self._h_settle = None
        self._clock = clock
        self._staged: List[_StagedBatch] = []
        self._inflight: List[_Inflight] = []
        self._entry_h: Optional[np.ndarray] = None
        # slot -> value decode captured at each instance's first height
        # advance: sync_device resets an advanced instance's slot map
        # and the double buffer stages h+1 before h's decisions are
        # collected, so the first (latched) decision decodes against the
        # table of its own height (service.poll_decisions reads this)
        self.first_advance_decode: dict = {}
        # ... and the height the instance was on before that advance
        self.first_advance_height: dict = {}
        self.dispatched_batches = 0
        self.dispatched_votes = 0
        self.noop_ticks = 0
        self.host_fallback_builds = 0
        # builds / votes on the verify-free unsigned step because every
        # record was a cache hit (dispatched_* count both streams)
        self.preverified_builds = 0
        self.preverified_votes = 0
        # votes that entered through a cleared BLS class or its
        # per-share fallback (a subset of preverified_votes)
        self.bls_votes = 0
        # signed builds above the ladder's top rung: prevented by the
        # max_votes cap, kept as the regression alarm
        self.offladder_builds = 0
        # builds adopted straight from a native phase drain (no
        # add_arrays, no build_phases_device), and the pubkey table
        # handed to the drains (one host copy, not one a drain)
        self.native_phase_builds = 0
        self._pk_np: Optional[np.ndarray] = None
        # every (kind, P[, rung]) warmup() launched
        self.warmed_keys: set = set()
        self.padded_phases = 0         # empty phases appended by pads
        self.pad_builds = 0            # builds of padding alone staged

    def _span(self, name: str):
        return (self.tracer.span(name) if self.tracer is not None
                else contextlib.nullcontext())

    def _event(self, kind: str, **fields) -> None:
        if self.flightrec is not None:
            self.flightrec.event(kind, **fields)

    def _next_tick(self) -> int:
        self.tick_seq += 1
        return self.tick_seq

    # -- window --------------------------------------------------------------

    def _sync_window(self) -> np.ndarray:
        """Adopt the target (base_round, heights) into the batcher;
        returns the heights.  Predictor mode reads nothing from the
        card; without a predictor the window is read back (a sync)."""
        if self.window_predictor is not None:
            base, hts = self.window_predictor()
            base = np.asarray(base, np.int64)  # lint: allow (host predictor output)
            hts = np.asarray(hts, np.int64)  # lint: allow (host predictor output)
        else:
            base, hts = self.driver.window()
        for i in np.nonzero(hts > self.batcher.heights)[0]:
            if int(i) not in self.first_advance_decode:
                self.first_advance_decode[int(i)] = {
                    s: self.batcher.decode_slot(int(i), s)
                    for s in range(self.batcher.slots.n_slots)}
                self.first_advance_height[int(i)] = \
                    int(self.batcher.heights[i])
        self.batcher.sync_device(base, hts)
        return hts

    def native_phase_state(self) -> Optional[PhaseBuildState]:
        """The PhaseBuildState a native phase drain densifies against,
        or None where this deployment cannot adopt one: no window
        predictor (the drain runs before _sync_window, so only a
        predicted window avoids reading the card), unsigned, dense
        dispatch mode (the drain fills packed lanes), or MSM verify
        mode.  The service wires this as the native queue's
        `phase_state` hook; it runs once a drain, on the drain's thread.

        The slot table is the batcher's as the predicted window will
        hold it: rows of instances whose height advances are empty,
        since the sync resets them.  stage() adopts only if the window
        and that table are what the sync produced; correctness never
        rests on the prediction, only the fast path does."""
        if (self.window_predictor is None or self.pubkeys is None
                or self.dense or self.batcher.verify_mode != "lanes"):
            return None
        base, hts = self.window_predictor()
        hts = np.asarray(hts, np.int64)
        if self._pk_np is None:
            self._pk_np = np.ascontiguousarray(
                np.asarray(self.pubkeys), np.uint8)
        lut = self.batcher.slots.dense.copy()
        lut[hts > self.batcher.heights] = -1
        return PhaseBuildState(
            heights=hts,
            base_round=np.asarray(base, np.int64),
            window=self.batcher.W,
            slot_lut=lut,
            pubkeys=self._pk_np,
            n_validators=self.batcher.V,
            lane_floor=0,                 # exact lanes (module docstring)
            max_votes=self.ladder.max_rung,
            phase_offset=1,
            pin_memory=self.driver.device.type == "cuda")

    def _entry_phase(self, heights: np.ndarray) -> VotePhase:
        """The round-entry phase from host heights: constants made on
        the card and the heights by a pinned non-blocking upload, so
        building it never waits for the card."""
        I, V = self.driver.I, self.driver.V
        dev = self.driver.device
        return VotePhase(
            round=torch.zeros((I,), dtype=I32, device=dev),
            typ=torch.zeros((I,), dtype=I32, device=dev),
            slots=torch.full((I, V), NIL_ID, dtype=I32, device=dev),
            mask=torch.zeros((I, V), dtype=torch.bool, device=dev),
            height=self.batcher._to_device(
                np.asarray(heights).astype(np.int32)))  # lint: allow (host heights: numpy)

    # -- stages --------------------------------------------------------------

    def stage(self, batch, sync: bool = True) -> bool:
        """Densify into the staged FIFO (host work that overlaps the
        step in flight).  Returns True when something was staged; a tick
        whose traffic densifies to nothing is a counted no-op.  With
        batch None, whatever the batcher holds pending is built (the
        drain path's held-vote re-entry; `sync=False` when the caller
        just synced).

        Held votes that re-entered on this tick's sync build before the
        fresh batch is added, and every build is capped at the top rung,
        so no build exceeds a warmed shape."""
        n_new = len(batch) if batch is not None else 0
        if n_new == 0 and self.batcher.pending_votes == 0:
            return False
        with self._span("serve.densify"):
            hts = (self._sync_window() if sync
                   else self.batcher.heights.copy())
            staged_any = False
            if self.batcher.pending_votes:
                staged_any |= self._build_all(hts, self._clock())
            if n_new:
                ph = batch.native_phases
                bat = self.batcher
                if (ph is not None and bat.pending_votes == 0
                        and self.pubkeys is not None and not self.dense
                        and bat.verify_mode == "lanes"
                        and np.array_equal(ph.heights, bat.heights)
                        and np.array_equal(ph.base_round, bat.base_round)
                        and np.array_equal(ph.slot_lut, bat.slots.dense)):
                    # the drain densified this batch against the window
                    # and slot table just synced: adopt it.  Anything
                    # else (a rotation between drain and stage, held
                    # re-entry that interned a value, a mode flip)
                    # builds the plain columns, which are always filled
                    phases, lanes = bat.adopt_native_phases(
                        batch, ph, self.pubkeys)
                    keys = (bat.last_build_keys
                            if self.cache is not None else None)
                    self.native_phase_builds += 1
                    staged_any |= self._stage_signed(
                        phases, lanes, hts, batch.t_first, keys,
                        native=True)
                else:
                    bat.add_arrays(batch.instance, batch.validator,
                                   batch.height, batch.round_, batch.typ,
                                   batch.value, batch.signatures,
                                   verified=batch.verified,
                                   digest=batch.digest)
                    staged_any |= self._build_all(hts, batch.t_first)
        if not staged_any:
            self.noop_ticks += 1
        return staged_any

    def _build_all(self, hts: np.ndarray, t_first: float) -> bool:
        """Drain everything pending into staged builds of at most
        `ladder.max_rung` votes each.  On a deployment with a cache or a
        BLS lane the pending queue first splits by the verified flag:
        fresh rows build signed, pre-verified rows build unsigned
        afterwards."""
        staged = False
        # gate on the cache or the BLS lane: without either no admission
        # path sets the verified column, and a stray verified row fed
        # straight to the batcher must not ride an unsigned build
        pre = (self.batcher.split_pending_verified()
               if (self.cache is not None
                   or self.bls_lane is not None) else [])
        while self.batcher.pending_votes > 0:
            before = self.batcher.pending_votes
            staged |= self._build_one(hts, t_first)
            if self.batcher.pending_votes >= before:  # defensive: a
                break          # non-draining build must not spin
        if pre:
            # fail closed: if the fresh loop left unverified rows
            # pending, building "pre-verified" from the queue would drain
            # them unsigned — re-park the verified rows instead and build
            # only when the queue holds nothing but them
            leftover = self.batcher.pending_votes
            self.batcher.adopt_pending(pre)
            while leftover == 0 and self.batcher.pending_votes > 0:
                before = self.batcher.pending_votes
                staged |= self._build_one(hts, t_first,
                                          preverified=True)
                if self.batcher.pending_votes >= before:
                    break
        return staged

    def _build_one(self, hts: np.ndarray, t_first: float,
                   preverified: bool = False) -> bool:
        """One capped build -> staged FIFO entry (False = densified to
        nothing)."""
        cap = self.ladder.max_rung
        keys = None
        if preverified:
            return self._stage_preverified(hts, t_first, cap)
        if self.pubkeys is not None:
            if self.dense:
                phases, lanes = self.batcher.build_phases_device_dense(
                    self.pubkeys, max_votes=cap)
            else:
                phases, lanes = self.batcher.build_phases_device(
                    self.pubkeys, phase_offset=1, max_votes=cap)
            if self.cache is not None and lanes is not None:
                keys = self.batcher.last_build_keys
        else:
            phases, lanes = self.batcher.build_phases(max_votes=cap), None
        if self.pubkeys is not None and lanes is None and phases:
            # ineligible traffic (equivocation layers, mixed rounds, MSM
            # mode): the batcher verified on the host instead
            self.host_fallback_builds += 1
        return self._stage_signed(phases, lanes, hts, t_first, keys)

    def _stage_signed(self, phases, lanes, hts: np.ndarray,
                      t_first: float, keys, native: bool = False) -> bool:
        """The staging tail of _build_one and stage()'s native adopt
        branch: off-ladder alarm, tick lifecycle, entry policy,
        staged-FIFO append.  `phases` is [(VotePhase, n_votes)]; lanes
        may be None (host-verified/unsigned)."""
        n_lanes = int(lanes.pub.shape[0]) if lanes is not None else None
        if n_lanes is not None and n_lanes > self.ladder.max_rung:
            self.offladder_builds += 1
        if not phases:
            return False
        tick = self._next_tick()
        rung = (self.ladder.rung_for(n_lanes)
                if n_lanes is not None and n_lanes <= self.ladder.max_rung
                else n_lanes)
        extra = {"native": True} if native else {}
        self._event("tick_open", tick=tick,
                    votes=sum(n for _, n in phases), rung=rung,
                    lanes=n_lanes, signed=lanes is not None, **extra)
        # signed builds always prepend the entry phase (their lanes were
        # packed with phase_offset=1); unsigned builds when the window
        # heights advanced past the last entry (or on the first
        # dispatch).  An extra empty step mid-round changes nothing.
        entry = (lanes is not None or self._entry_h is None
                 or bool((hts > self._entry_h).any()))
        if entry:
            self._entry_h = hts.copy()
        n_votes = sum(n for _, n in phases)
        self._staged.append(_StagedBatch(
            phases=[p for p, _ in phases], lanes=lanes, entry=entry,
            entry_heights=hts if entry else None,
            n_votes=n_votes, t_first=t_first, cache_keys=keys,
            tick=tick))
        return True

    def _stage_preverified(self, hts: np.ndarray, t_first: float,
                           cap: int) -> bool:
        """Stage the pending pre-verified rows as unsigned builds of at
        most two vote phases each (entry prepended on every chunk), so
        a cache-hit burst over several rounds or layers never dispatches
        a phase count outside the warmed {2, 3}.  Splitting a phase list
        across dispatches is P sequential steps either way."""
        groups = self.batcher.build_phases(max_votes=cap)
        if not groups:
            return False
        for k in range(0, len(groups), 2):
            chunk = groups[k:k + 2]
            n_votes = sum(n for _, n in chunk)
            self._entry_h = hts.copy()
            tick = self._next_tick()
            self._event("tick_open", tick=tick, votes=n_votes,
                        rung=None, signed=False, preverified=True)
            self._staged.append(_StagedBatch(
                phases=[p for p, _ in chunk], lanes=None, entry=True,
                entry_heights=hts, n_votes=n_votes, t_first=t_first,
                preverified=True, tick=tick))
        return True

    # -- elastic padding -----------------------------------------------------

    def warmup_covers(self, kind: str, n_phases: int,
                      rung: int = 0) -> bool:
        """True iff warmup() launched exactly this build shape: (kind,
        total P with the entry[, lane rung]).  The elastic pod asks
        before it dispatches a padded plan: a merged plan outside the
        warmed set is a deployment error, never a new shape."""
        key = (("signed", int(n_phases), int(rung)) if kind == "signed"
               else (kind, int(n_phases)))
        return key in self.warmed_keys

    def pad_staged_to(self, st: _StagedBatch, n_phases: int) -> int:
        """Pad one staged build up to a step sequence of `n_phases`
        (entry included) by appending empty vote phases and, on a dense
        signed build, all-zero cells, so that the dense lanes' leading
        axis tracks the phase count.  Returns the phases appended (0 =
        already that long).  Dense and unsigned builds only: a packed
        lane build's shape carries its rung, not its P."""
        cur = len(st.phases) + (1 if st.entry else 0)
        extra = int(n_phases) - cur
        if extra <= 0:
            return 0
        if st.lanes is not None and not self.dense:
            raise ValueError(
                "phase padding is defined for dense and unsigned builds "
                "only (a packed-lane shape carries a rung, not a P)")
        hts = (st.entry_heights if st.entry_heights is not None
               else self.batcher.heights.copy())
        st.phases = list(st.phases) + [self._entry_phase(hts)] * extra
        if st.lanes is not None:
            lanes = st.lanes

            def grow(x):
                return torch.cat([x, torch.zeros(
                    (extra,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)])

            st.lanes = DenseSignedPhases(pub=lanes.pub, sig=grow(lanes.sig),
                                         blocks=grow(lanes.blocks))
        self.padded_phases += extra
        self._event("tick_pad", tick=st.tick, phases=extra,
                    n_phases=int(n_phases))
        return extra

    def stage_padding(self, n_phases: int, signed: bool = True) -> int:
        """Stage a build of padding alone: the entry, empty phases and,
        signed and dense, all-zero cells, the very shape warmup()
        launched for this P and a state-machine no-op on every instance.
        What a host dispatches for a negotiated slot it has no traffic
        for, so the pod's collectives stay in lockstep.  `n_phases` is
        the total P, entry included, and is kept exactly: padding to
        another P would hand agree() differing plans.  n_phases = 1
        stages the entry alone.  Returns the tick id."""
        if int(n_phases) < 1:
            raise ValueError(
                f"a padding build needs n_phases >= 1: {n_phases}")
        hts = self.batcher.heights.copy()
        Ps = int(n_phases) - 1
        phases = [self._entry_phase(hts)] * Ps
        lanes = None
        if Ps and signed and self.pubkeys is not None and self.dense:
            d = self.driver
            dev = d.device
            lanes = DenseSignedPhases(   # warmup's padding, dtype for dtype
                pub=torch.zeros((d.V, 32), dtype=I32, device=dev),
                sig=torch.zeros((Ps, d.I, d.V, 64), dtype=I32, device=dev),
                blocks=torch.zeros((Ps, d.I, d.V, 1, 32), dtype=I32,
                                   device=dev))
        tick = self._next_tick()
        self._event("tick_open", tick=tick, votes=0, rung=None,
                    signed=lanes is not None, padding=True)
        self._staged.append(_StagedBatch(
            phases=phases, lanes=lanes, entry=True, entry_heights=hts,
            n_votes=0, t_first=self._clock(), tick=tick))
        self.pad_builds += 1
        return tick

    # -- dispatch ------------------------------------------------------------

    def dispatch_staged(self) -> int:
        """Queue every staged build's fused step on the card (nothing
        read back; back to back).  Returns the votes dispatched.  If a
        dispatch raises, the failing build and every later one go back
        on the staged FIFO before the exception propagates, so a caller
        that retries loses no vote."""
        staged, self._staged = self._staged, []
        total = 0
        for k, st in enumerate(staged):
            try:
                t0 = self._clock()
                with self._span("serve.dispatch"):
                    if self.tracer is not None:
                        self.tracer.flow("tick", st.tick, "t")
                    phases = st.phases
                    if st.entry:
                        phases = [self._entry_phase(st.entry_heights)] \
                            + phases
                    self.driver.step_async(phases, st.lanes,
                                           tick=st.tick)
            except BaseException:
                self._staged = staged[k:] + self._staged
                raise
            if self._h_dispatch is not None:
                self._h_dispatch.record(self._clock() - t0)
            self._inflight.append(_Inflight(
                t_first=st.t_first, n_votes=st.n_votes,
                t_dispatch=self._clock(), cache_keys=st.cache_keys,
                rejects=getattr(self.driver, "last_step_rejects", None),
                tick=st.tick))
            self.dispatched_batches += 1
            self.dispatched_votes += st.n_votes
            if st.preverified:
                # counted at dispatch: a staged build can be requeued
                self.preverified_builds += 1
                self.preverified_votes += st.n_votes
            total += st.n_votes
        return total

    def stage_bls(self, classes) -> bool:
        """Aggregate and pairing-check the closed BLS classes
        (BlsLane.clear_classes), then feed every surviving row into the
        batcher as pre-verified votes and build them through the same
        unsigned path as cache hits.  Forged shares die inside the
        lane (counted there)."""
        if not classes or self.bls_lane is None:
            return False
        with self._span("serve.bls_clear"):
            rows = self.bls_lane.clear_classes(classes)
        if rows is None:
            self.noop_ticks += 1
            return False
        n = len(rows["instance"])
        with self._span("serve.densify"):
            hts = self._sync_window()
            self.batcher.add_class_votes(
                rows["instance"], rows["validator"], rows["height"],
                rows["round_"], rows["typ"], rows["value"])
            self.bls_votes += n
            staged = self._build_all(
                hts, rows["t_first"] if rows["t_first"] is not None
                else self._clock())
        if not staged:
            self.noop_ticks += 1
        return staged

    def pump(self, batch, bls_classes=None) -> Tuple[int, bool]:
        """One tick: dispatch what was staged, then densify `batch` (and
        any closed BLS classes) while the card runs.  Returns (votes
        dispatched, staged?)."""
        dispatched = self.dispatch_staged()
        staged = self.stage(batch)
        if bls_classes:
            staged |= self.stage_bls(bls_classes)
        return dispatched, staged

    # -- settle --------------------------------------------------------------

    def settle(self) -> List[_Inflight]:
        """Collect every queued message batch (the one sync point) and
        hand back the in-flight metadata for end-to-end latency.

        Dedup-cache insertion happens here, after collect(): a signed
        dispatch's digests become entries iff its verify rejected zero
        lanes; a dispatch with any rejected lane caches nothing, and one
        without a verdict is skipped (fail closed)."""
        t0 = self._clock()
        with self._span("serve.collect"):
            self.driver.collect()
        if self._h_settle is not None:
            self._h_settle.record(self._clock() - t0)
        done, self._inflight = self._inflight, []
        now = self._clock()
        for b in done:
            if self.tracer is not None:
                self.tracer.flow("tick", b.tick, "f")   # lifecycle end
            self._event("tick_close", tick=b.tick, votes=b.n_votes,
                        e2e_s=round(now - b.t_first, 6))
        if self.cache is not None:
            for b in done:
                if b.cache_keys is None:
                    continue
                if b.rejects is None:
                    self.cache.note_unverified_batch()
                    continue
                if int(b.rejects.sum()) == 0:
                    dig, inst, heights = b.cache_keys
                    self.cache.insert(dig, inst, heights)
                else:
                    self.cache.note_rejected_batch()
        return done

    # -- warmup --------------------------------------------------------------

    def warmup(self, n_phases=(2, 3), arm: bool = True) -> int:
        """Launch every step shape the steady state dispatches once, on
        all-padding inputs against `driver.state_copies()` (the live
        state is untouched): each signed (P, rung) — P = 2 (entry + one
        class, a deadline-closed batch) and P = 3 (entry + both) by
        default — and, with a cache or a BLS lane, the unsigned sequence
        per P; with a BLS lane every `bls_aggregate` rung and, when it
        pairs on the card, every pairing class rung.  Records
        `warmed_keys`.  In dense mode a signed shape is one a P (the
        dense step's shape is (P, I, V)): ("dense_signed", P), on
        all-zero dense lanes through the driver's own dense dispatch.
        With a retrace sentinel on the driver every launch is observed
        into the expected set, and `arm` closes it: a later dispatch at
        an unwarmed shape raises.  Returns the shapes warmed."""
        if self.pubkeys is None and self.bls_lane is None:
            return 0
        if isinstance(n_phases, int):
            n_phases = (n_phases,)
        d = self.driver
        dev = d.device
        zero_hts = np.zeros(d.I, np.int64)
        warmed = 0
        def copies():
            state, tally = d.state_copies()
            if getattr(d, "mesh", None) is None:
                return state, tally
            from agnes_tpu_torch.parallel import place_step_state

            return place_step_state(d.mesh, state, tally)

        for P in n_phases:
            phases_st = stack_tuples([self._entry_phase(zero_hts)] * P)
            exts_st = stack_tuples([d.ext()] * P)
            if self.pubkeys is not None and self.dense:
                Ps = max(P - 1, 1)           # the entry carries no lanes
                dense = DenseSignedPhases(
                    pub=torch.zeros((d.V, 32), dtype=I32, device=dev),
                    sig=torch.zeros((Ps, d.I, d.V, 64), dtype=I32,
                                    device=dev),
                    blocks=torch.zeros((Ps, d.I, d.V, 1, 32), dtype=I32,
                                       device=dev))
                d._dense_dispatch_fn(Ps)(*copies(), exts_st, phases_st,
                                         dense)
                self.warmed_keys.add(("dense_signed", P))
                warmed += 1
            elif self.pubkeys is not None:
                for r in self.ladder.rungs:
                    lanes = SignedLanes(
                        pub=torch.zeros((r, 32), dtype=I32, device=dev),
                        sig=torch.zeros((r, 64), dtype=I32, device=dev),
                        blocks=torch.zeros((r, 1, 32), dtype=I32,
                                           device=dev),
                        phase_idx=torch.full((r,), P, dtype=I32,
                                             device=dev),  # dropped
                        inst=torch.zeros((r,), dtype=I32, device=dev),
                        val=torch.zeros((r,), dtype=I32, device=dev),
                        real=torch.zeros((r,), dtype=torch.bool,
                                         device=dev))
                    d._signed(phases_st, exts_st, lanes, *d.state_copies())
                    self.warmed_keys.add(("signed", P, r))
                    warmed += 1
            if self.cache is not None or self.bls_lane is not None:
                # pre-verified builds (cache hits and cleared BLS rows)
                # ride the unsigned sequence: one shape per P
                d._unsigned(phases_st, exts_st, *copies())
                self.warmed_keys.add(("unsigned", P))
                warmed += 1
        if self.bls_lane is not None and self.ladder.bls_rungs:
            from agnes_tpu_torch.crypto import bls as BLS

            nw = self.bls_lane.registry.n_windows
            for r in self.ladder.bls_rungs:
                args = (torch.zeros((r, 2, BLS.NLIMBS), dtype=I32,
                                    device=dev),
                        torch.zeros((r, 4, BLS.NLIMBS), dtype=I32,
                                    device=dev),
                        torch.zeros((r, BLS.W_LIMBS), dtype=I32,
                                    device=dev))
                d._observe("bls_aggregate", args, statics=(nw,))
                BLS.bls_aggregate(*args, n_windows=nw)
                self.warmed_keys.add(("bls_aggregate", r))
                warmed += 1
        if (self.bls_lane is not None and self.ladder.bls_class_rungs
                and self.bls_lane.uses_device_pairing):
            from agnes_tpu_torch.crypto import bls as BLS
            from agnes_tpu_torch.crypto import bls_pairing as BP

            for r in self.ladder.bls_class_rungs:
                args = (torch.zeros((r, 2, 3, BLS.NLIMBS), dtype=I32,
                                    device=dev),
                        torch.zeros((r, 2, 3, 2, BLS.NLIMBS), dtype=I32,
                                    device=dev))
                d._observe("bls_pairing_product", args)
                BP.bls_pairing_product(*args)
                self.warmed_keys.add(("bls_pairing_product", r))
                warmed += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if arm and getattr(d, "sentinel", None) is not None:
            d.sentinel.arm()
        return warmed
