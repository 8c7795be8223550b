"""VoteService: the serve plane's façade (twin of
`agnes_tpu.serve.service`).

The one object a network front end talks to.  It wires admission
(queue.py), micro-batching (batcher.py), densify/dispatch (pipeline.py)
and decision collection into four calls:

    svc.submit(wire_bytes)   admit packed 96-byte wire records
    svc.pump()               advance the pipeline one tick (dispatch the
                             staged batch, densify the next); never reads
                             from the card
    svc.poll_decisions()     newly decided instances (collects the
                             deferred device messages — the sync point)
    svc.drain()              graceful shutdown: flush the queue and the
                             staged slot, re-enter held future-round
                             votes once, settle, return the final report

Every stage feeds a utils.metrics.Metrics registry (queue depth, batch
fill and in-flight gauges, admission counters, windowed rates, the
latency histograms) and, given a Tracer, per-stage spans; given a
FlightRecorder, ticks, rejects, dispatches, retrace trips and each
kernel's first nvcc build (the port's only compile) land in its ring.

`native_admission=True` swaps the admission queue for its C++ twin
(serve/native_admission.py; `native_shards=N` for N instance-range
shards), whose drain also densifies eligible batches straight into the
signed step's arrays for the pipeline to adopt.  Decisions are the same
either way; serve/threaded.py runs a service on socket-facing threads.

Runs on the card unless built over a CPU driver and batcher.  Over a
driver with a mesh the service plans the dense ladder
(`ShapeLadder.plan_dense` on the rank's block) and the pipeline takes
the dense dispatch mode, as in the twin; over a mesh of several ranks
the driver must carry the pod's coordinator (distributed/shard.py's
HostShard attaches it), or the pipeline refuses it.
"""

from __future__ import annotations

import time
import weakref
from typing import List, NamedTuple, Optional

import numpy as np

from agnes_tpu_torch.serve.batcher import MicroBatcher, ShapeLadder
from agnes_tpu_torch.serve.pipeline import ServePipeline
from agnes_tpu_torch.serve.queue import (
    REJECT_NEWEST,
    AdmissionQueue,
    AdmitResult,
)
from agnes_tpu_torch.utils.metrics import (
    COMPILE_MS_PREFIX,
    SERVE_ADMIT_RATE,
    SERVE_ADMIT_WAIT_S,
    SERVE_ADMITTED,
    SERVE_BATCH_CLOSE_AGE_S,
    SERVE_BATCH_FILL,
    SERVE_BATCHES,
    SERVE_BLS_AGG_CLASSES,
    SERVE_BLS_FALLBACK_VOTES,
    SERVE_BLS_POP_MISSING,
    SERVE_CACHE_BYTES,
    SERVE_CACHE_EVICTIONS,
    SERVE_CACHE_HIT_RATE,
    SERVE_CACHE_HITS,
    SERVE_CACHE_MISSES,
    SERVE_DECISIONS,
    SERVE_DISPATCH_RATE,
    SERVE_E2E_DECISION_S,
    SERVE_E2E_LATENCY_S,
    SERVE_EVICTED,
    SERVE_INFLIGHT,
    SERVE_NATIVE_DENSIFY_WALL_S,
    SERVE_NATIVE_DRAIN_WALL_S,
    SERVE_NATIVE_INBOX_DEPTH,
    SERVE_NATIVE_PHASE_BUILDS,
    SERVE_NATIVE_REJECTS_FAIRNESS,
    SERVE_NATIVE_REJECTS_MALFORMED,
    SERVE_NATIVE_REJECTS_OVERFLOW,
    SERVE_NATIVE_SHARD_DEPTH_PREFIX,
    SERVE_NATIVE_SHARD_REJECTS_PREFIX,
    SERVE_NOOP_TICKS,
    SERVE_PREVERIFIED_DISPATCHED,
    SERVE_QUEUE_DEPTH,
    SERVE_REJECTED_FAIRNESS,
    SERVE_REJECTED_MALFORMED,
    SERVE_REJECTED_OVERFLOW,
    SERVE_SUBMITTED,
    SERVE_VOTES_DISPATCHED,
    Metrics,
)

#: one process-wide build observer (cuda_build.on_build) forwarding each
#: kernel's first nvcc build to a WeakSet of flight recorders
_BUILD_RECORDERS: Optional[weakref.WeakSet] = None


def _notify_build(name: str, seconds: float) -> None:
    for rec in list(_BUILD_RECORDERS or ()):
        rec.event("compile", entry=name, ms=round(seconds * 1e3, 1))


def _watch_builds(flightrec) -> None:
    global _BUILD_RECORDERS
    if _BUILD_RECORDERS is None:
        from agnes_tpu_torch import cuda_build

        _BUILD_RECORDERS = weakref.WeakSet()
        cuda_build.on_build(_notify_build)
    _BUILD_RECORDERS.add(flightrec)


def _build_gauges() -> dict:
    """`compile_ms_<kernel>` for every kernel built in this process."""
    from agnes_tpu_torch import cuda_build

    return {COMPILE_MS_PREFIX + n: round(s * 1e3, 1)
            for n, s in cuda_build.build_seconds.items()}


class Decision(NamedTuple):
    """One newly latched instance decision, decoded for the consumer
    (slot -> value id through the batcher's slot map)."""

    instance: int
    value_slot: int
    value_id: Optional[int]
    round: int


class VoteService:
    """Assembles and drives the serve plane (module docstring)."""

    def __init__(self, driver, batcher,
                 pubkeys: Optional[np.ndarray] = None, *,
                 capacity: Optional[int] = None,
                 instance_cap: Optional[int] = None,
                 overload_policy: str = REJECT_NEWEST,
                 target_votes: Optional[int] = None,
                 max_delay_s: float = 0.005,
                 ladder: Optional[ShapeLadder] = None,
                 window_predictor=None,
                 dedup_cache=None,
                 bls_lane=None,
                 native_admission: bool = False,
                 native_shards: int = 1,
                 metrics: Optional[Metrics] = None,
                 tracer=None,
                 flightrec=None,
                 clock=time.monotonic):
        """`pubkeys` None is an unsigned deployment.  `dedup_cache`
        (serve/cache.VerifiedCache, or True for a default one) enables
        the verified-vote dedup layer and needs `pubkeys`.  `bls_lane`
        (serve/bls_lane.BlsLane) attaches the BLS aggregate lane, beside
        or without Ed25519 pubkeys.  The default ladder is
        `ShapeLadder.plan(I, V)`, or over a mesh driver
        `ShapeLadder.plan_dense` on the rank's block (the dense dispatch
        mode), at the driver's `hbm_budget_bytes` or the card's memory;
        a CPU service is given a ladder, or a driver with a budget.  `flightrec` (utils/flightrec.FlightRecorder) is
        also handed to the driver.

        `native_admission` swaps the admission queue for its C++ twin
        (serve/native_admission.NativeAdmissionQueue): one GIL-releasing
        call per submit and per drain, the BLS table's header screens
        native too, and, with a window predictor on a signed lanes-mode
        deployment, drains that fill the signed step's arrays for the
        pipeline to adopt.  `native_shards` > 1 (needs
        `native_admission`, I % native_shards == 0 and capacity %
        native_shards == 0) splits it into instance-range shards behind
        one submit fan-in and a merged drain.  Both change throughput,
        never decisions."""
        I, V = driver.I, driver.V
        if dedup_cache is not None and dedup_cache is not False:
            from agnes_tpu_torch.serve.cache import VerifiedCache

            if dedup_cache is True:
                dedup_cache = VerifiedCache()
            if pubkeys is None:
                raise ValueError(
                    "dedup_cache needs a signed deployment (pubkeys): "
                    "unsigned services never verify, so there is "
                    "nothing to dedup")
        else:
            dedup_cache = None
        self.cache = dedup_cache
        self.bls = bls_lane
        if ladder is None:
            hbm = getattr(driver, "hbm_budget_bytes", None)
            if hbm is None and driver.device.type != "cuda":
                raise ValueError(
                    "a CPU service has no memory budget: pass a ladder "
                    "(or a driver with hbm_budget_bytes)")
            if getattr(driver, "mesh", None) is not None:
                # dense dispatch mode: the step's shape is the
                # deployment's; plan the budget on the rank's block
                ladder = ShapeLadder.plan_dense(
                    I, V, local_shape=driver._local_shape(), hbm_bytes=hbm)
            else:
                ladder = ShapeLadder.plan(I, V, hbm_bytes=hbm)
        if bls_lane is not None and not ladder.bls_rungs:
            ladder = ladder.with_bls(V)
        self.ladder = ladder
        self.metrics = metrics or Metrics()
        self.flightrec = flightrec
        # default: two full both-classes ticks — a burst fits while one
        # tick is in flight; overload surfaces as rejects
        capacity = capacity if capacity is not None else 4 * I * V
        self.native_admission = bool(native_admission)
        self.native_shards = int(native_shards)
        if self.native_shards < 1:
            raise ValueError(
                f"native_shards must be >= 1: {native_shards}")
        if self.native_shards > 1 and not self.native_admission:
            raise ValueError(
                "native_shards > 1 requires native_admission=True "
                "(sharding is a property of the C++ front end)")
        qkw = {}
        if self.native_shards > 1:
            from agnes_tpu_torch.serve.native_admission import (
                NativeAdmissionShards as queue_cls,
            )

            qkw["n_shards"] = self.native_shards
        elif self.native_admission:
            from agnes_tpu_torch.serve.native_admission import (
                NativeAdmissionQueue as queue_cls,
            )
        else:
            queue_cls = AdmissionQueue
        # one construction site: the queues are byte-compatible twins
        self.queue = queue_cls(
            I, capacity, instance_cap=instance_cap,
            policy=overload_policy, cache=self.cache,
            bls_table=(bls_lane.table if bls_lane is not None else None),
            clock=clock, **qkw)
        self._shard_depth_names = (
            [SERVE_NATIVE_SHARD_DEPTH_PREFIX + str(s)
             for s in range(self.native_shards)]
            if self.native_shards > 1 else [])
        if self.native_admission:
            self.queue.drain_hist = self.metrics.histogram(
                SERVE_NATIVE_DRAIN_WALL_S)
            self.queue.densify_hist = self.metrics.histogram(
                SERVE_NATIVE_DENSIFY_WALL_S)
            if bls_lane is not None:
                bls_lane.table.native_screen = True
        self.queue.wait_hist = self.metrics.histogram(SERVE_ADMIT_WAIT_S)
        self._h_close_age = self.metrics.histogram(SERVE_BATCH_CLOSE_AGE_S)
        self._h_e2e = self.metrics.histogram(SERVE_E2E_DECISION_S)
        self.micro = MicroBatcher(self.queue, ladder,
                                  target_votes=target_votes,
                                  max_delay_s=max_delay_s, clock=clock)
        self.pipeline = ServePipeline(driver, batcher, pubkeys, ladder,
                                      window_predictor=window_predictor,
                                      cache=self.cache,
                                      bls_lane=bls_lane, tracer=tracer,
                                      metrics=self.metrics,
                                      flightrec=flightrec, clock=clock)
        if self.native_admission:
            # the drain fills the signed step's arrays against the
            # pipeline's predicted window (None: a plain drain)
            self.queue.phase_state = self.pipeline.native_phase_state
        if bls_lane is not None:
            bls_lane.bind(driver, metrics=self.metrics, ladder=ladder)
        self.driver = driver
        if flightrec is not None and \
                getattr(driver, "flightrec", None) is None:
            driver.flightrec = flightrec      # dispatch/retrace events
        if flightrec is not None:
            _watch_builds(flightrec)
        self.batcher = batcher
        self.tracer = tracer
        self._clock = clock
        self._reported = np.zeros(I, bool)
        self._draining = False

    # -- ingress -------------------------------------------------------------

    def _refuse(self, wire_bytes, rec_size: int) -> AdmitResult:
        """A draining service rejects everything (fail closed), keeping
        submitted == admitted + rejected."""
        n = len(wire_bytes) // rec_size
        tail = 1 if len(wire_bytes) % rec_size else 0
        self.metrics.count(SERVE_SUBMITTED, n + tail)
        self.metrics.count(SERVE_REJECTED_OVERFLOW, n)
        self.metrics.count(SERVE_REJECTED_MALFORMED, tail)
        return AdmitResult(0, n, 0, tail, 0)

    def _count_admission(self, res: AdmitResult) -> None:
        m = self.metrics
        m.count(SERVE_SUBMITTED, res.accepted + res.rejected)
        m.count(SERVE_ADMITTED, res.accepted)
        m.count(SERVE_REJECTED_OVERFLOW, res.rejected_overflow)
        m.count(SERVE_REJECTED_FAIRNESS, res.rejected_fairness)
        m.count(SERVE_REJECTED_MALFORMED, res.rejected_malformed)

    def submit(self, wire_bytes) -> AdmitResult:
        """Admit wire records (rejected records are counted and
        dropped)."""
        if self._draining:
            from agnes_tpu_torch.bridge.native_ingest import REC_SIZE

            return self._refuse(wire_bytes, REC_SIZE)
        if self.tracer is not None:
            with self.tracer.span("serve.submit"):
                # flow start for the tick these records will ride
                self.tracer.flow("tick", self.pipeline.tick_seq + 1, "s")
                res = self.queue.submit(wire_bytes)
        else:
            res = self.queue.submit(wire_bytes)
        m = self.metrics
        self._count_admission(res)
        m.count(SERVE_EVICTED, res.evicted)
        if self.cache is not None and res.accepted:
            m.count(SERVE_CACHE_HITS, res.pre_verified)
            m.count(SERVE_CACHE_MISSES, res.accepted - res.pre_verified)
        if self.flightrec is not None and res.rejected:
            self.flightrec.event(
                "reject", overflow=res.rejected_overflow,
                fairness=res.rejected_fairness,
                malformed=res.rejected_malformed)
        depth = self.queue.depth
        if self.native_admission:
            # the native screens' taxonomy and resident depth beside the
            # shared serve counters (counter writes only on a reject:
            # this is the per-submit hot path)
            if res.rejected:
                m.count(SERVE_NATIVE_REJECTS_OVERFLOW,
                        res.rejected_overflow)
                m.count(SERVE_NATIVE_REJECTS_FAIRNESS,
                        res.rejected_fairness)
                m.count(SERVE_NATIVE_REJECTS_MALFORMED,
                        res.rejected_malformed)
            m.gauge(SERVE_NATIVE_INBOX_DEPTH, depth)
            for s, name in enumerate(self._shard_depth_names):
                m.gauge(name, self.queue.shard_depth(s))
        m.gauge(SERVE_QUEUE_DEPTH, depth)
        return res

    def submit_bls(self, wire_bytes) -> AdmitResult:
        """Admit packed BLS wire shares into the class-bucketing lane;
        the same fail-closed semantics as submit."""
        if self.bls is None:
            raise ValueError("submit_bls on a service without a "
                             "bls_lane")
        from agnes_tpu_torch.serve.bls_lane import BLS_REC_SIZE

        if self._draining:
            return self._refuse(wire_bytes, BLS_REC_SIZE)
        res = self.queue.submit_bls(wire_bytes)
        self._count_admission(res)
        self.metrics.gauge(SERVE_BLS_POP_MISSING,
                           self.bls.table.counters["bls_pop_missing"])
        if self.flightrec is not None and res.rejected:
            self.flightrec.event(
                "reject", overflow=res.rejected_overflow,
                fairness=res.rejected_fairness,
                malformed=res.rejected_malformed, bls=True)
        return res

    def _mirror_bls_metrics(self) -> None:
        """Reconcile the lane's counters into the registry (every path
        that clears classes calls this)."""
        if self.bls is None:
            return
        c = self.bls.counters
        for name, key in ((SERVE_BLS_AGG_CLASSES, "agg_classes"),
                          (SERVE_BLS_FALLBACK_VOTES, "fallback_votes")):
            delta = c[key] - self.metrics.counters.get(name, 0)
            if delta > 0:
                self.metrics.count(name, delta)

    # -- the event-loop tick -------------------------------------------------

    def pump(self, now: Optional[float] = None) -> dict:
        """One tick: maybe close a micro-batch (size-or-deadline),
        dispatch the staged batch, densify the closed one.  Never reads
        from the card in predictor mode.  Returns a small status dict."""
        return self._pump_batch(self._close_batch(now))

    def _close_batch(self, now: Optional[float] = None):
        """Size-or-deadline micro-batch close (admission side only)."""
        return self.micro.poll(now)

    def _pump_batch(self, batch) -> dict:
        """Pipeline half of a tick: dispatch staged, densify `batch`
        and any closed BLS classes."""
        n_batch = len(batch) if batch is not None else 0
        if n_batch:
            self._h_close_age.record(self._clock() - batch.t_first,
                                     n_batch)
        bls_classes = self.bls.poll() if self.bls is not None else None
        dispatched, staged = self.pipeline.pump(batch, bls_classes)
        self._mirror_bls_metrics()
        m = self.metrics
        if n_batch:
            m.count(SERVE_BATCHES)
            m.gauge(SERVE_BATCH_FILL, self.micro.fill(n_batch))
        if dispatched:
            m.count(SERVE_VOTES_DISPATCHED, dispatched)
        if batch is not None and not staged:
            m.count(SERVE_NOOP_TICKS)
        m.gauge(SERVE_QUEUE_DEPTH, self.queue.depth)
        m.gauge(SERVE_INFLIGHT, len(self.pipeline._inflight))
        return {"batch_votes": n_batch, "dispatched": dispatched,
                "staged": staged}

    # -- egress --------------------------------------------------------------

    def _settle(self) -> None:
        """Collect deferred device work + update latency/rate gauges."""
        done = self.pipeline.settle()
        m = self.metrics
        if done:
            now = self._clock()
            m.gauge(SERVE_E2E_LATENCY_S,
                    now - min(b.t_first for b in done))
            for b in done:
                self._h_e2e.record(now - b.t_first, b.n_votes)
        m.gauge(SERVE_INFLIGHT, 0)
        if self.native_admission:
            # adopted native builds and, sharded, the shard-summed reject
            # taxonomy, reconciled into the registry at the sync point
            delta = (self.pipeline.native_phase_builds
                     - m.counters.get(SERVE_NATIVE_PHASE_BUILDS, 0))
            if delta > 0:
                m.count(SERVE_NATIVE_PHASE_BUILDS, delta)
            if self.native_shards > 1:
                c = self.queue.counters
                for cause in ("overflow", "fairness", "malformed"):
                    name = SERVE_NATIVE_SHARD_REJECTS_PREFIX + cause
                    delta = (c["rejected_" + cause]
                             - m.counters.get(name, 0))
                    if delta > 0:
                        m.count(name, delta)
        m.gauge(SERVE_ADMIT_RATE, m.interval_rate(SERVE_ADMITTED))
        m.gauge(SERVE_DISPATCH_RATE,
                m.interval_rate(SERVE_VOTES_DISPATCHED))
        if self.cache is not None:
            delta = (self.cache.counters["evicted"]
                     - m.counters.get(SERVE_CACHE_EVICTIONS, 0))
            if delta > 0:
                m.count(SERVE_CACHE_EVICTIONS, delta)
            delta = (self.pipeline.preverified_votes
                     - m.counters.get(SERVE_PREVERIFIED_DISPATCHED, 0))
            if delta > 0:
                m.count(SERVE_PREVERIFIED_DISPATCHED, delta)
            m.gauge(SERVE_CACHE_BYTES, self.cache.bytes)
            rh = m.interval_rate(SERVE_CACHE_HITS)
            rm = m.interval_rate(SERVE_CACHE_MISSES)
            m.gauge(SERVE_CACHE_HIT_RATE,
                    rh / (rh + rm) if rh + rm > 0 else 0.0)
            # decided heights never reach a verify lane again
            self.cache.prune_decided(self.batcher.heights)

    def poll_decisions(self) -> List[Decision]:
        """Newly latched first decisions since the last poll (the
        driver latches each instance's first decision).  The sync
        point."""
        self._settle()
        st = self.driver.stats
        new = st.decided & ~self._reported
        out: List[Decision] = []
        for i in np.nonzero(new)[0]:
            slot = int(st.decision_value[i])
            # decode through the table of the decision's own height (the
            # pipeline's snapshot at the first advance); the live table
            # only when no advance happened
            snap = self.pipeline.first_advance_decode.get(int(i))
            if snap is not None and slot in snap:
                value_id = snap[slot]
            else:
                value_id = self.batcher.decode_slot(int(i), slot)
            out.append(Decision(
                instance=int(i), value_slot=slot, value_id=value_id,
                round=int(st.decision_round[i])))
        self._reported |= new
        if out:
            self.metrics.count(SERVE_DECISIONS, len(out))
        return out

    # -- shutdown ------------------------------------------------------------

    def drain(self) -> dict:
        """Graceful shutdown: stop admitting, push everything queued and
        staged through the card, re-enter held future-round votes whose
        window has arrived (one pass against the card's real window),
        settle, and return the final report."""
        self._draining = True
        while self.queue.depth > 0:
            self.pipeline.pump(self.micro.flush())
        self.pipeline.pump(None)           # dispatch the last staged
        if self.bls is not None:
            open_cls = self.bls.flush()
            if open_cls:
                self.pipeline.pump(None, open_cls)
                self.pipeline.pump(None)
            self._mirror_bls_metrics()
        self.pipeline.window_predictor = None
        held_before = self.batcher.held_votes
        if held_before:
            self.driver.collect()
            self.pipeline._sync_window()       # re-enters held votes
            if self.pipeline.stage(None, sync=False):
                self.pipeline.dispatch_staged()
        # dispatches on the drain path went around pump()'s counting
        delta = (self.pipeline.dispatched_votes
                 - self.metrics.counters.get(SERVE_VOTES_DISPATCHED, 0))
        if delta > 0:
            self.metrics.count(SERVE_VOTES_DISPATCHED, delta)
        decisions = self.poll_decisions()
        for name, ms in _build_gauges().items():
            self.metrics.gauge(name, ms)
        snap = self.metrics.snapshot(window=True)
        st = self.driver.stats
        return {
            "decisions_total": st.decisions_total,
            "decided_instances": int(st.decided.sum()),
            "final_decisions": decisions,
            "held_flushed": held_before - self.batcher.held_votes,
            "held_remaining": self.batcher.held_votes,
            "late_quorums": self.batcher.drain_host_events(),
            "rejected_signature_device":
                self.driver.rejected_signature_device,
            "queue": dict(self.queue.counters),
            "noop_ticks": self.pipeline.noop_ticks,
            "host_fallback_builds": self.pipeline.host_fallback_builds,
            "offladder_builds": self.pipeline.offladder_builds,
            "dispatched_batches": self.pipeline.dispatched_batches,
            "dispatched_votes": self.pipeline.dispatched_votes,
            "preverified_builds": self.pipeline.preverified_builds,
            "preverified_votes": self.pipeline.preverified_votes,
            "serve_cache": (self.cache.snapshot()
                            if self.cache is not None else None),
            # the native front end's counters and depth (None: Python
            # admission) and the builds adopted from its phase drain
            "native_admission": (self.queue.native_snapshot()
                                 if self.native_admission else None),
            "native_phase_builds": self.pipeline.native_phase_builds,
            "bls": (self.bls.snapshot() if self.bls is not None
                    else None),
            "bls_votes": self.pipeline.bls_votes,
            "metrics": snap,
            "serve_rates_window": {k: v for k, v in snap.items()
                                   if k.endswith("_per_sec")},
            "latency": {name: h.snapshot()
                        for name, h in self.metrics.hists.items()},
        }

    # -- export surface ------------------------------------------------------

    def start_metrics_server(self, port: int = 0,
                             host: str = "127.0.0.1"):
        """Attach a `/metrics` Prometheus endpoint over this service's
        registry (utils/metrics_http.MetricsServer) with the kernels'
        `compile_ms_<kernel>` build walls.  Returns the started server
        (`server.port`, `server.stop()`)."""
        from agnes_tpu_torch.utils.metrics_http import MetricsServer

        server = MetricsServer(self.metrics, host=host, port=port,
                               extra_sources=(_build_gauges,))
        server.start()
        return server
