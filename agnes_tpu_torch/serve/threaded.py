"""ThreadedVoteService: the host event loop above VoteService (twin of
`agnes_tpu.serve.threaded`).

VoteService is single-threaded by contract: one caller alternates
submit / pump / poll.  A network front end cannot: bytes arrive on
socket threads while the dispatch loop must keep the card fed.  This
module is that layer, two daemon threads over one VoteService:

    submit thread    drains a socket-shaped Inbox (serve/queue.py) into
                     the bounded admission queue
    dispatch thread  pumps service ticks: closes micro-batches,
                     densifies, queues the fused steps on the card

with a two-lock discipline that keeps the caller-facing `submit`
wait-free relative to the step in flight:

* ``_admission`` guards the admission queue and the MicroBatcher.  It is
  held across `queue.submit` (submit thread) and `micro.poll` (dispatch
  thread), never across a dispatch.
* ``_device`` guards the pipeline and the driver (densify, dispatch,
  collection).  Only the dispatch thread and the caller's
  poll_decisions / drain take it; the submit thread never does.

`submit()` itself takes neither lock: it appends to the Inbox (its own
short mutex), so a socket thread can always hand bytes off, even while
the dispatch thread sits in a launch.

With the native admission front end (serve/native_admission.py, single
queue or shards) the admission lock is elided: the C++ handle holds its
own mutexes, queue.submit / drain are single GIL-releasing ctypes calls,
and a Python lock held across such a call would block every thread that
wants it for the whole native call.  The queue's ``native = True`` class
attribute is the key.  The dedup lookup runs inside `queue.submit` on
the submit thread, never under the device lock; the cache's own leaf
mutex covers its dict operations.

Note that torch's launches hold the GIL (ctypes releases it only for the
`ag_*` calls), so on the card the submit thread can still wait for the
interpreter while the dispatch thread launches a step; the busy gauges
below show how much.

Observability: `serve_inbox_depth`, `serve_submit_busy_frac` and
`serve_dispatch_busy_frac` gauges (each loop's busy time over one shared
sample window) and the `serve_inbox_dropped` counter, on the service's
thread-safe Metrics registry.

Shutdown is drain-then-join, loss-free for admitted work: `drain()`
stops intake, lets the submit thread finish the inbox, joins both
threads, then runs VoteService.drain() (flush + held re-entry + settle)
on the calling thread and returns its report.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

from agnes_tpu_torch.serve.queue import Inbox
from agnes_tpu_torch.utils.metrics import (
    SERVE_DISPATCH_BUSY_FRAC,
    SERVE_INBOX_DEPTH,
    SERVE_INBOX_DROPPED,
    SERVE_SUBMIT_BUSY_FRAC,
    SERVE_THREAD_FAILURES,
)


class ThreadedVoteService:
    """Submit/dispatch threads over a VoteService (module docstring).

    ``idle_wait_s`` bounds how long either loop sleeps when it finds
    no work (the inbox get timeout and the dispatch idle nap);
    ``gauge_interval_s`` is the busy-fraction gauge window."""

    def __init__(self, service, *,
                 inbox_capacity: int = 1024,
                 idle_wait_s: float = 0.0005,
                 gauge_interval_s: float = 0.05,
                 clock=time.monotonic,
                 thread_factory=threading.Thread,
                 sleep=time.sleep):
        self.service = service
        self.inbox = Inbox(inbox_capacity)
        self.idle_wait_s = float(idle_wait_s)
        self.gauge_interval_s = float(gauge_interval_s)
        self._clock = clock
        #: the schedule checker's seams (analysis/schedcheck.py): a
        #: cooperative thread factory and a logical sleep let it
        #: serialize every yield point of these real loops; the
        #: defaults cost one attribute read
        self._sleep = sleep
        self._admission = threading.Lock()
        self._device = threading.Lock()
        #: native admission: the queue's handle holds its own mutexes,
        #: so the admission lock is elided around submit and the
        #: micro-batch close — the GIL-releasing C call must never run
        #: under a Python lock another thread waits on (everything the
        #: lock otherwise guards is inside the handle or thread-safe)
        self._native = bool(getattr(service.queue, "native", False))
        #: monotone per-loop busy seconds (single writer each) and the
        #: one shared sample window sample_busy_gauges() closes, so the
        #: final partial window lands at drain and a sample between
        #: loop wakeups reads live values
        self._busy_totals = {"submit": 0.0, "dispatch": 0.0}
        #: start instant of a loop's call currently in flight (None =
        #: idle), so a mid-call sample attributes the elapsed span to
        #: the CURRENT window — without it a 60 s call would read idle
        #: for 60 one-second samples and then land whole in one window
        self._busy_inflight = {"submit": None, "dispatch": None}
        self._busy_sample = {"t": None, "submit": 0.0, "dispatch": 0.0}
        self._busy_mu = threading.Lock()
        self._stop = threading.Event()       # stop intake, finish work
        self._started = False
        #: first exception that killed a loop (None = healthy).  A
        #: dead loop FAILS CLOSED: the guard closes the inbox (so
        #: submit refuses) and stops the twin loop; drain() surfaces
        #: the exception in its report under "thread_failure".
        self.failure: Optional[BaseException] = None
        self._submit_t = thread_factory(
            target=lambda: self._guard(self._submit_loop), daemon=True,
            name="agnes-serve-submit")
        self._dispatch_t = thread_factory(
            target=lambda: self._guard(self._dispatch_loop),
            daemon=True, name="agnes-serve-dispatch")

    def _guard(self, loop) -> None:
        """Exception containment for a loop thread: without it, a
        runtime error mid-pump (a CUDA error, a densify bug) would kill
        the daemon thread SILENTLY — submit would keep accepting work
        nothing will ever dispatch.  Instead the first failure is
        recorded, counted, and the whole host fails closed."""
        try:
            loop()
        except BaseException as e:  # noqa: BLE001 — fail closed on ANY
            if self.failure is None:
                self.failure = e
            self.service.metrics.count(SERVE_THREAD_FAILURES)
            fr = getattr(self.service, "flightrec", None)
            if fr is not None:
                # the crash-surviving trail names the dead loop — a
                # wedged host's heartbeat dates and attributes it
                fr.event("thread_failure",
                         thread=threading.current_thread().name,
                         error=repr(e))
            self._stop.set()
            self.inbox.close()       # refuse producers immediately

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ThreadedVoteService":
        if not self._started:
            self._started = True
            self._submit_t.start()
            self._dispatch_t.start()
        return self

    # -- ingress (any thread; wait-free wrt device work) ---------------------

    def submit(self, wire_bytes) -> bool:
        """Hand a wire blob to the event loop.  Returns False (and
        counts `serve_inbox_dropped`) when the inbox is full, closed
        (draining or a loop thread died) — fail closed, never block:
        backpressure surfaces to the network peer as a refusal, not a
        stall.  The inbox is the ONE refusal authority, so its
        `dropped` count and the metric cannot diverge."""
        if not self.inbox.put(wire_bytes):
            self.service.metrics.count(SERVE_INBOX_DROPPED)
            return False
        return True

    # -- the loops -----------------------------------------------------------

    def busy_seconds(self) -> dict:
        """Lifetime busy seconds per loop (monotone totals — the
        sampler's source).  A probe divides by its own measured span
        for a whole-run busy fraction instead of whatever the last
        gauge window happened to cover."""
        return dict(self._busy_totals)

    def sample_busy_gauges(self, now: Optional[float] = None) -> None:
        """Refresh `serve_submit_busy_frac` / `serve_dispatch_busy_frac`
        from the loops' monotone busy totals over ONE shared sample
        window.  Callable from any thread — the loops call it on their
        gauge cadence, poll_decisions and drain call it so the final
        partial window still lands, and a heartbeat source may call it
        to read the gauges live between loop wakeups."""
        m = self.service.metrics
        with self._busy_mu:
            now = self._clock() if now is None else now
            t0 = self._busy_sample["t"]
            if t0 is None:
                self._busy_sample["t"] = now
                for name in ("submit", "dispatch"):
                    self._busy_sample[name] = self._observed(name, now)
                return
            dt = now - t0
            if dt <= 0:
                return
            for name, gauge in (("submit", SERVE_SUBMIT_BUSY_FRAC),
                                ("dispatch", SERVE_DISPATCH_BUSY_FRAC)):
                observed = self._observed(name, now)
                # clamp: attribution keeps windows consistent, the
                # min() only absorbs clock-read jitter at the edges
                m.gauge(gauge, min(
                    1.0, (observed - self._busy_sample[name]) / dt))
                self._busy_sample[name] = observed
            self._busy_sample["t"] = now

    def _observed(self, name: str, now: float) -> float:
        """Busy seconds observable at `now`: the completed total plus
        the elapsed span of any call still in flight (callers hold
        _busy_mu).  A loop sitting in a minutes-long device call is
        BUSY for every window the call spans, not idle-then-60x."""
        start = self._busy_inflight[name]
        inflight = max(0.0, now - start) if start is not None else 0.0
        return self._busy_totals[name] + inflight

    @contextlib.contextmanager
    def _busy(self, name: str):
        """Busy-span bookkeeping for one loop call: mark in flight so
        mid-call samples attribute the elapsed span to their window,
        accumulate + clear on the way out — in a finally, so a raising
        call never leaves a dead thread reading 100% busy forever."""
        t0 = self._clock()
        with self._busy_mu:
            self._busy_inflight[name] = t0
        try:
            yield
        finally:
            with self._busy_mu:
                self._busy_totals[name] += self._clock() - t0
                self._busy_inflight[name] = None

    def _submit_loop(self) -> None:
        m = self.service.metrics
        if self.service.tracer is not None:
            # label this row in the chrome trace
            self.service.tracer.name_thread(self._submit_t.name)
        self.sample_busy_gauges()        # open the shared window
        win_t0 = self._clock()
        while not (self._stop.is_set() and self.inbox.depth == 0):
            blob = self.inbox.get(timeout=self.idle_wait_s)
            if blob is not None:
                with self._busy("submit"):
                    if self._native:
                        # self-synchronized native queue: the
                        # GIL-releasing C call runs lock-free
                        self.service.submit(blob)
                    else:
                        with self._admission:
                            self.service.submit(blob)
            now = self._clock()
            if now - win_t0 >= self.gauge_interval_s:
                self.sample_busy_gauges(now)
                m.gauge(SERVE_INBOX_DEPTH, self.inbox.depth)
                win_t0 = now

    def _dispatch_loop(self) -> None:
        if self.service.tracer is not None:
            self.service.tracer.name_thread(self._dispatch_t.name)
        win_t0 = self._clock()
        while True:
            if self._native:
                batch = self.service._close_batch()
            else:
                with self._admission:
                    batch = self.service._close_batch()
            # pump when there is a closed batch OR builds staged by a
            # previous tick wait for their dispatch (reading the FIFO's
            # truthiness unlocked is benign: worst case one extra tick)
            # OR a BLS aggregate class would close (classes are polled
            # inside _pump_batch, so without this gate a BLS-only
            # deployment would strand deadline-expired classes until
            # drain)
            if (batch is not None or self.service.pipeline._staged
                    or (self.service.bls is not None
                        and self.service.bls.ready())):
                with self._busy("dispatch"):
                    with self._device:
                        self.service._pump_batch(batch)
            elif self._stop.is_set():
                break          # idle AND draining: nothing left to pump
            else:
                self._sleep(self.idle_wait_s)
            now = self._clock()
            if now - win_t0 >= self.gauge_interval_s:
                self.sample_busy_gauges(now)
                win_t0 = now

    # -- egress (calling thread) ----------------------------------------------

    def poll_decisions(self) -> List:
        """Newly latched decisions (VoteService.poll_decisions under
        the device lock — serialized against the dispatch thread's
        pipeline work, never against submit).  Also refreshes the
        busy-fraction gauges on the shared sample window, so a poll
        cadence keeps them live even when the loops sit in long
        device calls."""
        self.sample_busy_gauges()
        with self._device:
            return self.service.poll_decisions()

    # -- shutdown -------------------------------------------------------------

    def drain(self, timeout_s: Optional[float] = 60.0) -> dict:
        """Graceful shutdown: close intake, join both threads, flush
        any inbox residue through admission, then run the service's
        own drain (queue flush + held-vote re-entry + settle) and
        return its final report (plus inbox accounting).

        Loss-free for accepted work: `inbox.close()` atomically
        orders every racing `submit` against the final flush — a
        producer that slipped past the stop flag and appended after
        the submit loop exited still gets its blob admitted here; a
        producer arriving after the close gets False (counted).

        `timeout_s` is HONEST: a thread that does not quiesce in time
        (e.g. the dispatch thread inside a first kernel build) raises
        TimeoutError instead of silently blocking on the device lock
        for however long that takes — retry with a larger budget."""
        self._stop.set()
        self.inbox.close()
        if self._started:
            # ONE shared deadline across both joins, so the promised
            # bound is timeout_s total, not per thread
            t_end = (None if timeout_s is None
                     else self._clock() + timeout_s)
            for t in (self._submit_t, self._dispatch_t):
                t.join(timeout=None if t_end is None
                       else max(0.0, t_end - self._clock()))
            stuck = [t.name for t in (self._submit_t, self._dispatch_t)
                     if t.is_alive()]
            if stuck:
                raise TimeoutError(
                    f"serve threads did not quiesce within "
                    f"{timeout_s}s: {', '.join(stuck)} (a kernel "
                    f"build or a long step can hold the dispatch "
                    f"thread; retry drain with a larger timeout_s)")
        # flush the final partial busy window: without this, the last
        # < gauge_interval_s of loop work never reached the gauges and
        # a short-lived service reported busy fractions of 0
        self.sample_busy_gauges()
        # Holding the admission lock across the device-lock acquisition
        # is what the two-lock discipline forbids on the serve path.
        # Here it is deliberate and safe: both loop threads are joined
        # (or were never started), so this is a quiescent section —
        # nothing can contend, and the final flush + service drain
        # need both domains at once.
        with self._admission, self._device:  # lockcheck: allow (quiescent: loops joined above)
            try:
                # schedcheck: atomic (residue flush: every blob the
                # inbox accepted before close() is admitted here; the
                # schedule checker's conservation monitor proves it)
                while True:     # TOCTOU residue (docstring)
                    blob = self.inbox.get(timeout=0)
                    if blob is None:
                        break
                    self.service.submit(blob)
                report = self.service.drain()
            except BaseException as e:  # noqa: BLE001
                # the service drain re-dispatches queued work through
                # the same driver a loop thread may have died on; for
                # a FAILED host the promised contract is a report
                # carrying thread_failure, not a second raise.  A
                # healthy host's drain error is a real bug: re-raise.
                if self.failure is None:
                    raise
                report = {"drain_error": repr(e),
                          "metrics": self.service.metrics.snapshot()}
        report["inbox"] = {"enqueued": self.inbox.enqueued,
                           "dropped": self.inbox.dropped,
                           "depth_at_drain": self.inbox.depth}
        report["thread_failure"] = (repr(self.failure)
                                    if self.failure is not None else None)
        return report


def threaded_service(driver, batcher, pubkeys=None, *,
                     inbox_capacity: int = 1024,
                     idle_wait_s: float = 0.0005,
                     **service_kw) -> ThreadedVoteService:
    """Convenience assembler: VoteService + ThreadedVoteService,
    started.  `service_kw` passes through to VoteService (ladder,
    capacity, window_predictor, native_admission, ...)."""
    from agnes_tpu_torch.serve.service import VoteService

    svc = VoteService(driver, batcher, pubkeys, **service_kw)
    return ThreadedVoteService(svc, inbox_capacity=inbox_capacity,
                               idle_wait_s=idle_wait_s).start()
