"""Deterministic interleaving explorer for the threaded serve host (twin
of `agnes_tpu.analysis.schedcheck`).

The races the threaded host has been known to hold (the inbox close /
put check-then-act race, a native drain sized from a depth read before
the call, a shard fan-in whose routing scratch was shared, busy-
fraction windows without in-flight attribution) are each a real-thread
interleaving no unit test reaches on purpose.  lockcheck proves lock
order statically and the model checkers exhaust modelled schedules;
this module runs the real host code (`ThreadedVoteService`, `Inbox`,
`AdmissionQueue`, `MicroBatcher`, `VerifiedCache`) on real OS threads
under a cooperative turnstile scheduler that keeps exactly one thread
runnable, hands control over only at announced yield points, and
explores the resulting schedule tree exhaustively under CHESS-style
iterative preemption bounding with sleep-set pruning.

Yield points (serialized scheduling choices):
  * lock acquire / release, through `InstrumentedLock`'s hooks
    (analysis/lockcheck.py): `SchedLock` overrides `_raw_acquire` /
    `_raw_release` / `_sched_point` and reuses its order bookkeeping,
    and the lock set comes from `lockcheck.LOCK_REGISTRY`
  * inbox put / get, through the inbox mutex and a cooperative
    Condition
  * condition waits: a timeout wake-up is a scheduling choice, budgeted
    one per global progress version per thread, so idle loops cannot
    spin the schedule space without bound
  * native ctypes call boundaries: the GIL-release span of a native
    admission queue's submit / drain, modelled by `_NativeQueue` around
    a real AdmissionQueue
  * clock reads: `SchedClock` advances a fixed logical tick per read

Soundness model: between two announced points the running thread runs
alone (every other one is parked on its semaphore), so each quantum is
atomic and every shared-memory interaction is an announced (kind,
resource) pair.  Two pending operations are independent iff their
resources differ, which makes sleep-set pruning sound: a pruned
sibling's subtree is covered by the commuted order already explored.
`--no-sleep-sets` runs the full tree; the tests check that both reach
the same terminal states on a small config.

Monitors (violations, not asserts: every run completes and reports):
  conservation  inbox residue after drain, enqueued != submitted,
                claimed drained votes != the queue's drained counter
  deadlock      no thread enabled while some are live (including an
                idle livelock whose wake budget ran out)
  lock-order    lockcheck.LockOrderState, strict=False: record and
                explore on
  atomicity     `# schedcheck: atomic` spans (ATOMIC_SPANS): an
                announced read / write on a guarded resource while
                another thread holds its guard lock
  gauge sanity  busy-fraction gauges above 1.0

Proof of bite: the four races are re-introduced as MUTANTS, caught by
exploration, ddmin-minimized to a replayable thread schedule
(modelcheck._ddmin over the choice list; replay skips a forced choice
whose thread is not enabled), and the minimized schedule replays clean
on the honest build.

Caveats: the preemption bound is a bug-finding bound, not a proof over
all schedules; only Python-visible yield points are serialized (the C++
`ag_*` spans release the GIL and race inside, which the ThreadSanitizer
stress harness tests/native/tsan_admission_stress.cpp covers); and the
cooperative quantum is coarser than real instruction interleaving
(races inside one lock-protected section are invisible, but such a
section is what the lock already makes atomic).

Dispatch is stubbed (`_SchedService` counts votes instead of running a
pipeline), so a run touches no device: it launches nothing and leaves
CUDA uninitialized.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from agnes_tpu_torch.analysis import lockcheck
from agnes_tpu_torch.analysis.modelcheck import _ddmin
from agnes_tpu_torch.bridge.native_ingest import REC_SIZE, pack_wire_votes
from agnes_tpu_torch.serve.batcher import MicroBatcher, ShapeLadder
from agnes_tpu_torch.serve.cache import VerifiedCache
from agnes_tpu_torch.serve.queue import (
    AdmissionQueue,
    AdmitResult,
    DROP_OLDEST,
    Inbox,
    REJECT_NEWEST,
)
from agnes_tpu_torch.serve.threaded import ThreadedVoteService
from agnes_tpu_torch.utils.metrics import (
    Metrics,
    SCHEDCHECK_SCHEDULES_EXPLORED,
    SCHEDCHECK_VIOLATIONS,
    SERVE_DISPATCH_BUSY_FRAC,
    SERVE_SUBMIT_BUSY_FRAC,
)

#: `# schedcheck: atomic` spans — (file, qualified function) -> the
#: guarded resource.  The comment in the source and this registry are
#: cross-checked by check_atomic_annotations() (and its test), so the
#: annotation cannot rot silently in either direction.  At runtime the
#: guard is enforced via RESOURCE_GUARDS: an announced read/write on
#: the resource while ANOTHER thread holds the guard lock is an
#: atomicity violation (honest code only touches these under the
#: lock; the announce IS the instrumentation of a mutant's unlocked
#: access).
ATOMIC_SPANS: Dict[Tuple[str, str], str] = {
    ("agnes_tpu_torch/serve/queue.py", "Inbox.put"): "inbox",
    ("agnes_tpu_torch/serve/queue.py", "Inbox.close"): "inbox",
    ("agnes_tpu_torch/serve/queue.py", "Inbox.get"): "inbox",
    ("agnes_tpu_torch/serve/threaded.py", "ThreadedVoteService.drain"):
        "inbox",
}

ATOMIC_MARKER = "# schedcheck: atomic"


class _ThreadStop(BaseException):
    """Raised inside a controlled thread at its next yield point when
    the scheduler unwinds a run (deadlock / truncation).  BaseException
    so `except Exception` in exercised code cannot swallow it; the
    host's deliberate `except BaseException` containment CAN catch it,
    but its containment path hits another yield point (inbox.close)
    and re-raises — the unwind always completes."""


class _TCB:
    """Per-thread control block of the turnstile scheduler."""

    __slots__ = ("tid", "name", "sem", "started", "done", "block",
                 "pending", "notified", "last_spin_ver", "error")

    def __init__(self, tid: int, name: str):
        self.tid = tid
        self.name = name
        self.sem = threading.Semaphore(0)
        self.started = False
        self.done = False
        self.block = None            # None = runnable at `pending`
        self.pending = ("start", None)
        self.notified = False
        self.last_spin_ver = -1      # idle-wake budget (progress-gated)
        self.error: Optional[BaseException] = None


@dataclass
class Violation:
    kind: str
    detail: str
    step: int


@dataclass
class Decision:
    """One recorded scheduling choice (only points with >1 enabled
    thread are choices — single-enabled steps are deterministic)."""

    enabled: Tuple[int, ...]
    chosen: int
    running: Optional[int]          # thread granted the prior quantum
    preempts_before: int
    pending: Dict[int, Optional[str]]   # tid -> announced resource


@dataclass
class RunResult:
    choices: List[int]
    decisions: List[Decision]
    violations: List[Violation]
    digest: tuple = ()
    trace: List[tuple] = field(default_factory=list)
    steps: int = 0
    truncated: bool = False
    completed: bool = False


class Scheduler:
    """Cooperative turnstile: the scheduler thread and every worker
    share a baton — exactly one is ever runnable.  Workers announce
    (kind, resource) and park on their semaphore; the scheduler picks
    the next thread (forced prefix, then continue-current default),
    counts preemptions, and records every multi-choice decision for
    the explorer."""

    def __init__(self, forced: Sequence[int] = (),
                 preemption_bound: int = 2, max_steps: int = 20000):
        self.forced = list(forced)
        self._forced_i = 0
        self.preemption_bound = preemption_bound
        self.max_steps = max_steps
        self.tcbs: Dict[int, _TCB] = {}
        self._ident: Dict[int, _TCB] = {}
        self._main_sem = threading.Semaphore(0)
        self._poison = False
        self.running: Optional[int] = None
        self.progress_ver = 0
        self.preemptions = 0
        self.steps = 0
        self.trace: List[tuple] = []
        self.decisions: List[Decision] = []
        self.choices: List[int] = []
        self.violations: List[Violation] = []
        self.truncated = False
        self._guards: Dict[str, "SchedLock"] = {}

    # -- worker-side API ------------------------------------------------------

    def _cur(self) -> _TCB:
        try:
            return self._ident[threading.get_ident()]
        except KeyError:
            raise RuntimeError(
                "SchedPoint reached outside a controlled thread")

    def _yield(self, tcb: _TCB, kind: str, resource, block) -> None:
        if self._poison:
            raise _ThreadStop()
        tcb.pending = (kind, resource)
        tcb.block = block
        # turnstile handoff: release one semaphore, park on another —
        # structurally not a with-block pair
        self._main_sem.release()  # lockcheck: allow (turnstile handoff)
        tcb.sem.acquire()  # lockcheck: allow (turnstile park)
        if self._poison:
            raise _ThreadStop()

    def point(self, kind: str, resource: Optional[str] = None) -> None:
        """Announce-and-yield: the next shared-memory operation of the
        calling thread is (kind, resource); control returns when the
        scheduler grants the quantum."""
        self._yield(self._cur(), kind, resource, None)

    def sleep(self, seconds: float) -> None:  # noqa: ARG002 — logical
        """The host's idle nap: blocks until the next global progress
        version (budgeted — without the gate an idle loop would admit
        unboundedly many no-op wake orderings)."""
        self._yield(self._cur(), "sleep", None, ("sleep",))

    def progress(self) -> None:
        """Bump the global progress version: new work exists, so every
        idle thread earns one more timeout wake-up."""
        self.progress_ver += 1

    def record_violation(self, kind: str, detail: str) -> None:
        self.violations.append(Violation(kind, detail, self.steps))

    def register_guard(self, resource: str, lock: "SchedLock") -> None:
        self._guards[resource] = lock

    def thread_factory(self, target=None, name=None, daemon=True,
                       args=(), kwargs=None) -> "SchedThread":
        return SchedThread(self, target=target, name=name,
                           daemon=daemon, args=args, kwargs=kwargs)

    # -- lock / condition protocol -------------------------------------------

    def lock_acquire(self, lock: "SchedLock") -> None:
        tcb = self._cur()
        self._yield(tcb, "lock", lock.resource, ("lock", lock))
        lock.owner = tcb.tid        # granted only when free

    def lock_release(self, lock: "SchedLock") -> None:
        if self._poison:            # unwind path: just free it
            lock.owner = None
            return
        tcb = self._cur()
        self._yield(tcb, "unlock", lock.resource, None)
        lock.owner = None

    def cond_wait(self, cond: "SchedCondition", can_timeout: bool
                  ) -> None:
        tcb = self._cur()
        lock = cond.lock
        # release is atomic with starting to wait (real Condition
        # semantics) — it only ENABLES others, so performing it before
        # the yield keeps the announce-before-perform invariant for
        # every state-READING operation
        lock.state.stack().remove((lock.name, lock.rank))
        lock.owner = None
        cond.waiters.append(tcb.tid)
        self._yield(tcb, "cond_wait", lock.resource,
                    ("cond", cond, can_timeout))
        lock.__enter__()            # cooperative reacquire

    def cond_notify(self, cond: "SchedCondition",
                    n: Optional[int] = None) -> None:
        for tid in (cond.waiters if n is None else cond.waiters[:n]):
            self.tcbs[tid].notified = True
        self.progress()

    def join(self, target: _TCB) -> None:
        if target.done or not target.started:
            return
        # modeled UNTIMED (drain's join timeout never fires): a stuck
        # thread surfaces as the deadlock monitor, not as a spurious
        # TimeoutError no real-time bound justifies under logical time
        self._yield(self._cur(), "join", f"join:{target.name}",
                    ("join", target))

    # -- scheduler side -------------------------------------------------------

    def _enabled(self, tcb: _TCB) -> bool:
        if not tcb.started or tcb.done:
            return False
        b = tcb.block
        if b is None:
            return True
        if b[0] == "lock":
            return b[1].owner is None
        if b[0] == "cond":
            return tcb.notified or (
                b[2] and self.progress_ver > tcb.last_spin_ver)
        if b[0] == "sleep":
            return self.progress_ver > tcb.last_spin_ver
        if b[0] == "join":
            return b[1].done
        raise AssertionError(f"unknown block {b!r}")

    def _choose(self, enabled: List[int]) -> int:
        while self._forced_i < len(self.forced):
            want = self.forced[self._forced_i]
            self._forced_i += 1
            if want in enabled:
                return want
            # ddmin replay: a forced choice whose thread is not
            # enabled here is SKIPPED — keeps every subset of a
            # schedule well-defined (the modelcheck replay contract)
        if self.running in enabled:
            return self.running     # continue-current default
        return min(enabled)

    def _grant(self, tid: int) -> None:
        tcb = self.tcbs[tid]
        b = tcb.block
        if b is not None:
            if b[0] == "cond":
                cond = b[1]
                if tcb.notified:
                    tcb.notified = False
                else:
                    tcb.last_spin_ver = self.progress_ver
                if tid in cond.waiters:
                    cond.waiters.remove(tid)
            elif b[0] == "sleep":
                tcb.last_spin_ver = self.progress_ver
            elif b[0] == "lock":
                b[1].owner = tid    # ownership fixed AT grant
        tcb.block = None
        kind, resource = tcb.pending
        if kind in ("read", "write"):
            guard = self._guards.get(resource)
            if guard is not None and guard.owner not in (None, tid):
                self.record_violation(
                    "atomicity",
                    f"{tcb.name} {kind}s {resource!r} while "
                    f"{self.tcbs[guard.owner].name} holds "
                    f"{guard.name!r} (# schedcheck: atomic span)")
        self.trace.append((tid, kind, resource))
        self.running = tid
        tcb.sem.release()  # lockcheck: allow (grant the quantum)
        self._main_sem.acquire()  # until its next yield  # lockcheck: allow

    def run(self, driver: Callable[[], None]) -> str:
        """Run `driver` in a controlled thread to completion of ALL
        threads; returns 'done' | 'deadlock' | 'truncated'."""
        d = self.thread_factory(target=driver, name="driver")
        d.start()
        outcome = "done"
        while True:
            live = [t for t in self.tcbs.values()
                    if t.started and not t.done]
            if not live:
                break
            enabled = sorted(t.tid for t in live if self._enabled(t))
            if not enabled:
                blocked = ", ".join(
                    f"{t.name}@{t.pending[0]}:{t.pending[1]}"
                    for t in live)
                self.record_violation(
                    "deadlock",
                    f"no thread enabled; live threads blocked at "
                    f"[{blocked}]")
                outcome = "deadlock"
                break
            if self.steps >= self.max_steps:
                self.truncated = True
                outcome = "truncated"
                break
            self.steps += 1
            if len(enabled) > 1:
                chosen = self._choose(enabled)
                if (self.running is not None
                        and self.running in enabled
                        and chosen != self.running):
                    pre = self.preemptions
                    self.preemptions += 1
                else:
                    pre = self.preemptions
                self.decisions.append(Decision(
                    enabled=tuple(enabled), chosen=chosen,
                    running=self.running,
                    preempts_before=pre,
                    pending={t: self.tcbs[t].pending[1]
                             for t in enabled}))
                self.choices.append(chosen)
            else:
                chosen = enabled[0]
            self._grant(chosen)
        if outcome != "done":
            self._unwind()
        for t in self.tcbs.values():
            if t.error is not None and not self._poison:
                self.record_violation(
                    "exception", f"{t.name}: {t.error!r}")
        return outcome

    def _unwind(self) -> None:
        """Poison every yield point and walk each live thread to
        completion — they raise _ThreadStop at their next wake and
        unwind through the real code's finally blocks."""
        self._poison = True
        for tcb in self.tcbs.values():
            while tcb.started and not tcb.done:
                tcb.sem.release()  # lockcheck: allow (poison wake)
                self._main_sem.acquire()  # lockcheck: allow (turnstile)


class SchedThread:
    """threading.Thread look-alike the host builds via its
    `thread_factory` seam; every lifecycle edge goes through the
    scheduler."""

    def __init__(self, sched: Scheduler, target=None, name=None,
                 daemon=True, args=(), kwargs=None):  # noqa: ARG002
        self.sched = sched
        tid = len(sched.tcbs)
        self.name = name or f"sched-{tid}"
        self.tcb = _TCB(tid, self.name)
        sched.tcbs[tid] = self.tcb
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        self._os = threading.Thread(
            target=self._run, name=self.name,
            daemon=True)  # lint: allow-thread (scheduler turnstile: workers park on semaphores, unwound via _ThreadStop)

    def start(self) -> None:
        self.tcb.started = True
        self._os.start()

    def is_alive(self) -> bool:
        return self.tcb.started and not self.tcb.done

    def join(self, timeout=None) -> None:  # noqa: ARG002 — untimed
        self.sched.join(self.tcb)

    def _run(self) -> None:
        tcb = self.tcb
        self.sched._ident[threading.get_ident()] = tcb
        tcb.sem.acquire()  # wait for the first grant  # lockcheck: allow
        try:
            if not self.sched._poison and self._target is not None:
                self._target(*self._args, **self._kwargs)
        except _ThreadStop:
            pass
        except BaseException as e:  # noqa: BLE001 — surfaced as violation
            tcb.error = e
        finally:
            tcb.done = True
            self.sched.progress()   # joiners + idle budgets advance
            self.sched._main_sem.release()  # lockcheck: allow (exit)


class SchedLock(lockcheck.InstrumentedLock):
    """InstrumentedLock with the SchedPoint hooks overridden: acquire
    and release are announced, explorable yield points; the order
    bookkeeping (LockOrderState) is inherited verbatim and becomes the
    checker's runtime lock-order monitor (strict=False)."""

    def __init__(self, sched: Scheduler, name: str, rank: int,
                 state: lockcheck.LockOrderState, strict: bool = False,
                 resource: Optional[str] = None):
        super().__init__(name, rank, state, strict=False)
        self.sched = sched
        self.resource = resource if resource is not None else name
        self.owner: Optional[int] = None

    def _raw_acquire(self) -> None:
        self.sched.lock_acquire(self)

    def _raw_release(self) -> None:
        self.sched.lock_release(self)


class SchedCondition:
    """Cooperative stand-in for threading.Condition(lock): wait_for is
    a blocking yield whose timeout wake-up is a budgeted scheduling
    choice; notify marks waiters wakeable."""

    def __init__(self, sched: Scheduler, lock: SchedLock, name: str):
        self.sched = sched
        self.lock = lock
        self.name = name
        self.waiters: List[int] = []

    def __enter__(self):
        self.lock.__enter__()
        return self

    def __exit__(self, *exc):
        return self.lock.__exit__(*exc)

    def wait_for(self, pred, timeout: Optional[float] = None) -> bool:
        if pred():
            return True
        if timeout is not None and timeout <= 0:
            return False
        while True:
            try:
                self.sched.cond_wait(self,
                                     can_timeout=timeout is not None)
            except _ThreadStop:
                # unwind mid-wait: cond_wait released the lock and
                # never reacquired — rebalance the order stack so the
                # enclosing `with cond:` __exit__ stays well-formed
                self.lock.state.stack().append(
                    (self.lock.name, self.lock.rank))
                raise
            if pred():
                return True
            if timeout is not None:
                # modeled timeout fire (real code may still have
                # budget left — a superset of real timings, which the
                # caller's None-return path must tolerate anyway)
                return False

    def notify(self, n: int = 1) -> None:
        self.sched.cond_notify(self, n)

    def notify_all(self) -> None:
        self.sched.cond_notify(self, None)


class SchedClock:
    """Logical clock: every read is an announced yield point and
    advances a fixed tick.  `resource=None` marks reads independent
    (sound whenever control flow does not branch on clock VALUES —
    the honest scopes pin max_delay_s=0 and a huge gauge interval to
    guarantee that); the busy-frac scenario sets 'clock' so sample
    windows interleave."""

    def __init__(self, sched: Scheduler, tick_s: float = 0.02,
                 resource: Optional[str] = None):
        self.sched = sched
        self.tick_s = tick_s
        self.resource = resource
        self.t = 0.0

    def __call__(self) -> float:
        self.sched.point("clock", self.resource)
        self.t += self.tick_s
        return self.t


class _SchedEvent:
    """threading.Event stand-in whose set() is a progress edge (stop
    must refresh every idle thread's wake budget or the loops could
    never observe it)."""

    def __init__(self, sched: Scheduler):
        self.sched = sched
        self._flag = False

    def set(self) -> None:
        self._flag = True
        self.sched.progress()

    def is_set(self) -> bool:
        return self._flag


# ---------------------------------------------------------------------------
# The system under test: real host + stubbed dispatch
# ---------------------------------------------------------------------------


class _StubPipeline:
    def __init__(self):
        self._staged: List = []


class _SchedService:
    """VoteService stand-in: REAL AdmissionQueue + MicroBatcher (+
    VerifiedCache) inside, dispatch stubbed to a vote counter — no
    device work, same duck surface the threaded host touches
    (tracer/flightrec/bls/pipeline/metrics/queue/micro)."""

    def __init__(self, queue, micro, metrics: Metrics,
                 sched: Scheduler):
        self.queue = queue
        self.micro = micro
        self.metrics = metrics
        self.sched = sched
        self.tracer = None
        self.flightrec = None
        self.bls = None
        self.pipeline = _StubPipeline()
        self.blobs_submitted = 0
        self.votes_drained = 0

    def submit(self, wire_bytes):
        res = self.queue.submit(wire_bytes)
        self.blobs_submitted += 1
        self.sched.progress()       # dispatch's idle nap may now close
        return res

    def _close_batch(self):
        return self.micro.poll()

    def _pump_batch(self, batch) -> None:
        if batch is not None:
            self.votes_drained += len(batch)

    def poll_decisions(self) -> List:
        return []

    def drain(self) -> dict:
        while True:
            batch = self.micro.flush()
            if batch is None:
                break
            self.votes_drained += len(batch)
        return {"metrics": self.metrics.snapshot()}


class _NativeQueue:
    """The native admission handle, modeled: wraps a REAL
    AdmissionQueue, reports native=True (the host elides its admission
    lock — the production shape), and announces every call boundary as
    a 'native' SchedPoint: the GIL-release span the Python scheduler
    cannot see into.  The inner call itself is one atomic quantum —
    the real handle's mutex gives exactly that."""

    native = True

    def __init__(self, inner: AdmissionQueue, sched: Scheduler):
        self.inner = inner
        self.sched = sched

    @property
    def depth(self):
        return self.inner.depth

    @property
    def oldest_ts(self):
        return self.inner.oldest_ts

    @property
    def counters(self):
        return self.inner.counters

    @property
    def cache(self):
        return self.inner.cache

    def submit(self, wire_bytes):
        self.sched.point("native", "queue")
        return self.inner.submit(wire_bytes)

    def drain(self, max_records=None):
        self.sched.point("native", "queue")
        return self.inner.drain(max_records)


class _PaddedBatch:
    """What the pre-review-fix drain produced under shrinkage: a batch
    CLAIMING n0 records while holding fewer real ones (the tail rows
    were uninitialized memory)."""

    def __init__(self, cols, claimed: int):
        self.cols = cols
        self.claimed = claimed

    def __len__(self) -> int:
        return self.claimed


class _ShrinkDrainQueue(_NativeQueue):
    """[mutant: native_drain_shrink] a drain whose batch is sized
    from an UNLOCKED depth read BEFORE the native call
    instead of from the native return value.  A concurrent drain (the
    handle's documented contract — the dispatch loop racing a raw
    drainer) shrinks the queue inside the GIL-release gap, so the
    claimed size exceeds the records actually drained: rows past the
    real count are uninitialized np.empty memory (phantom votes)."""

    def drain(self, max_records=None):
        self.sched.point("native", "queue")
        n0 = self.inner.depth if max_records is None else min(
            self.inner.depth, int(max_records))
        if n0 <= 0:
            return None
        self.sched.point("native", "queue")   # the GIL-release gap
        cols = self.inner.drain(n0)
        actual = 0 if cols is None else len(cols)
        if actual == n0:
            return cols
        return _PaddedBatch(cols, n0)


class _ShardedQueue:
    """The sharded native handle, modeled: N REAL
    AdmissionQueues (capacity split evenly, home shard =
    instance // L — the C side's HostPlan-style routing) behind the
    single-queue duck surface.  The HONEST submit is ONE announced
    native span: route + per-shard fan-out inside one quantum, which
    is exactly what the real handle's whole-call GIL release gives.
    The model checks CONSERVATION across the fan-in (`records_in`
    below is the accounting boundary every record crosses before
    routing); byte-level merge determinism is the conformance
    differential's job (tests/test_native_admission.py), not this
    checker's."""

    native = True

    def __init__(self, inners: List[AdmissionQueue],
                 sched: Scheduler, instances_per_shard: int):
        self.shards = inners
        self.sched = sched
        self.L = instances_per_shard
        self.records_in = 0          # records handed to the fan-in

    @property
    def depth(self):
        return sum(q.depth for q in self.shards)

    @property
    def oldest_ts(self):
        live = [t for t in (q.oldest_ts for q in self.shards)
                if t is not None]
        return min(live) if live else None

    @property
    def counters(self):
        out: Dict[str, int] = {}
        for q in self.shards:
            for k, v in q.counters.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def cache(self):
        return self.shards[0].cache

    def _route(self, raw: bytes) -> List[bytearray]:
        """Per-shard byte groups, ascending-shard order preserved
        within each group (the real fan-in's arrival order)."""
        groups = [bytearray() for _ in self.shards]
        for k in range(len(raw) // REC_SIZE):
            rec = raw[k * REC_SIZE:(k + 1) * REC_SIZE]
            inst = int.from_bytes(rec[0:4], "little")
            s = min(inst // self.L, len(self.shards) - 1)
            groups[s] += rec
        return groups

    def _fan_out(self, groups) -> AdmitResult:
        rs = [self.shards[s].submit(bytes(g))
              for s, g in enumerate(groups) if g]
        if not rs:
            return AdmitResult(0, 0, 0, 0, 0, 0)
        return AdmitResult(*(sum(f) for f in zip(*rs)))

    def submit(self, wire_bytes):
        raw = wire_bytes if isinstance(wire_bytes, bytes) \
            else bytes(wire_bytes)
        self.records_in += len(raw) // REC_SIZE
        self.sched.point("native", "queue")   # ONE atomic native span
        return self._fan_out(self._route(raw))

    def drain(self, max_records=None):
        self.sched.point("native", "queue")
        for q in self.shards:
            b = q.drain(max_records)
            if b is not None:
                return b
        return None


class _LostRouteShards(_ShardedQueue):
    """[mutant: shard_route_lost] a fan-in whose routing scratch
    lives on the HANDLE (one shared buffer, not a
    stack-local) and whose fan-out runs as a SECOND native span.  Two
    concurrent submits: B preempts A inside the gap, routes into the
    shared scratch and consumes it; A resumes to a consumed scratch
    (its records never reach any shard) — or A fans out B's groups
    and B finds the scratch consumed (B's records lost instead).
    Either interleaving breaks fan-in conservation: records_in !=
    the summed per-shard `submitted` counters."""

    _scratch: Optional[List[bytearray]] = None

    def submit(self, wire_bytes):
        raw = wire_bytes if isinstance(wire_bytes, bytes) \
            else bytes(wire_bytes)
        self.records_in += len(raw) // REC_SIZE
        self.sched.point("native", "queue")   # span 1: route
        self._scratch = self._route(raw)
        self.sched.point("native", "queue")   # span 2: fan-out (gap!)
        groups, self._scratch = self._scratch, None
        if groups is None:                    # consumed by the racer
            return AdmitResult(0, 0, 0, 0, 0, 0)
        return self._fan_out(groups)


class _ToctouInbox(Inbox):
    """[mutant: inbox_close_toctou] Inbox.put with closed/capacity
    checked OUTSIDE the mutex.  The unlocked reads are announced as
    'read' points on the guarded 'inbox' resource — preempt the
    producer between check and append while drain closes + flushes,
    and an accepted blob lands AFTER the final flush (lost work)."""

    def __init__(self, capacity: int, sched: Scheduler):
        super().__init__(capacity)
        self._sched = sched

    def put(self, blob) -> bool:
        self._sched.point("read", "inbox")      # unlocked closed-check
        if self.closed or len(self._q) >= self.capacity:
            with self._mu:
                self.dropped += 1
            return False
        with self._mu:
            self._q.append(blob)
            self.enqueued += 1
            self._not_empty.notify()
        return True


class _NoInflightHost(ThreadedVoteService):
    """[mutant: busy_frac_inflight] busy-frac windows that read
    the completed totals only (no in-flight attribution)
    and publish the raw ratio (no clamp) — a span completing just
    after a sample lands whole in the next short window and the gauge
    reads busy_frac > 1."""

    def sample_busy_gauges(self, now=None) -> None:
        m = self.service.metrics
        with self._busy_mu:
            now = self._clock() if now is None else now
            t0 = self._busy_sample["t"]
            if t0 is None:
                self._busy_sample["t"] = now
                for name in ("submit", "dispatch"):
                    self._busy_sample[name] = self._busy_totals[name]
                return
            dt = now - t0
            if dt <= 0:
                return
            for name, gauge in (("submit", SERVE_SUBMIT_BUSY_FRAC),
                                ("dispatch", SERVE_DISPATCH_BUSY_FRAC)):
                observed = self._busy_totals[name]     # in-flight lost
                m.gauge(gauge,
                        (observed - self._busy_sample[name]) / dt)
                self._busy_sample[name] = observed
            self._busy_sample["t"] = now


# ---------------------------------------------------------------------------
# Scenario configs + system assembly
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SchedConfig:
    name: str
    producers: int = 1
    blobs: int = 1                  # per producer
    records: int = 2                # per blob
    polls: int = 0                  # driver poll_decisions calls
    #: blobs the driver submits BEFORE start() — work already inboxed
    #: when the loops wake, so drain-phase races need no producer
    #: interleaving (keeps the shrink mutant reachable at bound 1)
    preload: int = 0
    #: extra threads calling queue.drain() directly, racing the
    #: dispatch loop — the native handle's documented concurrent-
    #: drain contract ("the queue may shrink between the two under
    #: concurrent drains"), same topology as the TSan stress harness
    raw_drainers: int = 0
    drain_calls: int = 2            # per raw drainer
    drain_records: int = 3          # max_records per raw drain call
    #: extra threads calling queue.submit() directly, racing each
    #: other and the submit loop — the sharded handle's
    #: documented contract (N socket threads through one fan-in, no
    #: shared mutex); the Python queue's contract is the admission
    #: lock, so this too requires native=True
    raw_submitters: int = 0
    submit_blobs: int = 1           # per raw submitter
    instances: int = 2
    capacity: int = 64
    inbox_capacity: int = 8
    target_votes: int = 4
    native: bool = False
    #: >1 models the sharded native handle (_ShardedQueue):
    #: N real AdmissionQueues behind one fan-in; requires native=True
    #: and instances % native_shards == 0
    native_shards: int = 1
    drop_oldest: bool = False
    cache: bool = False
    gauge_interval_s: float = 1e9   # huge: no clock-value branching
    tick_s: float = 0.02
    clock_dep: bool = False         # 'clock' reads become dependent
    preemption_bound: int = 2
    max_steps: int = 20000


@dataclass
class _System:
    tsvc: ThreadedVoteService
    svc: _SchedService
    inner_queue: AdmissionQueue
    state: lockcheck.LockOrderState
    accepted: int = 0
    raw_drained: List[int] = field(default_factory=list)


def _blob(cfg: SchedConfig, salt: int) -> bytes:
    n = cfg.records
    idx = np.arange(n, dtype=np.int64)
    return pack_wire_votes(
        (idx + salt) % cfg.instances,        # spread across instances
        (idx + 7 * salt) % 1024,             # distinct validators
        np.zeros(n, np.int64),               # height 0
        np.zeros(n, np.int64),               # round 0
        np.ones(n, np.int64),                # precommit
        np.full(n, 5, np.int64))             # value


def _instrument(tsvc: ThreadedVoteService, sched: Scheduler
                ) -> lockcheck.LockOrderState:
    """Swap every LOCK_REGISTRY lock for a SchedLock (the generalized
    InstrumentedLock seam), plus the structures the registry does not
    cover: the inbox mutex + condition, the busy-sample mutex, and the
    stop event (a progress edge)."""
    state = lockcheck.instrument(
        tsvc, strict=False,
        lock_factory=lambda name, rank, st, strict:
            SchedLock(sched, name, rank, st))
    mu = SchedLock(sched, "inbox._mu", 2, state, resource="inbox")
    tsvc.inbox._mu = mu
    tsvc.inbox._not_empty = SchedCondition(sched, mu, "inbox")
    sched.register_guard("inbox", mu)
    tsvc._busy_mu = SchedLock(sched, "_busy_mu", 2, state)
    tsvc._stop = _SchedEvent(sched)
    return state


class _PlainTick:
    """Non-yielding logical clock for the queue INSIDE a native shim:
    the real native call is one GIL-releasing span, so its internal
    clock read must not be a Python-visible yield point — the shim's
    'native' announce IS the call's one scheduling boundary."""

    def __init__(self, tick_s: float):
        self.tick_s = tick_s
        self.t = 0.0

    def __call__(self) -> float:
        self.t += self.tick_s
        return self.t


def _build(cfg: SchedConfig, sched: Scheduler,
           mutant: Optional[str] = None) -> _System:
    clk = SchedClock(sched, cfg.tick_s,
                     "clock" if cfg.clock_dep else None)
    metrics = Metrics()
    cache = VerifiedCache(max_bytes=1 << 16) if cfg.cache else None
    policy = DROP_OLDEST if cfg.drop_oldest else REJECT_NEWEST
    if cfg.native and cfg.native_shards > 1:
        per_cap = cfg.capacity // cfg.native_shards
        inners = [AdmissionQueue(cfg.instances, per_cap,
                                 policy=policy, cache=cache,
                                 clock=_PlainTick(cfg.tick_s))
                  for _ in range(cfg.native_shards)]
        shim = (_LostRouteShards if mutant == "shard_route_lost"
                else _ShardedQueue)
        # the sharded handle IS the terminal-state authority: its
        # summed counters feed the digest + conservation monitors
        queue = inner = shim(inners, sched,
                             cfg.instances // cfg.native_shards)
    else:
        inner = AdmissionQueue(
            cfg.instances, cfg.capacity, policy=policy, cache=cache,
            clock=_PlainTick(cfg.tick_s) if cfg.native else clk)
        queue = inner
        if cfg.native:
            shim = (_ShrinkDrainQueue if mutant == "native_drain_shrink"
                    else _NativeQueue)
            queue = shim(inner, sched)
    micro = MicroBatcher(queue, ShapeLadder(rungs=(cfg.target_votes,)),
                         target_votes=cfg.target_votes,
                         max_delay_s=0.0, clock=clk)
    svc = _SchedService(queue, micro, metrics, sched)
    host = (_NoInflightHost if mutant == "busy_frac_inflight"
            else ThreadedVoteService)
    tsvc = host(svc, inbox_capacity=cfg.inbox_capacity,
                idle_wait_s=0.001,
                gauge_interval_s=cfg.gauge_interval_s, clock=clk,
                thread_factory=sched.thread_factory, sleep=sched.sleep)
    if mutant == "inbox_close_toctou":
        tsvc.inbox = _ToctouInbox(cfg.inbox_capacity, sched)
    state = _instrument(tsvc, sched)
    sys_ = _System(tsvc=tsvc, svc=svc, inner_queue=inner, state=state)

    # gauge-sanity monitor: busy fractions are fractions
    orig_gauge = metrics.gauge

    def gauge(name, value, _orig=orig_gauge):
        if name in (SERVE_SUBMIT_BUSY_FRAC, SERVE_DISPATCH_BUSY_FRAC) \
                and value > 1.0 + 1e-9:
            sched.record_violation(
                "busy_frac", f"{name} = {value:.3f} > 1.0")
        _orig(name, value)

    metrics.gauge = gauge
    return sys_


def run_once(cfg: SchedConfig, mutant: Optional[str] = None,
             forced: Sequence[int] = ()) -> RunResult:
    """ONE complete execution of the scenario under a (possibly
    forced-prefix) schedule, with all monitors."""
    if cfg.raw_drainers and not cfg.native:
        raise ValueError(
            "raw_drainers requires native=True: only the internally-"
            "synchronized native handle documents concurrent drains; "
            "the Python queue's contract is the _admission lock")
    if cfg.raw_submitters and not cfg.native:
        raise ValueError(
            "raw_submitters requires native=True: only the "
            "internally-synchronized native handle documents "
            "concurrent submits (the shard fan-in); the Python "
            "queue's contract is the _admission lock")
    if cfg.native_shards > 1 and (
            not cfg.native or cfg.instances % cfg.native_shards
            or cfg.capacity % cfg.native_shards):
        raise ValueError(
            "native_shards > 1 requires native=True and instances/"
            "capacity divisible by the shard count (the real handle's "
            "fail-closed construction screens)")
    sched = Scheduler(forced=forced,
                      preemption_bound=cfg.preemption_bound,
                      max_steps=cfg.max_steps)
    holder: List[_System] = []

    def driver():
        sys_ = _build(cfg, sched, mutant)
        holder.append(sys_)
        tsvc = sys_.tsvc
        for i in range(cfg.preload):
            if tsvc.submit(_blob(cfg, 101 * (i + 1))):
                sys_.accepted += 1
        tsvc.start()
        blobs = [_blob(cfg, 13 * p + b)
                 for p in range(cfg.producers)
                 for b in range(cfg.blobs)]

        def make(p: int):
            def produce():
                for b in range(cfg.blobs):
                    if tsvc.submit(blobs[p * cfg.blobs + b]):
                        sys_.accepted += 1
            return produce

        def make_submitter(i: int):
            def subloop():
                for b in range(cfg.submit_blobs):
                    sys_.svc.queue.submit(
                        _blob(cfg, 211 * (i + 1) + b))
            return subloop

        def make_drainer(i: int):
            def drainloop():
                total = 0
                for _ in range(cfg.drain_calls):
                    b = sys_.svc.queue.drain(cfg.drain_records)
                    if b is not None:
                        total += len(b)
                sys_.raw_drained.append(total)
            return drainloop

        prods = [sched.thread_factory(target=make(p),
                                      name=f"producer-{p}")
                 for p in range(cfg.producers)]
        prods += [sched.thread_factory(target=make_submitter(i),
                                       name=f"submitter-{i}")
                  for i in range(cfg.raw_submitters)]
        prods += [sched.thread_factory(target=make_drainer(i),
                                       name=f"drainer-{i}")
                  for i in range(cfg.raw_drainers)]
        for t in prods:
            t.start()
        for _ in range(cfg.polls):
            tsvc.poll_decisions()
        tsvc.drain(timeout_s=None)
        for t in prods:
            t.join()

    outcome = sched.run(driver)
    res = RunResult(choices=sched.choices, decisions=sched.decisions,
                    violations=sched.violations, trace=sched.trace,
                    steps=sched.steps, truncated=sched.truncated,
                    completed=outcome == "done")
    if holder and outcome == "done":
        sys_ = holder[0]
        inbox, svc, q = sys_.tsvc.inbox, sys_.svc, sys_.inner_queue
        if inbox.depth != 0:
            res.violations.append(Violation(
                "conservation",
                f"inbox residue after drain: depth={inbox.depth} "
                f"(an accepted blob was never admitted)", sched.steps))
        if inbox.enqueued != svc.blobs_submitted:
            res.violations.append(Violation(
                "conservation",
                f"enqueued {inbox.enqueued} != blobs admitted "
                f"{svc.blobs_submitted}", sched.steps))
        if sys_.accepted != inbox.enqueued:
            res.violations.append(Violation(
                "conservation",
                f"producer-accepted {sys_.accepted} != enqueued "
                f"{inbox.enqueued}", sched.steps))
        if isinstance(q, _ShardedQueue) \
                and q.records_in != q.counters["submitted"]:
            res.violations.append(Violation(
                "conservation",
                f"fan-in records {q.records_in} != sharded submitted "
                f"{q.counters['submitted']} (records lost or "
                f"duplicated in shard routing)", sched.steps))
        claimed = svc.votes_drained + sum(sys_.raw_drained)
        if claimed != q.counters["drained"]:
            res.violations.append(Violation(
                "conservation",
                f"claimed drained votes {claimed} != queue drained "
                f"counter {q.counters['drained']} (phantom/lost "
                f"records)", sched.steps))
        if sys_.state.violations:
            res.violations.append(Violation(
                "lock_order", "; ".join(sys_.state.violations),
                sched.steps))
    res.digest = _digest(holder[0] if holder else None, res)
    return res


def _digest(sys_: Optional[_System], res: RunResult) -> tuple:
    """Terminal-state digest (integer counters only — logical-clock
    values are schedule-relative by construction and must not split
    otherwise-equal states)."""
    if sys_ is None:
        return ("no-system",)
    q = sys_.inner_queue
    return (sys_.tsvc.inbox.enqueued, sys_.tsvc.inbox.dropped,
            sys_.tsvc.inbox.depth, sys_.svc.blobs_submitted,
            sys_.svc.votes_drained, sys_.accepted,
            tuple(sorted(q.counters.items())),
            tuple(sorted({v.kind for v in res.violations})))


# ---------------------------------------------------------------------------
# Exploration: preemption-bounded DFS with sleep-set pruning
# ---------------------------------------------------------------------------


def _indep(r1: Optional[str], r2: Optional[str]) -> bool:
    """Two pending operations commute iff their announced resources
    differ (each quantum performs exactly the one announced op on
    shared state — module docstring)."""
    return r1 is None or r2 is None or r1 != r2


@dataclass
class ExploreResult:
    schedules: int = 0
    violations: List[dict] = field(default_factory=list)
    digests: set = field(default_factory=set)
    truncated: int = 0
    complete: bool = True
    max_decisions: int = 0
    first_violating: Optional[RunResult] = None


def explore(cfg: SchedConfig, mutant: Optional[str] = None, *,
            sleep_sets: bool = True,
            max_schedules: Optional[int] = None,
            deadline_at: Optional[float] = None,
            stop_on_violation: bool = False) -> ExploreResult:
    """DFS over the schedule tree: each node is a forced choice
    prefix; one execution per node; children branch at every recorded
    decision past the prefix, bounded by the preemption budget and
    pruned by sleep sets (already-explored independent siblings)."""
    out = ExploreResult()
    stack: List[Tuple[List[int], frozenset]] = [([], frozenset())]
    while stack:
        if max_schedules is not None and out.schedules >= max_schedules:
            out.complete = False
            break
        if deadline_at is not None and time.time() > deadline_at:
            out.complete = False
            break
        prefix, sleep = stack.pop()
        res = run_once(cfg, mutant, forced=prefix)
        out.schedules += 1
        out.digests.add(res.digest)
        out.max_decisions = max(out.max_decisions, len(res.decisions))
        if res.truncated:
            out.truncated += 1
            out.complete = False
        for v in res.violations:
            out.violations.append(
                {"kind": v.kind, "detail": v.detail,
                 "schedule": list(res.choices)})
        if res.violations:
            if out.first_violating is None:
                out.first_violating = res
            if stop_on_violation:
                out.complete = False
                return out
        for i in range(len(prefix), len(res.decisions)):
            d = res.decisions[i]
            base_sleep = sleep if i == len(prefix) else frozenset()
            explored = [d.chosen]
            for alt in d.enabled:
                if alt == d.chosen or alt in base_sleep:
                    continue
                extra = 1 if (d.running in d.enabled
                              and alt != d.running) else 0
                if d.preempts_before + extra > cfg.preemption_bound:
                    continue
                child_sleep = frozenset(
                    b for b in explored
                    if sleep_sets and _indep(d.pending.get(b),
                                             d.pending.get(alt)))
                stack.append((res.choices[:i] + [alt], child_sleep))
                explored.append(alt)
    return out


# ---------------------------------------------------------------------------
# Mutants: shipped (or review-caught) races, resurrected
# ---------------------------------------------------------------------------

#: name -> (config, expected violation kinds, description)
MUTANTS: Dict[str, Tuple[SchedConfig, Tuple[str, ...], str]] = {
    "inbox_close_toctou": (
        SchedConfig("mut_toctou", producers=1, blobs=2, records=2,
                    polls=0, preemption_bound=2),
        ("conservation", "atomicity"),
        "Inbox.put checked closed/capacity outside _mu — a "
        "blob accepted after close() lands after the final drain "
        "flush (lost work)"),
    "native_drain_shrink": (
        SchedConfig("mut_shrink", producers=0, preload=1, records=3,
                    native=True, drop_oldest=True, raw_drainers=1,
                    drain_calls=1, drain_records=3,
                    polls=0, preemption_bound=2),
        ("conservation",),
        "drain sized batches from an unlocked "
        "pre-call depth read; a concurrent drain shrinks the queue "
        "inside the GIL-release gap -> phantom uninitialized rows"),
    "shard_route_lost": (
        SchedConfig("mut_shard_route", producers=0, records=2,
                    native=True, native_shards=2, raw_submitters=2,
                    polls=0, preemption_bound=2),
        ("conservation",),
        "fan-in whose routing scratch lived on the "
        "shard-group handle (shared) and the fan-out ran as a second "
        "native span — a concurrent submit clobbers/consumes the "
        "route inside the gap and records never reach any shard"),
    "busy_frac_inflight": (
        SchedConfig("mut_busy", producers=1, blobs=2, records=2,
                    polls=4, gauge_interval_s=0.02, clock_dep=True,
                    preemption_bound=2, max_steps=40000),
        ("busy_frac",),
        "busy-frac windows without in-flight "
        "attribution or clamp — a span completing right after a "
        "sample lands whole in one short window (busy_frac > 1)"),
}


def self_test(deadline_at: Optional[float] = None) -> dict:
    """Prove the checker bites: every mutant caught, its schedule
    ddmin-minimized, and the minimized schedule replaying CLEAN on
    the honest build."""
    import dataclasses

    report = {}
    for name, (cfg, kinds, _desc) in MUTANTS.items():
        # CHESS iterative bounding: most races need ONE preemption, so
        # exhausting bound b before b+1 finds them orders of magnitude
        # sooner than diving straight into the bound-2 tree
        total = 0
        found = None
        for b in range(cfg.preemption_bound + 1):
            found = explore(
                dataclasses.replace(cfg, preemption_bound=b),
                mutant=name, stop_on_violation=True,
                max_schedules=50000, deadline_at=deadline_at)
            total += found.schedules
            if found.first_violating is not None:
                break
        rec = {"caught": found.first_violating is not None,
               "schedules_to_find": total,
               "preemption_bound": b}
        if found.first_violating is not None:
            res = found.first_violating
            rec["kinds"] = sorted({v.kind for v in res.violations})

            def pred(acts, _cfg=cfg, _name=name, _kinds=kinds):
                r = run_once(_cfg, _name, forced=acts)
                return any(v.kind in _kinds for v in r.violations)

            minimized = (_ddmin(list(res.choices), pred)
                         if res.choices and pred(list(res.choices))
                         else list(res.choices))
            honest = run_once(cfg, None, forced=minimized)
            rec["schedule_len"] = len(res.choices)
            rec["minimized_len"] = len(minimized)
            rec["minimized"] = minimized
            rec["honest_clean"] = not honest.violations
        report[name] = rec
    report["ok"] = all(
        r.get("caught") and r.get("honest_clean")
        for n, r in report.items() if n != "ok")
    return report


# ---------------------------------------------------------------------------
# Atomic-annotation cross-check
# ---------------------------------------------------------------------------


def check_atomic_annotations(repo_root: str) -> List[str]:
    """Source `# schedcheck: atomic` markers and the ATOMIC_SPANS
    registry must agree exactly (both directions) — returns problem
    strings, empty when consistent."""
    import ast
    import os

    problems: List[str] = []
    by_file: Dict[str, set] = {}
    for (rel, func), _res in ATOMIC_SPANS.items():
        by_file.setdefault(rel, set()).add(func)
    for rel, funcs in sorted(by_file.items()):
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            problems.append(f"{rel}: registered in ATOMIC_SPANS but "
                            f"file is gone")
            continue
        with open(path) as fh:
            src = fh.read()
        marker_lines = [i + 1 for i, line in
                        enumerate(src.splitlines())
                        if ATOMIC_MARKER in line]
        spans = {}      # qualified function -> (lo, hi)
        tree = ast.parse(src)

        def walk(node, prefix=""):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = prefix + child.name
                    spans[q] = (child.lineno, child.end_lineno)
                    walk(child, q + ".")
                elif isinstance(child, ast.ClassDef):
                    walk(child, prefix + child.name + ".")

        walk(tree)
        marked = set()
        for ln in marker_lines:
            hits = [q for q, (lo, hi) in spans.items()
                    if lo <= ln <= hi]
            if not hits:
                problems.append(f"{rel}:{ln}: marker outside any "
                                f"function")
                continue
            marked.add(max(hits, key=lambda q: spans[q][0]))
        if marked != funcs:
            for q in sorted(funcs - marked):
                problems.append(
                    f"{rel}: ATOMIC_SPANS lists {q} but no "
                    f"'{ATOMIC_MARKER}' marker in it")
            for q in sorted(marked - funcs):
                problems.append(
                    f"{rel}: '{ATOMIC_MARKER}' marker in {q} not "
                    f"registered in ATOMIC_SPANS")
    return problems


# ---------------------------------------------------------------------------
# Scopes + CLI
# ---------------------------------------------------------------------------

SCOPES: Dict[str, List[SchedConfig]] = {
    "tiny": [
        SchedConfig("tiny", producers=1, blobs=1, records=2, polls=0),
    ],
    "smoke": [
        # polls=0 keeps the two-producer envelope exhaustible (~27k
        # schedules); poll_decisions interleavings are exercised by
        # the busy_frac mutant drill (polls=4) in the self-test
        SchedConfig("smoke_base", producers=2, blobs=1, records=2,
                    polls=0),
        SchedConfig("smoke_native", producers=2, blobs=1, records=3,
                    capacity=4, native=True, drop_oldest=True),
        SchedConfig("smoke_cache", producers=1, blobs=2, records=2,
                    cache=True),
    ],
}


def run_scope(scope: str, *, sleep_sets: bool = True,
              max_schedules: Optional[int] = None,
              deadline_at: Optional[float] = None) -> dict:
    t0 = time.perf_counter()
    configs = {}
    total = 0
    viol = 0
    complete = True
    for cfg in SCOPES[scope]:
        r = explore(cfg, sleep_sets=sleep_sets,
                    max_schedules=max_schedules,
                    deadline_at=deadline_at)
        configs[cfg.name] = {
            "schedules": r.schedules,
            "distinct_states": len(r.digests),
            "violations": r.violations,
            "truncated_runs": r.truncated,
            "max_decisions": r.max_decisions,
            "complete": r.complete,
        }
        total += r.schedules
        viol += len(r.violations)
        complete = complete and r.complete
    return {
        "scope": scope,
        "schedules_explored": total,
        "violations": viol,
        "complete": complete,
        "configs": configs,
        "seconds": round(time.perf_counter() - t0, 1),
        "ok": viol == 0,
    }


def main(argv: Optional[List[str]] = None) -> int:
    """CLI (`python -m agnes_tpu_torch.analysis.schedcheck`).  Pure
    CPU, no device work; honors the enclosing timeout budget
    (utils/budget.Deadline discovery) so a gate
    always gets a parseable record — complete=False is the sentinel
    half of the real-value-or-sentinel contract."""
    import argparse

    from agnes_tpu_torch.utils.budget import Deadline

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scope", default="smoke",
                    choices=sorted(SCOPES),
                    help="bounded exploration envelope")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--self-test", action="store_true",
                    help="mutant catch + ddmin + honest-replay suite")
    ap.add_argument("--no-sleep-sets", action="store_true",
                    help="disable sleep-set pruning (debug aid)")
    ap.add_argument("--max-schedules", type=int, default=None)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="wall budget; default: discovered from "
                         "AGNES_SCHEDCHECK_DEADLINE_S or the "
                         "enclosing `timeout N`")
    args = ap.parse_args(argv)

    if args.deadline_s is not None:
        deadline = Deadline.after(args.deadline_s)
    else:
        deadline = Deadline.discover(
            env_var="AGNES_SCHEDCHECK_DEADLINE_S")
    rem = deadline.remaining()
    deadline_at = None if deadline.at is None \
        else time.time() + max(1.0, rem - min(20.0, rem * 0.2))

    t0 = time.perf_counter()
    if args.self_test:
        report = self_test(deadline_at=deadline_at)
        report["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(report, sort_keys=True), flush=True)
        return 0 if report["ok"] else 1

    report = run_scope(args.scope,
                       sleep_sets=not args.no_sleep_sets,
                       max_schedules=args.max_schedules,
                       deadline_at=deadline_at)
    report["metrics"] = {
        SCHEDCHECK_SCHEDULES_EXPLORED: report["schedules_explored"],
        SCHEDCHECK_VIOLATIONS: report["violations"],
    }
    report["deadline"] = {"source": deadline.source,
                          "budget_s": None if rem == float("inf")
                          else round(rem, 1)}
    if not args.json:
        for name, r in report["configs"].items():
            status = "EXHAUSTED" if r["complete"] else "partial"
            print(f"[agnes_schedcheck] {name}: {r['schedules']} "
                  f"schedules / {r['distinct_states']} states "
                  f"{status}, {len(r['violations'])} violation(s)",
                  flush=True)
    print(json.dumps(report, sort_keys=True), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
