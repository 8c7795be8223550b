"""Serve lock order: the threaded host's two-lock discipline, checked
at the AST, plus a runtime instrumented-lock mode for tests (twin of
`agnes_tpu.analysis.lockcheck`).

serve/threaded.py keeps `submit` wait-free relative to the step in
flight by a lock discipline no test sees break until it deadlocks or
stalls:

  LOCK001  bare ``.acquire()`` / ``.release()``: an exception between
           the two leaks the lock; every acquisition must be a
           ``with`` block
  LOCK002  inconsistent order: the admission lock acquired while the
           device lock is held; the global order is admission ->
           device
  LOCK003  the admission lock held across device work (a
           DISPATCH_CALLS call): every producer waits for its whole
           span
  LOCK004  the admission lock held across a device-lock acquisition:
           even in order, submit then waits behind device work
  LOCK005  a native C call (``ag_*``) under the admission lock: ctypes
           releases the GIL for the call's whole span, so a Python
           lock held across it blocks every thread that wants it; the
           native handles carry their own mutexes, so the host elides
           the lock.  In the port the CUDA kernels' C entries are
           ``ag_*`` symbols too, so the rule covers the kernel launches
           as well.  Paired with lint's LINT004, which keeps every
           ``ag_*`` call inside the audited wrapper modules.

DISPATCH_CALLS, the calls LOCK003 forbids under the admission lock,
name the port's own device work: the driver's `step`, `step_seq`,
`step_seq_signed`, `step_seq_signed_dense`, `step_async`,
`run_heights_fused`, `collect` and `block_until_ready` (in the port a
DeviceDriver method: collect, then torch.cuda.synchronize), the serve
plane's `pump`, `_pump_batch`, `dispatch_staged`, `settle`, `warmup`,
`drain` and `poll_decisions`, and `synchronize` (torch.cuda's, a
stream's or an event's).  The twin's `device_put` has no port
counterpart: the port uploads with `.to(device)`, which is also every
host-side dtype cast's name, so it is not listed.

Suppressions are explicit and greppable: a ``# lockcheck: allow``
comment on the line (reason after the marker).  The one sanctioned
hold is ThreadedVoteService.drain's quiescent section: both loop
threads are joined before it runs, so holding both locks is
deliberate.

Runtime mode: `InstrumentedLock` wraps a lock with a per-thread held
stack that checks the same order on every real acquisition, and
`instrument()` swaps a ThreadedVoteService's locks for instrumented
ones, so the threaded tests run their concurrency scenarios over the
discipline itself.  Its acquire / release route through the
`_raw_acquire` / `_raw_release` / `_sched_point` hooks, which the
schedule checker (analysis/schedcheck.py) overrides to make every
acquisition an explorable yield point.
"""

from __future__ import annotations

import ast
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from agnes_tpu_torch.analysis.findings import Finding

#: attribute names of the two serve locks
ADMISSION_LOCKS = frozenset({"_admission"})
DEVICE_LOCKS = frozenset({"_device"})

#: attribute calls that are (or directly wrap) device work — forbidden
#: under the admission lock (module docstring lists them)
DISPATCH_CALLS = frozenset({
    "step", "step_seq", "step_seq_signed", "step_seq_signed_dense",
    "step_async", "run_heights_fused", "pump", "_pump_batch",
    "dispatch_staged", "settle", "collect", "block_until_ready",
    "warmup", "drain", "poll_decisions", "synchronize",
})

PRAGMA = "lockcheck: allow"

#: the C symbol prefix of the native host core (core/native/*.cpp) and
#: of the CUDA kernels' C entries (csrc/*.cu): a call on an attribute
#: with this prefix is a GIL-releasing ctypes call — LOCK005 forbids
#: it under the admission lock, as lint's LINT004 pairs it
NATIVE_CAPI_PREFIXES = ("ag_",)


def _lock_name(node) -> Optional[str]:
    """The lock attribute acquired by a with-item expression, if any."""
    if isinstance(node, ast.Attribute) and \
            node.attr in (ADMISSION_LOCKS | DEVICE_LOCKS):
        return node.attr
    return None


def _has_pragma(source_lines, lineno: int) -> bool:
    line = source_lines[lineno - 1] if lineno - 1 < len(source_lines) \
        else ""
    return PRAGMA in line


class _LockVisitor(ast.NodeVisitor):
    def __init__(self, filename: str, source: str):
        self.filename = filename
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self.held: List[str] = []          # lock attrs held, outer first

    def _find(self, code: str, node, msg: str) -> None:
        self.findings.append(Finding(
            "locks", code, f"{self.filename}:{node.lineno}", msg))

    # -- bare acquire/release ------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("acquire",
                                                       "release"):
            if not _has_pragma(self.lines, node.lineno):
                self._find(
                    "LOCK001", node,
                    f"bare .{f.attr}() — an exception between acquire "
                    f"and release leaks the lock; use a `with` block")
        self._check_dispatch(node)
        self._check_native(node)
        self.generic_visit(node)

    def _check_native(self, node: ast.Call) -> None:
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr.startswith(NATIVE_CAPI_PREFIXES)):
            return
        if any(h in ADMISSION_LOCKS for h in self.held) \
                and not _has_pragma(self.lines, node.lineno):
            self._find(
                "LOCK005", node,
                f".{f.attr}() under the admission lock — the ctypes "
                f"call releases the GIL for its whole span, so every "
                f"thread contending this lock blocks for the full "
                f"native call; the handle has its own mutex, elide "
                f"the Python lock (serve/threaded.py)")

    def _check_dispatch(self, node: ast.Call) -> None:
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in DISPATCH_CALLS):
            return
        admission_held = any(h in ADMISSION_LOCKS for h in self.held)
        device_held = any(h in DEVICE_LOCKS for h in self.held)
        if admission_held and not device_held \
                and not _has_pragma(self.lines, node.lineno):
            self._find(
                "LOCK003", node,
                f".{f.attr}() under the admission lock — device "
                f"work here blocks every producer for its whole "
                f"duration (move it under the device lock; see "
                f"VoteService._close_batch/_pump_batch)")

    # -- with blocks ---------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired = [n for n in
                    (_lock_name(item.context_expr)
                     for item in node.items) if n]
        allow = _has_pragma(self.lines, node.lineno)
        pushed = 0
        for name in acquired:
            if not allow:
                self._order_check(name, node)
            self.held.append(name)
            pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - pushed:]

    def _order_check(self, name: str, node) -> None:
        admission_held = any(h in ADMISSION_LOCKS for h in self.held)
        if name in ADMISSION_LOCKS and \
                any(h in DEVICE_LOCKS for h in self.held):
            self._find(
                "LOCK002", node,
                "admission lock acquired while holding the device "
                "lock — inverts the global admission -> device order "
                "(deadlock with any in-order path)")
        if name in DEVICE_LOCKS and admission_held:
            self._find(
                "LOCK004", node,
                "device lock acquired while holding the admission "
                "lock — submit serializes behind device work for the "
                "whole wait (quiescent shutdown sections may annotate "
                f"`# {PRAGMA} (reason)`)")


def check_source(source: str, filename: str = "<string>"
                 ) -> List[Finding]:
    tree = ast.parse(source, filename=filename)
    v = _LockVisitor(filename, source)
    v.visit(tree)
    return v.findings


def check_paths(paths) -> List[Finding]:
    """Lint every .py file under the given files/directories."""
    import os

    findings: List[Finding] = []
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in names
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    for fpath in sorted(files):
        with open(fpath, "r") as fh:
            src = fh.read()
        findings.extend(check_source(src, filename=fpath))
    return findings


def default_paths(repo_root: str) -> List[str]:
    """Every module of the port's package tree (lint.package_modules,
    the scan-root derivation every repo-wide pass shares), so a new
    threaded module is covered the moment the file exists.  The rules
    are scoped to the `_admission` / `_device` attribute names and
    honour the pragma, so the wide scan stays free of false
    positives."""
    import os

    from agnes_tpu_torch.analysis.lint import package_modules

    return [os.path.join(repo_root, rel)
            for rel in package_modules(repo_root)]


# -- runtime instrumented-lock mode -------------------------------------------

@dataclass
class LockOrderState:
    """Shared recorder for a set of InstrumentedLocks: per-thread held
    stack + violation log (thread-safe)."""

    violations: List[str] = field(default_factory=list)
    acquisitions: int = 0
    _tls: threading.local = field(default_factory=threading.local)
    _mu: threading.Lock = field(default_factory=threading.Lock)

    def stack(self) -> List[Tuple[str, int]]:
        if not hasattr(self._tls, "held"):
            self._tls.held = []
        return self._tls.held


class InstrumentedLock:
    """A threading.Lock that checks the global acquisition order at run
    time.  `rank` orders the locks (admission 0 < device 1 < the rank-2
    leaf mutexes); an acquisition while holding an equal-or-higher rank
    is a violation — recorded, and raised when `strict`.

    Acquire and release route through `_raw_acquire` / `_raw_release`
    and announce themselves through `_sched_point`: the schedule
    checker subclasses this lock to make every acquisition a
    serialized, explorable yield point while reusing the order
    bookkeeping below as it is.  All three hooks are trivial here."""

    def __init__(self, name: str, rank: int, state: LockOrderState,
                 strict: bool = True):
        self.name = name
        self.rank = rank
        self.state = state
        self.strict = strict
        self._lock = threading.Lock()

    # -- the schedule checker's hooks (overridden by SchedLock) ----------
    def _sched_point(self, event: str) -> None:
        """Called before acquire ('acquire') and after release
        ('release'); a no-op outside the schedule checker."""

    def _raw_acquire(self) -> None:
        self._lock.acquire()  # lockcheck: allow (the wrapper IS the with)

    def _raw_release(self) -> None:
        self._lock.release()  # lockcheck: allow (wrapper __exit__)

    # -- order bookkeeping (shared with SchedLock) -----------------------
    def _order_check(self) -> None:
        held = self.state.stack()
        bad = [n for n, r in held if r >= self.rank]
        if bad:
            msg = (f"lock order violation: acquiring {self.name!r} "
                   f"(rank {self.rank}) while holding {bad}")
            with self.state._mu:
                self.state.violations.append(msg)
            if self.strict:
                raise AssertionError(msg)

    def __enter__(self):
        self._order_check()
        self._sched_point("acquire")
        self._raw_acquire()
        self.state.stack().append((self.name, self.rank))
        with self.state._mu:
            self.state.acquisitions += 1
        return self

    def __exit__(self, *exc):
        self.state.stack().remove((self.name, self.rank))
        self._raw_release()
        self._sched_point("release")
        return False

    # the bare-call API stays available for foreign code, but counts as
    # a violation: LOCK001 made executable
    def acquire(self, *a, **kw):
        with self.state._mu:
            self.state.violations.append(
                f"bare acquire() on {self.name!r}")
        return self._lock.acquire(*a, **kw)  # lockcheck: allow (delegate)

    def release(self):
        return self._lock.release()  # lockcheck: allow (delegate)


#: `threading.Lock` is a factory function (not a type) on CPython —
#: the resolver's isinstance check needs the real lock type
_LOCK_TYPE = type(threading.Lock())


def _leaf(*path: str):
    """Resolver for a rank-2 leaf mutex at threaded_service.<path>._mu
    (getattr-safe: absent anywhere along the path means the deployment
    has no such lock and the registry entry is skipped)."""
    def resolve(t):
        obj = t
        for attr in path:
            obj = getattr(obj, attr, None)
            if obj is None:
                return None
        return (obj, "_mu") if isinstance(
            getattr(obj, "_mu", None), _LOCK_TYPE) else None
    return resolve


#: the instrumented lock set: (name, rank, resolver), where
#: resolver(threaded_service) returns the (holder, attribute) to swap, or
#: None when the deployment has no such lock (no cache, no BLS lane, no
#: flight recorder, a test stub).  The two serve locks keep their
#: admission (0) -> device (1) order; every leaf mutex, held for dict or
#: ring operations only, is rank 2: acquirable under anything, never
#: while holding another leaf.  The native admission handle's C++
#: mutexes sit below all of these (NATIVE_LOCK_ORDER).
LOCK_REGISTRY: Tuple = (
    ("_admission", 0, lambda t: (t, "_admission")),
    ("_device", 1, lambda t: (t, "_device")),
    ("cache._mu", 2, _leaf("service", "queue", "cache")),
    ("bls_table._mu", 2, _leaf("service", "queue", "bls_table")),
    ("flightrec._mu", 2, _leaf("service", "flightrec")),
)


#: the native side of the lock order: the C++ mutexes the sharded
#: admission front end (core/native/admission_shards.cpp) holds below
#: everything Python.  They live inside the handle and cannot be
#: swapped at run time, so this table is the documented contract that
#: the ThreadSanitizer stress harness (tests/native/
#: tsan_admission_stress.cpp) exercises.  Entries are (name, rank,
#: rule):
#:
#:   AdmQ::mu             per-shard leaf, one per shard; a group
#:                        operation that must hold several (the merged
#:                        drain, the export) takes them in ascending
#:                        shard order, all or nothing
#:   AdmShards::route_mu  the routing-table leaf (seq -> shard route for
#:                        mark_verified), never nested with any AdmQ::mu
#:                        in either direction
#:
#: Both sit strictly below the Python locks: every ag_adms_* entry
#: takes them inside one GIL-released span and returns with none held,
#: which is why LOCK005 can demand that the admission lock be elided.
NATIVE_LOCK_ORDER: Tuple = (
    ("AdmQ::mu", 2, "per-shard leaf; multi-shard holds ascending"),
    ("AdmShards::route_mu", 2, "routing leaf; never nested with mu"),
)


def instrument(threaded_service, strict: bool = True,
               lock_factory=None) -> LockOrderState:
    """Swap a ThreadedVoteService's locks (every LOCK_REGISTRY entry
    that resolves on this deployment) for instrumented ones, BEFORE
    start(); returns the shared order state a test asserts on.
    `lock_factory(name, rank, state, strict)` lets the schedule checker
    substitute its cooperative SchedLock while this registry stays the
    one source of the lock set."""
    factory = lock_factory or InstrumentedLock
    state = LockOrderState()
    for name, rank, resolve in LOCK_REGISTRY:
        target = resolve(threaded_service)
        if target is None:
            continue
        holder, attr = target
        setattr(holder, attr, factory(name, rank, state, strict))
    return state
