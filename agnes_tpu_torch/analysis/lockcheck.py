"""Serve lock order at run time (the runtime half of the twin's
`agnes_tpu.analysis.lockcheck`).

serve/threaded.py keeps `submit` wait-free relative to the step in
flight by a lock discipline: the admission lock before the device lock,
never the other way round, and every acquisition a ``with`` block.
`InstrumentedLock` wraps a lock with a per-thread held stack that checks
that order on every real acquisition, and `instrument()` swaps a
ThreadedVoteService's locks for instrumented ones, so the threaded tests
run their concurrency scenarios over the discipline itself.

Not ported yet: the twin's static half, the AST passes LOCK001-005 over
the serve code (they report through the JAX package's
`jaxpr_audit.Finding`); they come with the analyzers (ROADMAP §1 item
7b-ii).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Tuple


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
    is a violation — recorded, and raised when `strict`."""

    def __init__(self, name: str, rank: int, state: LockOrderState,
                 strict: bool = True):
        self.name = name
        self.rank = rank
        self.state = state
        self.strict = strict
        self._lock = threading.Lock()

    def __enter__(self):
        held = self.state.stack()
        bad = [n for n, r in held if r >= self.rank]
        if bad:
            msg = (f"lock order violation: acquiring {self.name!r} "
                   f"(rank {self.rank}) while holding {bad}")
            with self.state._mu:
                self.state.violations.append(msg)
            if self.strict:
                raise AssertionError(msg)
        self._lock.acquire()
        held.append((self.name, self.rank))
        with self.state._mu:
            self.state.acquisitions += 1
        return self

    def __exit__(self, *exc):
        self.state.stack().remove((self.name, self.rank))
        self._lock.release()
        return False

    # the bare-call API stays available for foreign code, but counts as
    # a violation: every acquisition must be a `with` block
    def acquire(self, *a, **kw):
        with self.state._mu:
            self.state.violations.append(
                f"bare acquire() on {self.name!r}")
        return self._lock.acquire(*a, **kw)

    def release(self):
        return self._lock.release()


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
#: mutexes sit below all of these and are never held across a return
#: to Python.
LOCK_REGISTRY: Tuple = (
    ("_admission", 0, lambda t: (t, "_admission")),
    ("_device", 1, lambda t: (t, "_device")),
    ("cache._mu", 2, _leaf("service", "queue", "cache")),
    ("bls_table._mu", 2, _leaf("service", "queue", "bls_table")),
    ("flightrec._mu", 2, _leaf("service", "flightrec")),
)


def instrument(threaded_service, strict: bool = True) -> LockOrderState:
    """Swap a ThreadedVoteService's locks (every LOCK_REGISTRY entry
    that resolves on this deployment) for instrumented ones, BEFORE
    start(); returns the shared order state a test asserts on."""
    state = LockOrderState()
    for name, rank, resolve in LOCK_REGISTRY:
        target = resolve(threaded_service)
        if target is None:
            continue
        holder, attr = target
        setattr(holder, attr, InstrumentedLock(name, rank, state, strict))
    return state
