"""The "no unwarmed shape after warmup" tripwire (twin of
`agnes_tpu.analysis.retrace`).

Nothing in the port recompiles per shape, so the tripwire guards the
serve plane's shape contract rather than a compile cache: the ladder
fixes the set of (entry, shape) pairs a service may launch, warmup
launches each once, and an armed sentinel refuses anything else.

* Every dispatch computes a **signature**: the resolved statics plus
  (shape, dtype) of every tensor leaf of its arguments.  A signed
  dispatch's lanes are keyed on the smallest ladder rung that holds
  them (`RetraceSentinel.rungs`, set by the pipeline), not on their
  exact count: builds are not padded, since a padding lane would cost
  as much verify work as a real one.
* **Unarmed (learning)**: signatures are recorded as the expected set.
* **Armed**: `ServePipeline.warmup()` registers the warmed set, then
  arms the sentinel; any signature outside it raises `RetraceError` and
  counts `retrace_unexpected` (utils/metrics.py).

Opt-in: `DeviceDriver(..., audit=True)` installs the sentinel on every
dispatch path; `ServePipeline.warmup()` arms it when present.

The pure-host half, `warmup_covers()` and its finding form
`coverage_findings()` (RET001, the lint CLI's `retrace` pass), proves
statically that every shape the pipeline can dispatch (builds capped at
the top rung, lanes keyed on their rung, the entry phase prepended so P
is in {2, 3}; in dense mode one shape a phase count) is in the warmup
plan.  `observed_shapes()` reads the same (P, rung) shapes back off a
sentinel's observed signatures, so a run on the card can check that the
static proof covers what it really launched.  The twin's sharding key is
left out: the port's mesh places every step the same way, so there is
no second placement of one shape to key on.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple


class RetraceError(RuntimeError):
    """An unexpected dispatch signature reached a serve entry."""


def _leaves(tree, out: list) -> list:
    """Tensor / array leaves of nested tuples, lists and NamedTuples,
    in order; other leaves (ints, None) are kept as they are."""
    if isinstance(tree, (tuple, list)):
        for x in tree:
            _leaves(x, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(tree)
    return out


def signature(args, statics: Tuple = ()) -> Tuple:
    """Hashable signature of a dispatch: the statics and (shape, dtype)
    of each leaf of `args`."""
    return (tuple(statics),
            tuple((tuple(getattr(x, "shape", ())),
                   str(getattr(x, "dtype", type(x).__name__)))
                  for x in _leaves(args, [])))


def lane_signature(lanes, rung: int) -> Tuple:
    """The signature of a signed dispatch's lanes (SignedLanes) with
    the lane dimension read as `rung`: the lanes' trailing shapes and
    dtypes, and the rung."""
    return (int(rung),
            tuple((tuple(x.shape[1:]), str(x.dtype)) for x in lanes))


class RetraceSentinel:
    """Signature sentinel (module docstring).  Thread-safe."""

    def __init__(self, metrics=None, strict: bool = True):
        from agnes_tpu_torch.utils.metrics import Metrics

        self.metrics = metrics if metrics is not None else Metrics()
        self.strict = strict
        self.armed = False
        # the serve ladder's lane rungs (ascending); empty = exact counts
        self.rungs: Tuple[int, ...] = ()
        self.expected: Set[Tuple] = set()
        self.unexpected: List[Tuple] = []
        #: every (entry, signature) observed, armed or not
        self.seen: Set[Tuple] = set()
        self._observed: Dict[str, int] = {}
        self._lock = threading.Lock()

    def lane_key(self, n_lanes: int) -> int:
        """The rung a signed dispatch of `n_lanes` lanes is keyed on:
        the smallest of `rungs` holding it; the count itself without a
        ladder or above its top rung (never warmed, so it trips)."""
        for r in self.rungs:
            if n_lanes <= r:
                return r
        return int(n_lanes)

    def expect(self, entry: str, sig: Tuple) -> None:
        """Register one expected (entry, signature)."""
        with self._lock:
            self._expect_locked(entry, sig)

    def _expect_locked(self, entry: str, sig: Tuple) -> None:
        from agnes_tpu_torch.utils.metrics import ANALYSIS_ENTRIES_AUDITED

        if (entry, sig) not in self.expected:
            self.expected.add((entry, sig))
            self.metrics.count(ANALYSIS_ENTRIES_AUDITED)

    def observe(self, entry: str, sig: Tuple) -> None:
        """Record a dispatch signature; once armed, raise (and count
        `retrace_unexpected`) on any signature outside the expected
        set."""
        from agnes_tpu_torch.utils.metrics import RETRACE_UNEXPECTED

        with self._lock:
            self._observed[entry] = self._observed.get(entry, 0) + 1
            self.seen.add((entry, sig))
            if not self.armed:
                self._expect_locked(entry, sig)
                return
            if (entry, sig) not in self.expected:
                self.unexpected.append((entry, sig))
                self.metrics.count(RETRACE_UNEXPECTED)
                if self.strict:
                    raise RetraceError(
                        f"unexpected dispatch: entry {entry!r} with a "
                        f"signature outside the warmed set "
                        f"({len(self.expected)} expected) — an "
                        f"off-ladder shape or an unwarmed phase count")

    def arm(self) -> "RetraceSentinel":
        """Close the expected set."""
        with self._lock:
            self.armed = True
        return self

    def report(self) -> dict:
        with self._lock:
            return {
                "armed": self.armed,
                "entries_observed": dict(self._observed),
                "expected_signatures": len(self.expected),
                "unexpected": len(self.unexpected),
            }


# -- static warmup-coverage proof ---------------------------------------------

def dispatchable_shapes(ladder, dense: bool = False,
                        dedup: bool = False) -> Set[Tuple]:
    """Every (P, rung) shape the serve pipeline can dispatch on the
    signed path: builds are capped at the top rung and keyed on the rung
    that holds them, and the entry phase makes P = 1 + {1, 2} vote
    classes.  Dense mode's key is (P, I, V): the rung is not part of
    it, so its slot is None.  With `dedup` the pre-verified stream also
    dispatches the unsigned sequence, ("unsigned", P), its builds
    chunked to at most two vote phases (ServePipeline._stage_preverified)."""
    ps = (2, 3)
    out: Set[Tuple] = ({(p, None) for p in ps} if dense
                       else {(p, r) for p in ps for r in ladder.rungs})
    if dedup:
        out |= {("unsigned", p) for p in ps}
    return out


def warmup_shapes(ladder, n_phases=(2, 3), dense: bool = False,
                  dedup: bool = False) -> Set[Tuple]:
    """The shapes ServePipeline.warmup(n_phases) launches."""
    if isinstance(n_phases, int):
        n_phases = (n_phases,)
    out: Set[Tuple] = ({(p, None) for p in n_phases} if dense
                       else {(p, r) for p in n_phases
                             for r in ladder.rungs})
    if dedup:
        out |= {("unsigned", p) for p in n_phases}
    return out


def warmup_covers(ladder, n_phases=(2, 3), dense: bool = False,
                  dedup: bool = False) -> bool:
    """True iff every dispatchable shape is warmed."""
    return dispatchable_shapes(ladder, dense, dedup) <= warmup_shapes(
        ladder, n_phases, dense, dedup)


def coverage_findings(ladder, n_phases=(2, 3), dense: bool = False,
                      dedup: bool = False) -> List:
    """The finding form of warmup_covers, for the lint CLI."""
    from agnes_tpu_torch.analysis.findings import Finding

    if isinstance(n_phases, int):
        n_phases = (n_phases,)
    missing = dispatchable_shapes(ladder, dense, dedup) - warmup_shapes(
        ladder, n_phases, dense, dedup)
    if not missing:
        return []
    return [Finding(
        "retrace", "RET001", "ServePipeline.warmup",
        f"dispatchable signed shapes not covered by the warmup plan "
        f"{tuple(n_phases)}: {sorted(missing, key=repr)} — each would "
        f"launch unwarmed mid-service")]


#: the step entries a sentinel observes, by the shape key they map to
_LANE_ENTRIES = ("consensus_step_seq_signed",)
_DENSE_ENTRIES = ("consensus_step_seq_signed_dense",
                  "sharded_step_seq_signed")
_UNSIGNED_ENTRIES = ("consensus_step_seq", "sharded_step_seq")


def observed_shapes(sentinel) -> Set[Tuple]:
    """The step shapes a sentinel has seen, in dispatchable_shapes'
    terms: (P, rung) for the packed-lane signed step, (P, None) for the
    dense one, ("unsigned", P) for the plain sequence.  Every step
    entry's arguments open with the state, the tally and the stacked
    external events, whose first leaf is [P, I]; the signed step's
    statics carry its lane rung (lane_signature).  Other entries (the
    BLS lane's) are not step shapes and are left out."""
    from agnes_tpu_torch.device.encoding import DeviceState
    from agnes_tpu_torch.device.tally import TallyState

    at = len(DeviceState._fields) + len(TallyState._fields)
    out: Set[Tuple] = set()
    with sentinel._lock:
        seen = list(sentinel.seen)
    for entry, (statics, leaves) in seen:
        if entry in _LANE_ENTRIES:
            out.add((int(leaves[at][0][0]), int(statics[1][0])))
        elif entry in _DENSE_ENTRIES:
            out.add((int(leaves[at][0][0]), None))
        elif entry in _UNSIGNED_ENTRIES:
            out.add(("unsigned", int(leaves[at][0][0])))
    return out
