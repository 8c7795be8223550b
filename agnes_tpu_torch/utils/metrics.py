"""Counters, gauges and latency histograms for the consensus planes (twin
of `agnes_tpu.utils.metrics`).

A small thread-safe registry: monotonic counters, gauges and mergeable
log-bucket `Histogram`s, exported as a dict, one JSON line, or (through
utils/metrics_http.py) the Prometheus text format.

Two rate families, because they answer different questions:

* `rate(name)` — lifetime average (counter / elapsed).  Right for a run
  that starts, measures and exits; wrong for a long-lived service,
  whose divisor grows forever.
* `interval_rate(name)` / `interval_rates()` — windowed: the delta
  since the previous call over the time since it, then the window
  resets.  What a scrape loop and the serve plane's gauges report.

The names below (`SERVE_*`, `BLS_*`, `RETRACE_UNEXPECTED`, ...) are the
twin's, so a scrape of either package reads the same series.  Stdlib
only.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class Histogram:
    """Thread-safe, mergeable log-bucket latency histogram.

    Fixed bucket table: `SUB` sub-buckets per octave (relative bucket
    width 2**(1/SUB) ~ 19%) spanning [2**LO_EXP, 2**HI_EXP) — ~60 ns to
    ~18 h.  Values outside clamp into the edge buckets.  Recording is
    one log2, one index and one increment under a leaf mutex.  Every
    histogram shares the table, so `merge` is element-wise addition.
    Quantiles come from the bucket's geometric midpoint: within one
    bucket width of the exact order statistic."""

    SUB = 4                    # sub-buckets per octave
    LO_EXP = -24               # 2**-24 s ~ 60 ns
    HI_EXP = 16                # 2**16 s ~ 18 h
    NB = (HI_EXP - LO_EXP) * SUB

    __slots__ = ("name", "counts", "n", "total", "vmax", "_mu")

    def __init__(self, name: str = ""):
        self.name = name
        self.counts = [0] * self.NB
        self.n = 0
        self.total = 0.0
        self.vmax = 0.0
        self._mu = threading.Lock()

    @classmethod
    def _index(cls, value: float) -> int:
        if value <= 0.0:
            return 0
        i = int(math.floor(math.log2(value) * cls.SUB)) \
            - cls.LO_EXP * cls.SUB
        return 0 if i < 0 else (cls.NB - 1 if i >= cls.NB else i)

    @classmethod
    def bucket_upper(cls, i: int) -> float:
        """Upper edge of bucket `i` (seconds)."""
        return 2.0 ** (cls.LO_EXP + (i + 1) / cls.SUB)

    @classmethod
    def _bucket_mid(cls, i: int) -> float:
        return 2.0 ** (cls.LO_EXP + (i + 0.5) / cls.SUB)

    def record(self, value: float, n: int = 1) -> None:
        """Record `value` (seconds) `n` times."""
        i = self._index(value)
        with self._mu:
            self.counts[i] += n
            self.n += n
            self.total += value * n
            if value > self.vmax:
                self.vmax = value

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold `other` into self (element-wise).  Returns self."""
        with other._mu:
            counts = list(other.counts)
            n, total, vmax = other.n, other.total, other.vmax
        with self._mu:
            for i, c in enumerate(counts):
                if c:
                    self.counts[i] += c
            self.n += n
            self.total += total
            if vmax > self.vmax:
                self.vmax = vmax
        return self

    def quantile(self, q: float) -> float:
        """The q-quantile (0 < q <= 1) as the geometric midpoint of the
        bucket holding the target order statistic; 0.0 when empty.
        q=1 reports the exact tracked max."""
        with self._mu:
            if self.n == 0:
                return 0.0
            if q >= 1.0:
                return self.vmax
            target = max(1, math.ceil(q * self.n))
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= target:
                    return min(self._bucket_mid(i), self.vmax)
            return self.vmax

    def snapshot(self) -> dict:
        """p50/p90/p99/max/count/mean."""
        with self._mu:
            n, total, vmax = self.n, self.total, self.vmax
        return {
            "count": n,
            "mean": (total / n) if n else 0.0,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "max": vmax,
        }

    def prom_buckets(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """Prometheus histogram view: ([(upper_edge_s, cumulative
        count)], sum, count) over the occupied bucket range."""
        with self._mu:
            counts = list(self.counts)
            total, n = self.total, self.n
        lo = next((i for i, c in enumerate(counts) if c), None)
        if lo is None:
            return [], total, n
        hi = max(i for i, c in enumerate(counts) if c)
        out: List[Tuple[float, int]] = []
        acc = sum(counts[:lo])
        for i in range(lo, hi + 1):
            acc += counts[i]
            out.append((self.bucket_upper(i), acc))
        return out, total, n


@dataclass
class Metrics:
    """Process-local metric registry (module docstring).  Every
    read-modify-write runs under one RLock, so a submit thread, a
    dispatch thread and a scraper may share it; histograms have their
    own leaf mutexes."""

    counters: Dict[str, int] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    hists: Dict[str, Histogram] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)
    # per-name interval windows, and the all-counter windows keyed by
    # consumer ("shared" default) so independent scrapers do not close
    # each other's windows
    _win: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    _win_all: Dict[str, Tuple[Dict[str, int], float]] = \
        field(default_factory=dict)
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False, compare=False)

    def count(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def histogram(self, name: str) -> Histogram:
        """Get-or-create the named latency histogram (hot paths keep the
        reference and record without the registry lock)."""
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Histogram(name)
        return h

    def observe(self, name: str, value: float, n: int = 1) -> None:
        """Record `value` into the named histogram (creating it)."""
        self.histogram(name).record(value, n)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def rate(self, name: str) -> float:
        """Lifetime average rate."""
        dt = self.elapsed()
        with self._lock:
            c = self.counters.get(name, 0)
        return c / dt if dt > 0 else 0.0

    def interval_rate(self, name: str) -> float:
        """Per-second rate of `name` over the window since the last
        interval_rate(name) call (since construction on the first);
        reading it closes the window."""
        with self._lock:
            now = time.perf_counter()
            last_c, last_t = self._win.get(name, (0, self._t0))
            c = self.counters.get(name, 0)
            self._win[name] = (c, now)
        dt = now - last_t
        return (c - last_c) / dt if dt > 0 else 0.0

    def interval_rates(self) -> Dict[str, float]:
        """One windowed snapshot of every counter, `{name}_per_sec`,
        on the "shared" window key."""
        with self._lock:
            return self._windowed_rates_locked("shared")

    def _windowed_rates_locked(self, key: str) -> Dict[str, float]:
        now = time.perf_counter()
        base, last_t = self._win_all.get(key) or ({}, self._t0)
        dt = now - last_t
        out = {}
        for name, c in self.counters.items():
            d = c - base.get(name, 0)
            out[f"{name}_per_sec"] = (round(d / dt, 2) if dt > 0
                                      else 0.0)
        self._win_all[key] = (dict(self.counters), now)
        return out

    def snapshot(self, window: bool = False,
                 window_key: str = "shared") -> dict:
        """Counters + gauges + histogram quantiles in one dict.
        `window=False` derives each `{name}_per_sec` from the lifetime
        `rate()`; `window=True` from the `window_key` interval window
        (each independent periodic consumer uses its own key)."""
        with self._lock:
            out = dict(self.counters)
            out.update(self.gauges)
            out["elapsed_s"] = round(self.elapsed(), 4)
            if window:
                out.update(self._windowed_rates_locked(window_key))
            else:
                for name in self.counters:
                    out[f"{name}_per_sec"] = round(self.rate(name), 2)
            hists = list(self.hists.items())
        for name, h in hists:            # hist mutexes: outside _lock
            snap = h.snapshot()
            out[f"{name}_count"] = snap["count"]
            for q in ("p50", "p90", "p99", "max"):
                out[f"{name}_{q}"] = round(snap[q], 6)
        return out

    def export_view(self) -> Tuple[Dict[str, int], Dict[str, float],
                                   Dict[str, Histogram]]:
        """Consistent (counters, gauges, hists) copies for an
        exporter."""
        with self._lock:
            return dict(self.counters), dict(self.gauges), \
                dict(self.hists)

    def json_line(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


#: analysis plane: vetted dispatch signatures, and dispatches the
#: retrace sentinel saw outside its warmed set (analysis/retrace.py)
ANALYSIS_ENTRIES_AUDITED = "analysis_entries_audited"
RETRACE_UNEXPECTED = "retrace_unexpected"
#: serve latency histograms (seconds):
#:   serve_admit_wait_s           submit -> drain wait per admitted record
#:   serve_batch_close_age_s      oldest-record age when a batch closes
#:   serve_dispatch_wall_s        host wall of queueing one staged build
#:   serve_settle_wall_s          wall of the settle-side collect()
#:   serve_submit_to_decision_s   oldest admitted record of a settled
#:                                batch -> its decisions visible
SERVE_ADMIT_WAIT_S = "serve_admit_wait_s"
SERVE_BATCH_CLOSE_AGE_S = "serve_batch_close_age_s"
SERVE_DISPATCH_WALL_S = "serve_dispatch_wall_s"
SERVE_SETTLE_WALL_S = "serve_settle_wall_s"
SERVE_E2E_DECISION_S = "serve_submit_to_decision_s"
#: the threaded host (serve/threaded.py): inbox depth (gauge), blobs
#: refused by a full or closed inbox, loop threads that died, and each
#: loop's busy share of the gauge window (gauges)
SERVE_INBOX_DEPTH = "serve_inbox_depth"
SERVE_INBOX_DROPPED = "serve_inbox_dropped"          # counter
SERVE_THREAD_FAILURES = "serve_thread_failures"      # counter
SERVE_SUBMIT_BUSY_FRAC = "serve_submit_busy_frac"
SERVE_DISPATCH_BUSY_FRAC = "serve_dispatch_busy_frac"
#: BLS aggregate lane: the pairing wall per class (histogram) and the
#: device pairing dispatches (counter, also a flight-recorder event)
BLS_PAIRING_WALL_S = "bls_pairing_wall_s"
BLS_DEVICE_PAIRING_DISPATCHES = "bls_device_pairing_dispatches"
#: the serve plane's counters (serve/service.py), gauges noted
SERVE_SUBMITTED = "serve_submitted"
SERVE_ADMITTED = "serve_admitted"
SERVE_REJECTED_OVERFLOW = "serve_rejected_overflow"
SERVE_REJECTED_FAIRNESS = "serve_rejected_fairness"
SERVE_REJECTED_MALFORMED = "serve_rejected_malformed"
SERVE_EVICTED = "serve_evicted"
SERVE_BATCHES = "serve_batches"
SERVE_NOOP_TICKS = "serve_noop_ticks"
SERVE_VOTES_DISPATCHED = "serve_votes_dispatched"
SERVE_DECISIONS = "serve_decisions"
SERVE_QUEUE_DEPTH = "serve_queue_depth"                  # gauge
SERVE_BATCH_FILL = "serve_batch_fill"                    # gauge
SERVE_INFLIGHT = "serve_inflight"                        # gauge
SERVE_E2E_LATENCY_S = "serve_e2e_latency_s"              # gauge
SERVE_ADMIT_RATE = "serve_admit_rate_per_sec_window"     # gauge
SERVE_DISPATCH_RATE = "serve_dispatch_rate_per_sec_window"  # gauge
#: the dedup layer: admission hits/misses (hits + misses == admitted),
#: LRU evictions, resident bytes and the windowed hit rate (gauges), and
#: votes dispatched on the verify-free unsigned step
SERVE_CACHE_HITS = "serve_cache_hits"
SERVE_CACHE_MISSES = "serve_cache_misses"
SERVE_CACHE_EVICTIONS = "serve_cache_evictions"
SERVE_CACHE_BYTES = "serve_cache_bytes"                  # gauge
SERVE_CACHE_HIT_RATE = "serve_cache_hit_rate_window"     # gauge
SERVE_PREVERIFIED_DISPATCHED = "serve_preverified_votes_dispatched"
#: the BLS lane's serve counters: pairing-cleared classes, votes that
#: fell back to per-share verification, shares refused for a missing
#: proof of possession (a gauge of the table's counter)
SERVE_BLS_AGG_CLASSES = "serve_bls_agg_classes"
SERVE_BLS_FALLBACK_VOTES = "serve_bls_fallback_votes"
SERVE_BLS_POP_MISSING = "bls_pop_missing"
#: the native admission front end (serve/native_admission.py):
#:   serve_native_inbox_depth     gauge — records resident in the C++
#:                                admission queue
#:   serve_native_drain_wall_s    histogram — wall of one GIL-releasing
#:                                drain call
#:   serve_native_rejects_<cause> counters (overflow / fairness /
#:                                malformed), the native screens' reject
#:                                taxonomy beside the serve_rejected_*
#:                                counters
#:   serve_native_densify_wall_s  histogram — wall of the drains that
#:                                also filled the phase/lane arrays
#:   serve_native_phase_builds    counter — builds the pipeline adopted
#:                                from a native phase drain
#:   serve_native_shard_depth_<s> gauges — per-shard resident depth
#:   serve_native_shard_rejects_<cause> counters — the reject taxonomy
#:                                summed across shards
SERVE_NATIVE_INBOX_DEPTH = "serve_native_inbox_depth"
SERVE_NATIVE_DRAIN_WALL_S = "serve_native_drain_wall_s"
SERVE_NATIVE_REJECTS_PREFIX = "serve_native_rejects_"
SERVE_NATIVE_REJECTS_OVERFLOW = SERVE_NATIVE_REJECTS_PREFIX + "overflow"
SERVE_NATIVE_REJECTS_FAIRNESS = SERVE_NATIVE_REJECTS_PREFIX + "fairness"
SERVE_NATIVE_REJECTS_MALFORMED = (SERVE_NATIVE_REJECTS_PREFIX
                                  + "malformed")
SERVE_NATIVE_DENSIFY_WALL_S = "serve_native_densify_wall_s"
SERVE_NATIVE_PHASE_BUILDS = "serve_native_phase_builds"
SERVE_NATIVE_SHARD_DEPTH_PREFIX = "serve_native_shard_depth_"
SERVE_NATIVE_SHARD_REJECTS_PREFIX = "serve_native_shard_rejects_"
#: the pod (distributed/): records a host's front door screened off
#: because their global instance id belongs to another host's block
#: (counter, distributed/shard.py; the drain report's
#: `pod.foreign_rejects`)
POD_FOREIGN_REJECTS = "pod_foreign_rejects"
#: the elastic pod (distributed/elastic.py): the current membership
#: epoch (gauge, steps at each applied boundary, so a wedge's timeline
#: shows which partition was live), the wall of a negotiated tick
#: (histogram: stage, pack, all_gather, merge, pad, dispatch), and
#: readmissions applied at boundaries (counter, mirrored from
#: MembershipEpoch.readmissions)
POD_MEMBERSHIP_EPOCH = "pod_membership_epoch"
POD_NEGOTIATION_WALL_S = "pod_negotiation_wall_s"
POD_HOST_READMISSIONS = "pod_host_readmissions"
#: the bounded model checkers (analysis/modelcheck.py and the admission
#: and membership models): distinct canonical states visited and
#: property violations found by a scope; the measured orbit reduction
#: of the symmetry-reduced consensus shards against their unreduced
#: visit counts (modelcheck.SYM_BASELINE_STATES; -1 = not measured), the
#: same for the epoch shards alone; and the state totals of the
#: admission model, the membership model, and the consensus shards with
#: validator-set epochs / a sleepy-churn budget.  The CLI's report
#: carries all eight under `metrics`.
MODELCHECK_STATES_EXPLORED = "modelcheck_states_explored"
MODELCHECK_VIOLATIONS = "modelcheck_violations"
MODELCHECK_SYM_ORBIT_REDUCTION = "modelcheck_sym_orbit_reduction"
MODELCHECK_ADMISSION_STATES = "modelcheck_admission_states"
MODELCHECK_MEMBERSHIP_STATES = "modelcheck_membership_states"
MODELCHECK_EPOCH_STATES = "modelcheck_epoch_states"
MODELCHECK_CHURN_STATES = "modelcheck_churn_states"
MODELCHECK_EPOCH_ORBIT_REDUCTION = "modelcheck_epoch_orbit_reduction"
#: the schedule checker (analysis/schedcheck.py): distinct complete
#: thread schedules it executed over the real threaded serve host, and
#: the monitor violations it found (conservation, deadlock, lock order,
#: atomicity, busy-fraction sanity).  Its CLI report carries both under
#: `metrics`.
SCHEDCHECK_SCHEDULES_EXPLORED = "schedcheck_schedules_explored"
SCHEDCHECK_VIOLATIONS = "schedcheck_violations"
#: per-kernel first-build wall gauges, `compile_ms_<kernel>`: the port's
#: only compile is a kernel's nvcc build (cuda_build.py)
COMPILE_MS_PREFIX = "compile_ms_"
VOTES_INGESTED = "votes_ingested"
VOTES_VERIFIED = "votes_verified"
THRESHOLDS_CROSSED = "thresholds_crossed"
DECISIONS = "decisions"
ROUNDS_SKIPPED = "rounds_skipped"
EQUIVOCATIONS = "equivocations"


def attach_to_driver(driver, metrics: Optional[Metrics] = None) -> Metrics:
    """Wrap a DeviceDriver's step() so the registry tracks votes,
    decisions, tally thresholds crossed and equivocators.  Idempotent:
    the wrapper is installed once and reads its registry through
    `driver._agnes_metrics` at call time, so a re-attach with a new
    registry rebinds it and a bare re-attach returns the one in
    place."""
    if getattr(driver.step, "_agnes_metrics_wrapper", False):
        if metrics is not None:
            driver._agnes_metrics = metrics
        return driver._agnes_metrics

    driver._agnes_metrics = metrics or Metrics()
    inner = driver.step

    def step(ext=None, phase=None):
        m = driver._agnes_metrics
        decided_before = int(driver.stats.decided.sum())
        votes_before = driver.stats.votes_ingested
        # tally.emitted holds the highest threshold reached per
        # (instance, round, class): its sum rises exactly when a
        # threshold is newly crossed
        emitted_before = int(driver.tally.emitted.sum())
        msgs = inner(ext=ext, phase=phase)
        m.count(VOTES_INGESTED, driver.stats.votes_ingested - votes_before)
        m.count(DECISIONS, int(driver.stats.decided.sum()) - decided_before)
        m.count(THRESHOLDS_CROSSED,
                int(driver.tally.emitted.sum()) - emitted_before)
        m.gauge(EQUIVOCATIONS, int(driver.equivocators_detected().sum()))
        return msgs

    step._agnes_metrics_wrapper = True
    driver.step = step
    return driver._agnes_metrics
