"""Flight recorder: a bounded in-memory event ring and a crash-surviving
heartbeat file (twin of `agnes_tpu.utils.flightrec`).

* **FlightRecorder** — a bounded ring of structured events (tick
  open/close, rung chosen, rejects by cause, retrace trips, kernel
  builds, dispatches, ...).  Thread-safe, fixed memory, per-kind
  monotone counters that survive ring eviction.
* **Heartbeat** — a daemon thread appending one NDJSON line per
  interval to a file: windowed rates, histogram quantiles and gauges
  (from caller-supplied `sources`, e.g. `Metrics.snapshot(window=
  True)`), the recorder's per-kind counts, and any stage a source
  names.  Each line is flushed before the thread sleeps, so a killed
  or wedged process still leaves a parseable trail whose last line
  dates the wedge.  The file rotates (`os.replace` to `<path>.1`) past
  `max_bytes`.
* **Schema helpers** — `validate_heartbeat_line` / `read_heartbeat` /
  `last_line_age_s` / `render_postmortem`, and `render_pod_postmortem`
  over a pod's trails (one a process, stamped with its `host_id`).  A
  trail written by either package validates and reads under the
  other's helpers (same schema, version 2).

Stdlib only.  `render_postmortem` leaves out the twin's sections for
planes the port does not have (the graph census, the native admission
front end); it keeps the elastic pod's membership trail, and the pod
post-mortem's ranked header each host's membership epoch.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: heartbeat line schema version.  v2: a line may carry `host_id` /
#: `process_index` (one trail per pod process); v1 lines stay valid
#: (the host keys are optional; a single-process run omits them).
SCHEMA_VERSION = 2

#: required heartbeat keys -> accepted types (every line is validated
#: against this)
REQUIRED_KEYS = {
    "v": int,
    "kind": str,
    "seq": int,
    "t": (int, float),          # wall-clock epoch seconds
    "pid": int,
    "uptime_s": (int, float),
}

#: optional keys type-checked when present (schema v2: the multi-host
#: identity stamp)
OPTIONAL_KEYS = {
    "host_id": int,
    "process_index": int,
}


class FlightRecorder:
    """Bounded ring of structured events (module docstring).

    `event(kind, **fields)` is the one producer call: a dict append
    under a leaf mutex — cheap enough for the serve plane's
    never-wait-on-device sections.  The ring holds the newest
    `capacity` events (older ones evicted and counted in `dropped`);
    `counts()` are per-kind MONOTONE totals independent of eviction,
    which is what the heartbeat line reports."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque()
        self._counts: Dict[str, int] = {}
        self._last: Dict[str, dict] = {}
        self.dropped = 0
        self._mu = threading.Lock()

    def event(self, kind: str, **fields) -> None:
        ev = {"kind": kind, "t": round(time.time(), 3)}
        ev.update(fields)
        with self._mu:
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped += 1
            self._ring.append(ev)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._last[kind] = ev

    def __len__(self) -> int:
        return len(self._ring)

    def counts(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._counts)

    def last(self, kind: str) -> Optional[dict]:
        with self._mu:
            ev = self._last.get(kind)
            return dict(ev) if ev is not None else None

    def tail(self, n: Optional[int] = None,
             kind: Optional[str] = None) -> List[dict]:
        """Newest-last snapshot of the ring (optionally one kind)."""
        with self._mu:
            evs = [dict(e) for e in self._ring
                   if kind is None or e["kind"] == kind]
        return evs if n is None else evs[-n:]


def _json_safe(obj):
    """Best-effort JSON-safe copy: a heartbeat line must NEVER fail to
    serialize (a crashing telemetry thread is worse than a lossy
    field)."""
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    try:                       # numpy scalars et al. without importing
        return float(obj)      # numpy here (stdlib-only contract)
    except Exception:  # noqa: BLE001
        return repr(obj)


class Heartbeat:
    """Appends one NDJSON heartbeat line per interval (module
    docstring).  `sources` is a MUTABLE sequence of zero-arg callables
    returning dicts, re-read every beat — callers append sources as
    subsystems come up.  A source that raises
    is counted in `source_errors`, never fatal."""

    def __init__(self, path: str, interval_s: float = 1.0,
                 recorder: Optional[FlightRecorder] = None,
                 sources=None, max_bytes: int = 8_000_000,
                 host_id: Optional[int] = None):
        """`host_id` (schema v2): the pod process index — when set,
        every line carries `host_id` + `process_index` (None = single
        process, keys omitted)."""
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive: {interval_s}")
        self.path = str(path)
        self.interval_s = float(interval_s)
        self.recorder = recorder
        self.sources = sources if sources is not None else []
        self.max_bytes = int(max_bytes)
        self.host_id = None if host_id is None else int(host_id)
        self.seq = 0
        self.source_errors = 0
        self._t0 = time.monotonic()
        self._last_beat: Optional[float] = None      # monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()

    # -- line production -----------------------------------------------------

    def _line(self) -> dict:
        line = {
            "v": SCHEMA_VERSION,
            "kind": "hb",
            "seq": self.seq,
            "t": round(time.time(), 3),
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "interval_s": self.interval_s,
        }
        if self.host_id is not None:
            line["host_id"] = self.host_id
            line["process_index"] = self.host_id
        if self.recorder is not None:
            line["events"] = self.recorder.counts()
            line["events_dropped"] = self.recorder.dropped
        for src in list(self.sources):
            try:
                d = src()
            except Exception:  # noqa: BLE001 — telemetry never kills
                self.source_errors += 1
                continue
            if isinstance(d, dict):
                line.update(_json_safe(d))
        if self.source_errors:
            line["source_errors"] = self.source_errors
        return line

    def _rotate_locked(self) -> None:
        try:
            if os.path.getsize(self.path) > self.max_bytes:
                os.replace(self.path, self.path + ".1")   # atomic
        except OSError:
            pass

    def beat(self) -> dict:
        """Append one line NOW (the thread's tick; also callable
        directly — tests and shutdown paths use it)."""
        with self._mu:
            self._rotate_locked()
            line = self._line()
            self.seq += 1
            payload = json.dumps(line, sort_keys=True, default=repr)
            with open(self.path, "a") as f:
                f.write(payload + "\n")
                f.flush()       # into the kernel: survives SIGKILL
            self._last_beat = time.monotonic()
        return line

    def last_line_age(self) -> Optional[float]:
        """Seconds since the last appended line (None = never beat)."""
        with self._mu:
            last = self._last_beat
        return None if last is None else time.monotonic() - last

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Heartbeat":
        if self._thread is None:
            self.beat()         # even a run killed in second 0 leaves
            self._thread = threading.Thread(         # a dated line
                target=self._loop, daemon=True,
                name="agnes-heartbeat")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except Exception:  # noqa: BLE001 — a telemetry thread
                pass           # must never take the host down

    def stop(self, final_beat: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 5)
        if final_beat:
            try:
                self.beat()
            except Exception:  # noqa: BLE001
                pass


# -- parsing / schema ---------------------------------------------------------

def validate_heartbeat_line(obj) -> List[str]:
    """Schema problems of one parsed line (empty list = valid)."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"not an object: {type(obj).__name__}"]
    for key, types in REQUIRED_KEYS.items():
        if key not in obj:
            problems.append(f"missing required key {key!r}")
        elif not isinstance(obj[key], types) or isinstance(obj[key],
                                                           bool):
            problems.append(
                f"key {key!r} has type {type(obj[key]).__name__}")
    for key, types in OPTIONAL_KEYS.items():
        if key in obj and (not isinstance(obj[key], types)
                           or isinstance(obj[key], bool)):
            problems.append(
                f"optional key {key!r} has type "
                f"{type(obj[key]).__name__}")
    if not problems and obj["v"] > SCHEMA_VERSION:
        problems.append(f"schema version {obj['v']} from the future")
    return problems


def read_heartbeat(path: str) -> Tuple[List[dict],
                                       List[Tuple[int, str]]]:
    """Parse an NDJSON heartbeat file -> (lines, bad) where `bad` is
    [(1-based line number, problem)].  A final TRUNCATED line (the
    process died mid-write) is reported in `bad`, not raised."""
    lines: List[dict] = []
    bad: List[Tuple[int, str]] = []
    with open(path) as f:
        for i, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                obj = json.loads(raw)
            except ValueError:
                bad.append((i, "unparseable JSON"))
                continue
            problems = validate_heartbeat_line(obj)
            if problems:
                bad.append((i, "; ".join(problems)))
            else:
                lines.append(obj)
    return lines, bad


def last_line_age_s(path: str,
                    now: Optional[float] = None) -> Optional[float]:
    """Age (seconds) of the newest VALID line's wall timestamp — the
    number that dates a wedge post-mortem.  None when the file is
    missing or holds no valid line."""
    try:
        lines, _ = read_heartbeat(path)
    except OSError:
        return None
    if not lines:
        return None
    now = time.time() if now is None else now
    return now - lines[-1]["t"]


def _fmt_t(t: float) -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t))


def render_postmortem(path: str,
                      now: Optional[float] = None) -> str:
    """Human post-mortem summary of a heartbeat file: the run, the age
    of its last line (stale past two intervals), the stage, the event
    counts, the windowed rates, the latency quantiles, the first-build
    walls, the BLS device pairing dispatches and the elastic membership
    trail."""
    now = time.time() if now is None else now
    lines, bad = read_heartbeat(path)
    out = [f"heartbeat {path}: {len(lines)} valid line(s), "
           f"{len(bad)} bad"]
    for i, why in bad[:5]:
        out.append(f"  BAD line {i}: {why}")
    if not lines:
        out.append("  no valid lines — nothing to reconstruct")
        return "\n".join(out)
    first, last = lines[0], lines[-1]
    age = now - last["t"]
    interval = float(last.get("interval_s", 0)) or None
    out.append(f"  run: pid {last['pid']}, first beat "
               f"{_fmt_t(first['t'])}, last beat {_fmt_t(last['t'])} "
               f"(uptime {last['uptime_s']:.1f}s, {len(lines)} beats)")
    stale = interval is not None and age > 2 * interval
    out.append(f"  last line age: {age:.1f}s"
               + (f" — STALE (> 2x the {interval:.1f}s interval): "
                  f"the process died or wedged around "
                  f"{_fmt_t(last['t'])}" if stale else
                  " (fresh: within two heartbeat intervals)"))
    if "stage" in last:
        out.append(f"  stage at last beat: {last['stage']}")
    ev = last.get("events")
    if isinstance(ev, dict) and ev:
        top = sorted(ev.items(), key=lambda kv: -kv[1])
        out.append("  events: " + ", ".join(
            f"{k}={v}" for k, v in top[:10])
            + (f" (+{last.get('events_dropped', 0)} evicted from the "
               f"ring)" if last.get("events_dropped") else ""))
    rates = {k: v for k, v in last.items()
             if k.endswith("_per_sec") and isinstance(v, (int, float))
             and v > 0}
    if rates:
        top = sorted(rates.items(), key=lambda kv: -kv[1])
        out.append("  rates over the last window: " + ", ".join(
            f"{k}={v:g}" for k, v in top[:8]))
    quants = {k: v for k, v in last.items()
              if (k.endswith("_p50") or k.endswith("_p99"))
              and isinstance(v, (int, float)) and v > 0}
    if quants:
        out.append("  latency quantiles at last beat: " + ", ".join(
            f"{k}={v:.6g}s" for k, v in sorted(quants.items())))
    comp = {k: v for k, v in last.items()
            if k.startswith("compile_ms_")
            and isinstance(v, (int, float))}
    if comp:
        top = sorted(comp.items(), key=lambda kv: -kv[1])
        out.append("  first-dispatch compile walls: " + ", ".join(
            f"{k[len('compile_ms_'):]}={v:.0f}ms" for k, v in top[:8]))
    # the BLS device pairing steady state, by name (the name mirrors
    # utils/metrics.py's BLS_DEVICE_PAIRING_DISPATCHES: counter, source
    # key and event kind at once; stdlib only, so spelled literally)
    bls_disp = last.get("bls_device_pairing_dispatches")
    if isinstance(ev, dict):
        bls_disp = bls_disp or ev.get("bls_device_pairing_dispatches")
    if bls_disp:
        out.append(f"  bls device pairing: {bls_disp} dispatch(es)")
    # the elastic membership trail: the current epoch, the readmissions
    # and the boundary / re-lift / hold-overflow event counts, by name
    # (the names mirror utils/metrics.py's POD_MEMBERSHIP_EPOCH /
    # POD_HOST_READMISSIONS and ElasticShard's event kinds).  Dropped
    # held gossip is called out: the reader must not dig for it
    epoch = last.get("pod_membership_epoch")
    readm = last.get("pod_host_readmissions")
    memb = {}
    if isinstance(ev, dict):
        readm = readm or ev.get("pod_host_readmissions")
        memb = {k: ev[k] for k in ("membership_boundary",
                                   "membership_relift",
                                   "membership_hold_overflow")
                if ev.get(k)}
    if isinstance(epoch, (int, float)) or readm or memb:
        bits = []
        if isinstance(epoch, (int, float)):
            bits.append(f"epoch {int(epoch)}")
        if readm:
            bits.append(f"{int(readm)} readmission(s)")
        bits.extend(f"{k}={v}" for k, v in sorted(memb.items()))
        out.append("  elastic membership: " + ", ".join(bits)
                   + (" — HELD GOSSIP DROPPED (reroute capacity "
                      "overflow)" if memb.get(
                          "membership_hold_overflow") else ""))
    return "\n".join(out)


def render_pod_postmortem(paths: Sequence[str],
                          now: Optional[float] = None) -> str:
    """Merged post-mortem over a pod's heartbeat trails (one file a pod
    process).  The header ranks the trails by last-beat age, oldest
    first: on a wedged pod the host that went quiet first is where the
    post-mortem starts.  Each file's single-trail summary follows.  A
    missing or empty trail is itself a ranked finding (a process that
    never beat died before its recorder started)."""
    now = time.time() if now is None else now
    rows = []                  # (sort key, label line)
    for k, path in enumerate(paths):
        label = f"host file {k} ({path})"
        try:
            lines, bad = read_heartbeat(path)
        except OSError as e:
            rows.append((float("-inf"), f"  {label}: UNREADABLE "
                                       f"({e.__class__.__name__}) — "
                                       f"died before first beat?"))
            continue
        if not lines:
            rows.append((float("-inf"),
                         f"  {label}: no valid lines ({len(bad)} bad)"))
            continue
        last = lines[-1]
        age = now - last["t"]
        host = last.get("host_id")
        who = (f"host {host}" if host is not None
               else f"pid {last['pid']}")
        interval = float(last.get("interval_s", 0)) or None
        stale = interval is not None and age > 2 * interval
        ep = last.get("pod_membership_epoch")
        rows.append((
            -age,
            f"  {who}: last beat {_fmt_t(last['t'])} "
            f"(age {age:.1f}s, {len(lines)} beats, seq {last['seq']}"
            # hosts wedged on different membership epochs is the elastic
            # pod's failure signature
            + (f", epoch {int(ep)}" if isinstance(ep, (int, float))
               else "") + ")"
            + (" — STALE: wedged/died around this time" if stale
               else " — fresh")))
    out = [f"pod heartbeat merge: {len(paths)} trail(s), oldest "
           f"last-beat first (the first host to go quiet is where the "
           f"wedge began)"]
    out.extend(line for _, line in sorted(rows, key=lambda r: r[0]))
    for path in paths:
        out.append("")
        try:
            out.append(render_postmortem(path, now=now))
        except OSError as e:
            out.append(f"heartbeat {path}: unreadable ({e})")
    return "\n".join(out)
