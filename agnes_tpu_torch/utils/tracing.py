"""Tracing: host spans (chrome-trace JSON) + device range helpers (twin
of `agnes_tpu.utils.tracing`).

Host side: `Tracer` records begin/end spans and writes the standard
chrome://tracing / perfetto JSON array format — a bounded ring of
`max_events` entries (oldest evicted, `dropped_events` counted), small
sequential thread ids in first-seen order with `thread_name` metadata
rows, and flow events (`flow(name, fid, phase)`, ph s/t/f) that chain
one tick's spans across threads.  It is the twin's `Tracer`, copied.

Device side: `span` names a region for `torch.profiler`
(`record_function`), and where the process has a CUDA device it also
opens an NVTX range, so `nsys` shows the region by name on the card's
timeline.  On a machine without CUDA the NVTX range is skipped (there
is no device to annotate) and the profiler label and host span remain.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional

import torch

#: flow-event phases: start / step / end (chrome-trace ph values)
FLOW_START, FLOW_STEP, FLOW_END = "s", "t", "f"


@dataclass
class _Span:
    name: str
    ts_us: float
    dur_us: float
    tid: int
    ph: str = "X"                  # "X" span | "s"/"t"/"f" flow event
    fid: Optional[int] = None      # flow (tick) id for flow events


@dataclass
class Tracer:
    """Collects host spans; `write(path)` emits chrome-trace JSON."""

    max_events: int = 65536
    spans: Deque[_Span] = None
    dropped_events: int = 0
    _t0: float = field(default_factory=time.perf_counter)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _tids: Dict[int, int] = field(default_factory=dict)
    _thread_names: Dict[int, str] = field(default_factory=dict)

    def __post_init__(self):
        if self.spans is None:
            self.spans = collections.deque()

    def _tid_locked(self) -> int:
        """Small stable id of the calling thread (first-seen order);
        captures the thread's name on first sight.  Caller holds the
        lock."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids) + 1
            self._thread_names.setdefault(
                tid, threading.current_thread().name)
        return tid

    def name_thread(self, name: str) -> None:
        """Label the CALLING thread's row in the trace viewer."""
        with self._lock:
            self._thread_names[self._tid_locked()] = name

    def _append_locked(self, span: _Span) -> None:
        if len(self.spans) >= self.max_events:
            self.spans.popleft()
            self.dropped_events += 1
        self.spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self._append_locked(_Span(
                    name=name,
                    ts_us=(start - self._t0) * 1e6,
                    dur_us=(end - start) * 1e6,
                    tid=self._tid_locked()))

    def flow(self, name: str, fid: int, phase: str) -> None:
        """Record one flow event (`phase` in "s"/"t"/"f") on the
        calling thread — the cross-thread correlation arrow for flow
        id `fid`."""
        assert phase in (FLOW_START, FLOW_STEP, FLOW_END), phase
        now = time.perf_counter()
        with self._lock:
            self._append_locked(_Span(
                name=name, ts_us=(now - self._t0) * 1e6, dur_us=0.0,
                tid=self._tid_locked(), ph=phase, fid=int(fid)))

    def write(self, path: str) -> None:
        pid = os.getpid()
        with self._lock:
            spans = list(self.spans)
            names = dict(self._thread_names)
        events = [{"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": tid, "args": {"name": name}}
                  for tid, name in sorted(names.items())]
        for s in spans:
            if s.ph == "X":
                events.append({"name": s.name, "ph": "X", "ts": s.ts_us,
                               "dur": s.dur_us, "pid": pid,
                               "tid": s.tid})
            else:
                ev = {"name": s.name, "ph": s.ph, "ts": s.ts_us,
                      "pid": pid, "tid": s.tid, "cat": "tick",
                      "id": s.fid}
                if s.ph == FLOW_END:
                    ev["bp"] = "e"     # bind to enclosing slice's end
                events.append(ev)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"traceEvents": events}, f)
        os.replace(tmp, path)

    def total_us(self, name: str) -> float:
        with self._lock:
            return sum(s.dur_us for s in self.spans
                       if s.name == name and s.ph == "X")

    def flow_phases(self, fid: int) -> set:
        """The flow phases recorded for `fid` (test/debug helper):
        a fully correlated tick shows {"s", "t", "f"}."""
        with self._lock:
            return {s.ph for s in self.spans if s.fid == fid
                    and s.ph != "X"}


@contextlib.contextmanager
def span(name: str, tracer: Optional[Tracer] = None):
    """Device+host combined scope: names the region for the PyTorch
    profiler and, with a CUDA device present, as an NVTX range; records
    a host span when a tracer is given."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            if tracer is None:
                yield
            else:
                with tracer.span(name):
                    yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
