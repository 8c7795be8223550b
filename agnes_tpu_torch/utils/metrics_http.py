"""`/metrics` endpoint: Prometheus text exposition over stdlib
http.server (twin of `agnes_tpu.utils.metrics_http`).

Renders a `utils.metrics.Metrics` registry — counters, gauges and the
log-bucket latency `Histogram`s — in the Prometheus text format
(version 0.0.4: `# TYPE` lines, `_bucket{le=...}` cumulative histogram
series, `_sum`/`_count`).  `MetricsServer` is a ThreadingHTTPServer on
a daemon thread, bound to localhost by default, serving GET /metrics;
`VoteService.start_metrics_server()` wires its registry (plus the
per-kernel `compile_ms_<kernel>` build walls) through here.  Stdlib
only, so a scrape answers even when the card is wedged; the registry is
read through `Metrics.export_view()`.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, Optional

#: exposition content type (Prometheus text format 0.0.4)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return out if out and not out[0].isdigit() else "_" + out


def _fmt(v) -> str:
    if v != v:                                   # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(metrics,
                      extra_sources: Iterable[Callable[[], dict]] = ()
                      ) -> str:
    """One scrape body: every counter, gauge and histogram in
    `metrics` (via `export_view()`), plus gauge dicts from
    `extra_sources` callables (e.g. the registry's compile_ms view).
    A source that raises is skipped — a scrape must always answer."""
    counters, gauges, hists = metrics.export_view()
    lines = []
    for name in sorted(counters):
        pn = _sanitize(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_fmt(counters[name])}")
    extra: Dict[str, float] = {}
    for src in extra_sources:
        try:
            d = src()
        except Exception:  # noqa: BLE001 — scrape must answer
            continue
        if isinstance(d, dict):
            extra.update(d)
    for name in sorted({**gauges, **extra}):
        pn = _sanitize(name)
        val = extra.get(name, gauges.get(name))
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(val)}")
    for name in sorted(hists):
        pn = _sanitize(name)
        buckets, total, count = hists[name].prom_buckets()
        lines.append(f"# TYPE {pn} histogram")
        for le, cum in buckets:
            lines.append(f'{pn}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{pn}_sum {_fmt(total)}")
        lines.append(f"{pn}_count {count}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Inverse of `render_prometheus` for tests and self-scrapes:
    {series -> value}, labeled series keyed as rendered (e.g.
    'h_bucket{le="0.001"}').  Comment/blank lines skipped."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        out[series] = float(value)
    return out


class MetricsServer:
    """GET /metrics scraper target over one Metrics registry (module
    docstring).  `start()` binds (port 0 = ephemeral) and returns the
    actual port; `stop()` shuts the listener down.  Handler threads
    are daemonic — an abandoned server never blocks interpreter
    exit."""

    def __init__(self, metrics, host: str = "127.0.0.1", port: int = 0,
                 extra_sources: Iterable[Callable[[], dict]] = ()):
        self.metrics = metrics
        self.host = host
        self.port = int(port)
        self.extra_sources = tuple(extra_sources)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404)
                    return
                try:
                    body = render_prometheus(
                        outer.metrics, outer.extra_sources
                    ).encode()
                except Exception:  # noqa: BLE001 — never hang a scrape
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):          # quiet: a scrape per
                pass                            # interval is not news

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="agnes-metrics-http")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None
