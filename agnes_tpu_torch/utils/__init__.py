"""Auxiliary subsystems of the PyTorch port (twins of `agnes_tpu.utils`):

  checkpoint.py   snapshot/resume of the device driver, the vote
                  batcher and the native ingest loop (slot maps and the
                  signed-evidence log), in the twin's .npz format, and
                  of a host executor (the twin's JSON document).
  tracing.py      host spans (chrome-trace JSON, bounded ring, stable
                  thread ids, tick flow events) + `span`, which names a
                  region for torch.profiler and as an NVTX range.
  budget.py       the verify planner (lane chunks from the card's memory).
  metrics.py      counters, gauges, log-bucket latency histograms and the
                  serve plane's metric names.
  flightrec.py    the flight recorder's event ring and NDJSON heartbeat.
  metrics_http.py the Prometheus `/metrics` endpoint over a registry.
"""

from agnes_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_batcher,
    load_driver,
    load_executor_into,
    load_native_loop,
    save_batcher,
    save_driver,
    save_executor,
    save_native_loop,
)
from agnes_tpu_torch.utils.tracing import Tracer, span  # noqa: F401
