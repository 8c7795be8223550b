"""Auxiliary subsystems of the PyTorch port (twins of `agnes_tpu.utils`):

  checkpoint.py   snapshot/resume of the device driver, the vote
                  batcher and the native ingest loop (slot maps and the
                  signed-evidence log), in the twin's .npz format, and
                  of a host executor (the twin's JSON document).
  tracing.py      host spans (chrome-trace JSON, bounded ring, stable
                  thread ids, tick flow events) + `span`, which names a
                  region for torch.profiler and as an NVTX range.
  budget.py       the verify planner (lane chunks from the card's memory)
                  and the wall-clock deadline (discovery, alarm margin,
                  TERM / ALRM handlers).
  metrics.py      counters, gauges, log-bucket latency histograms and the
                  serve plane's metric names.
  flightrec.py    the flight recorder's event ring and NDJSON heartbeat.
  metrics_http.py the Prometheus `/metrics` endpoint over a registry.
  metrics_cli.py  the heartbeat post-mortem / schema-check CLI.
  config.py       the typed run configuration (validators, instances,
                  mesh shape, timeouts, dtypes), its bridge factories
                  and CLI parsing.

`checkpoint` and `tracing` import torch, so their names below resolve
on first access (a module `__getattr__`) and importing this package
loads no torch: the metrics CLI and the flight recorder must run on a
box whose CUDA stack is what failed.  `Metrics` and `RunConfig` are
plain imports: `metrics.py` is stdlib-only, and `config.py` imports the
bridges it builds only when it builds one.
"""

from agnes_tpu_torch.utils.config import RunConfig  # noqa: F401
from agnes_tpu_torch.utils.metrics import Metrics  # noqa: F401

#: lazily exported names -> their module
_LAZY = {
    **{name: "agnes_tpu_torch.utils.checkpoint"
       for name in ("load_batcher", "load_driver", "load_executor_into",
                    "load_native_loop", "save_batcher", "save_driver",
                    "save_executor", "save_native_loop")},
    "Tracer": "agnes_tpu_torch.utils.tracing",
    "span": "agnes_tpu_torch.utils.tracing",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
