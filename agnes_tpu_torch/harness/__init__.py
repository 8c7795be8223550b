"""harness layer of the PyTorch port (see the package docstring).

  simulator.py      in-memory multi-node network over ConsensusExecutor
                    (host plane), with Byzantine node behaviours.
  device_driver.py  closed-loop driver for the fused device step.
  configs.py        the six benchmark configs, runnable as
                    `python -m agnes_tpu_torch.harness.configs N`.
  replay.py         cross-plane differential: tap a Network's nodes,
                    replay each node's stream through the device plane.
"""

from agnes_tpu_torch.harness.simulator import Network, NodeSpec  # noqa: F401
from agnes_tpu_torch.harness.replay import (  # noqa: F401
    ReplayResult,
    replay_trace,
    trace_network,
)

# DeviceDriver resolves on first access: it imports torch, and the
# consensus checker imports `harness.simulator` (this package's
# `__init__` with it) in an interpreter that must stay torch-free.


def __getattr__(name: str):
    if name != "DeviceDriver":
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    from agnes_tpu_torch.harness.device_driver import DeviceDriver

    globals()[name] = DeviceDriver
    return DeviceDriver
