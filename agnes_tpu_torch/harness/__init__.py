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
