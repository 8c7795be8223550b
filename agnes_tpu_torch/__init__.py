"""agnes_tpu_torch — the PyTorch / CUDA port of agnes_tpu for NVIDIA Hopper.

A second package beside `agnes_tpu` (the JAX reference, left as it is):
the same device plane — batched state machine, dense tally, fused
consensus step, batched Ed25519 verify — as PyTorch tensor code, with
the TPU's Pallas kernels replaced by hand-written CUDA kernels
(`csrc/`, built by nvcc at first use).  It imports neither `jax` nor
anything of `agnes_tpu`.  Entry points take `device=` (default "cuda")
and raise when that device is absent; pass device="cpu" to run the
plain PyTorch versions of the kernels.

The layout mirrors `agnes_tpu/` so each module's JAX twin sits at the
same path (`crypto/sha512.py` <-> `crypto/sha512_jax.py`).
"""

__version__ = "0.1.0"

from agnes_tpu_torch.types import (  # noqa: F401
    NIL,
    Proposal,
    Vote,
    VoteType,
)
