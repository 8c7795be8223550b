"""Batched Ed25519 verification (twin of
`agnes_tpu.crypto.ed25519_jax.verify_batch`, line 210).

COFACTORED semantics, framework-wide (rationale: `ed25519_ref.verify`):
A and R must decode canonically, S < L, and [8]([S]B - [k]A) == [8]R.
The JAX twin routes to the fused Pallas kernel on the accelerator; the
port always takes the fused path of `crypto/ed25519_verify.py`: the prologue in
plain torch ops, then `verify_signed5` (or `verify_w4`), which launches
the hand-written CUDA kernel for tensors on the card and runs its plain
PyTorch version for tensors on the CPU — nothing else.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from agnes_tpu_torch.crypto import ed25519_verify as V


def verify_batch(pub: torch.Tensor, sig: torch.Tensor,
                 msg_blocks: torch.Tensor, window: int = 5) -> torch.Tensor:
    """pub [B, 32] int32 bytes, sig [B, 64] int32 bytes, msg_blocks
    [B, n_blocks, 32] uint32 words (as int32 bit patterns) of the padded
    R || A || M.  Returns [B] bool.  `window` picks the kernel instance,
    as `pallas_verify.verify_batch_pallas` does: 5 (signed 5-bit digits,
    the default) or 4 (unsigned 4-bit digits); the verdicts are the
    same."""
    if pub.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=pub.device)
    args, ok_s = V.prologue(pub, sig, msg_blocks, window)
    kernel = V.verify_signed5 if window == 5 else V.verify_w4
    return (kernel(*args) > 0) & ok_s


def pack_verify_inputs(pubs: List[bytes], msgs: List[bytes],
                       sigs: List[bytes], device="cuda"):
    """Host packer for tests and the smoke: lists of (32-byte pub, msg,
    64-byte sig), all messages of one length -> (pub [B,32], sig [B,64],
    blocks [B,n,32]) int32 tensors on `device` (blocks hold the padded
    SHA-512 words of R || A || M as uint32 bit patterns)."""
    data = [s[:32] + p + m for p, m, s in zip(pubs, msgs, sigs)]
    n = len(data[0])
    if any(len(d) != n for d in data):
        raise ValueError("equal-length messages required")
    n_blocks = (n + 1 + 16 + 127) // 128
    buf = np.zeros((len(data), n_blocks * 128), np.uint8)
    for i, d in enumerate(data):
        buf[i, :n] = np.frombuffer(d, np.uint8)
    buf[:, n] = 0x80
    buf[:, -16:] = np.frombuffer((8 * n).to_bytes(16, "big"), np.uint8)
    w = buf.reshape(len(data), n_blocks, 32, 4).astype(np.uint32)
    words = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pub = np.stack([np.frombuffer(p, np.uint8) for p in pubs])
    sig = np.stack([np.frombuffer(s, np.uint8) for s in sigs])
    return (t(pub.astype(np.int32)), t(sig.astype(np.int32)),
            t(words.view(np.int32)))
