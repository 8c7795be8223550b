"""GF(2^255 - 19) limb constants and byte <-> limb conversion (the part
of `agnes_tpu.crypto.field_jax`, lines 42-107, that the verify prologue
needs), plus the generic limb helpers `crypto/scalar.py` shares.

Representation (unchanged from the JAX twin): 20 little-endian limbs of
13 bits (radix 2^13, 260 bits of headroom), each a SIGNED int32.  Batch
axes lead and the limb axis is last, as in the twin; `crypto/verify.py`
moves the limb axis first for the kernel boundary.  Right shifts are
arithmetic (torch's `>>` on int32), which is what makes a negative
column borrow correctly in `carry_chain`.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

I32 = torch.int32

BITS = 13
RADIX = 1 << BITS          # 8192
LMASK = RADIX - 1
NLIMBS = 20                # 260 bits
P = 2**255 - 19
FOLD = 608                 # 2^260 mod p = 32 * 19


def to_limbs(x: int, n: int = NLIMBS) -> List[int]:
    """Python int -> n 13-bit limbs (host helper; no mod-p)."""
    return [(x >> (BITS * i)) & LMASK for i in range(n)]


def from_limbs(limbs) -> int:
    """Sequence of limbs (any signs) -> Python int."""
    return sum(int(v) << (BITS * i) for i, v in enumerate(limbs))


# 64p = 2^261 - 1216 spread over 20 limbs (limb19 oversized at 2^14-1):
# freeze adds it to make signed values positive before exact reduction.
SUB_K = [LMASK] * NLIMBS
SUB_K[0] = RADIX - 1216
SUB_K[NLIMBS - 1] = (1 << 14) - 1
assert from_limbs(SUB_K) == 64 * P


def bytes_to_limbs(b: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """[..., n_bytes] little-endian byte values -> [..., n_limbs] int32
    13-bit limbs (limb i covers bits [13i, 13i+13))."""
    n_bytes = b.shape[-1]
    b = b.to(I32)
    out = []
    for i in range(n_limbs):
        lo_bit = BITS * i
        byte0, off = lo_bit // 8, lo_bit % 8
        v = b[..., byte0] >> off
        got = 8 - off
        k = 1
        while got < BITS:
            if byte0 + k < n_bytes:
                v = v | (b[..., byte0 + k] << got)
            got += 8
            k += 1
        out.append(v & LMASK)
    return torch.stack(out, dim=-1)


def bytes32_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] little-endian bytes -> [..., NLIMBS] field limbs."""
    return bytes_to_limbs(b, NLIMBS)


def carry_chain(r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One signed sequential carry chain over the last axis: returns
    (limbs in [0, 2^13), carry out)."""
    c = torch.zeros_like(r[..., 0])
    outs = []
    for k in range(r.shape[-1]):
        t = r[..., k] + c
        outs.append(t & LMASK)
        c = t >> BITS
    return torch.stack(outs, dim=-1), c


def raw_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b for a >= b, both limb-normalized (generic limb count)."""
    return carry_chain(a - b)[0]


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b on normalized limbs, lexicographic from the top; `b` is a
    tensor broadcastable to `a` (generic limb count)."""
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for k in reversed(range(a.shape[-1])):
        ak, bk = a[..., k], b[..., k]
        gt = gt | (eq & (ak > bk))
        eq = eq & (ak == bk)
    return gt | eq
