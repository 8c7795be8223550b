"""Scalars mod the ed25519 group order L, in 13-bit limbs (twin of
`agnes_tpu.crypto.scalar_jax`, lines 33-114).

The challenge k = SHA-512(R || A || M) is reduced mod L by limb-aligned
Barrett reduction with mu = floor(2^520 / L):

    q = floor(k * mu / 2^520)  in [floor(k/L) - 2, floor(k/L)]
    r = k - q*L                in [0, 3L)  ->  two conditional - L.

All products are (variable x constant) convolutions done as shifted
multiply-adds over the constant's limbs; column sums stay under
21 * 2^26 < 2^31, so everything is int32 like the twin.
"""

from __future__ import annotations

import functools
from typing import List

import torch

from agnes_tpu_torch.crypto.field import (
    BITS,
    I32,
    LMASK,
    bytes_to_limbs,
    carry_chain,
    geq,
    raw_sub,
)

L = 2**252 + 27742317777372353535851937790883648493
N_HASH = 40                      # limbs for a 512-bit hash (520 bits)
N_SCALAR = 20                    # limbs for reduced scalars (260 bits)
MU = (1 << 520) // L             # 268 bits -> 21 limbs


def _const_limbs(x: int) -> List[int]:
    out = []
    while x:
        out.append(x & LMASK)
        x >>= BITS
    return out or [0]


MU_LIMBS = _const_limbs(MU)
L_LIMBS_LIST = _const_limbs(L)
L_LIMBS_PADDED = L_LIMBS_LIST + [0] * (N_SCALAR - len(L_LIMBS_LIST))


@functools.lru_cache(maxsize=None)
def _l_limbs_on(device: torch.device) -> torch.Tensor:
    """L's limbs on `device`, uploaded once (read-only): a fresh
    upload per call would be a blocking copy on the step's path."""
    return torch.tensor(L_LIMBS_PADDED, dtype=I32, device=device)


def _l_limbs(like: torch.Tensor) -> torch.Tensor:
    return _l_limbs_on(like.device)


def _mul_const(a: torch.Tensor, const: List[int]) -> torch.Tensor:
    """[..., n] limbs times a constant (as limb list) -> [..., n+m-1]
    raw columns (unnormalized, < 2^31)."""
    n, m = a.shape[-1], len(const)
    acc = torch.zeros(a.shape[:-1] + (n + m - 1,), dtype=I32, device=a.device)
    for j, cj in enumerate(const):
        if cj:
            acc[..., j:j + n] += a * cj
    return acc


def _chain(r: torch.Tensor) -> torch.Tensor:
    """Normalize non-negative raw columns; the final carry is appended
    as an extra limb (caller knows the true width)."""
    limbs, c = carry_chain(r)
    return torch.cat([limbs, c[..., None]], dim=-1)


def barrett_reduce(k: torch.Tensor) -> torch.Tensor:
    """[..., N_HASH] normalized limbs (value < 2^520) -> [..., N_SCALAR]
    limbs of k mod L (canonical, < L)."""
    t = _chain(_mul_const(k, MU_LIMBS))          # k*mu, limbs
    q = t[..., N_HASH:]                           # >> 520
    ql = _chain(_mul_const(q, L_LIMBS_LIST))[..., :N_HASH]
    r = _chain(k - ql)[..., :N_SCALAR]            # in [0, 3L), signed-safe
    l_limbs = _l_limbs(r)
    for _ in range(2):
        ge = geq(r, l_limbs)
        r = torch.where(ge[..., None], raw_sub(r, l_limbs), r)
    return r


def digest_to_limbs(digest: torch.Tensor) -> torch.Tensor:
    """`sha512.sha512_blocks` digest ([..., 16] uint32 values, (hi, lo)
    big-endian word pairs) -> [..., N_HASH] limbs of the RFC 8032
    little-endian integer."""
    d = digest.to(torch.int64)
    bytes_le = []
    for j in range(64):
        t, b = j // 8, j % 8
        half = d[..., 2 * t] if b < 4 else d[..., 2 * t + 1]
        shift = 24 - 8 * (b % 4)
        bytes_le.append((half >> shift) & 0xFF)
    return bytes_to_limbs(torch.stack(bytes_le, dim=-1), N_HASH)


def scalar_from_bytes32(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] little-endian bytes -> [..., N_SCALAR] limbs (< 2^256,
    NOT reduced — use `is_canonical` for the S < L check)."""
    return bytes_to_limbs(b, N_SCALAR)


def is_canonical(s: torch.Tensor) -> torch.Tensor:
    """s < L (the RFC 8032 §5.1.7 malleability check)."""
    return ~geq(s, _l_limbs(s))


def bits_msb_first(s: torch.Tensor, n_bits: int = 260) -> torch.Tensor:
    """[..., n_limbs] limbs -> [n_bits, ...] bool, most significant bit
    first (the Shamir loop's input)."""
    idx = torch.arange(n_bits - 1, -1, -1, device=s.device)
    bits = (s[..., idx // BITS] >> (idx % BITS).to(s.dtype)) & 1
    return bits.bool().movedim(-1, 0)
