"""Batched SHA-512 over pre-padded blocks (twin of
`agnes_tpu.crypto.sha512_jax.sha512_blocks`, line 181).

The JAX twin carries each 64-bit word as a (hi, lo) pair of uint32
lanes because the TPU has no 64-bit vector unit.  Torch's uint32 ops
are sparse on CUDA, so here a word is one int64 holding the same 64
bits: additions wrap mod 2^64 in two's complement, and every right
shift is masked, since `>>` on int64 is arithmetic.  The interface
keeps the twin's layout: blocks [..., n_blocks, 32] of uint32 values
(held as int32 bit patterns or int64), digest [..., 16] of uint32
values (held in int64), (hi, lo) big-endian word pairs.  The round and
IV constants are generated from their definition (FIPS 180-4 §4.2.3 /
§5.3.5); the tests pin the output against `hashlib.sha512`.
"""

from __future__ import annotations

import math
from typing import List

import torch

I64 = torch.int64
MASK32 = 0xFFFFFFFF


def _primes(n: int) -> List[int]:
    ps, x = [], 2
    while len(ps) < n:
        if all(x % p for p in ps):
            ps.append(x)
        x += 1
    return ps


def _icbrt(n: int) -> int:
    x = 1 << ((n.bit_length() + 2) // 3 + 1)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            break
        x = y
    return x


def _signed64(x: int) -> int:
    """Unsigned 64-bit value -> the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


# K[t] = floor(frac(cbrt(prime_t)) * 2^64); H0[i] = frac(sqrt(prime_i))
_K = [_signed64(_icbrt(p << 192) & ((1 << 64) - 1)) for p in _primes(80)]
_H0 = [_signed64(math.isqrt(p << 128) & ((1 << 64) - 1))
       for p in _primes(8)]


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of the 64 bits held in an int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def _compress(state: List[torch.Tensor], w16: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    """One SHA-512 compression of the 16 message words `w16`."""
    w = list(w16)
    for t in range(16, 80):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ _shr(w[t - 15], 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ _shr(w[t - 2], 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        big_s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + big_s1 + ch + _K[t] + w[t]
        big_s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = big_s0 + maj
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    return [s + x for s, x in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-512 over pre-padded message blocks.

    blocks: [..., n_blocks, 32] uint32 values — each block is 16
    big-endian 64-bit words as (hi, lo) column pairs.  Returns the
    digest as [..., 16] int64 holding uint32 values, same (hi, lo)
    big-endian word convention."""
    words32 = blocks.to(I64) & MASK32
    shape = blocks.shape[:-2]
    state = [torch.full(shape, h, dtype=I64, device=blocks.device)
             for h in _H0]
    for blk in range(blocks.shape[-2]):
        col = words32[..., blk, :]
        w16 = [(col[..., 2 * t] << 32) | col[..., 2 * t + 1]
               for t in range(16)]
        state = _compress(state, w16)
    return torch.stack([half for s in state
                        for half in (_shr(s, 32), s & MASK32)], dim=-1)
