"""GF(2^255 - 19) limb arithmetic (twin of `agnes_tpu.crypto.field_jax`),
plus the batched power `pow_p` with its CUDA kernel.

Representation (unchanged from the JAX twin): 20 little-endian limbs of
13 bits (radix 2^13, 260 bits of headroom), each a SIGNED int32 kept in
the weak range |limb| <= 8800.  Batch axes lead and the limb axis is
last, as in the twin; `crypto/ed25519_verify.py` moves the limb axis first for
its kernel boundary.  Right shifts are arithmetic (torch's `>>` on
int32), which is what makes a negative column borrow correctly.  The
bound proofs are the twin's (its module docstring).

`mul` gives the twin's limbs limb for limb.  The twin sums schoolbook
columns with an int32 matmul against a constant matrix; PyTorch has no
int32 matmul on the card, so `columns` lays the 20 x 20 outer product
out skewed (row i shifted right by i) and sums the rows: the same column
integers, then the twin's carry sequence exactly.  `crypto/ed25519_verify.py`
builds its columns with the same function, limbs first.

`pow_p` (x^e for a static e) launches the hand-written CUDA kernel
`csrc/ed25519_pow.cu` for tensors on the card and, for tensors on the
CPU, runs `pow_plain` — a step-for-step transcription of the TPU kernel
`pallas_ed25519._pow_kernel` — and freezes its result.  The kernel
follows the shortest known addition chain for the two exponents the
port raises to ((p-5)/8 and p-2) and fixed 4-bit windows for any other
(`pow_schedule`); both return canonical limbs in [0, p), so every later
step sees the same limbs on either device.  A failed build or launch
raises; `POW_LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as tF

from agnes_tpu_torch import cuda_build

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


def limbs_to_bytes32(a: torch.Tensor) -> torch.Tensor:
    """[..., NLIMBS] *frozen* limbs -> [..., 32] int32 little-endian
    bytes (values 0..255)."""
    out = []
    for byte in range(32):
        lo_bit = 8 * byte
        limb0, off = lo_bit // BITS, lo_bit % BITS
        v = a[..., limb0] >> off
        got = BITS - off
        if got < 8 and limb0 + 1 < NLIMBS:
            v = v | (a[..., limb0 + 1] << got)
        out.append(v & 0xFF)
    return torch.stack(out, dim=-1)


def limbs25(x: int) -> List[int]:
    """Python int (< 2^255) -> the CUDA kernels' 10 limbs in radix
    2^25.5 (limb i holds 26 bits for even i, 25 for odd i)."""
    out = []
    for i in range(10):
        w = 26 - (i & 1)
        out.append(x & ((1 << w) - 1))
        x >>= w
    return out


def limbs32(v: int) -> List[int]:
    """v in [0, 2^256) -> 8 radix-2^32 limbs, least significant first, as
    int32 bit patterns (the layout of `csrc/fe25519_r32.cuh`)."""
    return [((v >> (32 * i)) & 0xFFFFFFFF) - ((v >> (32 * i + 31)) & 1) * 2**32
            for i in range(8)]


@functools.lru_cache(maxsize=None)
def _const(limbs: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(limbs, dtype=I32, device=device)


def const(x: int, like: torch.Tensor) -> torch.Tensor:
    """Python int -> [NLIMBS] int32 limbs on `like`'s device (cached;
    read-only)."""
    return _const(tuple(to_limbs(x)), like.device)


# --- carry normalization (field_jax lines 124-190) --------------------------


@functools.lru_cache(maxsize=None)
def _pass_scales(n: int, fold, device: torch.device):
    """Per-limb scales of one carry pass: the low part is r - 2^13 hi
    (r & LMASK, except the exact pass's top limb, which keeps its full
    value), and hi moves up one limb (into limb 0 times `fold`, or not
    at all for the exact pass)."""
    lo = [-RADIX] * n
    up = [0 if fold is None else fold] + [1] * (n - 1)
    if fold is None:
        lo[-1] = 0
    return (torch.tensor(lo, dtype=I32, device=device),
            torch.tensor(up, dtype=I32, device=device))


def _vpass(r: torch.Tensor, fold=FOLD) -> torch.Tensor:
    """One vectorized carry pass over the limb axis.  fold=None: exact,
    the top limb keeps its full value; otherwise the top limb's carry
    wraps into limb 0 times `fold`.  Two fused multiply-adds over a
    rolled copy of the carries: the twin's pass, in fewer operations."""
    hi = r >> BITS                 # arithmetic shift: signed carries
    lo_scale, up_scale = _pass_scales(r.shape[-1], fold, r.device)
    return torch.addcmul(r, hi, lo_scale).addcmul_(hi.roll(1, -1), up_scale)


def carry(r: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """Signed columns (|col| < 2^31 / 20) -> weak limbs, value mod p."""
    for _ in range(passes):
        r = _vpass(r)
    return r


def _add_limb0(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([r[..., :1] + v[..., None], r[..., 1:]], dim=-1)


def strict_carry(r: torch.Tensor) -> torch.Tensor:
    """Exact normalization to limbs in [0, 2^13) of a value the caller
    guarantees non-negative."""
    for _ in range(3):
        r = _vpass(r)
    r, c = carry_chain(r)
    r = _add_limb0(r, FOLD * c)
    r, c2 = carry_chain(r)
    return _add_limb0(r, FOLD * c2)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b, passes=2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a - b, passes=2)


def columns(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Raw schoolbook columns (|col| < 2^31) of two limb tensors whose
    20 limbs lie along `dim` (-1: limbs last, as here; 0: limbs first, as
    in `crypto/ed25519_verify.py`): 39 columns along the same axis.  The outer
    product, its row axis padded to 40 entries, flattened and re-cut at
    width 39, puts a_i b_j in column i + j of row i (zeros elsewhere); the
    rows then sum to the columns.  Three operations for any batch."""
    if dim not in (0, -1):
        raise ValueError(f"columns: limb axis must be 0 or -1, got {dim}")
    n = NLIMBS
    row = 0 if dim == 0 else -2          # the outer product's row axis
    prod = a.unsqueeze(row + 1) * b.unsqueeze(row)
    after = prod.ndim - 1 - (row + 1) % prod.ndim   # axes after the pad axis
    prod = tF.pad(prod, (0, 0) * after + (0, n))
    flat = prod.flatten(row, row + 1).narrow(dim, 0, n * (2 * n - 1))
    return flat.unflatten(dim, (n, 2 * n - 1)).sum(row, dtype=I32)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply, limb for limb `field_jax.mul`: columns, the high
    half as its own 21-limb number (3 exact passes), the *608 fold (its
    limb 20 sits at 2^520 = 608^2), 4 carry passes."""
    cols = columns(a, b)
    lo, hi = cols[..., :NLIMBS], tF.pad(cols[..., NLIMBS:], (0, 2))
    for _ in range(3):
        hi = _vpass(hi, fold=None)
    r = _add_limb0(lo + FOLD * hi[..., :NLIMBS], (FOLD * FOLD) * hi[..., NLIMBS])
    return carry(r)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small constant (k < 2^17)."""
    return carry(a * k)


def one_like(a: torch.Tensor) -> torch.Tensor:
    return tF.pad(torch.ones_like(a[..., :1]), (0, NLIMBS - 1))


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Canonical representative in [0, p) with strict limbs: add 64p,
    exact-normalize, conditional-subtract ladder."""
    a = strict_carry(a + _const(tuple(SUB_K), a.device))
    for m in (16, 8, 4, 2, 1, 1):
        mp = const(m * P, a)
        a = torch.where(geq(a, mp)[..., None], raw_sub(a, mp), a)
    return a


def eq_mod_p(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a == b (mod p) for partially-reduced inputs."""
    return (freeze(a) == freeze(b)).all(dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (freeze(a) == 0).all(dim=-1)


# --- x^e: the TPU kernel's plain version and the CUDA wrapper ---------------

POW_KERNEL = "ed25519_pow"      # csrc/ed25519_pow.cu

# pow kernel launches since import (reset by callers that count a run)
POW_LAUNCHES = 0


def exponent_bits(e: int) -> List[int]:
    """e's bits, most significant first (the TPU kernel's static bit
    string, which `pow_plain` walks)."""
    return [(e >> i) & 1 for i in reversed(range(e.bit_length()))]


# The shortest known addition chains of the exponents the port raises
# to, as (squarings, multiplies): ref10's pow22523 for (p-5)/8 = 2^252 - 3
# and its invert for p-2 = 2^255 - 21 (both build x^(2^250 - 1) from
# x^(2^k - 1) blocks of 5, 10, 20, 10, 50, 100, 50 squarings).  The
# kernel runs exactly these (`fe_pow22523`, `fe_invert` in
# csrc/fe25519_r32.cuh).
POW_CHAINS = {(P - 5) // 8: (251, 11), P - 2: (254, 11)}

# the kernel's schedules (csrc/ed25519_pow.cu): 0 = fixed windows of
# POW_WINDOW bits over the exponent's digits, else a chain of POW_CHAINS
POW_CHAIN_IDS = {(P - 5) // 8: 1, P - 2: 2}
POW_WINDOW = 4


def pow_schedule(e: int) -> Tuple[int, Tuple[int, ...]]:
    """(chain id, digits) the kernel takes for exponent e >= 1: a chain's
    id and no digits, or 0 and e's radix-16 digits, most significant
    first (the first not 0)."""
    if e in POW_CHAIN_IDS:
        return POW_CHAIN_IDS[e], ()
    digits = []
    while e:
        digits.append(e & ((1 << POW_WINDOW) - 1))
        e >>= POW_WINDOW
    return 0, tuple(reversed(digits))


def pow_int32_ops(e: int) -> int:
    """int32 operations a lane of the kernel does for exponent e, one per
    product of the radix-2^25.5 field's yardstick (55 a squaring, 100 a
    multiply): the chain of `POW_CHAINS` for its exponents; otherwise the
    window table x^2..x^15 (7 squarings, 7 multiplies), then per further
    digit 4 squarings and a multiply where the digit is not 0."""
    if e in POW_CHAINS:
        n_sqr, n_mul = POW_CHAINS[e]
    else:
        digits = pow_schedule(e)[1]
        n_sqr = 7 + POW_WINDOW * (len(digits) - 1)
        n_mul = 7 + sum(1 for d in digits[1:] if d)
    return 55 * n_sqr + 100 * n_mul


def pow_least_int32_ops(e: int) -> int:
    """int32 operations x^e needs at least, per lane: the shortest known
    chain of `POW_CHAINS`, counted as `pow_int32_ops` counts.  The bound
    of the pow kernel, which runs that chain (`pow_int32_ops(e)` is the
    same number)."""
    n_sqr, n_mul = POW_CHAINS[e]
    return 55 * n_sqr + 100 * n_mul


def _mul_tpu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`pallas_ed25519._fe_mul`, limb for limb: the same columns, but the
    high half is 20 limbs whose top keeps its full value through the 3
    exact passes (its row 39 is the zero column)."""
    cols = columns(a, b)
    lo, hi = cols[..., :NLIMBS], tF.pad(cols[..., NLIMBS:], (0, 1))
    for _ in range(3):
        hi = _vpass(hi, fold=None)
    return carry(lo + FOLD * hi)


def pow_plain(x: torch.Tensor, e: int) -> torch.Tensor:
    """[..., 20] weak limbs -> x^e as weak limbs: `_pow_kernel`'s body
    (square-and-multiply from r = 1, MSB first, branch-free select) on
    any device.  Limb for limb `pallas_ed25519.pow_p_pallas`."""
    r = one_like(x)
    for bit in exponent_bits(e):
        r = _mul_tpu(r, r)
        if bit:
            r = _mul_tpu(r, x)
    return r


@functools.lru_cache(maxsize=None)
def _pow_lib() -> ctypes.CDLL:
    lib = cuda_build.load(POW_KERNEL)
    fn = lib.ag_fe_pow
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _digits_tensor(digits: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    return torch.tensor(digits or (0,), dtype=I32, device=device)


def pow_p(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e mod p for [..., 20] int32 limbs (weak, signed) and a static
    exponent e >= 1; canonical limbs out.  CUDA tensors launch the kernel
    on the rows in place; CPU tensors run `pow_plain` and freeze."""
    global POW_LAUNCHES
    if x.dtype != I32 or x.shape[-1] != NLIMBS:
        raise ValueError(f"pow_p: [..., {NLIMBS}] int32 limbs, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if e < 1:
        raise ValueError(f"pow_p: exponent must be >= 1, got {e}")
    dev = x.device
    if dev.type == "cpu":
        return freeze(pow_plain(x, e))
    if dev.type != "cuda":
        raise ValueError(f"pow_p: unsupported device {dev}")
    rows = x.reshape(-1, NLIMBS).contiguous()      # [B, 20], in place
    out = torch.empty_like(rows)
    B = rows.shape[0]
    if B:
        chain, digits = pow_schedule(e)
        dig = _digits_tensor(digits, dev)
        lib = _pow_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ag_fe_pow(rows.data_ptr(), out.data_ptr(), B, chain,
                                dig.data_ptr(), len(digits), stream)
        if err != 0:
            raise RuntimeError(f"pow kernel launch failed: CUDA error {err}")
        POW_LAUNCHES += 1
    return out.view(x.shape)


def inv(a: torch.Tensor) -> torch.Tensor:
    return pow_p(a, P - 2)
