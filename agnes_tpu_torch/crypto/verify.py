"""Fused Ed25519 verify: prologue, CUDA kernel wrappers and the kernel's
plain PyTorch version (twin of `agnes_tpu.crypto.pallas_verify`).

Boundary (kept from `_verify_jit`, so the kernel can be diffed alone):

  prologue (`prologue`, plain torch ops, as XLA ran it around the
  Pallas call): SHA-512 of R || A || M, Barrett reduction mod L, the
  S < L check, y/sign split of A and R, recoding of S and k into digits:
  52 signed 5-bit digits each (window 5) or 65 unsigned 4-bit digits
  each (window 4);

  kernel (`verify_signed5`, `verify_w4`): y limbs [20, B] int32 and sign
  bits [B] int32 of A and R, digit planes [52 or 65, B] int32 of S and k
  ->  one int32 ok per lane.  It computes exactly the verdicts of
  `pallas_verify._verify_kernel` (signed5=True and signed5=False):
  reject a non-canonical y (>= p), a non-residue x^2 and x = 0 with
  sign = 1, then check the cofactored equation [8]([S]B - [k]A) == [8]R
  projectively.

Both wrappers launch the CUDA kernel
(`agnes_tpu_torch/csrc/ed25519_verify.cu`, a template over the window,
computing in radix-2^32 limbs) for tensors on the card and run
`verify_plain` — a transcription of the Pallas kernel body over [20, B]
tensors with the same 20 x 13-bit signed int32 limbs — for tensors on
the CPU.  Nothing else: a failed build or
launch raises.  `LAUNCHES` and `LAUNCHES_W4` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from agnes_tpu_torch import cuda_build
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import field as F
from agnes_tpu_torch.crypto import scalar as S
from agnes_tpu_torch.crypto import sha512
from agnes_tpu_torch.crypto.field import (
    BITS,
    FOLD,
    I32,
    LMASK,
    NLIMBS,
    P,
    SUB_K,
    bytes32_to_limbs,
    limbs32,
    to_limbs,
)

N_WIN5 = 52                # 5-bit signed windows covering 260 bits
N_ENT = 17                 # table entries 0..16 for signed 5-bit digits
N_WIN4 = 65                # 4-bit unsigned windows covering 260 bits
N_ENT4 = 16                # table entries 0..15 for 4-bit digits
KERNEL = "ed25519_verify"  # csrc/ed25519_verify.cu

# kernel launches since import, by window (reset by callers that count
# a run)
LAUNCHES = 0
LAUNCHES_W4 = 0

# Work of one lane of the CUDA kernel, counted from its structure (it is
# data-independent: fixed windows, fixed chains).  The bound's yardstick
# is the radix-2^25.5 field the kernel was first written in: a multiply
# makes 100 products of 32 x 32 bits, a squaring 55, each counted as one
# int32 operation against the card's IMAD rate — the convention of the
# BLS kernels' bounds.  The kernel now computes in radix 2^32
# (csrc/fe25519_r32.cuh: 64 products a multiply, 36 a squaring, each a
# lo and a hi half in PTX carry chains); the count is kept, so the
# kernel's share of its bound reads the same before and after.
# chip_smoke.py turns this into the kernel's bound.
FIELD_MULS_PER_LANE = 1757
FIELD_SQRS_PER_LANE = 1574
INT32_OPS_PER_LANE = 100 * FIELD_MULS_PER_LANE + 55 * FIELD_SQRS_PER_LANE
# bytes a lane moves: y limbs and sign of A and R, two digit planes, ok
BYTES_PER_LANE = 4 * (2 * NLIMBS + 2 + 2 * N_WIN5 + 1)
# window 4: one -A table entry fewer (a niels add of 8 multiplies and its
# conversion, 9), and 65 windows of 3 plain + 1 T doubling (13
# multiplies, 16 squarings), a -A add (8) and a B add (6) in place of 52
# windows of 4 + 1 doublings (16, 20), 8 and 6: the same squarings
FIELD_MULS_PER_LANE_W4 = (FIELD_MULS_PER_LANE - 9 - N_WIN5 * (16 + 8 + 6)
                          + N_WIN4 * (13 + 8 + 6))
INT32_OPS_PER_LANE_W4 = (100 * FIELD_MULS_PER_LANE_W4
                         + 55 * FIELD_SQRS_PER_LANE)
BYTES_PER_LANE_W4 = 4 * (2 * NLIMBS + 2 + 2 * N_WIN4 + 1)

_D = to_limbs(ref.D)
_D2 = to_limbs(2 * ref.D % P)
_SQRT_M1 = to_limbs(ref.SQRT_M1)
_P_LIMBS = to_limbs(P)


# --- plain field ops on [20, ...batch] tensors ------------------------------
# The Pallas kernel's radix-2^13 signed-limb scheme, limb axis FIRST
# (see field_jax's docstring for the int32 bound proofs).


def _add_const(a: torch.Tensor, c: Sequence[int]) -> torch.Tensor:
    return a + torch.tensor(list(c), dtype=I32,
                            device=a.device).reshape((NLIMBS,)
                                                     + (1,) * (a.ndim - 1))


@functools.lru_cache(maxsize=None)
def _vp_scales(n: int, fold, device: torch.device, ndim: int):
    """`field._pass_scales` shaped [n, 1, ...] to broadcast over the
    batch axes of an `ndim`-axis limb-first tensor."""
    shape = (-1,) + (1,) * (ndim - 1)
    return tuple(s.view(shape) for s in F._pass_scales(n, fold, device))


def _vp(r: torch.Tensor, fold) -> torch.Tensor:
    """One vectorized carry pass along the leading limb axis: the
    fused multiply-add form of `field._vpass` (fold=None: exact, the top
    limb intact)."""
    hi = r >> BITS                 # arithmetic: signed carries
    lo_scale, up_scale = _vp_scales(r.shape[0], fold, r.device, r.ndim)
    return torch.addcmul(r, hi, lo_scale).addcmul_(hi.roll(1, 0), up_scale)


def _carry(r: torch.Tensor, passes: int) -> torch.Tensor:
    for _ in range(passes):
        r = _vp(r, FOLD)
    return r


def _fadd(a, b):
    return _carry(a + b, 2)


def _fsub(a, b):
    return _carry(a - b, 2)


def _mul_cols(cols: torch.Tensor) -> torch.Tensor:
    """[39, ...] raw schoolbook columns -> weak [20, ...] limbs (the high
    half gets a zero row 39, as in the Pallas kernel)."""
    lo = cols[:NLIMBS]
    hi = torch.cat([cols[NLIMBS:], torch.zeros_like(cols[:1])])
    for _ in range(2):
        hi = _vp(hi, None)
    return _carry(lo + FOLD * hi, 3)


def _fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product's columns by `field.columns` with the limb axes first,
    so every operation runs over the contiguous batch axes."""
    return _mul_cols(F.columns(a, b, dim=0))


def _fsqr(a: torch.Tensor) -> torch.Tensor:
    """Squaring: the product's columns are the symmetric schoolbook's
    (2 a_i a_j + a_k^2), the same integers."""
    return _fmul(a, a)


def _fmul_const(a: torch.Tensor, c: Sequence[int]) -> torch.Tensor:
    c = torch.tensor(list(c), dtype=I32, device=a.device)
    return _fmul(a, c.view((NLIMBS,) + (1,) * (a.ndim - 1)))


def _pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        x = _fsqr(x)
    return x


def _sqrt_chain(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3): 251 squarings + 11 muls."""
    t0 = _fsqr(z)                       # 2
    t1 = _fmul(z, _pow2k(t0, 2))        # 9
    t0 = _fmul(t0, t1)                  # 11
    t0 = _fmul(t1, _fsqr(t0))           # 31 = 2^5 - 1
    t1 = _pow2k(t0, 5)
    t0 = _fmul(t1, t0)                  # 2^10 - 1
    t1 = _pow2k(t0, 10)
    t1 = _fmul(t1, t0)                  # 2^20 - 1
    t2 = _pow2k(t1, 20)
    t1 = _fmul(t2, t1)                  # 2^40 - 1
    t1 = _pow2k(t1, 10)
    t0 = _fmul(t1, t0)                  # 2^50 - 1
    t1 = _pow2k(t0, 50)
    t1 = _fmul(t1, t0)                  # 2^100 - 1
    t2 = _pow2k(t1, 100)
    t1 = _fmul(t2, t1)                  # 2^200 - 1
    t1 = _pow2k(t1, 50)
    t0 = _fmul(t1, t0)                  # 2^250 - 1
    return _fmul(_pow2k(t0, 2), z)      # 2^252 - 3


def _one(shape, device) -> torch.Tensor:
    one = torch.zeros(shape, dtype=I32, device=device)
    one[0] = 1
    return one


def _chain_seq(r: torch.Tensor):
    """Sequential signed carry chain over the limb axis."""
    c = torch.zeros_like(r[0])
    outs = []
    for k in range(r.shape[0]):
        t = r[k] + c
        outs.append(t & LMASK)
        c = t >> BITS
    return torch.stack(outs, dim=0), c


def _geq_const(a: torch.Tensor, c: Sequence[int]) -> torch.Tensor:
    """a >= c on strict limbs; returns [batch] bool."""
    gt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for k in reversed(range(NLIMBS)):
        gt = gt | (eq & (a[k] > c[k]))
        eq = eq & (a[k] == c[k])
    return gt | eq


def _sub_const(a: torch.Tensor, c: Sequence[int]) -> torch.Tensor:
    """a - c for a >= c, strict limbs in/out (sequential borrow)."""
    cy = torch.zeros_like(a[0])
    outs = []
    for k in range(NLIMBS):
        t = a[k] - c[k] + cy
        outs.append(t & LMASK)
        cy = t >> BITS
    return torch.stack(outs, dim=0)


def _freeze(a: torch.Tensor) -> torch.Tensor:
    """Canonical representative in [0, p): add 64p, exact-normalize,
    conditional-subtract ladder."""
    r = _add_const(a, SUB_K)
    for _ in range(3):
        r = _vp(r, FOLD)
    r, c = _chain_seq(r)
    r = torch.cat([r[0:1] + FOLD * c[None], r[1:]], dim=0)
    r, c2 = _chain_seq(r)
    r = torch.cat([r[0:1] + FOLD * c2[None], r[1:]], dim=0)
    for m in (16, 8, 4, 2, 1, 1):
        mp = to_limbs(m * P)
        ge = _geq_const(r, mp)
        r = torch.where(ge[None], _sub_const(r, mp), r)
    return r


def _is_zero(a: torch.Tensor) -> torch.Tensor:
    return (_freeze(a) == 0).all(dim=0)


def _where_fe(mask: torch.Tensor, a, b):
    return torch.where(mask[None], a, b)


# --- plain point ops (extended coords; each coord [20, ...batch]) ----------


def _pt_dbl(X, Y, Z, want_t: bool):
    """dbl-2008-hwcd for a=-1: 4 squarings + 3 (4 with T) muls."""
    A = _fsqr(X)
    B = _fsqr(Y)
    ZZ = _fsqr(Z)
    C = ZZ + ZZ                              # raw; consumed by a sub
    E = _fsub(_fsub(_fsqr(_fadd(X, Y)), A), B)
    G = _fsub(B, A)
    F = _fsub(G, C)
    H = _carry(-(A + B), 2)
    X3 = _fmul(E, F)
    Y3 = _fmul(G, H)
    Z3 = _fmul(F, G)
    T3 = _fmul(E, H) if want_t else None
    return X3, Y3, Z3, T3


def _pt_add_niels(X1, Y1, Z1, T1, n_ypx, n_ymx, n_t2d, n_z2, want_t: bool):
    """extended + projective-niels entry (Y2+X2, Y2-X2, 2d*T2, 2*Z2);
    n_z2=None for affine entries (Z2=1 -> D = Z1+Z1)."""
    A = _fmul(_fsub(Y1, X1), n_ymx)
    B = _fmul(_fadd(Y1, X1), n_ypx)
    C = _fmul(T1, n_t2d)
    D = _fmul(Z1, n_z2) if n_z2 is not None else _fadd(Z1, Z1)
    E = _fsub(B, A)
    F = _fsub(D, C)
    G = _fadd(D, C)
    H = _fadd(B, A)
    X3 = _fmul(E, F)
    Y3 = _fmul(G, H)
    Z3 = _fmul(F, G)
    T3 = _fmul(E, H) if want_t else None
    return X3, Y3, Z3, T3


def _pt_add_ext(p, q, want_t: bool):
    """Unified extended+extended addition (table build only)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = _fmul(_fsub(Y1, X1), _fsub(Y2, X2))
    B = _fmul(_fadd(Y1, X1), _fadd(Y2, X2))
    C = _fmul_const(_fmul(T1, T2), _D2)
    ZZ = _fmul(Z1, Z2)
    D = ZZ + ZZ
    E = _fsub(B, A)
    F = _carry(D - C, 2)
    G = _carry(D + C, 2)
    H = _fadd(B, A)
    return (_fmul(E, F), _fmul(G, H), _fmul(F, G),
            _fmul(E, H) if want_t else None)


def _to_niels(p):
    """Extended point -> (Y+X, Y-X, 2d*T, 2Z) projective-niels entry."""
    X, Y, Z, T = p
    return (_fadd(Y, X), _fsub(Y, X), _fmul_const(T, _D2), _fadd(Z, Z))


def _decompress(y: torch.Tensor, sign: torch.Tensor):
    """Strict y limbs [20, B] + sign [B] -> (x limbs, ok [B] bool)."""
    one = _one(y.shape, y.device)
    ok = ~_geq_const(y, _P_LIMBS)
    y2 = _fsqr(y)
    u = _fsub(y2, one)
    v = _carry(_fmul_const(y2, _D) + one, 2)
    v3 = _fmul(v, _fsqr(v))
    uv3 = _fmul(u, v3)
    uv7 = _fmul(uv3, _fmul(v3, v))
    x = _fmul(uv3, _sqrt_chain(uv7))
    vx2 = _fmul(v, _fsqr(x))
    root_direct = _is_zero(vx2 - u)
    root_flip = _is_zero(vx2 + u)
    x = _where_fe(root_flip, _fmul_const(x, _SQRT_M1), x)
    ok &= root_direct | root_flip
    xf = _freeze(x)
    x_is_zero = (xf == 0).all(dim=0)
    flip = (xf[0] & 1) != sign
    x = _where_fe(flip, _fsub(torch.zeros_like(xf), xf), xf)
    ok &= ~(x_is_zero & (sign == 1))
    return x, ok


# --- fixed-base multiples of B (host constants) -----------------------------


@functools.lru_cache(maxsize=None)
def _btable_ints() -> Tuple[Tuple[int, int, int], ...]:
    """((y+x), (y-x), 2dxy) mod p of the affine e*B, e = 0..16."""
    out = []
    for e in range(N_ENT):
        if e == 0:
            x, y = 0, 1
        else:
            pt = ref._mul(e, ref.BASE)
            zi = ref._inv(pt[2])
            x, y = pt[0] * zi % P, pt[1] * zi % P
        out.append(((y + x) % P, (y - x) % P, 2 * ref.D * x * y % P))
    return tuple(out)


def _btable13(device) -> torch.Tensor:
    """[17, 3, 20] int32: the B table in the plain version's limbs."""
    return torch.tensor([[to_limbs(c) for c in ent] for ent in _btable_ints()],
                        dtype=I32, device=device)


def verify_plain(ya: torch.Tensor, sa: torch.Tensor, yr: torch.Tensor,
                 sr: torch.Tensor, sdig: torch.Tensor,
                 kdig: torch.Tensor, window: int = 5) -> torch.Tensor:
    """The kernel body in plain PyTorch: the same inputs and verdicts as
    `verify_signed5` (window 5) or `verify_w4` (window 4), ok [B] int32,
    on any device.  Mirrors `_verify_kernel(signed5=window == 5)` step
    for step; the table picks are gathers instead of the Pallas select
    tree."""
    signed5 = _window(window) == 5
    n_ent, n_win = (N_ENT, N_WIN5) if signed5 else (N_ENT4, N_WIN4)
    dev = ya.device
    B = ya.shape[1]
    one = _one((NLIMBS, B), dev)
    zero = torch.zeros_like(one)

    xa, ok_a = _decompress(ya, sa)
    xr, ok_r = _decompress(yr, sr)

    # -A extended (Z=1): negate x and t
    nax = _fsub(zero, xa)
    na = (nax, ya, one, _fmul(nax, ya))

    # table[e] = e * (-A) in projective-niels form
    ext = [None] * n_ent
    ext[1] = na
    ext[2] = _pt_dbl(*na[:3], want_t=True)
    for e in range(3, n_ent, 2):
        ext[e] = _pt_add_ext(ext[e - 2], ext[2], want_t=True)
    for e in range(4, n_ent, 2):
        p = ext[e // 2]
        ext[e] = _pt_dbl(p[0], p[1], p[2], want_t=True)
    id_niels = (one, one, zero, _fadd(one, one))
    atab = torch.stack([torch.stack(id_niels)]
                       + [torch.stack(_to_niels(ext[e]))
                          for e in range(1, n_ent)])  # [n_ent, 4, 20, B]
    del ext
    btab = _btable13(dev)[:n_ent]                        # [n_ent, 3, 20]

    X, Y, Z = zero, one, one
    for i in range(n_win):
        for _ in range(window - 1):
            X, Y, Z, _ = _pt_dbl(X, Y, Z, want_t=False)
        X, Y, Z, T = _pt_dbl(X, Y, Z, want_t=True)
        kd, sd = kdig[i], sdig[i]
        idx = kd.abs().long().reshape(1, 1, 1, B).expand(1, 4, NLIMBS, B)
        n_ypx, n_ymx, n_t2d, n_z2 = torch.gather(atab, 0, idx)[0]
        b_ypx, b_ymx, b_t2d = btab[sd.abs().long()].permute(1, 2, 0)
        if signed5:
            # -(Y+X, Y-X, 2dT, 2Z) = (Y-X, Y+X, -2dT, 2Z)
            neg_k, neg_s = kd < 0, sd < 0
            n_ypx, n_ymx = (_where_fe(neg_k, n_ymx, n_ypx),
                            _where_fe(neg_k, n_ypx, n_ymx))
            n_t2d = _where_fe(neg_k, _carry(-n_t2d, 2), n_t2d)
            b_ypx, b_ymx = (_where_fe(neg_s, b_ymx, b_ypx),
                            _where_fe(neg_s, b_ypx, b_ymx))
            b_t2d = _where_fe(neg_s, _carry(-b_t2d, 2), b_t2d)
        X, Y, Z, T = _pt_add_niels(X, Y, Z, T, n_ypx, n_ymx, n_t2d, n_z2,
                                   want_t=True)
        X, Y, Z, _ = _pt_add_niels(X, Y, Z, T, b_ypx, b_ymx, b_t2d, None,
                                   want_t=False)

    # cofactored equality: [8]Q == [8]R, projectively
    RX, RY, RZ = xr, yr, one
    for _ in range(3):
        X, Y, Z, _ = _pt_dbl(X, Y, Z, want_t=False)
        RX, RY, RZ, _ = _pt_dbl(RX, RY, RZ, want_t=False)
    eqx = _is_zero(_fmul(X, RZ) - _fmul(RX, Z))
    eqy = _is_zero(_fmul(Y, RZ) - _fmul(RY, Z))
    return (ok_a & ok_r & eqx & eqy).to(I32)


# --- the CUDA kernel --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_consts() -> Tuple[int, ...]:
    """The kernel's constant block (432 int32, radix-2^32 limbs): d, 2d,
    sqrt(-1), then the B table's 17 x (y+x, y-x, 2dxy)."""
    out = limbs32(ref.D) + limbs32(2 * ref.D % P) + limbs32(ref.SQRT_M1)
    for ent in _btable_ints():
        for c in ent:
            out += limbs32(c)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    for fn in (lib.ag_ed25519_verify_signed5, lib.ag_ed25519_verify_w4):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _consts_tensor(device: torch.device) -> torch.Tensor:
    """The constant block on `device`, uploaded once (read-only)."""
    return torch.tensor(kernel_consts(), dtype=I32, device=device)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != I32:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _window(window: int) -> int:
    if window not in (4, 5):
        raise ValueError(f"window must be 4 or 5: {window}")
    return window


def _verify_call(window: int, ya, sa, yr, sr, sdig, kdig):
    """(ok [B] int32, whether the kernel was launched)."""
    n_win = N_WIN5 if _window(window) == 5 else N_WIN4
    dev = ya.device
    B = ya.shape[1] if ya.ndim == 2 else -1
    for name, t, shape in (("ya", ya, (NLIMBS, B)), ("sa", sa, (B,)),
                           ("yr", yr, (NLIMBS, B)), ("sr", sr, (B,)),
                           ("sdig", sdig, (n_win, B)),
                           ("kdig", kdig, (n_win, B))):
        _check(name, t, shape, dev)
    if dev.type == "cpu":
        return verify_plain(ya, sa, yr, sr, sdig, kdig, window), False
    if dev.type != "cuda":
        raise ValueError(f"ed25519 verify: unsupported device {dev}")
    out = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return out, False
    lib = _lib()
    fn = (lib.ag_ed25519_verify_signed5 if window == 5
          else lib.ag_ed25519_verify_w4)
    consts = _consts_tensor(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ya.data_ptr(), sa.data_ptr(), yr.data_ptr(), sr.data_ptr(),
                 sdig.data_ptr(), kdig.data_ptr(), consts.data_ptr(),
                 out.data_ptr(), B, stream)
    if err != 0:
        raise RuntimeError(f"ed25519 verify kernel (window {window}) launch "
                           f"failed: CUDA error {err}")
    return out, True


def verify_signed5(ya: torch.Tensor, sa: torch.Tensor, yr: torch.Tensor,
                   sr: torch.Tensor, sdig: torch.Tensor,
                   kdig: torch.Tensor) -> torch.Tensor:
    """Per-lane verdicts (ok [B] int32) from the kernel boundary inputs
    with 52 signed 5-bit digit planes.  CUDA tensors launch the kernel;
    CPU tensors run `verify_plain`."""
    global LAUNCHES
    out, launched = _verify_call(5, ya, sa, yr, sr, sdig, kdig)
    LAUNCHES += launched
    return out


def verify_w4(ya: torch.Tensor, sa: torch.Tensor, yr: torch.Tensor,
              sr: torch.Tensor, sdig: torch.Tensor,
              kdig: torch.Tensor) -> torch.Tensor:
    """`verify_signed5` with 65 unsigned 4-bit digit planes (the
    kernel's window-4 instance)."""
    global LAUNCHES_W4
    out, launched = _verify_call(4, ya, sa, yr, sr, sdig, kdig)
    LAUNCHES_W4 += launched
    return out


# --- the XLA prologue of _verify_jit, in plain torch ops --------------------


def _digits52_signed(limbs: torch.Tensor) -> torch.Tensor:
    """[B, 20] scalar limbs -> [52, B] SIGNED 5-bit digits in [-16, 15],
    most significant window first (carry recoding; safe for any
    32-byte value, see the JAX twin)."""
    raw = []
    for j in range(N_WIN5):
        lo = 5 * j
        li, off = lo // BITS, lo % BITS
        d = limbs[..., li] >> off
        if off > BITS - 5 and li + 1 < NLIMBS:
            d = d | (limbs[..., li + 1] << (BITS - off))
        raw.append(d & 31)
    carry = torch.zeros_like(raw[0])
    outs = []
    for j in range(N_WIN5):              # lsb-first carry walk
        t = raw[j] + carry
        ge = t >= 16
        outs.append(torch.where(ge, t - 32, t))
        carry = ge.to(t.dtype)
    return torch.stack(outs[::-1], dim=0)


def _digits65(limbs: torch.Tensor) -> torch.Tensor:
    """[B, 20] scalar limbs -> [65, B] unsigned 4-bit digits, most
    significant window first."""
    outs = []
    for j in range(N_WIN4):
        lo = 4 * j
        li, off = lo // BITS, lo % BITS
        d = limbs[..., li] >> off
        if off > BITS - 4 and li + 1 < NLIMBS:
            d = d | (limbs[..., li + 1] << (BITS - off))
        outs.append(d & 15)
    return torch.stack(outs[::-1], dim=0)


def _ysign(b32: torch.Tensor):
    """[B, 32] byte values -> (y limbs [B, 20], sign [B])."""
    b = b32.to(I32)
    sign = b[..., 31] >> 7
    b = torch.cat([b[..., :31], (b[..., 31] & 0x7F)[..., None]], dim=-1)
    return bytes32_to_limbs(b), sign


def prologue(pub: torch.Tensor, sig: torch.Tensor, msg_blocks: torch.Tensor,
             window: int = 5):
    """(pub [B,32], sig [B,64], blocks [B,n,32]) -> the kernel's inputs
    (ya, sa, yr, sr, sdig, kdig), contiguous in the kernel's layout, and
    ok_s [B] bool (S < L).  The digit planes are for `window` (5: signed,
    52; 4: unsigned, 65)."""
    digits = _digits52_signed if _window(window) == 5 else _digits65
    k = S.barrett_reduce(S.digest_to_limbs(sha512.sha512_blocks(msg_blocks)))
    s_limbs = S.scalar_from_bytes32(sig[..., 32:])
    ok_s = S.is_canonical(s_limbs)
    ya, sa = _ysign(pub)
    yr, sr = _ysign(sig[..., :32])
    return ((ya.t().contiguous(), sa.contiguous(),
             yr.t().contiguous(), sr.contiguous(),
             digits(s_limbs).contiguous(), digits(k).contiguous()), ok_s)
