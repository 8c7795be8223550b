"""BLS12-381 pairing product: optimal-ate Miller loop + final
exponentiation (twin of `agnes_tpu.crypto.bls_pairing_jax`).

The aggregate lane's O(1) per class: per class, the product
e(-G1, asig) * e(apk, H(msg)) == 1 is decided on the device and only a
[C] bool vector crosses back to the host (`bls_pairing_product`).

The algorithm is the twin's, step for step (its module docstring has
the derivation): G2 points in homogeneous projective Fp2 coordinates
and G1 points in projective Fp — the MSM's outputs feed in directly;
line evaluations scaled by subfield factors the final exponentiation's
easy part kills; the final exponentiation f^(3 (p^12-1)/r), the CUBE of
`bls_ref.final_exponentiate`'s value, through the x-chain
3H = (x-1)^2 (x+p) (x^2+p^2-1) + 3 (asserted at import).  Degenerate
inputs collapse to a rejecting verdict; a pair with an identity point
is skipped through an explicit Z == 0 (mod p) select.

The twin's rolled `fori_loop`s are Python loops over the same static bit
tables.  Where the twin computes a select-gated step on every iteration
(the Miller loop's addition step, the exponentiation's multiply), the
port computes it on set bits only: the kept values and their stacked
reduce are the same, so the limbs are the twin's.  Every base-field
product and reduce is a launch of the CUDA kernels of `csrc/bls_fp.cu`
on the card; the rest is eager torch, so a dispatch is several hundred
thousand small launches (launch-bound).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from agnes_tpu_torch.crypto import bls_field as BF
from agnes_tpu_torch.crypto import bls_ref as ref
from agnes_tpu_torch.crypto import bls_tower as T
from agnes_tpu_torch.crypto.bls_field import (
    FV,
    FV2,
    NLIMBS,
    RED_BOUND,
    fv2_add,
    fv2_sub,
    fv_mul_pairs,
    fv_sub,
)
from agnes_tpu_torch.crypto.bls_tower import FV12

# the positive Miller loop count and its static bit table (bits below
# the MSB, MSB first)
_ATE = -ref.X_PARAM
_ATE_BITS: Tuple[int, ...] = tuple(
    (_ATE >> i) & 1 for i in range(_ATE.bit_length() - 2, -1, -1))

# the final exponentiation's hard-part identity, asserted at import
# (the bls_ref derive-and-assert pattern): 3H = (x-1)^2 (x+p)
# (x^2+p^2-1) + 3 for H = (p^4-p^2+1)/r
_P, _R, _X = ref.P, ref.R, ref.X_PARAM
assert (ref.P**4 - ref.P**2 + 1) % ref.R == 0
assert (_X - 1) ** 2 * (_X + _P) * (_X**2 + _P**2 - 1) + 3 \
    == 3 * ((_P**4 - _P**2 + 1) // _R)


def _dbl(x: FV2) -> FV2:
    return fv2_add(x, x)


def _mul3(x: FV2) -> FV2:
    return fv2_add(_dbl(x), x)


def _wrap_g2(q: torch.Tensor, bound: int = RED_BOUND):
    """[..., 3, 2, NLIMBS] -> (X, Y, Z) FV2 triple."""
    return tuple(FV2(FV(q[..., k, 0, :], bound),
                     FV(q[..., k, 1, :], bound)) for k in range(3))


def _wrap_g1(p: torch.Tensor, bound: int = RED_BOUND):
    """[..., 3, NLIMBS] -> (X, Y, Z) FV triple."""
    return tuple(FV(p[..., k, :], bound) for k in range(3))


def _mul_fp(x: FV2, s: FV) -> List[tuple]:
    """Operand pairs of the Fp2 x Fp product (two base products)."""
    return [(x.c0, s), (x.c1, s)]


def _dbl_step(R, Pp):
    """Projective doubling of R on y^2 z = x^3 + b' z^3 over Fp2 with
    the tangent line evaluated at the projective G1 point Pp,
    untwisted and uniformly scaled by w^3 * 2YZ^2 * Z_P (subfield
    factors, killed by the easy part).  Returns (2R, line) where line
    is the sparse coefficient triple (c0, c2, c3) over {1, w^2, w^3}:
      c0 = (2 Y^2 Z - 3 X^3) * Z_P
      c2 = 3 X^2 Z * X_P
      c3 = -2 Y Z^2 * Y_P."""
    X, Y, Z = R
    XP, YP, ZP = Pp
    # layer 1: the independent squares/products
    pr = fv_mul_pairs(
        T.fv2_mul_pairs_expand_many([(X, X), (Y, Y), (Z, Z), (Y, Z),
                                     (X, Y)]))
    t0, t1, t2, S, XY = T.fv2_mul_pairs_combine_many(pr, 5)
    W = _mul3(t0)
    # layer 2
    pr = fv_mul_pairs(
        T.fv2_mul_pairs_expand_many(
            [(XY, S), (W, W), (S, S), (t1, Z), (t0, X), (W, Z),
             (Y, t2)]))
    B, W2, Ssq, t1Z, t0X, WZ, Yt2 = T.fv2_mul_pairs_combine_many(pr, 7)
    H = fv2_sub(W2, _dbl(_dbl(_dbl(B))))
    # layer 3: outputs + line coefficients (Fp2 x Fp products ride the
    # same stacked call)
    pairs = T.fv2_mul_pairs_expand_many(
        [(H, S), (W, fv2_sub(_dbl(_dbl(B)), H)), (t1, Ssq), (S, Ssq)])
    c0_in = fv2_sub(_dbl(t1Z), _mul3(t0X))
    pairs += _mul_fp(c0_in, ZP) + _mul_fp(WZ, XP) + _mul_fp(Yt2, YP)
    pr = fv_mul_pairs(pairs)
    HS, Wt, t1S2, S3 = T.fv2_mul_pairs_combine_many(pr, 4)
    c0 = FV2(pr[12], pr[13])
    c2 = FV2(pr[14], pr[15])
    c3n = FV2(pr[16], pr[17])                  # -c3
    e8 = lambda v: _dbl(_dbl(_dbl(v)))         # noqa: E731
    # outputs UNREDUCED: consumers (the next multiply's stacked
    # kernel, or the body's one stacked carry reduction) handle it
    return (_dbl(HS), fv2_sub(Wt, e8(t1S2)), e8(S3)), \
        (c0, c2, _dbl(c3n))


def _add_step(R, Q, Pp):
    """Projective addition R + Q with the chord line through them
    evaluated at Pp, scaled by B * Z1 * Z_P (subfield factors):
      A = Y2 Z1 - Y1 Z2,  B = X2 Z1 - X1 Z2
      c0 = (Y1 B - A X1) * Z_P ; c2 = A Z1 * X_P ; c3 = -B Z1 * Y_P."""
    X1, Y1, Z1 = R
    X2, Y2, Z2 = Q
    XP, YP, ZP = Pp
    pr = fv_mul_pairs(T.fv2_mul_pairs_expand_many(
        [(Y2, Z1), (Y1, Z2), (X2, Z1), (X1, Z2), (Z1, Z2)]))
    Y2Z1, Y1Z2, X2Z1, X1Z2, Z1Z2 = T.fv2_mul_pairs_combine_many(pr, 5)
    A = fv2_sub(Y2Z1, Y1Z2)
    B = fv2_sub(X2Z1, X1Z2)
    pr = fv_mul_pairs(T.fv2_mul_pairs_expand_many(
        [(B, B), (A, A), (Y1, B), (A, X1), (A, Z1), (B, Z1)]))
    B2, A2, Y1B, AX1, AZ1, BZ1 = T.fv2_mul_pairs_combine_many(pr, 6)
    pr = fv_mul_pairs(T.fv2_mul_pairs_expand_many(
        [(B2, B), (B2, X1Z2), (A2, Z1Z2)]))
    B3, vX1Z2, u2Z = T.fv2_mul_pairs_combine_many(pr, 3)
    Wn = fv2_sub(fv2_sub(u2Z, B3), _dbl(vX1Z2))
    pairs = T.fv2_mul_pairs_expand_many(
        [(B, Wn), (A, fv2_sub(vX1Z2, Wn)), (B3, Y1Z2), (B3, Z1Z2)])
    pairs += (_mul_fp(fv2_sub(Y1B, AX1), ZP) + _mul_fp(AZ1, XP)
              + _mul_fp(BZ1, YP))
    pr = fv_mul_pairs(pairs)
    X3, Yt, B3Y, Z3 = T.fv2_mul_pairs_combine_many(pr, 4)
    c0 = FV2(pr[12], pr[13])
    c2 = FV2(pr[14], pr[15])
    c3n = FV2(pr[16], pr[17])
    return (X3, fv2_sub(Yt, B3Y), Z3), (c0, c2, c3n)


def _mul_line(f: FV12, line) -> FV12:
    """f * (c0 + c2 w^2 + c3 w^3) with c3 carried NEGATED (the line
    builders emit -c3 to spare a negation) — a full Karatsuba Fp12
    multiply against the padded sparse element (the twin's choice; the
    port keeps its products so the limbs match)."""
    c0, c2, c3n = line
    zero = FV2(BF._zero_fv(c0.c0.a), BF._zero_fv(c0.c0.a))
    neg3 = FV2(fv_sub(BF._zero_fv(c3n.c0.a), c3n.c0),
               fv_sub(BF._zero_fv(c3n.c1.a), c3n.c1))
    ln = FV12((c0, zero, c2, neg3, zero, zero))
    return T.fv12_mul(f, ln)


_red12 = T.fv12_force_red


def miller_loop(q_pts: torch.Tensor, p_pts: torch.Tensor) -> FV12:
    """Batched optimal-ate Miller loop: q_pts [..., 3, 2, NLIMBS]
    projective G2 (the twist), p_pts [..., 3, NLIMBS] projective G1.
    Returns the Miller value as an FV12 (equal to `bls_ref`'s affine
    miller_loop up to subfield factors — compare after the final
    exponentiation).  A Python loop over the static ate bits: the
    doubling step every iteration, the addition step on set bits only
    (the twin computes it every iteration and selects; a stacked reduce
    is row by row, so reducing only the kept values gives the twin's
    limbs); each iteration's carry values reduce in ONE stacked call."""
    Pp = _wrap_g1(p_pts)
    Q = _wrap_g2(q_pts)
    R = Q
    f = T.fv12_in(T.fv12_out(T.fv12_one(q_pts.shape[:-3], q_pts.device)),
                  RED_BOUND)
    for bit in _ATE_BITS:
        R, line = _dbl_step(R, Pp)
        f = _mul_line(T.fv12_square(f), line)
        if bit:
            R, line_a = _add_step(R, Q, Pp)
            f = _mul_line(f, line_a)
        red = BF.fv_reduce_stack(
            [c for fc in R for c in (fc.c0, fc.c1)] + T.fv12_comps(f))
        R = tuple(FV2(red[2 * k], red[2 * k + 1]) for k in range(3))
        f = FV12(tuple(FV2(red[6 + 2 * j], red[7 + 2 * j])
                       for j in range(6)))
    return f


# --- final exponentiation ----------------------------------------------------

def _pow_static(f: FV12, e: int) -> FV12:
    """f^e for UNITARY f and a static POSITIVE exponent: cyclotomic
    square-and-multiply over e's bits, the multiply on set bits only
    (the twin multiplies every step and selects; the reduce is row by
    row, so the limbs are the twin's)."""
    assert e > 0
    bit_list = tuple((e >> i) & 1
                     for i in range(e.bit_length() - 2, -1, -1))
    base = T.fv12_in(T.fv12_out(_red12(f)), RED_BOUND)
    acc = base
    for bit in bit_list:
        sq = T.fv12_cyclotomic_square(acc)
        acc = _red12(T.fv12_mul(sq, base) if bit else sq)
    return acc


def final_exponentiate(x: FV12) -> FV12:
    """x^(3 (p^12-1)/r) — the CUBE of `bls_ref.final_exponentiate`
    (module docstring; verdict-equivalent, differential-pinned).
    Easy part (p^6-1)(p^2+1) pays the one Fp12 inversion; hard part
    3H via the x-chain: a = m^((x-1)^2), b = a^(x+p) =
    conj(a^|x|) frob(a), c = b^(x^2+p^2-1) = b^(x^2) frob^2(b)
    conj(b), result = c * m^3 — unitary inverses are conjugations,
    and every exponent is a static positive integer."""
    m = T.fv12_mul(T.fv12_conj(x), T.fv12_inv(x))          # ^(p^6-1)
    m = T.fv12_mul(T.fv12_frob(T.fv12_frob(m)), m)         # ^(p^2+1)
    a = _pow_static(m, (_X - 1) ** 2)                      # ^(x-1)^2
    b = T.fv12_mul(T.fv12_conj(_pow_static(a, -_X)),       # ^x (x<0)
                   T.fv12_frob(a))                         # * ^p
    c = T.fv12_mul(
        T.fv12_mul(_pow_static(b, _X * _X),                # ^(x^2)
                   T.fv12_frob(T.fv12_frob(b))),           # ^(p^2)
        T.fv12_conj(b))                                    # ^(-1)
    return T.fv12_mul(c, T.fv12_mul(T.fv12_square(m), m))  # * m^3


# --- identity detection + the registered entry -------------------------------

def _z_is_zero_g1(p_pts: torch.Tensor) -> torch.Tensor:
    """[..., 3, NLIMBS] -> [...] bool: Z == 0 (mod p)."""
    return BF.fv_eq_mod_p(FV(p_pts[..., 2, :], RED_BOUND), 0)


def _z_is_zero_g2(q_pts: torch.Tensor) -> torch.Tensor:
    z = q_pts[..., 2, :, :]                       # [..., 2, NLIMBS]
    strict = BF.reduce_cols(z, BF._ELEM_LIMB + BF.LMASK)
    return (BF.strict_eq_mod_p(strict[..., 0, :], 0)
            & BF.strict_eq_mod_p(strict[..., 1, :], 0))


def bls_pairing_product(p_pts: torch.Tensor,
                        q_pts: torch.Tensor) -> torch.Tensor:
    """ALL closed classes' pairing checks in one call.

    p_pts [C, 2, 3, NLIMBS]    — per (class, pair) projective G1
    q_pts [C, 2, 3, 2, NLIMBS] — per (class, pair) projective G2

    Pair layout (the lane's packing): pair 0 = (-G1, asig), pair 1 =
    (apk, H(class message)).  Returns ok [C] bool on the inputs'
    device: prod_k e(p_k, q_k) == 1, with a pair whose EITHER point is
    the identity skipped (`bls_ref.pairing_product_is_one` semantics —
    an all-identity padding class returns True and is ignored by the
    caller)."""
    f = miller_loop(q_pts, p_pts)             # batch [C, 2]
    skip = _z_is_zero_g1(p_pts) | _z_is_zero_g2(q_pts)  # [C, 2]
    f_arr = T.fv12_out(_red12(f))
    one = T.fv12_out(T.fv12_one(f_arr.shape[:-3], f_arr.device))
    f_arr = torch.where(skip[..., None, None, None], one, f_arr)
    f0 = T.fv12_in(f_arr[..., 0, :, :, :], RED_BOUND)
    f1 = T.fv12_in(f_arr[..., 1, :, :, :], RED_BOUND)
    out = final_exponentiate(T.fv12_mul(f0, f1))
    return T.fv12_eq_one(out)


# --- host-side packing -------------------------------------------------------

def pack_g1_proj(pt) -> np.ndarray:
    """bls_ref affine G1 point (or None) -> [3, NLIMBS] projective."""
    out = np.zeros((3, NLIMBS), np.int32)
    if pt is None:
        out[1] = BF.to_limbs(1)
        return out
    out[0] = BF.to_limbs(pt[0])
    out[1] = BF.to_limbs(pt[1])
    out[2] = BF.to_limbs(1)
    return out


def pack_g2_proj(pt) -> np.ndarray:
    """bls_ref affine G2 point (or None) -> [3, 2, NLIMBS]."""
    out = np.zeros((3, 2, NLIMBS), np.int32)
    if pt is None:
        out[1, 0] = BF.to_limbs(1)
        return out
    x, y = pt
    out[0, 0] = BF.to_limbs(x.c[0])
    out[0, 1] = BF.to_limbs(x.c[1])
    out[1, 0] = BF.to_limbs(y.c[0])
    out[1, 1] = BF.to_limbs(y.c[1])
    out[2, 0] = BF.to_limbs(1)
    return out


#: the constant first-pair G1 point of every class: -G1
NEG_G1_LIMBS: np.ndarray = pack_g1_proj(ref.point_neg(ref.G1))
