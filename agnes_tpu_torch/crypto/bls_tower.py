"""Fp2/Fp6/Fp12 extension tower for BLS12-381 (twin of
`agnes_tpu.crypto.bls_tower_jax`).

The pairing's field stack on top of `bls_field`'s 12-bit-limb Barrett
base field, with the twin's static value bounds (FV):

    Fp2  = Fp [u] / (u^2 + 1)                    FV2 (bls_field)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u      three FV2 coeffs
    Fp12 = Fp6[w] / (w^2 - v)                    FV12: SIX FV2 coeffs
                                                 over {1, w, .., w^5}

`bls_ref.FQ12` carries 12 Fp coefficients over w with w^12 = 2 w^6 - 2;
with u = w^6 - 1 the two are the same field (`pack_fq12` /
`unpack_fq12`, host side, exact).

The formulas, the Karatsuba choices and the grouping of base-field
products into one stacked `fv_mul_pairs` call per tower multiply are the
twin's, so the limbs match it limb for limb: each stacked call is one
launch of the CUDA multiply kernel (`csrc/bls_fp.cu`) on the card, and
each stacked reduce one launch of the reduce kernel.  An Fp12 multiply
is 54 base-field products in one launch, the cyclotomic square 27, the
Frobenius 15.  Inversion exists at every level (Fp12 -> Fp6 -> Fp2 ->
the Fermat chain `fv_inv`); all of them map 0 to 0.

Oracle: `bls_ref` FQ2/FQ12 (tests/test_torch_bls.py)."""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from agnes_tpu_torch.crypto import bls_field as BF
from agnes_tpu_torch.crypto.bls_field import (
    FV,
    FV2,
    NLIMBS,
    fv2_add,
    fv2_conj,
    fv2_mul_pairs_combine,
    fv2_mul_pairs_expand,
    fv2_neg,
    fv2_sub,
    fv_add,
    fv_in,
    fv_mul_pairs,
    fv_sub,
)
from agnes_tpu_torch.crypto.bls_ref import P


class FV12(NamedTuple):
    """Fp12 element as six FV2 coefficients over {1, w, ..., w^5}."""

    c: Tuple[FV2, ...]


# --- host <-> device representation -----------------------------------------

def pack_fq12(e) -> np.ndarray:
    """bls_ref FQ12 -> [6, 2, NLIMBS] int32 limbs (host): with
    u = w^6 - 1, coefficient j over the Fp2 basis is
    (a_j + a_{j+6}) + a_{j+6} u."""
    out = np.zeros((6, 2, NLIMBS), np.int32)
    for j in range(6):
        out[j, 0] = BF.to_limbs((e.c[j] + e.c[j + 6]) % P)
        out[j, 1] = BF.to_limbs(e.c[j + 6] % P)
    return out


def unpack_fq12(arr) -> "object":
    """[..., 6, 2, NLIMBS] limbs (one element) -> bls_ref FQ12."""
    from agnes_tpu_torch.crypto import bls_ref as ref

    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) \
        else np.asarray(arr)
    coeffs = [0] * 12
    for j in range(6):
        c0 = BF.from_limbs(a[..., j, 0, :]) % P
        c1 = BF.from_limbs(a[..., j, 1, :]) % P
        coeffs[j] = (c0 - c1) % P
        coeffs[j + 6] = c1
    return ref.FQ12(coeffs)


def fv12_in(arr: torch.Tensor, bound: int = P) -> FV12:
    """[..., 6, 2, NLIMBS] -> FV12."""
    return FV12(tuple(
        FV2(FV(arr[..., j, 0, :], bound), FV(arr[..., j, 1, :], bound))
        for j in range(6)))


def fv12_out(x: FV12) -> torch.Tensor:
    """FV12 -> [..., 6, 2, NLIMBS] limb array."""
    return torch.stack([torch.stack([c.c0.a, c.c1.a], dim=-2)
                        for c in x.c], dim=-3)


def fv12_one(shape: Tuple[int, ...], device) -> FV12:
    """The Fp12 one of batch `shape` on `device` (no default: nothing
    of the lane may land on the CPU unasked)."""
    zero = torch.zeros(shape + (NLIMBS,), dtype=BF.I32, device=device)
    one = BF._one_like(zero)

    def cc(a):
        return FV2(FV(a, 1), FV(zero, 1))

    return FV12((cc(one),) + tuple(cc(zero) for _ in range(5)))


# --- small Fp2 helpers -------------------------------------------------------

def fv2_mul_pairs_expand_many(ops) -> List[tuple]:
    """Karatsuba operand pairs for a LIST of Fp2 products — the
    callers' collection step before one stacked `fv_mul_pairs`."""
    pairs: List[tuple] = []
    for x, y in ops:
        pairs.extend(fv2_mul_pairs_expand(x, y))
    return pairs


def fv2_mul_pairs_combine_many(prods: List[FV], n: int) -> List[FV2]:
    """Recombine the first 3n stacked products into n FV2 results."""
    return [fv2_mul_pairs_combine(*prods[3 * k:3 * k + 3])
            for k in range(n)]

def _mul_xi(t: FV2) -> FV2:
    """t * xi for xi = 1 + u: (c0 - c1) + (c0 + c1) u — adds only."""
    return FV2(fv_sub(t.c0, t.c1), fv_add(t.c0, t.c1))


def fv12_comps(x: FV12) -> List[FV]:
    """The 12 base-field components in the canonical flattening
    order (c0.c0, c0.c1, c1.c0, ...) — every stacked-reduce / compare
    path shares this one definition."""
    out: List[FV] = []
    for c in x.c:
        out.extend([c.c0, c.c1])
    return out


def fv12_force_red(x: FV12) -> FV12:
    """All 12 base-field components below 4p in ONE stacked reduce —
    the loop-carry boundary's reduction (intermediates stay UNREDUCED:
    every stacked multiply auto-reduces grown operands itself)."""
    red = BF.fv_reduce_stack(fv12_comps(x))
    return FV12(tuple(FV2(red[2 * j], red[2 * j + 1])
                      for j in range(6)))


# --- Fp6 = Fp2[v]/(v^3 - xi), coefficients as FV2 triples --------------------
#
# Fp6 values travel as plain 3-tuples of FV2; FV12 groups its flat
# coefficients as d0 = (c0, c2, c4), d1 = (c1, c3, c5) with v = w^2.

def _fp6_mul_expand(x, y):
    """Karatsuba operand pairs of one Fp6 product (x, y: FV2 triples):
    6 Fp2 products = 18 Fp operand pairs, for a caller that stacks
    several Fp6 products into one `fv_mul_pairs` call."""
    a0, a1, a2 = x
    b0, b1, b2 = y
    fp2_ops = [
        (a0, b0), (a1, b1), (a2, b2),
        (fv2_add(a1, a2), fv2_add(b1, b2)),
        (fv2_add(a0, a1), fv2_add(b0, b1)),
        (fv2_add(a0, a2), fv2_add(b0, b2)),
    ]
    pairs: List[tuple] = []
    for fx, fy in fp2_ops:
        pairs.extend(fv2_mul_pairs_expand(fx, fy))
    return pairs


def _fp6_mul_combine(prods: List[FV]):
    """18 stacked Fp products -> the Fp6 result (Karatsuba
    recombination over v^3 = xi)."""
    f2 = [fv2_mul_pairs_combine(*prods[3 * k:3 * k + 3])
          for k in range(6)]
    v0, v1, v2, s12, s01, s02 = f2
    c0 = fv2_add(v0, _mul_xi(fv2_sub(s12, fv2_add(v1, v2))))
    c1 = fv2_add(fv2_sub(s01, fv2_add(v0, v1)), _mul_xi(v2))
    c2 = fv2_add(fv2_sub(s02, fv2_add(v0, v2)), v1)
    return (c0, c1, c2)


def _mul_v(x):
    """(a0, a1, a2) * v = (xi a2, a0, a1) over v^3 = xi."""
    a0, a1, a2 = x
    return (_mul_xi(a2), a0, a1)


def _fp6_add(x, y):
    return tuple(fv2_add(a, b) for a, b in zip(x, y))


def _fp6_sub(x, y):
    return tuple(fv2_sub(a, b) for a, b in zip(x, y))


# --- Fp12 arithmetic ---------------------------------------------------------

def _split(x: FV12):
    """Flat {w^i} coefficients -> (d0, d1) Fp6 pair over w^2 = v."""
    c = x.c
    return (c[0], c[2], c[4]), (c[1], c[3], c[5])


def _join(d0, d1) -> FV12:
    return FV12((d0[0], d1[0], d0[1], d1[1], d0[2], d1[2]))


def fv12_mul(x: FV12, y: FV12) -> FV12:
    """Karatsuba over Fp6 (t0 = d0 e0, t1 = d1 e1,
    t2 = (d0+d1)(e0+e1)): 54 base-field products, ALL of them through
    ONE stacked Barrett body (module docstring)."""
    d0, d1 = _split(x)
    e0, e1 = _split(y)
    pairs = (_fp6_mul_expand(d0, e0) + _fp6_mul_expand(d1, e1)
             + _fp6_mul_expand(_fp6_add(d0, d1), _fp6_add(e0, e1)))
    prods = fv_mul_pairs(pairs)
    t0 = _fp6_mul_combine(prods[0:18])
    t1 = _fp6_mul_combine(prods[18:36])
    t2 = _fp6_mul_combine(prods[36:54])
    r0 = _fp6_add(t0, _mul_v(t1))
    r1 = _fp6_sub(t2, _fp6_add(t0, t1))
    return _join(r0, r1)


def fv12_square(x: FV12) -> FV12:
    """x * x through `fv12_mul` — the twin's choice, kept so the limbs
    match it (a dedicated squaring would need ~25% fewer products)."""
    return fv12_mul(x, x)


def fv12_conj(x: FV12) -> FV12:
    """The p^6-power Frobenius: c_i -> (-1)^i c_i.  On the
    cyclotomic subgroup (unitary elements) this IS the inverse."""
    return FV12(tuple(c if i % 2 == 0 else fv2_neg(c)
                      for i, c in enumerate(x.c)))


# Frobenius constants: gamma_i = xi^(i (p-1)/6) in Fp2, derived at
# import from the curve parameters (the bls_ref pattern) and asserted
# to be what the p-power Frobenius needs: w^p = gamma_1 * w.
def _fq2_pow(a: Tuple[int, int], e: int) -> Tuple[int, int]:
    out, b = (1, 0), a
    while e:
        if e & 1:
            out = ((out[0] * b[0] - out[1] * b[1]) % P,
                   (out[0] * b[1] + out[1] * b[0]) % P)
        b = ((b[0] * b[0] - b[1] * b[1]) % P, (2 * b[0] * b[1]) % P)
        e >>= 1
    return out


assert P % 6 == 1
_GAMMA: Tuple[Tuple[int, int], ...] = tuple(
    _fq2_pow((1, 1), i * (P - 1) // 6) for i in range(6))
#: limb constants of gamma_0..gamma_5 (gamma_0 = 1 unused)
_GAMMA_LIMBS = [(tuple(int(v) for v in BF.to_limbs(g[0])),
                 tuple(int(v) for v in BF.to_limbs(g[1])))
                for g in _GAMMA]


def fv12_frob(x: FV12) -> FV12:
    """x^p: coefficient-wise Fp2 conjugation times the static
    gamma_i constants — 15 base-field products in one stacked body."""
    conj = [fv2_conj(c) for c in x.c]
    pairs: List[tuple] = []
    for i in range(1, 6):
        g0, g1 = _GAMMA_LIMBS[i]
        dev = conj[i].c0.a.device
        gc = FV2(fv_in(BF._const_tensor(g0, dev)),
                 fv_in(BF._const_tensor(g1, dev)))
        pairs.extend(fv2_mul_pairs_expand(conj[i], gc))
    prods = fv_mul_pairs(pairs)
    out = [conj[0]]
    for k in range(5):
        out.append(fv2_mul_pairs_combine(*prods[3 * k:3 * k + 3]))
    return FV12(tuple(out))


def fv12_cyclotomic_square(x: FV12) -> FV12:
    """Granger–Scott squaring for UNITARY x (the final
    exponentiation's hard part lives in the cyclotomic subgroup):
    with Fp12 = Fp4[z]/(z^3 - s), z = w, s = w^3, and the Fp4
    components A = (c0, c3), B = (c1, c4), C = (c2, c5),

        x^2 = (3A^2 - 2A*) + (3 s C^2 + 2B*) z + (3B^2 - 2C*) z^2

    (* = Fp4 conjugation).  27 base-field products in one stacked
    body vs a full multiply's 54 — the hard part's dominant loop runs
    this body plus one multiply."""
    c = x.c
    groups = [(c[0], c[3]), (c[1], c[4]), (c[2], c[5])]
    pairs: List[tuple] = []
    for a, b in groups:
        # Fp4 square: (a + b s)^2 = (a^2 + xi b^2) + (2ab) s
        pairs.extend(fv2_mul_pairs_expand(a, a))
        pairs.extend(fv2_mul_pairs_expand(b, b))
        pairs.extend(fv2_mul_pairs_expand(a, b))
    prods = fv_mul_pairs(pairs)
    sqs = []
    for k in range(3):
        a2 = fv2_mul_pairs_combine(*prods[9 * k + 0:9 * k + 3])
        b2 = fv2_mul_pairs_combine(*prods[9 * k + 3:9 * k + 6])
        ab = fv2_mul_pairs_combine(*prods[9 * k + 6:9 * k + 9])
        sqs.append((fv2_add(a2, _mul_xi(b2)), fv2_add(ab, ab)))
    (A2, B2, C2) = sqs
    A, B, C = groups
    sC2 = (_mul_xi(C2[1]), C2[0])             # C^2 * s in Fp4

    def _3m2c(sq, orig):                      # 3*sq - 2*conj(orig)
        return (fv2_sub(fv2_add(fv2_add(sq[0], sq[0]), sq[0]),
                        fv2_add(orig[0], orig[0])),
                fv2_add(fv2_add(fv2_add(sq[1], sq[1]), sq[1]),
                        fv2_add(orig[1], orig[1])))

    def _3p2c(sq, orig):                      # 3*sq + 2*conj(orig)
        return (fv2_add(fv2_add(fv2_add(sq[0], sq[0]), sq[0]),
                        fv2_add(orig[0], orig[0])),
                fv2_sub(fv2_add(fv2_add(sq[1], sq[1]), sq[1]),
                        fv2_add(orig[1], orig[1])))

    ao = _3m2c(A2, A)
    bo = _3p2c(sC2, B)
    co = _3m2c(B2, C)
    return FV12((ao[0], bo[0], co[0], ao[1], bo[1], co[1]))


# --- inversion ---------------------------------------------------------------

def _fp6_inv(x):
    """Standard Fp6 inverse over v^3 = xi:
    t0 = a0^2 - xi a1 a2, t1 = xi a2^2 - a0 a1, t2 = a1^2 - a0 a2,
    norm = a0 t0 + xi a1 t2 + xi a2 t1; x^-1 = (t0, t1, t2)/norm."""
    a0, a1, a2 = x
    pairs = (fv2_mul_pairs_expand(a0, a0)
             + fv2_mul_pairs_expand(a1, a2)
             + fv2_mul_pairs_expand(a2, a2)
             + fv2_mul_pairs_expand(a0, a1)
             + fv2_mul_pairs_expand(a1, a1)
             + fv2_mul_pairs_expand(a0, a2))
    pr = fv_mul_pairs(pairs)
    sq = [fv2_mul_pairs_combine(*pr[3 * k:3 * k + 3])
          for k in range(6)]
    t0 = fv2_sub(sq[0], _mul_xi(sq[1]))
    t1 = fv2_sub(_mul_xi(sq[2]), sq[3])
    t2 = fv2_sub(sq[4], sq[5])
    pairs = (fv2_mul_pairs_expand(a0, t0)
             + fv2_mul_pairs_expand(a1, t2)
             + fv2_mul_pairs_expand(a2, t1))
    pr = fv_mul_pairs(pairs)
    n0 = fv2_mul_pairs_combine(*pr[0:3])
    n1 = fv2_mul_pairs_combine(*pr[3:6])
    n2 = fv2_mul_pairs_combine(*pr[6:9])
    ninv = BF.fv2_inv(fv2_add(n0, _mul_xi(fv2_add(n1, n2))))
    pairs = (fv2_mul_pairs_expand(t0, ninv)
             + fv2_mul_pairs_expand(t1, ninv)
             + fv2_mul_pairs_expand(t2, ninv))
    pr = fv_mul_pairs(pairs)
    return tuple(fv2_mul_pairs_combine(*pr[3 * k:3 * k + 3])
                 for k in range(3))


def fv12_inv(x: FV12) -> FV12:
    """(d0 + d1 w)^-1 = (d0 - d1 w) / (d0^2 - v d1^2): one Fp6
    inverse (one Fermat chain) + four Fp6 multiplies.  Used ONCE per
    pairing product (the easy part of the final exponentiation) and
    by the differential tests; maps 0 to 0."""
    d0, d1 = _split(x)
    pairs = _fp6_mul_expand(d0, d0) + _fp6_mul_expand(d1, d1)
    pr = fv_mul_pairs(pairs)
    d0sq = _fp6_mul_combine(pr[0:18])
    d1sq = _fp6_mul_combine(pr[18:36])
    t = _fp6_sub(d0sq, _mul_v(d1sq))
    tinv = _fp6_inv(t)
    pairs = _fp6_mul_expand(d0, tinv) + _fp6_mul_expand(d1, tinv)
    pr = fv_mul_pairs(pairs)
    r0 = _fp6_mul_combine(pr[0:18])
    r1 = tuple(fv2_neg(c) for c in _fp6_mul_combine(pr[18:36]))
    return _join(r0, r1)


# --- verdicts ----------------------------------------------------------------

def fv12_eq_one(x: FV12) -> torch.Tensor:
    """x == 1 in Fp12 -> [...] bool: all 12 base-field components
    strict-reduced in ONE stacked reduce, then compared against the
    four < 4p representatives of their target residue."""
    comps = fv12_comps(x)
    stacked = BF._stack([f.a for f in comps])
    bound = max(f.bound for f in comps)
    assert bound < BF.REDUCE_CAP
    strict = BF.reduce_cols(stacked, BF._ELEM_LIMB + BF.LMASK)
    ok = BF.strict_eq_mod_p(strict[..., 0, :], 1)
    for k in range(1, 12):
        ok = ok & BF.strict_eq_mod_p(strict[..., k, :], 0)
    return ok
