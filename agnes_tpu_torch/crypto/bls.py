"""BLS12-381 G1/G2 aggregation — the aggregate lane's O(N) (twin of
`agnes_tpu.crypto.bls_jax`).

One vote class's stake-weighted multi-scalar multiplications: the signer
pubkeys over G1 and the signature shares over G2, both through the
generic Pippenger of `crypto/msm.py` (4-bit windows over the 12-bit
weight limbs; padding lanes carry weight 0 and fall into the excluded
0 bucket).  The points add with the Renes–Costello–Batina COMPLETE
projective addition for a = 0 curves (eprint 2015/1060, algorithm 7:
branch-free, identity-safe, doubling-safe), over `bls_field`'s Barrett
field (G1) and its Fp2 (G2) — every field product and reduce a launch of
the CUDA kernels of `csrc/bls_fp.cu` on the card.

Outputs stay PROJECTIVE; the host converts to affine with two modular
inversions per class (`g1_from_device` / `g2_from_device`).  The twin
scans buckets sequentially and this port log-depth, so the projective
coordinates differ while the group elements agree (tests compare in
affine form).  Weights are voting powers of at most W_BITS bits."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from agnes_tpu_torch.crypto import bls_field as BF
from agnes_tpu_torch.crypto import bls_ref as ref
from agnes_tpu_torch.crypto import msm as M
from agnes_tpu_torch.crypto.bls_field import (
    I32,
    NLIMBS,
    RED_BOUND,
    fv2_add,
    fv2_in,
    fv2_mul,
    fv2_out,
    fv2_reduce,
    fv2_sub,
    fv_add,
    fv_in,
    fv_mul,
    fv_mul_small,
    fv_reduce,
    fv_sub,
)

#: stake-weight width: voting powers above it are screened by the lane
W_BITS = 24
W_LIMBS = -(-W_BITS // BF.BITS)          # 2
WINDOW_C = 4
N_WINDOWS = -(-W_BITS // WINDOW_C)       # 6


class G1P(NamedTuple):
    """Projective G1 point; each field [..., NLIMBS] int32 limbs."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class G2P(NamedTuple):
    """Projective G2 point; each field [..., 2, NLIMBS] int32 limbs."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def g1_identity(shape: Tuple[int, ...], device) -> G1P:
    z = torch.zeros(tuple(shape) + (NLIMBS,), dtype=I32, device=device)
    return G1P(x=z, y=BF._one_like(z), z=z)


def g2_identity(shape: Tuple[int, ...], device) -> G2P:
    z = torch.zeros(tuple(shape) + (2, NLIMBS), dtype=I32, device=device)
    one = z.clone()
    one[..., 0, 0] = 1
    return G2P(x=z, y=one, z=z)


def _rcb_add(p, q, *, add, sub, mul, red, b3_mul):
    """Renes–Costello–Batina 2015/1060 algorithm 7 (complete addition,
    a = 0), generic over the field op set — the twin's order of
    operations, so the limbs match it."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = mul(x1, x2)
    t1 = mul(y1, y2)
    t2 = mul(z1, z2)
    t3 = red(sub(mul(add(x1, y1), add(x2, y2)), add(t0, t1)))
    t4 = red(sub(mul(add(y1, z1), add(y2, z2)), add(t1, t2)))
    t6 = red(sub(mul(add(x1, z1), add(x2, z2)), add(t0, t2)))
    s3 = red(add(add(t0, t0), t0))               # 3 * X1X2
    t2b = b3_mul(t2)
    z3 = add(t1, t2b)
    t1b = sub(t1, t2b)
    y3 = b3_mul(t6)
    z3r = red(z3)
    x_out = red(sub(mul(t3, t1b), mul(t4, y3)))
    y_out = red(add(mul(y3, s3), mul(t1b, z3r)))
    z_out = red(add(mul(z3r, t4), mul(s3, t3)))
    return x_out, y_out, z_out


def g1_add(p: G1P, q: G1P) -> G1P:
    """Complete G1 addition; coords are RED_BOUND-bounded limbs."""
    def wrap(pt):
        return tuple(fv_in(c, RED_BOUND) for c in pt)

    x, y, z = _rcb_add(
        wrap(p), wrap(q),
        add=fv_add, sub=fv_sub, mul=fv_mul, red=fv_reduce,
        b3_mul=lambda t: fv_mul_small(t, 3 * ref.B_G1))
    return G1P(x=x.a, y=y.a, z=z.a)


def _fv2_b3(t):
    """t * 3*b' for b' = 4(1 + u): 12(c0 - c1) + 12(c0 + c1)u."""
    return BF.FV2(fv_mul_small(fv_sub(t.c0, t.c1), 12),
                  fv_mul_small(fv_add(t.c0, t.c1), 12))


def g2_add(p: G2P, q: G2P) -> G2P:
    """Complete G2 addition over Fp2; coords RED_BOUND-bounded."""
    def wrap(pt):
        return tuple(fv2_in(c, RED_BOUND) for c in pt)

    x, y, z = _rcb_add(
        wrap(p), wrap(q),
        add=fv2_add, sub=fv2_sub, mul=fv2_mul, red=fv2_reduce,
        b3_mul=_fv2_b3)
    return G2P(x=fv2_out(x), y=fv2_out(y), z=fv2_out(z))


G1 = M.Curve(g1_add, g1_identity, 1)
G2 = M.Curve(g2_add, g2_identity, 2)


def n_windows_for(w_bits: int) -> int:
    """Windows needed for stake weights of `w_bits` bits (clamped to
    W_BITS): a uniform-stake validator set (w_bits = 1) pays one
    window's bucket scan instead of six."""
    return -(-max(1, min(int(w_bits), W_BITS)) // WINDOW_C)


def bls_aggregate(pk: torch.Tensor, sig: torch.Tensor, w: torch.Tensor,
                  n_windows: int = N_WINDOWS) -> Tuple[G1P, G2P]:
    """One vote class's O(N) aggregation.

    pk  [N, 2, NLIMBS] int32 — signer pubkeys, affine G1 limb coords
    sig [N, 4, NLIMBS] int32 — signature shares, affine G2
                               (x0, x1, y0, y1) limb coords
    w   [N, W_LIMBS]   int32 — stake weights as 12-bit limbs; weight 0
                               marks a padding lane

    Every weight must fit `n_windows * WINDOW_C` bits.  Returns (agg_pk,
    agg_sig) PROJECTIVE: Σ [w_i] pk_i over G1 and Σ [w_i] sig_i over G2,
    on the inputs' device."""
    n = pk.shape[0]
    g1pts = G1P(x=pk[:, 0], y=pk[:, 1], z=BF._one_like(pk[:, 0]))
    g2x = torch.stack([sig[:, 0], sig[:, 1]], dim=-2)
    g2y = torch.stack([sig[:, 2], sig[:, 3]], dim=-2)
    g2pts = G2P(x=g2x, y=g2y, z=g2_identity((n,), pk.device).y)
    agg_pk = M.msm_generic(g1pts, w, n_windows, G1, WINDOW_C, BF.BITS)
    agg_sig = M.msm_generic(g2pts, w, n_windows, G2, WINDOW_C, BF.BITS)
    return agg_pk, agg_sig


# --- host-side packing / unpacking ------------------------------------------

def pack_g1_rows(points) -> np.ndarray:
    """bls_ref affine G1 points -> [n, 2, NLIMBS] int32 (host)."""
    out = np.zeros((len(points), 2, NLIMBS), np.int32)
    for i, pt in enumerate(points):
        assert pt is not None, "identity pubkey cannot be aggregated"
        out[i, 0] = BF.to_limbs(pt[0])
        out[i, 1] = BF.to_limbs(pt[1])
    return out


def pack_g2_rows(points) -> np.ndarray:
    """bls_ref affine G2 points -> [n, 4, NLIMBS] int32 (host)."""
    out = np.zeros((len(points), 4, NLIMBS), np.int32)
    for i, pt in enumerate(points):
        assert pt is not None, "identity share cannot be aggregated"
        x, y = pt
        out[i, 0] = BF.to_limbs(x.c[0])
        out[i, 1] = BF.to_limbs(x.c[1])
        out[i, 2] = BF.to_limbs(y.c[0])
        out[i, 3] = BF.to_limbs(y.c[1])
    return out


def pack_weights(weights) -> np.ndarray:
    """Voting powers -> [n, W_LIMBS] int32 12-bit limbs (must fit
    W_BITS; the lane screens at registration)."""
    w = np.asarray(weights, np.int64)
    assert (w >= 0).all() and (w < (1 << W_BITS)).all(), \
        f"weights must fit {W_BITS} bits"
    out = np.zeros(w.shape + (W_LIMBS,), np.int32)
    for i in range(W_LIMBS):
        out[..., i] = (w >> (BF.BITS * i)) & BF.LMASK
    return out


def _fp(t: torch.Tensor) -> int:
    return BF.from_limbs(t) % ref.P


def g1_from_device(p: G1P):
    """Projective limb output -> bls_ref affine G1 point (host; None for
    the identity)."""
    z = _fp(p.z)
    if z == 0:
        return None
    zi = pow(z, ref.P - 2, ref.P)
    return (_fp(p.x) * zi % ref.P, _fp(p.y) * zi % ref.P)


def g2_from_device(p: G2P):
    """Projective Fp2 limb output -> bls_ref affine G2 point."""
    def fq2(t):
        t = t.detach().cpu()
        return ref.fq2(_fp(t[..., 0, :]), _fp(t[..., 1, :]))

    z = fq2(p.z)
    if z.is_zero():
        return None
    zi = z.inv()
    return (fq2(p.x) * zi, fq2(p.y) * zi)
