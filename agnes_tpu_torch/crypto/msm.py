"""MSM-style Ed25519 batch verification by random linear combination
(twin of `agnes_tpu.crypto.msm_jax`).

Instead of checking each lane's [S_i]B == R_i + [k_i]A_i, draw random
128-bit z_i and check ONE combined, cofactored equation

    [8]([sum z_i S_i mod L]B + sum [z_i](-R_i) + sum [z_i k_i mod L](-A_i)) == O

(Bernstein et al.'s batch verification).  A lane that fails its own
equation makes the combination nonzero except with probability ~2^-128,
and the framework's policy is cofactored everywhere, so batch-accept and
per-lane accept agree (rationale: `msm_jax`'s module docstring).

The two multi-scalar multiplications are Pippenger bucket methods with
8-bit windows.  PyTorch has no `associative_scan`, so a window's bucket
sums are a stable sort by digit and a log-depth segmented Hillis-Steele
scan (ceil(log2 N) rounds of one vectorized point add over all lanes),
and Σ d·bucket_d is two log-depth passes over the 256 buckets (suffix
sums by a work-efficient scan, then a tree sum); every window of a batch goes through these
passes together.  Any summation order gives the same group element, so
the projective coordinates differ from the twin's while the verdicts do
not; the tests compare points projectively.  The window sums of the two
MSMs share one doubling chain (`msm_sum`).  The curve work runs on the port's field
ops, with decompression's power on the CUDA pow kernel
(`field.pow_p`) and [c]B on the CUDA Straus kernel
(`ed25519_point.straus_sub`); the bisection fallback settles its
leaves with `ed25519.verify_batch`, the CUDA verify kernel.

The Pippenger machinery is generic over a `Curve` (point add, identity,
coordinate shape): `msm_generic` is what the BLS lane's G1 and G2 MSMs
run (`crypto/bls.py`), with 4-bit windows over 12-bit weight limbs.
"""

from __future__ import annotations

import secrets
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from agnes_tpu_torch.crypto import ed25519_point as E
from agnes_tpu_torch.crypto import field as F
from agnes_tpu_torch.crypto import scalar as S
from agnes_tpu_torch.crypto import sha512
from agnes_tpu_torch.crypto.ed25519 import verify_batch
from agnes_tpu_torch.device.encoding import resolve_device

I32 = F.I32
BITS = F.BITS
NLIMBS = F.NLIMBS

Z_BITS = 128                     # random-coefficient width
Z_LIMBS = -(-Z_BITS // BITS)     # 10
WINDOW_C = 8                     # Pippenger window (bits)
N_BUCKETS = 1 << WINDOW_C
NW_Z = -(-Z_BITS // WINDOW_C)            # 16 windows for z scalars
NW_FULL = -(-253 // WINDOW_C)            # 32 windows for full scalars
# windows x points that one bucket pass carries at once: bounds the
# transient memory of the stacked field multiplies (~13 KB a lane)
LANE_BUDGET = 1 << 19


# --- scalar helpers (mod L) -------------------------------------------------


def mul_mod_L(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., na] x [..., nb] limb products mod L -> [..., 20] canonical
    (raw columns stay int32: <= 20 products < 2^26 each)."""
    na, nb = a.shape[-1], b.shape[-1]
    assert na <= 20 and nb <= 20
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    cols = torch.zeros(shape + (na + nb - 1,), dtype=I32, device=a.device)
    for i in range(na):
        cols[..., i:i + nb] += a[..., i:i + 1] * b
    limbs = S._chain(cols)                       # normalized, +1 limb
    return S.barrett_reduce(tF.pad(limbs, (0, S.N_HASH - limbs.shape[-1])))


def sum_mod_L(x: torch.Tensor) -> torch.Tensor:
    """[B, 20] canonical scalars -> [20] limbs of the sum mod L, int32
    throughout: partial sums over chunks of 2^15 rows stay < 2^28 per
    column and are normalized before they are summed again."""
    parts = ([c.sum(dim=0, dtype=I32) for c in x.split(1 << 15)]
             or [x.new_zeros(x.shape[-1])])
    parts = S._chain(torch.stack(parts))
    tot = parts.sum(dim=0, dtype=I32)
    limbs = S._chain(S._chain(tot[None]))[0]
    return S.barrett_reduce(tF.pad(limbs, (0, S.N_HASH - limbs.shape[-1])))


def window_digits(s: torch.Tensor, n_windows: int, c: int = WINDOW_C,
                  bits: int = BITS) -> torch.Tensor:
    """[..., n_limbs] limbs -> [n_windows, ...] c-bit digits, least
    significant window first (a window straddles at most one limb
    boundary, so c <= bits)."""
    assert 0 < c <= bits, (c, bits)
    nl = s.shape[-1]
    outs = []
    for w in range(n_windows):
        lo = c * w
        li, off = lo // bits, lo % bits
        d = s[..., li] >> off
        if off > bits - c and li + 1 < nl:
            d = d | (s[..., li + 1] << (bits - off))
        outs.append(d & ((1 << c) - 1))
    return torch.stack(outs, dim=0)


# --- log-depth Pippenger, generic over the curve --------------------------


class Curve(NamedTuple):
    """What the Pippenger machinery needs of a group: `point_add` of two
    point NamedTuples, `identity(shape, device)`, and the number of
    trailing axes of one coordinate (1 for [..., 20] Ed25519 or [..., 33]
    G1 limbs, 2 for [..., 2, 33] G2 limbs); the lane axis sits just
    before them."""

    point_add: Callable
    identity: Callable
    elem_dims: int = 1


ED25519 = Curve(E.point_add, E.identity, 1)


def _at(sl, nd: int = 1):
    """Index of `sl` on the lane axis of a coordinate with `nd` trailing
    axes."""
    return (Ellipsis, sl) + (slice(None),) * nd


def _lanes(p, sl, nd: int = 1):
    """The lanes `sl` (a slice of the lane axis) of a point."""
    return type(p)(*(c[_at(sl, nd)] for c in p))


def _lane_view(t: torch.Tensor, nd: int) -> torch.Tensor:
    """[..., N] per-lane tensor -> [..., N, 1, ...] against coordinates."""
    return t.reshape(t.shape + (1,) * nd)


def bucket_sums(points, digits: torch.Tensor, curve: Curve,
                n_buckets: int):
    """Bucket sums of windows: points with [N, *elem] (or [..., N,
    *elem]) coordinates, digits [..., N] -> points [..., n_buckets,
    *elem] where lane d is the sum of the points with digit d (identity
    where none).

    A STABLE sort by digit makes equal digits adjacent; an inclusive
    segmented Hillis-Steele scan (lane i takes lane i - 2^r's running
    sum unless a segment starts between them) leaves each run's total on
    its last lane, which is scattered into its bucket; the other lanes
    land in a dump slot that is cut off."""
    nd = curve.elem_dims
    lead, n = digits.shape[:-1], digits.shape[-1]
    order = torch.argsort(digits, dim=-1, stable=True)
    ds = torch.gather(digits, -1, order)
    elem = points[0].shape[points[0].ndim - nd:]
    full = lead + (n,) + elem
    idx = _lane_view(order, nd).expand(full)
    pts = type(points)(*(torch.gather(c.expand(full), -1 - nd, idx)
                         for c in points))
    new = ds[..., 1:] != ds[..., :-1]
    start = tF.pad(new, (1, 0), value=True)
    d = 1
    while d < n:
        summed = curve.point_add(_lanes(pts, slice(None, -d), nd),
                                 _lanes(pts, slice(d, None), nd))
        keep = _lane_view(start[..., d:], nd)
        pts = type(points)(*(
            torch.cat([c[_at(slice(None, d), nd)],
                       torch.where(keep, c[_at(slice(d, None), nd)], sm)],
                      dim=-1 - nd)
            for c, sm in zip(pts, summed)))
        start = torch.cat([start[..., :d], start[..., :-d] | start[..., d:]],
                          dim=-1)
        d *= 2
    end = tF.pad(new, (0, 1), value=True)
    slot = torch.where(end, ds, n_buckets).long()
    slot = _lane_view(slot, nd).expand(full)
    idn = curve.identity(lead + (n_buckets + 1,), digits.device)
    return type(points)(*(
        b.scatter(-1 - nd, slot, c)[_at(slice(None, n_buckets), nd)]
        for b, c in zip(idn, pts)))


def _prefix_sums(p, curve: Curve):
    """Inclusive prefix sums along the lane axis (a power of two long),
    work-efficient: add neighbouring pairs, recurse on the half, then
    fill in the even lanes — 2 log2(n) rounds, < 2n adds."""
    nd = curve.elem_dims
    lane = -1 - nd
    n = p[0].shape[lane]
    if n == 1:
        return p
    even = _lanes(p, slice(0, None, 2), nd)
    odd = _lanes(p, slice(1, None, 2), nd)
    q = _prefix_sums(curve.point_add(even, odd), curve)  # Σ_{i <= 2j+1}
    ev = curve.point_add(_lanes(q, slice(None, -1), nd),
                         _lanes(even, slice(1, None), nd))
    return type(p)(*(torch.stack([torch.cat([e[_at(slice(None, 1), nd)], v],
                                           dim=lane), o],
                                 dim=lane).flatten(lane - 1, lane)
                     for e, v, o in zip(even, ev, q)))


def bucket_aggregate(buckets, curve: Curve):
    """Σ_{d >= 1} d * bucket_d over the bucket axis (a power of two
    long; [..., nb, *elem] -> [..., *elem]) as two log-depth passes: the
    suffix sums s_d = Σ_{j >= d} bucket_j (prefix sums of the reversed
    buckets), then Σ_{d >= 1} s_d by a tree."""
    nd = curve.elem_dims
    lane = -1 - nd
    s = _prefix_sums(type(buckets)(*(c.flip(lane) for c in buckets)), curve)
    lead = s[0].shape[:lane]
    idn = curve.identity(lead + (1,), s[0].device)
    t = type(buckets)(*(torch.cat([c[_at(slice(None, -1), nd)], i],
                                  dim=lane)                 # drop s_0
                        for c, i in zip(s, idn)))
    n = t[0].shape[lane]
    while n > 1:
        n //= 2
        t = curve.point_add(_lanes(t, slice(None, n), nd),
                            _lanes(t, slice(n, None), nd))
    return type(buckets)(*(c[_at(0, nd)] for c in t))


def window_sums(points, scalars: torch.Tensor, n_windows: int,
                curve: Curve = ED25519, c: int = WINDOW_C,
                bits: int = BITS):
    """[n_windows, *elem] points: window w's Σ_d d * bucket_d (least
    significant window first).  Windows go through the bucket scan in
    groups of at most LANE_BUDGET lanes, then through one aggregate."""
    digits = window_digits(scalars, n_windows, c, bits)  # [n_windows, N]
    step = max(1, LANE_BUDGET // max(digits.shape[-1], 1))
    parts = [bucket_sums(points, digits[w:w + step], curve, 1 << c)
             for w in range(0, n_windows, step)]
    return bucket_aggregate(type(points)(*(torch.cat(cs)
                                           for cs in zip(*parts))), curve)


def horner(wsums, curve: Curve = ED25519, c: int = WINDOW_C):
    """Σ_w [2^(c w)] wsums[w]: acc <- [2^c] acc + wsums[w], MSB window
    first, from the identity (the twin's window loop)."""
    acc = curve.identity((), wsums[0].device)
    for w in reversed(range(wsums[0].shape[0])):
        for _ in range(c):
            acc = curve.point_add(acc, acc)
        acc = curve.point_add(acc, type(wsums)(*(x[w] for x in wsums)))
    return acc


def msm_generic(points, scalars: torch.Tensor, n_windows: int,
                curve: Curve, window_c: int = WINDOW_C, bits: int = BITS):
    """Σ [scalar_i] P_i over any `Curve`: points with [N, *elem]
    coordinates, scalars [N, n_limbs] of `bits`-bit limbs, n_windows
    `window_c`-bit windows.  Lanes with scalar 0 contribute nothing
    (every digit lands in the excluded 0 bucket), which is how padding
    rows drop out without a mask (`msm_jax.msm_generic`'s contract; the
    twin scans the buckets sequentially, this scan is log-depth, so the
    projective coordinates differ while the group element does not)."""
    return horner(window_sums(points, scalars, n_windows, curve, window_c,
                              bits), curve, window_c)


def msm_sum(terms) -> E.Point:
    """Σ over terms (points, scalars, n_windows) of Σ [scalar_i] P_i.
    The terms' window sums are added window by window, so all of them
    share one doubling chain."""
    total = None
    for points, scalars, nw in sorted(terms, key=lambda t: -t[2]):
        w = window_sums(points, scalars, nw)
        if total is None:
            total = w
            continue
        low = E.point_add(E.Point(*(c[:nw] for c in total)), w)
        total = E.Point(*(torch.cat([lo, c[nw:]])
                          for lo, c in zip(low, total)))
    return horner(total)


def msm(points: E.Point, scalars: torch.Tensor, n_windows: int) -> E.Point:
    """Multi-scalar multiplication Σ [scalar_i] P_i: points with [N, 20]
    coordinates, scalars [N, n_limbs], n_windows 8-bit windows covering
    the scalars.  Lanes with scalar 0 contribute nothing."""
    return msm_sum([(points, scalars, n_windows)])


# --- the batch check --------------------------------------------------------


def scalar_mul_base(c_limbs: torch.Tensor) -> E.Point:
    """[c]B for one scalar ([20] limbs): the Straus kernel with the A
    term pinned to the identity."""
    return E.straus_sub(c_limbs, torch.zeros_like(c_limbs),
                        E.identity((), c_limbs.device))


def make_z(batch: int, seed: Optional[int] = None,
           device="cuda") -> torch.Tensor:
    """[B, Z_LIMBS] int32 random 128-bit coefficients on `device`, drawn
    on the host per call from OS entropy (`secrets.token_bytes`), so the
    2^-128 soundness bound rests only on the CSPRNG.  A fixed seed
    (tests only) switches to a deterministic numpy stream — the twin's
    stream, so both draw the same z."""
    if seed is None:
        raw = np.frombuffer(secrets.token_bytes(batch * 16), dtype="<u2")
        words16 = raw.reshape(batch, 8).astype(np.int64)
    else:
        rng = np.random.default_rng(seed)
        words16 = rng.integers(0, 1 << 16, size=(batch, 8), dtype=np.int64)
    # a 13-bit limb spans at most two adjacent 16-bit words
    words = np.concatenate([words16, np.zeros((batch, 1), np.int64)], axis=1)
    idx = np.arange(Z_LIMBS)
    wi, off = (BITS * idx) // 16, (BITS * idx) % 16
    win = words[:, wi] | (words[:, wi + 1] << 16)
    val = (win >> off) & F.LMASK
    return torch.from_numpy(val.astype(np.int32)).to(resolve_device(device))


def verify_batch_msm(pub: torch.Tensor, sig: torch.Tensor,
                     msg_blocks: torch.Tensor, z: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One combined check for the whole batch: pub [B, 32] / sig [B, 64]
    int32 byte values, msg_blocks [B, n, 32] padded SHA-512 words of
    R || A || M, z [B, Z_LIMBS] random coefficients.

    Returns (batch_ok, a bool scalar: the combined equation holds for
    every lane with lane_ok; lane_ok [B] bool: A and R decode and S is
    canonical).  Structurally invalid lanes are excluded by zeroing
    their coefficient.  Final verdict = batch_ok ? lane_ok : fall back
    to the per-lane verifier."""
    a_point, ok_a = E.decompress(pub)
    r_point, ok_r = E.decompress(sig[..., :32])
    s = S.scalar_from_bytes32(sig[..., 32:])
    ok_s = S.is_canonical(s)
    lane_ok = ok_a & ok_r & ok_s

    k = S.barrett_reduce(S.digest_to_limbs(sha512.sha512_blocks(msg_blocks)))
    z = torch.where(lane_ok[..., None], z, 0)      # exclude invalid lanes
    zk = mul_mod_L(z, k)                           # [B, 20]
    zs = mul_mod_L(z, s)
    c = sum_mod_L(zs)                              # [20]

    # Σ [z](-R) + Σ [zk](-A) in one doubling chain: the same group
    # element as the twin's two MSMs added
    t = E.point_add(scalar_mul_base(c), msm_sum(
        [(E.point_neg(a_point), zk, NW_FULL),
         (E.point_neg(r_point), z, NW_Z)]))
    for _ in range(3):                   # x8: cofactored policy
        t = E.point_add(t, t)
    batch_ok = E.point_equal(t, E.identity((), t.x.device))
    return batch_ok, lane_ok


def verify_batch_adaptive(pub: torch.Tensor, sig: torch.Tensor,
                          msg_blocks: torch.Tensor,
                          seed: Optional[int] = None,
                          leaf: int = 64) -> np.ndarray:
    """[B] bool verdicts with per-lane semantics (the cofactored policy
    holds on both paths): try the MSM check; on failure bisect, settling
    sub-batches smaller than `leaf` with the per-lane verifier.  An
    honest batch costs one MSM pass; bad lanes only push their own
    sub-batches onto the per-lane path.

    The twin pads every sub-batch to a power of two so its jit cache
    holds O(log B) shapes; nothing here compiles per shape, and the
    verdicts of the real lanes do not depend on padding, so sub-batches
    run at their own size."""
    B = int(pub.shape[0])
    out = np.zeros(B, bool)
    # leaf >= 2: at leaf 1 the bisection midpoint lo + n//2 == lo and a
    # failing lane would recurse forever
    leaf = max(int(leaf), 2)

    def solve(lo: int, hi: int) -> None:
        n = hi - lo
        if n == 0:
            return
        if n < leaf:
            out[lo:hi] = verify_batch(pub[lo:hi], sig[lo:hi],
                                      msg_blocks[lo:hi]).cpu().numpy()
            return
        z = make_z(n, seed, device=pub.device)
        batch_ok, lane_ok = verify_batch_msm(pub[lo:hi], sig[lo:hi],
                                             msg_blocks[lo:hi], z)
        if bool(batch_ok):
            out[lo:hi] = lane_ok.cpu().numpy()
            return
        mid = lo + n // 2
        solve(lo, mid)
        solve(mid, hi)

    solve(0, B)
    return out
