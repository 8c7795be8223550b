"""Edwards25519 points on the port's field limbs (twin of the point half
of `agnes_tpu.crypto.ed25519_jax`, lines 43-207), and the Shamir
double-scalar multiplication `straus_sub` with its CUDA kernel.

Extended homogeneous coordinates, each a [..., 20] limb tensor with the
batch axes leading, and the complete unified a = -1 addition law: no
special cases, so the identity may be added like any point.

`decompress` and `compress` take their powers through `field.pow_p`
(CUDA kernel on the card).  `straus_sub` ([s]B - [k]A) launches the
hand-written CUDA kernel `csrc/ed25519_straus.cu` for tensors on the
card and runs `straus_plain` — a step-for-step transcription of the TPU
kernel `pallas_ed25519._straus_kernel` (260 MSB-first steps over the
table {O, B, -A, B - A}) and its wrapper's table build — for tensors on
the CPU.  Both return frozen coordinates of the same group element; the
kernel computes [s]B by a fixed-base comb and -[k]A by signed 5-bit
windows, so its projective representative differs from the plain
version's (compare with `point_equal`; both satisfy X Y = Z T).  A
failed build or launch raises; `STRAUS_LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from agnes_tpu_torch import cuda_build
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import field as F
from agnes_tpu_torch.crypto import scalar as S

I32 = F.I32
P = F.P
NLIMBS = F.NLIMBS
N_BITS = 260                    # scalar bits walked by the Shamir loop

_BX, _BY = ref.BASE[0], ref.BASE[1]        # affine base point (Z = 1)


class Point(NamedTuple):
    """Extended homogeneous coordinates; each field [..., 20] limbs."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity(shape: Tuple[int, ...], device) -> Point:
    zero = torch.zeros(tuple(shape) + (NLIMBS,), dtype=I32, device=device)
    one = F.one_like(zero)
    return Point(zero, one, one, zero)


def base_point(shape: Tuple[int, ...], device) -> Point:
    one = identity(shape, device).y
    bx, by = (F.const(v, one).expand_as(one) for v in (_BX, _BY))
    return Point(bx, by, one, F.const(_BX * _BY % P, one).expand_as(one))


def _unified_add(p: Point, q: Point, mul, d_passes: int) -> Point:
    """a = -1 unified addition, 9 multiplies; `mul` and the carry passes
    of d = 2 z1 z2 are the only differences between the JAX twin's
    point_add and the TPU kernel's `_pt_add`.  Independent multiplies
    run as one call over a stacked axis (the same limbs, fewer ops)."""
    x1, y1, z1, t1, x2, y2, z2, t2 = torch.broadcast_tensors(*p, *q)
    y, x = torch.stack([y1, y2]), torch.stack([x1, x2])
    ymx, ypx = F.sub(y, x), F.add(y, x)
    a, b = mul(torch.stack([ymx[0], ypx[0]]), torch.stack([ymx[1], ypx[1]]))
    tt, zz = mul(torch.stack([t1, z1]), torch.stack([t2, z2]))
    c = mul(tt, F.const(2 * ref.D % P, tt))
    d = F.carry(2 * zz, d_passes)
    e, f = F.sub(torch.stack([b, d]), torch.stack([a, c]))
    g, h = F.add(torch.stack([d, b]), torch.stack([c, a]))
    return Point(*mul(torch.stack([e, g, f, e]), torch.stack([f, h, g, h])))


def point_add(p: Point, q: Point) -> Point:
    """Unified a=-1 twisted Edwards addition (complete; 9 muls), limb
    for limb `ed25519_jax.point_add`."""
    return _unified_add(p, q, F.mul, 4)


def point_neg(p: Point) -> Point:
    zero = torch.zeros_like(p.x)
    return Point(F.sub(zero, p.x), p.y, p.z, F.sub(zero, p.t))


def point_equal(p: Point, q: Point) -> torch.Tensor:
    """Projective equality: x1 z2 == x2 z1 and y1 z2 == y2 z1."""
    return (F.eq_mod_p(F.mul(p.x, q.z), F.mul(q.x, p.z))
            & F.eq_mod_p(F.mul(p.y, q.z), F.mul(q.y, p.z)))


def decompress(ybytes: torch.Tensor) -> Tuple[Point, torch.Tensor]:
    """[..., 32] little-endian encoded points -> (Point, ok [...] bool).

    ok is False for a non-canonical y (>= p), a non-residue x^2, or
    x = 0 with sign 1; coordinates are garbage where not ok.  The power
    comes back frozen from `pow_p` (the twin's is weak), which changes
    no value: every later use is a multiply or a freeze."""
    b = ybytes.to(I32)
    sign = b[..., 31] >> 7
    b = torch.cat([b[..., :31], (b[..., 31] & 0x7F)[..., None]], dim=-1)
    y = F.bytes32_to_limbs(b)
    ok = ~F.geq(y, F.const(P, y))

    one = F.one_like(y)
    y2 = F.sqr(y)
    u = F.sub(y2, one)
    v = F.add(F.mul(y2, F.const(ref.D, y)), one)
    v3 = F.mul(v, F.sqr(v))
    v7 = F.mul(v3, F.mul(v3, v))
    x = F.mul(F.mul(u, v3), F.pow_p(F.mul(u, v7), (P - 5) // 8))

    vx2 = F.mul(v, F.sqr(x))
    neg_u = F.sub(torch.zeros_like(u), u)
    root_direct = F.eq_mod_p(vx2, u)
    root_flip = F.eq_mod_p(vx2, neg_u)
    x = torch.where(root_flip[..., None], F.mul(x, F.const(ref.SQRT_M1, x)),
                    x)
    ok &= root_direct | root_flip

    xf = F.freeze(x)
    x_is_zero = (xf == 0).all(dim=-1)
    flip_sign = (xf[..., 0] & 1) != sign
    x = torch.where(flip_sign[..., None], F.sub(torch.zeros_like(xf), xf), xf)
    ok &= ~(x_is_zero & (sign == 1))
    return Point(x, y, one, F.mul(x, y)), ok


def compress(p: Point) -> torch.Tensor:
    """Point -> [..., 32] canonical little-endian bytes (int32 0..255)."""
    zi = F.inv(p.z)
    x = F.freeze(F.mul(p.x, zi))
    y = F.freeze(F.mul(p.y, zi))
    out = F.limbs_to_bytes32(y)
    top = out[..., 31] | ((x[..., 0] & 1) << 7)
    return torch.cat([out[..., :31], top[..., None]], dim=-1)


# --- [s]B - [k]A: the TPU kernel's plain version and the CUDA wrapper -------

STRAUS_KERNEL = "ed25519_straus"     # csrc/ed25519_straus.cu

# straus kernel launches since import (reset by callers that count a run)
STRAUS_LAUNCHES = 0

COMB_ROWS, COMB_ENT = 33, 8          # j * 256^i * B, i < 33, j = 1..8
COMB_DIGITS = 2 * COMB_ROWS          # signed radix-16 digits of s < 2^260
K_WINDOWS = 53                       # signed 5-bit windows of k < 2^260

# Work of one lane of the CUDA kernel, in multiplies and squarings (one
# int32 operation a product of the radix-2^25.5 yardstick: 100 a
# multiply, 55 a squaring).  A lane whose warp walks -[k]A: the table of
# e * (-A) (1 + 15 x 9 multiplies), 52 windows of 5 doublings (4
# squarings and 3 multiplies each, 4 where T is needed) and an add of 8,
# one more doubling, the comb's 66 adds of 7, its 4 doublings, window 0's
# add.  A warp whose every k is 0 does only the comb and its doublings.
STRAUS_MULS_PER_LANE = (1 + 15 * 9) + 52 * (4 * 3 + 4 + 8) + 4 + (
    COMB_DIGITS * 7 + 3 * 3 + 4 + 8)
STRAUS_SQRS_PER_LANE = 52 * 5 * 4 + 4 + 4 * 4
STRAUS_INT32_OPS_PER_LANE = (100 * STRAUS_MULS_PER_LANE
                             + 55 * STRAUS_SQRS_PER_LANE)
STRAUS_COMB_INT32_OPS_PER_LANE = 100 * (COMB_DIGITS * 7 + 3 * 3 + 4) + (
    55 * 4 * 4)
# bytes: s and k limbs, A's 4 coordinates in, 4 coordinates out
STRAUS_BYTES_PER_LANE = 4 * (2 * NLIMBS + 4 * NLIMBS + 4 * NLIMBS)


def _lsb_bits(v: torch.Tensor, n: int) -> torch.Tensor:
    """[..., 20] strict limbs -> [n, B] int64 bits, least significant
    first, zero above bit 259."""
    b = S.bits_msb_first(v).reshape(N_BITS, -1).flip(0).long()
    return torch.cat([b, b.new_zeros((n - N_BITS, b.shape[1]))])


def signed_digits(v: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """[..., 20] strict scalar limbs (< 2^260) -> [n, B] int64 signed
    radix-2^width digits in [-2^(width-1), 2^(width-1)), least
    significant first: the kernel's digits (v + 2^(width-1) in every
    digit, minus that offset), by the carry recoding they equal."""
    bits = _lsb_bits(v, n * width).reshape(n, width, -1)
    nib = (bits << torch.arange(width, device=bits.device)
           .reshape(1, width, 1)).sum(1)
    half, out, c = 1 << (width - 1), [], torch.zeros_like(nib[0])
    for i in range(n):
        t = nib[i] + c
        c = (t >= half).long()
        out.append(t - (c << width))
    return torch.stack(out)


def _kernel_digits(s: torch.Tensor, k: torch.Tensor):
    """The kernel's digits on these scalars: (comb digits of s [66, B],
    k's signed 5-bit digits [53, B], which of those are not 0, the index
    of k's top digit that is not 0 (0 where k = 0))."""
    es = signed_digits(s, 4, COMB_DIGITS)
    kd = signed_digits(k, 5, K_WINDOWS)
    knz = kd != 0
    top = torch.where(knz.any(0), K_WINDOWS - 1 - knz.flip(0).long().argmax(0),
                      torch.zeros_like(knz[0], dtype=torch.long))
    return es, kd, knz, top


def straus_ops_by_method(s: torch.Tensor, k: torch.Tensor):
    """Per lane, the int32 operations of the two methods the repo runs
    for [s]B - [k]A, on these scalars (the yardstick of
    `field.pow_int32_ops`): (joint, kernel) int64 [B] tensors.

    joint: a joint double-and-add from the top bit either scalar has
    (the TPU kernel's walk without its identity steps): below it, a
    dedicated doubling (4 squarings, 3 multiplies) per bit and an add (8
    multiplies: 7 for the sum, 1 for the T its doubling must then give)
    per bit pair that is not (0, 0); the table entry -A costs a multiply
    (2d T) and B - A an add and 2d T (9), each only where a bit pair
    picks it; the output's T one more.

    kernel: the CUDA kernel's method without the work that the data makes
    needless: 7 multiplies per comb digit of s that is not 0; the
    doublings (4 squarings and 3 multiplies each) the walk needs from k's
    top signed 5-bit digit t on, at least the comb's 4 (max(5 t, 4));
    where k is not 0, the table entries up to the largest |digit| m (m
    multiplies for 2d T, 8 for each add past the first) and 8 multiplies
    per digit that is not 0 past the first."""
    sb = S.bits_msb_first(s).reshape(N_BITS, -1)
    kb = S.bits_msb_first(k).reshape(N_BITS, -1)
    used = sb | kb
    n = torch.where(used.any(0), N_BITS - used.to(I32).argmax(0),
                    torch.zeros_like(used[0], dtype=torch.long))
    dbl = (n - 1).clamp(min=0)
    adds = (used.sum(0) - 1).clamp(min=0)
    muls = (3 * dbl + 8 * adds + (n > 1).long() + (kb & ~sb).any(0).long()
            + 9 * (kb & sb).any(0).long())
    joint = 100 * muls + 55 * 4 * dbl

    es, kd, knz, top = _kernel_digits(s, k)
    has_k = knz.any(0)
    kdbl = (5 * top).clamp(min=4)
    m = kd.abs().amax(0)
    kmuls = torch.where(has_k, m + 8 * (m - 1) + 8 * (knz.sum(0) - 1),
                        torch.zeros_like(m))
    kernel = 100 * (7 * (es != 0).sum(0) + 3 * kdbl + kmuls) + 55 * 4 * kdbl
    return joint, kernel


def straus_least_int32_ops(s: torch.Tensor, k: torch.Tensor) -> int:
    """int32 operations [s]B - [k]A needs at least on these scalars,
    summed over the lanes (the kernel's bound): per lane the less of the
    two methods of `straus_ops_by_method`, so the count never exceeds the
    work of a method the repo runs.  The kernel itself does
    `STRAUS_INT32_OPS_PER_LANE` a lane (`STRAUS_COMB_INT32_OPS_PER_LANE`
    where its warp's k are all 0)."""
    joint, kernel = straus_ops_by_method(s, k)
    return int(torch.minimum(joint, kernel).sum())


def straus_chain_muls(s: torch.Tensor, k: torch.Tensor) -> int:
    """The longest dependent chain of field multiplies in the kernel's
    method over the lanes, counted at 2 multiplies an add or a doubling
    (a niels add's products of Y-X, Y+X and T, then E F, G H, F G, E H;
    a doubling's squarings, then its products): the comb's adds of the
    digits that are not 0, the doublings of `straus_ops_by_method` and
    -A's adds.  Times the dependent latency of one multiply, the
    kernel's latency floor at B = 1."""
    es, _, knz, top = _kernel_digits(s, k)
    chain = 2 * ((es != 0).sum(0) + (5 * top).clamp(min=4) + knz.sum(0))
    return int(chain.max())


def _pt_add_tpu(p: Point, q: Point) -> Point:
    """`pallas_ed25519._pt_add`, limb for limb."""
    return _unified_add(p, q, F._mul_tpu, 2)


def _addend_table(a_point: Point) -> torch.Tensor:
    """[4 points, 4 coords, B, 20]: {O, B, -A, B - A}, built as
    `straus_sub_pallas` builds it (the twin's point ops)."""
    shape = a_point.x.shape[:-1]
    dev = a_point.x.device
    na = point_neg(a_point)
    b = base_point(shape, dev)
    pts = (identity(shape, dev), b, na, point_add(b, na))
    return torch.stack([torch.stack(torch.broadcast_tensors(*p))
                        for p in pts])


def straus_plain(s: torch.Tensor, k: torch.Tensor, a_point: Point) -> Point:
    """[s]B - [k]A as weak limbs: `_straus_kernel`'s loop (double, then
    add the table entry picked by bs + 2 bk) on any device.  s, k
    [..., 20] strict scalar limbs; a_point of [..., 20] leaves."""
    a_flat = Point(*(c.expand(s.shape).reshape(-1, NLIMBS) for c in a_point))
    table = _addend_table(a_flat)                            # [4, 4, B, 20]
    lanes = torch.arange(table.shape[2], device=s.device)
    sel = (S.bits_msb_first(s).to(torch.long)
           + 2 * S.bits_msb_first(k).to(torch.long)).reshape(N_BITS, -1)
    acc = identity((table.shape[2],), s.device)
    for i in range(N_BITS):
        acc = _pt_add_tpu(acc, acc)
        acc = _pt_add_tpu(acc, Point(*table[sel[i], :, lanes].unbind(1)))
    return Point(*(c.reshape(s.shape) for c in acc))


@functools.lru_cache(maxsize=None)
def _straus_lib() -> ctypes.CDLL:
    lib = cuda_build.load(STRAUS_KERNEL)
    fn = lib.ag_ed25519_straus_sub
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def straus_consts() -> Tuple[int, ...]:
    """The kernel's constant block (8 + 33 x 8 x 24 int32, radix-2^32
    limbs): 2d, then the comb table, row i entry j - 1 the affine niels
    (y+x, y-x, 2dxy) of j * 256^i * B, built from the RFC 8032 oracle's
    point arithmetic."""
    out = F.limbs32(2 * ref.D % P)
    row = ref.BASE
    for _ in range(COMB_ROWS):
        pt = row
        for _ in range(COMB_ENT):
            zi = ref._inv(pt[2])
            x, y = pt[0] * zi % P, pt[1] * zi % P
            for c in ((y + x) % P, (y - x) % P, 2 * ref.D * x * y % P):
                out += F.limbs32(c)
            pt = ref._add(pt, row)
        for _ in range(8):
            row = ref._double(row)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _straus_consts_tensor(device: torch.device) -> torch.Tensor:
    """The constant block on `device`, uploaded once (read-only)."""
    return torch.tensor(straus_consts(), dtype=I32, device=device)


def _rows(t: torch.Tensor, shape) -> Tuple[torch.Tensor, int]:
    """t broadcast to shape + (20,) as rows of 20 contiguous limbs at one
    row stride (0 where every row is the same one): (tensor, stride).  A
    view where the layout allows one, else a contiguous copy."""
    t = t.expand(tuple(shape) + (NLIMBS,))
    try:
        v = t.view(-1, NLIMBS)
    except RuntimeError:
        v = t.reshape(-1, NLIMBS)
    if v.stride(1) != 1:
        v = v.contiguous()
    return v, v.stride(0)


def straus_sub(s: torch.Tensor, k: torch.Tensor, a_point: Point) -> Point:
    """[s]B - [k]A with frozen coordinates: s, k [..., 20] int32 strict
    scalar limbs (< 2^260), a_point of [..., 20] int32 limbs (weak,
    signed; broadcast to s's batch shape).  CUDA tensors launch the
    kernel on the rows in place; CPU tensors run `straus_plain` and
    freeze."""
    global STRAUS_LAUNCHES
    lead = s.shape[:-1]
    for name, t in (("s", s), ("k", k)) + tuple(zip("xyzt", a_point)):
        if t.dtype != I32 or t.shape[-1] != NLIMBS:
            raise ValueError(f"straus_sub: {name} must be [..., {NLIMBS}] "
                             f"int32, got {t.dtype} {tuple(t.shape)}")
    if k.shape != s.shape:
        raise ValueError(f"straus_sub: k {tuple(k.shape)} != s "
                         f"{tuple(s.shape)}")
    dev = s.device
    if dev.type == "cpu":
        return Point(*(F.freeze(c) for c in straus_plain(s, k, a_point)))
    if dev.type != "cuda":
        raise ValueError(f"straus_sub: unsupported device {dev}")
    sr = s.reshape(-1, NLIMBS).contiguous()
    kr = k.reshape(-1, NLIMBS).contiguous()
    B = sr.shape[0]
    coords = [_rows(c, lead) for c in a_point]
    out = torch.empty((4, B, NLIMBS), dtype=I32, device=dev)
    if B:
        consts = _straus_consts_tensor(dev)
        lib = _straus_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ag_ed25519_straus_sub(
                sr.data_ptr(), kr.data_ptr(),
                *(c.data_ptr() for c, _ in coords),
                *(st for _, st in coords), consts.data_ptr(),
                out.data_ptr(), B, stream)
        if err != 0:
            raise RuntimeError(f"straus kernel launch failed: CUDA error "
                               f"{err}")
        STRAUS_LAUNCHES += 1
    return Point(*(out[c].view(s.shape) for c in range(4)))
