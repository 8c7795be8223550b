"""GF(p) limb arithmetic for BLS12-381 — int32, 12-bit limbs (twin of
`agnes_tpu.crypto.bls_field_jax`), with the CUDA Barrett kernels.

Representation and bound discipline are the twin's (its module
docstring): 33 non-negative 12-bit limbs, products reduced by Barrett
against mu = floor(2^768 / p) on loosely carried limbs, results strict
limbs of a representative < 4p, every value carrying a STATIC Python
bound (`FV`) so that a formula that could overflow int32 fails in Python
before any arithmetic runs.

The two heavy bodies go through hand-written CUDA kernels
(`csrc/bls_fp.cu`), exactly where the twin's kernel lane routes them:

* `mul_rows` — the fused multiply + Barrett reduce of `fv_mul` /
  `fv_mul_pairs` (replaces `agnes_tpu/crypto/pallas_field.py::
  _mul_kernel`);
* `reduce_rows` — the Barrett reduce + carry chain of `reduce_cols` on
  33-wide columns, with a pass count fixed by the caller's column bound
  (replaces `pallas_field.py::_reduce_kernel`).

A CUDA tensor launches the kernel (a failed build or launch raises);
a CPU tensor runs the plain PyTorch version beside it, `mul_plain` /
`reduce_plain`: the twin's rolled `reduce_cols(_mul_cols(...))` and
`reduce_cols` in torch ops.  Both give the twin's limbs limb for limb.
There is no backend switch: the tensor's device decides.
`MUL_LAUNCHES` / `REDUCE_LAUNCHES` count kernel launches, and
`MUL_ROWS` / `REDUCE_ROWS` count them by row count.  The kernels read
the callers' [..., NLIMBS] rows in place and write contiguous rows; a
field element takes `group_size(R, MUL_GROUPS)` (or `REDUCE_GROUPS`)
lanes of a launch of R rows.

Plain-version notes.  PyTorch has no int32 matmul on the card, so the
twin's banded `x @ _MU_MAT` / `q @ _P_MAT` become skewed outer products
summed by rows (the same column integers).  The twin's final chain runs
over 24-bit limb pairs with a signed carry; its 33 output limbs are the
low 396 bits of the exact value sum_i r_i 2^(12 i) (two's complement),
so the plain version runs the same chain over 48-bit int64 groups of
four limbs — 9 steps instead of 17, the same bits.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from agnes_tpu_torch import cuda_build
from agnes_tpu_torch.crypto.bls_ref import P

I32 = torch.int32

BITS = 12
RADIX = 1 << BITS            # 4096
LMASK = RADIX - 1
NLIMBS = 33                  # 396 bits of headroom (4p < 2^384)
MU_SHIFT_LIMBS = 64          # Barrett shift: 2^768, limb-aligned
MU = (1 << (BITS * MU_SHIFT_LIMBS)) // P

#: loose-limb bound after a vectorized carry pass (strict is 4095)
LOOSE = RADIX + 8
#: Barrett precondition (slack for the loose-quotient error)
REDUCE_CAP = (1 << (BITS * MU_SHIFT_LIMBS)) - (1 << 762)
#: every reduce output obeys this value bound
RED_BOUND = 4 * P


def _const_limbs(x: int) -> List[int]:
    out = []
    while x:
        out.append(x & LMASK)
        x >>= BITS
    return out or [0]


# --- host <-> limb conversion ----------------------------------------------

def to_limbs(x: int) -> np.ndarray:
    """Python int in [0, 2^396) -> [NLIMBS] int32 (host helper)."""
    return np.asarray([(x >> (BITS * i)) & LMASK
                       for i in range(NLIMBS)], np.int32)


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of ints -> [len, NLIMBS] int32 (host helper)."""
    return np.stack([to_limbs(int(x)) for x in xs]) if len(xs) \
        else np.zeros((0, NLIMBS), np.int32)


def from_limbs(a) -> int:
    """Limb array or tensor (loose limbs welcome) -> Python int; the
    caller takes `% P`."""
    arr = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return sum(int(arr[..., i]) << (BITS * i)
               for i in range(arr.shape[-1]))


# --- vectorized carry passes ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pass_mask(n: int, device: torch.device) -> torch.Tensor:
    """LMASK on every limb but the top, which keeps all its bits."""
    return torch.tensor([LMASK] * (n - 1) + [-1], dtype=I32, device=device)


def _vpass(r: torch.Tensor) -> torch.Tensor:
    """One exact vectorized carry pass over the limb axis (`_vpass` of
    the twin): the top limb keeps its full value, signed carries borrow
    through the arithmetic shift."""
    out = r & _pass_mask(r.shape[-1], r.device)
    out[..., 1:] += r[..., :-1] >> BITS
    return out


def _passes_needed(col_bound: int) -> int:
    n, m = 0, int(col_bound)
    while m > LOOSE:
        m = RADIX + m // RADIX + 1
        n += 1
    return max(n, 1)


def _chain_strict(r: torch.Tensor) -> torch.Tensor:
    """Signed carry chain -> the NLIMBS strict limbs of the value's low
    396 bits (the twin's `_chain_strict(r)[..., :NLIMBS]`; the caller
    guarantees the value is non-negative and fits).  Runs over 48-bit
    int64 groups of four limbs (module docstring)."""
    r = r[..., :NLIMBS].to(torch.int64)
    r = tF.pad(r, (0, 36 - NLIMBS))
    g = r.unflatten(-1, (9, 4))
    s = (g[..., 0] + (g[..., 1] << 12) + (g[..., 2] << 24)
         + (g[..., 3] << 36))
    outs = []
    c = torch.zeros_like(s[..., 0])
    mask48 = (1 << 48) - 1
    for k in range(9):
        t = s[..., k] + c
        outs.append(t & mask48)
        c = t >> 48
    sup = torch.stack(outs, dim=-1)
    shifts = torch.tensor([0, 12, 24, 36], dtype=torch.int64,
                          device=r.device)
    limbs = (sup[..., None] >> shifts) & LMASK
    return limbs.flatten(-2)[..., :NLIMBS].to(I32)


def _skew_sum(prod: torch.Tensor, n_out: int) -> torch.Tensor:
    """[..., n, m] outer product (row i = a_i * b) -> [..., n_out]
    columns sum_{i+j=k} prod[i, j], clipped or zero-padded to n_out:
    row i padded to n + m entries and re-cut at width n + m - 1 lands
    in columns i..i+m-1."""
    n, m = prod.shape[-2], prod.shape[-1]
    w = n + m - 1
    flat = tF.pad(prod, (0, n)).flatten(-2)[..., :n * w]
    cols = flat.unflatten(-1, (n, w)).sum(-2, dtype=I32)
    if n_out > w:
        return tF.pad(cols, (0, n_out - w))
    return cols[..., :n_out]


@functools.lru_cache(maxsize=None)
def _const_tensor(const: Tuple[int, ...], device: torch.device
                  ) -> torch.Tensor:
    return torch.tensor(const, dtype=I32, device=device)


def _conv_const(a: torch.Tensor, const: Tuple[int, ...],
                n_out: int) -> torch.Tensor:
    """Limb convolution by a constant, out[k] = sum_i a[i] const[k-i]
    for k < n_out: the twin's banded `a @ _MU_MAT` / `a @ _P_MAT`."""
    c = _const_tensor(const, a.device)
    return _skew_sum(a[..., :, None] * c, n_out)


def _mul_cols(xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """Schoolbook columns of x*y ([..., NLIMBS] each, broadcast ->
    [..., 2*NLIMBS-1]), the twin's `_mul_cols` integers."""
    return _skew_sum(xa[..., :, None] * ya[..., None, :], _N65)


_N65 = 2 * NLIMBS - 1
_MU_LIMBS = tuple(_const_limbs(MU))
_P_LIMBS = tuple(_const_limbs(P))

#: static carry-pass counts of the fused bodies (`pallas_field`'s, the
#: same `_passes_needed` arithmetic as the rolled path), also compiled
#: into `csrc/bls_fp.cu` (a test pins them)
_ELEM_LIMB = 2 * LOOSE
_MUL_PASSES = _passes_needed(NLIMBS * _ELEM_LIMB * _ELEM_LIMB)
_MU_PASSES = _passes_needed(len(_MU_LIMBS) * LOOSE * LMASK)
_P_PASSES = _passes_needed(len(_P_LIMBS) * LOOSE * LMASK)
_R_PASSES = _passes_needed(2 * LOOSE * LMASK)


# --- the plain versions of the kernels -------------------------------------

def reduce_plain(cols: torch.Tensor, passes: int) -> torch.Tensor:
    """Barrett reduction of NON-NEGATIVE columns (value < REDUCE_CAP)
    after `passes` carry passes -> [..., NLIMBS] strict limbs < 4p: the
    twin's rolled `reduce_cols` body (plain version of the reduce
    kernel, and of the multiply kernel after `_mul_cols`)."""
    x = cols
    for _ in range(passes):
        x = _vpass(x)
    n = x.shape[-1]
    if n < _N65:
        x = tF.pad(x, (0, _N65 - n))
    t = _conv_const(x, _MU_LIMBS, _N65 + len(_MU_LIMBS))
    for _ in range(_MU_PASSES):
        t = _vpass(t)
    q = t[..., MU_SHIFT_LIMBS:MU_SHIFT_LIMBS + NLIMBS]
    ql = _conv_const(q, _P_LIMBS, _N65)
    for _ in range(_P_PASSES):
        ql = _vpass(ql)
    r = x - ql
    for _ in range(_R_PASSES):
        r = _vpass(r)
    return _chain_strict(r)


def mul_plain(xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """Plain version of the multiply kernel: the twin's rolled
    `reduce_cols(_mul_cols(xa, ya), NLIMBS * _ELEM_LIMB**2)`."""
    return reduce_plain(_mul_cols(xa, ya), _MUL_PASSES)


# --- the CUDA kernels --------------------------------------------------------

FP_KERNEL = "bls_fp"            # csrc/bls_fp.cu
#: lanes a field element may take on the card (csrc/bls_fp.cu's `Team`)
GROUP_SIZES = (2, 4, 8, 16, 32)
# kernel launches since import, in total and by row count (reset by
# callers that count a run)
MUL_LAUNCHES = 0
REDUCE_LAUNCHES = 0
MUL_ROWS: collections.Counter = collections.Counter()
REDUCE_ROWS: collections.Counter = collections.Counter()

def least_products(with_product: bool) -> int:
    """32-bit multiply-adds the least work of a kernel's function needs
    per element, counted from the constants.  The Barrett input x is the
    product's 65 columns (the multiply kernel, which also needs their
    33 x 33 schoolbook) or the reduce's 33 columns.  The quotient needs
    only the columns 64 and up of x * mu, from the limbs x has (the
    lower columns reach it only through carries): 561 products for the
    multiply, 1 for the reduce.  q is then at most n_x + 33 - 64 + 1
    limbs wide (33; 3 for the reduce: its top column < 2^31 gives
    x < 2^416, q < 2^36), and the remainder needs only the columns
    0..33 of q * p, the bits the 33 output limbs can see."""
    n_x = _N65 if with_product else NLIMBS
    quot = sum(1 for i in range(n_x) for j, c in enumerate(_MU_LIMBS)
               if c and i + j >= MU_SHIFT_LIMBS)
    q_w = min(NLIMBS, n_x + len(_MU_LIMBS) - MU_SHIFT_LIMBS + 1)
    rem = sum(1 for i in range(q_w) for j, c in enumerate(_P_LIMBS)
              if c and i + j <= NLIMBS)
    return quot + rem + (NLIMBS * NLIMBS if with_product else 0)


#: int32 operations a bound counts per element: one a product, since
#: with 12-bit limbs each is a single 32-bit IMAD (acc += a * b)
MUL_INT32_OPS = least_products(True)
REDUCE_INT32_OPS = least_products(False)

#: lanes a field element takes by the launch's row count, (rows at
#: least, lanes): the fastest on an H100 at the row counts that
#: scripts/bls_fp_probe.py timed (PERF.md §6).  Small launches want the
#: shortest latency, large ones the fewest redundant window products.
MUL_GROUPS = ((0, 32), (1536, 8), (12_288, 4))
REDUCE_GROUPS = ((0, 16), (4096, 4), (32_768, 2))


def group_size(rows: int, table) -> int:
    """Lanes a field element takes in a launch of `rows` rows."""
    return [g for lo, g in table if rows >= lo][-1]


@functools.lru_cache(maxsize=None)
def _fp_lib() -> ctypes.CDLL:
    lib = cuda_build.load(FP_KERNEL)
    lib.ag_bls_fp_mul.argtypes = [ctypes.c_void_p, ctypes.c_int64] * 2 + [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.ag_bls_fp_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ag_bls_fp_mul.restype = ctypes.c_int
    lib.ag_bls_fp_reduce.restype = ctypes.c_int
    return lib


def _check_rows(name: str, *ts: torch.Tensor) -> torch.device:
    for t in ts:
        if t.dtype != I32 or t.shape[-1] != NLIMBS:
            raise ValueError(f"{name}: [..., {NLIMBS}] int32 limbs, got "
                             f"{t.dtype} {tuple(t.shape)}")
    dev = ts[0].device
    if any(t.device != dev for t in ts) or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: operands on {[t.device for t in ts]}")
    return dev


def _rows(a: torch.Tensor, lead) -> Tuple[torch.Tensor, int]:
    """`a` broadcast to lead + [NLIMBS] as R rows the kernel reads in
    place: (tensor, row stride in int32 words).  A broadcast row has
    stride 0; only leading dims that no single stride covers (or limbs
    that are not adjacent) cost a copy.  The lane's usual operands (a
    contiguous stack, one constant row) take no torch op at all: the
    lane is bound by its host path."""
    if a.is_contiguous():
        if a.shape[:-1] == lead:
            return a, NLIMBS
        if a.dim() == 1:
            return a, 0
    b = a.expand(tuple(lead) + (NLIMBS,))
    try:
        v = b.view(-1, NLIMBS)
    except RuntimeError:
        v = b.reshape(-1, NLIMBS)
    if v.stride(1) != 1:
        v = v.contiguous()
    return v, v.stride(0)


def _launch(fn, dev: torch.device, *args) -> None:
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(fn, dev, *args)
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bls_fp launch failed: CUDA error {err}")


def mul_rows(xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """Fused multiply + Barrett reduce over [..., NLIMBS] limbs (leading
    shapes broadcast) -> contiguous [..., NLIMBS] strict limbs of a < 4p
    representative, limb for limb the twin's rolled path.  The caller
    (`fv_mul_pairs`) has enforced the Barrett precondition through the
    static FV bounds.  CUDA tensors launch the kernel once, reading the
    operands' rows in place; CPU tensors run `mul_plain`."""
    global MUL_LAUNCHES
    dev = _check_rows("mul_rows", xa, ya)
    if dev.type == "cpu":
        return mul_plain(xa, ya)
    lead = xa.shape[:-1] if xa.shape == ya.shape else \
        torch.broadcast_shapes(xa.shape[:-1], ya.shape[:-1])
    out = torch.empty(tuple(lead) + (NLIMBS,), dtype=I32, device=dev)
    R = out.numel() // NLIMBS
    if R:
        (xv, sa), (yv, sb) = _rows(xa, lead), _rows(ya, lead)
        _launch(_fp_lib().ag_bls_fp_mul, dev, xv.data_ptr(), sa,
                yv.data_ptr(), sb, out.data_ptr(), R,
                group_size(R, MUL_GROUPS))
        MUL_LAUNCHES += 1
        MUL_ROWS[R] += 1
    return out


def reduce_rows(cols: torch.Tensor, passes: int) -> torch.Tensor:
    """Barrett reduce + carry chain over [..., NLIMBS] NON-NEGATIVE
    columns (value < REDUCE_CAP) after `passes` carry passes -> strict
    < 4p limbs, limb for limb the twin's rolled `reduce_cols`.  CUDA
    tensors launch the kernel once (contiguous [..., NLIMBS] out) at the
    lane's pass counts, 1 and 2: its q * p uses the 3 quotient limbs that
    columns below 2^19 let be nonzero (csrc/bls_fp.cu).  CPU tensors run
    `reduce_plain`."""
    global REDUCE_LAUNCHES
    dev = _check_rows("reduce_rows", cols)
    if not 1 <= int(passes) <= 8:
        raise ValueError(f"reduce_rows: passes must be in [1, 8]: {passes}")
    if dev.type == "cpu":
        return reduce_plain(cols, passes)
    if int(passes) > 2:
        raise ValueError(f"reduce_rows: the reduce kernel takes the "
                         f"lane's pass counts, 1 or 2, not {passes}")
    lead = cols.shape[:-1]
    out = torch.empty(tuple(lead) + (NLIMBS,), dtype=I32, device=dev)
    R = out.numel() // NLIMBS
    if R:
        cv, sc = _rows(cols, lead)
        _launch(_fp_lib().ag_bls_fp_reduce, dev, cv.data_ptr(), sc,
                out.data_ptr(), R, int(passes),
                group_size(R, REDUCE_GROUPS))
        REDUCE_LAUNCHES += 1
        REDUCE_ROWS[R] += 1
    return out


# --- Barrett reduction ------------------------------------------------------

def reduce_cols(cols: torch.Tensor, col_bound: int) -> torch.Tensor:
    """Raw NON-NEGATIVE columns (value < REDUCE_CAP) -> [..., NLIMBS]
    STRICT limbs of a representative < 4p of the same residue class
    (the twin's docstring has the bound argument).  Every caller passes
    33-wide columns, which go through the reduce kernel as on the
    twin's kernel lane; `reduce_rows` refuses any other width."""
    return reduce_rows(cols, _passes_needed(col_bound))


# --- statically-bounded field values ---------------------------------------

@dataclasses.dataclass(frozen=True)
class FV:
    """A field value: non-negative loose limbs + a STATIC Python value
    bound (the bookkeeping costs no device work)."""

    a: torch.Tensor         # [..., NLIMBS] limbs, interior <= ~2*LOOSE
    bound: int

    def __post_init__(self):
        assert self.a.shape[-1] == NLIMBS, self.a.shape


def fv_in(arr: torch.Tensor, bound: int = P) -> FV:
    """Wrap a kernel input (canonical host-packed limbs by default)."""
    return FV(arr, bound)


def fv_add(x: FV, y: FV) -> FV:
    return FV(_vpass(x.a + y.a), x.bound + y.bound)


#: memoized subtraction spreads (limbs, value), keyed by the
#: subtrahend's top-limb bound
_SPREADS: Dict[int, Tuple[np.ndarray, int]] = {}


def _sub_spread(y_bound: int) -> Tuple[np.ndarray, int]:
    """(limb array, value) of a multiple of p that per-limb dominates
    any element with value < y_bound (the twin's `_sub_spread`)."""
    ytop = (int(y_bound) >> (BITS * (NLIMBS - 1))) + 2
    hit = _SPREADS.get(ytop)
    if hit is not None:
        return hit
    base = sum(_ELEM_LIMB << (BITS * i) for i in range(NLIMBS - 1))
    k = -(-(base + (ytop + 1) * (1 << (BITS * (NLIMBS - 1)))) // P)
    v = k * P
    rest = v - base
    assert rest >> (BITS * (NLIMBS - 1)) >= ytop
    limbs = np.asarray(
        [_ELEM_LIMB + ((rest >> (BITS * i)) & LMASK)
         for i in range(NLIMBS - 1)]
        + [rest >> (BITS * (NLIMBS - 1))], np.int64)
    assert (limbs < (1 << 30)).all(), "spread top limb overflow"
    assert sum(int(limbs[i]) << (BITS * i)
               for i in range(NLIMBS)) == v
    out = (np.asarray(limbs, np.int32), v)
    _SPREADS[ytop] = out
    return out


@functools.lru_cache(maxsize=None)
def _spread_tensor(y_top: int, device: torch.device
                   ) -> Tuple[torch.Tensor, int]:
    """`_sub_spread` on `device`, keyed by the bound's top limb."""
    spread, v = _sub_spread(y_top << (BITS * (NLIMBS - 1)))
    return torch.from_numpy(spread).to(device), v


def fv_sub(x: FV, y: FV) -> FV:
    """x - y + spread(y.bound): value-equivalent mod p, limbs stay
    non-negative (Barrett's one-sided-quotient requirement)."""
    s, v = _spread_tensor(y.bound >> (BITS * (NLIMBS - 1)), x.a.device)
    return FV(_vpass(x.a - y.a + s), x.bound + v)


def fv_reduce(x: FV) -> FV:
    """Re-reduce a grown value below 4p."""
    assert x.bound < REDUCE_CAP
    if x.bound <= RED_BOUND:
        return x
    return FV(reduce_cols(x.a, _ELEM_LIMB + LMASK), RED_BOUND)


def fv_mul(x: FV, y: FV) -> FV:
    # auto-reduce grown operands until the product fits the Barrett
    # precondition (static: the common case pays nothing)
    while x.bound * y.bound >= REDUCE_CAP:
        if x.bound >= y.bound:
            assert x.bound > RED_BOUND, "un-reducible operand pair"
            x = fv_reduce(x)
        else:
            y = fv_reduce(y)
    return FV(mul_rows(x.a, y.a), RED_BOUND)


def fv_mul_small(x: FV, k: int) -> FV:
    assert 0 < k * _ELEM_LIMB < (1 << 31) \
        and x.bound * k < REDUCE_CAP
    return FV(reduce_cols(x.a * k, k * _ELEM_LIMB), RED_BOUND)


def _stack(arrs: List[torch.Tensor]) -> torch.Tensor:
    """Stack limb tensors on a new axis -2, broadcasting their leading
    shapes first (a constant [NLIMBS] operand rides beside batched ones)."""
    shapes = {a.shape for a in arrs}
    if len(shapes) > 1:
        lead = torch.broadcast_shapes(*[s[:-1] for s in shapes])
        arrs = [a.expand(lead + (NLIMBS,)) for a in arrs]
    return torch.stack(arrs, dim=-2)


def fv_reduce_stack(fvs: List[FV]) -> List[FV]:
    """Re-reduce a LIST of values below 4p with ONE stacked reduce
    (every input reduced unconditionally, as in the twin)."""
    for x in fvs:
        assert x.bound < REDUCE_CAP
    out = reduce_cols(_stack([x.a for x in fvs]), _ELEM_LIMB + LMASK)
    return [FV(o, RED_BOUND) for o in out.unbind(-2)]


def fv_mul_pairs(pairs) -> List[FV]:
    """[(x, y), ...] -> [x*y, ...] through ONE stacked multiply-kernel
    launch; pairs over the Barrett precondition first auto-reduce their
    grown operands through ONE further stacked reduce (the twin's
    docstring)."""
    fixed = [list(p) for p in pairs]
    marks = []
    for i, (x, y) in enumerate(fixed):
        if x.bound * y.bound < REDUCE_CAP:
            continue
        hit = False
        for j in (0, 1):
            if fixed[i][j].bound > RED_BOUND:
                marks.append((i, j))
                hit = True
        assert hit, "un-reducible operand pair"
    if marks:
        red = fv_reduce_stack([fixed[i][j] for i, j in marks])
        for k, (i, j) in enumerate(marks):
            fixed[i][j] = red[k]
    for x, y in fixed:
        assert x.bound * y.bound < REDUCE_CAP
    out = mul_rows(_stack([x.a for x, _ in fixed]),
                   _stack([y.a for _, y in fixed]))
    return [FV(o, RED_BOUND) for o in out.unbind(-2)]


#: static bit table of p - 2, MSB first (the Fermat-inversion chain)
_INV_EXP_BITS = tuple((P - 2) >> i & 1
                      for i in range((P - 2).bit_length() - 1, -1, -1))


def _one_like(a: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return one


def fv_inv(x: FV) -> FV:
    """x^(p-2), the modular inverse (0 maps to 0): square-and-multiply
    over the static bits of p - 2, multiplying every step by x or by 1
    as the twin's branch-free loop does (a multiply by 1 still reduces,
    so skipping it would change the limbs)."""
    x = fv_reduce(x)
    one = _one_like(x.a)
    acc = x.a
    for bit in _INV_EXP_BITS[1:]:                  # MSB consumed
        sq = fv_mul_pairs([(FV(acc, RED_BOUND), FV(acc, RED_BOUND))])[0]
        acc = fv_mul_pairs([(sq, FV(x.a if bit else one, RED_BOUND))])[0].a
    return FV(acc, RED_BOUND)


# --- canonical comparison (device verdicts) ---------------------------------

def fv_strict(x: FV) -> torch.Tensor:
    """Strict limbs of a < 4p representative of x's residue class."""
    assert x.bound < REDUCE_CAP
    return reduce_cols(x.a, _ELEM_LIMB + LMASK)


@functools.lru_cache(maxsize=None)
def _reps(value: int, device: torch.device) -> torch.Tensor:
    """[4, NLIMBS] strict limbs of value % p + {0, 1, 2, 3} p."""
    return torch.from_numpy(np.stack(
        [to_limbs(value % P + k * P) for k in range(4)])).to(device)


def strict_eq_mod_p(strict: torch.Tensor, value: int) -> torch.Tensor:
    """strict (< 4p, strict limbs) == value (mod p) -> [...] bool: the
    four < 4p representatives, each a unique strict limb pattern."""
    reps = _reps(value, strict.device)
    return (strict[..., None, :] == reps).all(-1).any(-1)


def fv_eq_mod_p(x: FV, value: int) -> torch.Tensor:
    return strict_eq_mod_p(fv_strict(x), value)


# --- Fp2 (u^2 = -1), components as FV pairs ---------------------------------

@dataclasses.dataclass(frozen=True)
class FV2:
    c0: FV
    c1: FV


def fv2_in(arr: torch.Tensor, bound: int = P) -> FV2:
    """[..., 2, NLIMBS] -> FV2."""
    return FV2(FV(arr[..., 0, :], bound), FV(arr[..., 1, :], bound))


def fv2_add(x: FV2, y: FV2) -> FV2:
    return FV2(fv_add(x.c0, y.c0), fv_add(x.c1, y.c1))


def fv2_sub(x: FV2, y: FV2) -> FV2:
    return FV2(fv_sub(x.c0, y.c0), fv_sub(x.c1, y.c1))


def fv2_mul_pairs_expand(x: FV2, y: FV2):
    """The three Karatsuba operand pairs of x*y over u^2 = -1:
    a0b0, a1b1, (a0+a1)(b0+b1)."""
    return [(x.c0, y.c0), (x.c1, y.c1),
            (fv_add(x.c0, x.c1), fv_add(y.c0, y.c1))]


def fv2_mul_pairs_combine(v0: FV, v1: FV, v2: FV) -> FV2:
    """c0 = v0 - v1, c1 = v2 - v0 - v1 (Karatsuba recombination)."""
    return FV2(fv_sub(v0, v1), fv_sub(v2, fv_add(v0, v1)))


def fv2_mul(x: FV2, y: FV2) -> FV2:
    """Karatsuba over u^2 = -1, its three products in one launch."""
    v0, v1, v2 = fv_mul_pairs(fv2_mul_pairs_expand(x, y))
    return fv2_mul_pairs_combine(v0, v1, v2)


def _zero_fv(a: torch.Tensor) -> FV:
    return FV(torch.zeros_like(a), 1)


def fv2_neg(x: FV2) -> FV2:
    z = _zero_fv(x.c0.a)
    return FV2(fv_sub(z, x.c0), fv_sub(z, x.c1))


def fv2_conj(x: FV2) -> FV2:
    """a0 - a1 u: the p-power Frobenius on Fp2."""
    return FV2(x.c0, fv_sub(_zero_fv(x.c1.a), x.c1))


def fv2_inv(x: FV2) -> FV2:
    """(a0 - a1 u) / (a0^2 + a1^2), the denominator by the Fermat chain;
    0 maps to 0."""
    s0, s1 = fv_mul_pairs([(x.c0, x.c0), (x.c1, x.c1)])
    n = fv_inv(fv_add(s0, s1))
    z = _zero_fv(x.c1.a)
    c0, c1 = fv_mul_pairs([(x.c0, n), (fv_sub(z, x.c1), n)])
    return FV2(c0, c1)


def fv2_reduce(x: FV2) -> FV2:
    return FV2(fv_reduce(x.c0), fv_reduce(x.c1))


def fv2_out(x: FV2) -> torch.Tensor:
    """FV2 -> [..., 2, NLIMBS]."""
    return torch.stack([x.c0.a, x.c1.a], dim=-2)
