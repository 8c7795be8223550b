"""Port differential: the BLS12-381 field and tower of `agnes_tpu_torch`
against the JAX package, limb for limb.

* The plain versions of the two CUDA kernels (`bls_field.mul_plain`,
  `reduce_plain`) against the JAX rolled path
  (`bls_field_jax.reduce_cols(_mul_cols(...))`, `reduce_cols` at the
  pass counts the lane uses) and against the TPU kernels run by the
  Pallas interpreter (`pallas_field.mul_pairs_call` / `reduce_call`),
  on the boundary and random rows of tests/test_pallas_field.py.
* The constant tables and pass counts compiled into `csrc/bls_fp.cu`
  against the Python constants.
* `fv_mul_pairs`, `fv_inv`, the Fp2 helpers and the Fp12 multiply,
  square and Frobenius against the JAX twins at tiny shapes (the port
  eager; the twin under one `jax.jit`, since op-by-op JAX takes tens of
  seconds here); the Fp12 inverse against the `bls_ref` oracle (its
  JAX differential, a 14 s compile, is `slow`), the oracle being the
  JAX package's jax-free `bls_ref`.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py,
`chip_smoke.py`).  Inputs come from numpy with fixed seeds; every
comparison is exact.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agnes_tpu.crypto import bls_field_jax as JF
from agnes_tpu.crypto import bls_ref as ref
from agnes_tpu.crypto import bls_tower_jax as JT
from agnes_tpu.crypto import pallas_field as PF
from agnes_tpu_torch.crypto import bls_field as F
from agnes_tpu_torch.crypto import bls_tower as T
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = ref.P
_BOUNDARY = (0, 1, P - 1, P, 4 * P - 1)
CU = Path(F.__file__).resolve().parents[1] / "csrc" / "bls_fp.cu"


def _operand_rows(rng, n_random):
    """Boundary values strict, then loose sums a + b (a, b < 2p): the
    operand envelope of `fv_mul_pairs` (test_pallas_field's rows)."""
    rows = [JF.to_limbs(v) for v in _BOUNDARY]
    for _ in range(n_random):
        a = int(rng.integers(0, 2**62)) * int(rng.integers(0, 2**62)) \
            % (2 * P)
        b = int(rng.integers(0, 2**62)) ** 2 % (2 * P)
        rows.append(JF.to_limbs(a) + JF.to_limbs(b))
    return np.stack(rows).astype(np.int32)


def _col_rows(rng, n, k):
    """Columns as k-fold sums of strict encodings of values < 4p/k."""
    rows = []
    for _ in range(n):
        acc = None
        for _ in range(k):
            v = (int(rng.integers(0, 2**62)) ** 2) % (4 * P // k)
            lv = JF.to_limbs(v)
            acc = lv if acc is None else acc + lv
        rows.append(acc)
    return np.stack(rows).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_mul_plain_matches_rolled_and_residue():
    rng = np.random.default_rng(7)
    xa = _operand_rows(rng, 40)
    ya = _operand_rows(rng, 40)[::-1]
    want = np.asarray(jax.jit(lambda a, b: JF.reduce_cols(
        JF._mul_cols(a, b), JF.NLIMBS * JF._ELEM_LIMB * JF._ELEM_LIMB))(
            xa, ya.copy()))
    got = F.mul_rows(_t(xa), _t(ya)).numpy()       # CPU: the plain version
    np.testing.assert_array_equal(got, want)
    for i in range(len(xa)):
        g = F.from_limbs(got[i])
        assert g < 4 * P
        assert g % P == F.from_limbs(xa[i]) * F.from_limbs(ya[i]) % P


@pytest.mark.parametrize("k,bound", [(3, JF._ELEM_LIMB + JF.LMASK),
                                     (32, 16 * JF._ELEM_LIMB),
                                     (12, 12 * JF._ELEM_LIMB)])
def test_reduce_plain_matches_rolled(k, bound):
    """One pass (fv_reduce, fv_strict) and two (fv_mul_small by 12, the
    deep stacks), limb for limb."""
    rng = np.random.default_rng(11 + k)
    cols = np.concatenate([np.stack([JF.to_limbs(v) for v in _BOUNDARY]),
                           _col_rows(rng, 30, k)]).astype(np.int32)
    want = np.asarray(JF.reduce_cols(jnp.asarray(cols), bound))
    got = F.reduce_cols(_t(cols), bound).numpy()
    np.testing.assert_array_equal(got, want)
    assert F._passes_needed(bound) == JF._passes_needed(bound)


def test_plain_versions_match_pallas_interpret():
    """The TPU kernels themselves, under the Pallas interpreter."""
    rng = np.random.default_rng(3)
    xa = _operand_rows(rng, 11)
    ya = _operand_rows(rng, 11)[::-1].copy()
    got = F.mul_plain(_t(xa), _t(ya)).numpy()
    want = np.asarray(PF.mul_pairs_call(jnp.asarray(xa), jnp.asarray(ya),
                                        interpret=True))
    np.testing.assert_array_equal(got, want)
    bound = 16 * JF._ELEM_LIMB
    cols = _col_rows(rng, 16, 32)
    got = F.reduce_plain(_t(cols), F._passes_needed(bound)).numpy()
    want = np.asarray(PF.reduce_call(jnp.asarray(cols), bound,
                                     interpret=True))
    np.testing.assert_array_equal(got, want)


def _cu_table(name):
    body = re.search(name + r"\[\w+\] = \{([^}]*)\}", CU.read_text()).group(1)
    return tuple(int(v) for v in body.replace("\n", " ").split(",") if
                 v.strip())


def test_cuda_source_constants_pinned():
    assert _cu_table("kMu") == F._MU_LIMBS == tuple(PF._MU_LIMBS)
    assert _cu_table("kP") == F._P_LIMBS == tuple(PF._P_LIMBS)
    src = CU.read_text()
    for name, want in (("kMulPasses", PF._MUL_PASSES),
                       ("kMuPasses", PF._MU_PASSES),
                       ("kPPasses", PF._P_PASSES),
                       ("kRPasses", PF._R_PASSES),
                       ("kMuShift", F.MU_SHIFT_LIMBS), ("kN", F.NLIMBS)):
        got = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        assert got == want, name
    assert sum(v << (12 * i) for i, v in enumerate(_cu_table("kMu"))) == F.MU
    assert sum(v << (12 * i) for i, v in enumerate(_cu_table("kP"))) == P
    # the least work each kernel's bound counts
    assert F.MUL_INT32_OPS == F.least_products(True) == 33 * 33 + 561 + 591
    assert F.REDUCE_INT32_OPS == F.least_products(False) == 1 + 3 * 32
    assert int(re.search(r"constexpr int kQReduce = (\d+);", src)
               .group(1)) == 3                   # the reduce's q limbs
    # the group sizes the kernels launch with
    for fn in ("launch_mul", "launch_reduce"):
        cases = re.findall(rf"case (\d+): return {fn}<(\d+)>", src)
        assert all(a == b for a, b in cases), fn
        assert tuple(int(a) for a, _ in cases) == F.GROUP_SIZES, fn
    sizes = re.search(r"static_assert\((G == [^\"]*),\s*\"group size\"\)",
                      src)
    assert tuple(int(g) for g in re.findall(r"G == (\d+)", sizes.group(1))
                 ) == F.GROUP_SIZES
    assert _cu_table("kPG") == _cu_table("kP")   # the reduce's copy of p
    # the row-major contract: rows at a row stride in, contiguous rows out
    for idx in ("xa[row * sa + l]", "ya[row * sb + l]",
                "cols + mine * sc", "out[row * kN + l]"):
        assert src.count(idx) >= 1, idx
    assert "ag_bls_fp_mul(const int32_t* xa, int64_t sa," in src
    assert "ag_bls_fp_reduce(const int32_t* cols, int64_t sc," in src


def test_rows_are_read_in_place():
    """The wrappers' row views (`bls_field._rows`): contiguous stacks,
    broadcast constants, unbound and strided views keep their storage
    and give one row stride; only a broadcast no stride covers copies;
    the group size falls as the rows grow."""
    base = torch.arange(6 * 4 * 33, dtype=torch.int32).view(6, 4, 33)
    cases = [(base, (6, 4), 33), (base[0, 0], (6, 4), 0),
             (base.unbind(-2)[1], (6,), 4 * 33), (base[:, 1:3], (6, 2), None),
             (base[::2, 1], (3,), 2 * 4 * 33)]
    def kernel_rows(v, s, n):
        """The n rows the kernel reads: row i at word i * s of v."""
        return torch.as_strided(v, (n, 33), (s, 1), v.storage_offset())

    for a, lead, stride in cases:
        v, s = F._rows(a, lead)
        n = int(np.prod(lead))
        np.testing.assert_array_equal(
            kernel_rows(v, s, n).numpy(),
            a.expand(lead + (33,)).reshape(-1, 33).numpy())
        if stride is not None:
            assert s == stride and v.data_ptr() == a.data_ptr()
    v, s = F._rows(base[0, :2], (6, 2))          # strides (0, 33)
    assert s == 33 and v.data_ptr() != base.data_ptr()   # copied
    np.testing.assert_array_equal(kernel_rows(v, s, 12).numpy(),
                                  base[0, :2].repeat(6, 1).numpy())
    for table in (F.MUL_GROUPS, F.REDUCE_GROUPS):
        sizes = [F.group_size(r, table)
                 for r in (1, 432, 4096, 18_432, 70_000, 1 << 20)]
        assert sizes == sorted(sizes, reverse=True)
        assert set(sizes) <= set(F.GROUP_SIZES) and table[0][0] == 0


def test_cpu_wrappers_refuse_bad_input():
    with pytest.raises(ValueError):
        F.mul_rows(torch.zeros(2, 32, dtype=torch.int32),
                   torch.zeros(2, 32, dtype=torch.int32))
    with pytest.raises(ValueError):
        F.reduce_rows(torch.zeros(2, 33, dtype=torch.int64), 1)
    n0 = (F.MUL_LAUNCHES, F.REDUCE_LAUNCHES)
    F.reduce_rows(torch.zeros(2, 33, dtype=torch.int32), 1)
    assert (F.MUL_LAUNCHES, F.REDUCE_LAUNCHES) == n0   # CPU: no launch


# --- field values: the FV layer ------------------------------------------


def _elems(rng, n, shape=()):
    """n values < 4p (strict limbs) of leading shape `shape`."""
    vals = [int(rng.integers(0, 2**62)) ** 7 % (4 * P)
            for _ in range(n * int(np.prod(shape, dtype=int)))]
    return np.stack([JF.to_limbs(v) for v in vals]).astype(
        np.int32).reshape(tuple(shape) + (n, F.NLIMBS))


def _fv_ops(mod, e):
    """The FV-layer operations under test, written once for both
    packages: `mod` is bls_field or bls_field_jax, `e` [2, 6, 33]."""
    x = [mod.FV(e[:, k], mod.RED_BOUND) for k in range(6)]
    # a grown sum (12p) squared forces the auto-reduce of its operands
    big = mod.fv_add(mod.fv_add(x[0], x[1]), x[2])
    prods = mod.fv_mul_pairs([(x[3], x[4]), (big, big),
                              (mod.fv_sub(x[5], x[0]), x[1])])
    strict = mod.fv_strict(big)
    return ([p.a for p in prods]
            + [mod.fv_inv(x[2]).a, strict, mod.fv_mul_small(x[0], 12).a,
               mod.strict_eq_mod_p(strict, 0),
               mod.strict_eq_mod_p(strict, 12345)])


def _fp2_ops(mod, a, b):
    x, y = mod.fv2_in(a, mod.RED_BOUND), mod.fv2_in(b, mod.RED_BOUND)
    outs = [mod.fv2_mul(x, y), mod.fv2_neg(x), mod.fv2_conj(y),
            mod.fv2_reduce(mod.fv2_sub(x, y)), mod.fv2_inv(x)]
    return [mod.fv2_out(o) for o in outs]


def _check(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fv_mul_pairs_and_inv_match_jax():
    e = _elems(np.random.default_rng(21), 6, (2,))
    _check(_fv_ops(F, _t(e)), jax.jit(lambda v: _fv_ops(JF, v))(e))


def test_fp2_helpers_match_jax():
    rng = np.random.default_rng(22)
    a, b = _elems(rng, 2, (3,)), _elems(rng, 2, (3,))
    _check(_fp2_ops(F, _t(a), _t(b)),
           jax.jit(lambda u, v: _fp2_ops(JF, u, v))(a, b))


# --- the Fp12 tower -------------------------------------------------------


def _fp12(rng, n):
    return np.stack([_elems(rng, 2, (6,)) for _ in range(n)])


def _jit12(fn, n_args):
    return jax.jit(lambda *xs: JT.fv12_out(fn(*[JT.fv12_in(x, JF.RED_BOUND)
                                                for x in xs[:n_args]])))


def test_fp12_mul_square_frob_match_jax():
    rng = np.random.default_rng(23)
    a, b = _fp12(rng, 2), _fp12(rng, 2)
    ta, tb = (T.fv12_in(_t(x), F.RED_BOUND) for x in (a, b))
    jmul = _jit12(JT.fv12_mul, 2)
    np.testing.assert_array_equal(T.fv12_out(T.fv12_mul(ta, tb)).numpy(),
                                  np.asarray(jmul(a, b)))
    np.testing.assert_array_equal(T.fv12_out(T.fv12_square(ta)).numpy(),
                                  np.asarray(jmul(a, a)))
    np.testing.assert_array_equal(T.fv12_out(T.fv12_frob(tb)).numpy(),
                                  np.asarray(_jit12(JT.fv12_frob, 1)(b)))
    np.testing.assert_array_equal(T.fv12_out(T.fv12_conj(tb)).numpy(),
                                  np.asarray(JT.fv12_out(JT.fv12_conj(
                                      JT.fv12_in(jnp.asarray(b),
                                                 JF.RED_BOUND)))))


def test_fp12_inv_and_pack_vs_oracle():
    rng = np.random.default_rng(24)
    coeffs = [int(rng.integers(0, 2**62)) ** 5 % P for _ in range(12)]
    e = ref.FQ12(coeffs)
    arr = T.pack_fq12(e)
    np.testing.assert_array_equal(arr, JT.pack_fq12(e))
    assert T.unpack_fq12(arr).c == e.c
    x = T.fv12_in(_t(arr), P)
    inv = T.fv12_inv(x)
    assert T.unpack_fq12(T.fv12_out(inv)).c == e.inv().c
    one = T.fv12_mul(x, inv)
    assert bool(T.fv12_eq_one(one)) and not bool(T.fv12_eq_one(x))
    assert T.unpack_fq12(T.fv12_out(T.fv12_frob(x))).c == (e ** P).c


@pytest.mark.slow
def test_fp12_inv_and_cyclotomic_square_match_jax():
    rng = np.random.default_rng(25)
    a = _fp12(rng, 2)
    ta = T.fv12_in(_t(a), F.RED_BOUND)
    np.testing.assert_array_equal(T.fv12_out(T.fv12_inv(ta)).numpy(),
                                  np.asarray(_jit12(JT.fv12_inv, 1)(a)))
    np.testing.assert_array_equal(
        T.fv12_out(T.fv12_cyclotomic_square(ta)).numpy(),
        np.asarray(_jit12(JT.fv12_cyclotomic_square, 1)(a)))


def test_fv12_one_needs_a_device():
    with pytest.raises(TypeError):
        T.fv12_one(())
    one = T.fv12_out(T.fv12_one((2,), "cpu"))
    assert one.shape == (2, 6, 2, F.NLIMBS) and int(one.sum()) == 2
