"""Port differential: the BLS aggregation and pairing of
`agnes_tpu_torch` against the JAX package's jax-free `bls_ref` oracle
(fast) and the JAX twins (`slow`: each compiles a JAX BLS entry).

* The port's own copy of the oracle (`agnes_tpu_torch.crypto.bls_ref`,
  which the lane uses for message points and its per-share fallback)
  equal to the original statement for statement.

* `bls_aggregate` at N <= 8 with 2 windows (a padding lane included),
  in affine form, against oracle point sums (`slow`: the complete G1
  and G2 additions limb for limb against `bls_jax`'s, a 9 s compile).
* `bls_pairing_product` at C = 4 — an honest class (its aggregate
  projective, Z-scaled), a forged class, an identity aggregate beside a
  real signature, an all-identity padding class — against
  `bls_ref.pairing_product_is_one`.
* `final_exponentiate` equal to the CUBE of `bls_ref.final_exponentiate`,
  exactly.

On the CPU every field product runs the plain PyTorch version of the
CUDA multiply kernel (tests/test_torch_bls_field.py pins it limb for
limb); the kernels themselves run in tests/test_torch_cuda.py on a card.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agnes_tpu.crypto import bls_jax as JB
from agnes_tpu.crypto import bls_pairing_jax as JP
from agnes_tpu.crypto import bls_ref as ref
from agnes_tpu_torch.crypto import bls as B
from agnes_tpu_torch.crypto import bls_field as F
from agnes_tpu_torch.crypto import bls_pairing as BP
from agnes_tpu_torch.crypto import bls_ref as port_ref
from agnes_tpu_torch.crypto import bls_tower as T
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = ref.P


def _fixture(n, seed=1):
    """n pubkeys sk = v + 1 and their shares of one message, by
    cumulative adds (no scalar multiplications), and weights < 2^8 with
    the last lane a padding lane (weight 0)."""
    msg = ref.hash_to_g2(b"agnes class")
    pks, shares, a, s = [], [], None, None
    for _ in range(n):
        a, s = ref.point_add(a, ref.G1), ref.point_add(s, msg)
        pks.append(a)
        shares.append(s)
    w = np.random.default_rng(seed).integers(1, 256, n)
    w[-1] = 0
    return msg, pks, shares, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ints(x):
    """A point or field element of either package's `bls_ref` as nested
    ints (the two packages' FQP classes never compare equal)."""
    if isinstance(x, tuple):
        return tuple(_ints(c) for c in x)
    return x.c if hasattr(x, "c") else x


def _code(mod) -> str:
    """A module's AST without its docstrings."""
    tree = ast.parse(inspect.getsource(mod))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_port_oracle_copy_is_the_original():
    assert _code(port_ref) == _code(ref)
    msg = b"agnes class"
    assert _ints(port_ref.hash_to_g2(msg)) == _ints(ref.hash_to_g2(msg))
    assert (port_ref.P, port_ref.R, port_ref.H2) == (ref.P, ref.R, ref.H2)


def test_bls_aggregate_vs_oracle():
    _msg, pks, shares, w = _fixture(6)
    assert B.n_windows_for(8) == JB.n_windows_for(8) == 2
    assert B.n_windows_for(24) == 6 and B.n_windows_for(1) == 1
    np.testing.assert_array_equal(B.pack_weights(w), JB.pack_weights(w))
    np.testing.assert_array_equal(B.pack_g2_rows(shares),
                                  JB.pack_g2_rows(shares))
    apk, asig = B.bls_aggregate(_t(B.pack_g1_rows(pks)),
                                _t(B.pack_g2_rows(shares)),
                                _t(B.pack_weights(w)), n_windows=2)
    want_pk = want_sig = None
    for p, s, k in zip(pks, shares, w):
        want_pk = ref.point_add(want_pk, ref.point_mul(int(k), p))
        want_sig = ref.point_add(want_sig, ref.point_mul(int(k), s))
    assert _ints(B.g1_from_device(apk)) == _ints(want_pk)
    assert _ints(B.g2_from_device(asig)) == _ints(want_sig)


def _pairing_rows():
    """p [4, 2, 3, 33], q [4, 2, 3, 2, 33] and the oracle's verdicts."""
    msg = ref.hash_to_g2(b"class message")
    apk = ref.point_mul(3, ref.G1)
    asig = ref.point_mul(3, msg)
    forged = ref.point_mul(4, msg)
    cases = [(apk, asig), (apk, forged), (None, asig), (None, None)]
    ps, qs, want = [], [], []
    for k, (a, s) in enumerate(cases):
        g1 = BP.pack_g1_proj(a)
        if k == 0:      # projective input: (X Z, Y Z, Z) for Z = 5
            z = 5
            g1 = np.stack([F.to_limbs(a[0] * z % P), F.to_limbs(a[1] * z % P),
                           F.to_limbs(z)])
        if k == 3:      # all-identity padding: both pairs identities
            ps.append(np.zeros((2, 3, F.NLIMBS), np.int32))
            qs.append(np.zeros((2, 3, 2, F.NLIMBS), np.int32))
        else:
            ps.append(np.stack([BP.NEG_G1_LIMBS, g1]))
            qs.append(np.stack([BP.pack_g2_proj(s), BP.pack_g2_proj(msg)]))
        want.append(ref.pairing_product_is_one(
            [(ref.point_neg(ref.G1), s), (a, msg)]) if k < 3 else True)
    return np.stack(ps), np.stack(qs), want


def test_pairing_product_vs_oracle():
    p, q, want = _pairing_rows()
    assert want == [True, False, False, True]
    np.testing.assert_array_equal(BP.NEG_G1_LIMBS, JP.NEG_G1_LIMBS)
    got = BP.bls_pairing_product(_t(p), _t(q))
    assert got.dtype == torch.bool and got.tolist() == want


def test_final_exponentiate_is_cube_of_oracle():
    rng = np.random.default_rng(9)
    f = ref.FQ12([int(rng.integers(0, 2**62)) ** 5 % P for _ in range(12)])
    x = T.fv12_in(_t(T.pack_fq12(f)), P)
    got = T.unpack_fq12(T.fv12_out(BP.final_exponentiate(x)))
    assert got.c == (ref.final_exponentiate(f) ** 3).c


# --- slow twins: the JAX entries compiled ----------------------------------


@pytest.mark.slow
def test_bls_aggregate_matches_jax():
    _msg, pks, shares, w = _fixture(8, seed=2)
    args = (B.pack_g1_rows(pks), B.pack_g2_rows(shares), B.pack_weights(w))
    apk, asig = B.bls_aggregate(*map(_t, args), n_windows=2)
    japk, jasig = JB.bls_aggregate_jit(*map(jnp.asarray, args), n_windows=2)
    assert B.g1_from_device(apk) == JB.g1_from_device(
        jax.tree.map(np.asarray, japk))
    # two packages' FQ2 classes: compare their coefficients
    got = [c.c for c in B.g2_from_device(asig)]
    assert got == [c.c for c in JB.g2_from_device(
        jax.tree.map(np.asarray, jasig))]


@pytest.mark.slow
def test_pairing_product_matches_jax():
    p, q, want = _pairing_rows()
    got = BP.bls_pairing_product(_t(p), _t(q)).tolist()
    assert got == np.asarray(JP.bls_pairing_product_jit(
        jnp.asarray(p), jnp.asarray(q))).tolist() == want


@pytest.mark.slow
def test_g2_add_matches_jax_limb_for_limb():
    _msg, _pks, shares, _w = _fixture(4)
    rows = B.pack_g2_rows(shares)
    xy = (np.stack([rows[:, 0], rows[:, 1]], 1),
          np.stack([rows[:, 2], rows[:, 3]], 1))
    z = np.zeros((4, 2, F.NLIMBS), np.int32)
    z[:, 0] = F.to_limbs(1)
    p, q = xy + (z,), (xy[0][::-1].copy(), xy[1][::-1].copy(), z)
    got = B.g2_add(B.G2P(*map(_t, p)), B.G2P(*map(_t, q)))
    want = jax.jit(lambda a, b: JB.g2_add(JB.G2P(*a), JB.G2P(*b)))(p, q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.slow
def test_g1_add_matches_jax_limb_for_limb():
    _msg, pks, _shares, _w = _fixture(4)
    rows = B.pack_g1_rows(pks)
    one = np.broadcast_to(F.to_limbs(1), (4, F.NLIMBS))
    p = (rows[:, 0], rows[:, 1], one)
    q = (rows[::-1, 0], rows[::-1, 1], one)      # includes P + P
    got = B.g1_add(B.G1P(*map(_t, p)), B.G1P(*map(_t, q)))
    want = jax.jit(lambda a, b: JB.g1_add(JB.G1P(*a), JB.G1P(*b)))(p, q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
