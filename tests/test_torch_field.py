"""Port differential: the GF(2^255 - 19) layer of `agnes_tpu_torch` against
`agnes_tpu.crypto.field_jax` (eager jnp) limb for limb, and the plain
version of the pow kernel against `pallas_ed25519.pow_p_pallas` run in
interpret mode, limb for limb, and against Python's `pow`.  Inputs are
made with numpy from fixed seeds; every comparison is exact.

Also: the kernels' build key covers the shared headers (no nvcc needed).
The CUDA pow kernel itself runs only on the card
(tests/test_torch_cuda.py); `chip_smoke.py` holds it against `pow_plain`,
and tests/test_torch_pow_straus_host.py runs its lane math with g++.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agnes_tpu.crypto import field_jax as JF
from agnes_tpu.crypto import pallas_ed25519 as pk
from agnes_tpu.crypto import scalar_jax as JS
from agnes_tpu_torch import cuda_build
from agnes_tpu_torch.crypto import field as F
from agnes_tpu_torch.crypto import scalar as S
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = 2**255 - 19


def _limbs(v):
    return [(v >> (13 * i)) & 0x1FFF for i in range(20)]


def _value(row):
    return sum(int(x) << (13 * i) for i, x in enumerate(row))


def _weak_inputs(seed, n=24):
    """[n, 20] int32: random weak signed limbs, random strict limbs and
    the edges (0, p - 1, p, p + 1, 2^255, 2^260 - 1, all -8800, all
    8800, one negative top limb)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(-8800, 8801, (n, 20)).astype(np.int32)
    a[:4] = rng.randint(0, 8192, (4, 20))
    for i, v in enumerate([0, P - 1, P, P + 1, 2**255, 2**260 - 1]):
        a[4 + i] = _limbs(v)
    a[10], a[11] = -8800, 8800
    a[12, 19] = -8000
    return a


def test_field_ops_vs_field_jax_limb_for_limb():
    a, b = _weak_inputs(0), _weak_inputs(1)[::-1].copy()
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    fz = F.freeze(ta)
    pairs = {
        "mul": (F.mul(ta, tb), JF.mul(ja, jb)),
        "sqr": (F.sqr(ta), JF.sqr(ja)),
        "add": (F.add(ta, tb), JF.add(ja, jb)),
        "sub": (F.sub(ta, tb), JF.sub(ja, jb)),
        "carry": (F.carry(ta * 1000), JF.carry(ja * 1000)),
        "carry2": (F.carry(ta - tb, passes=2), JF.carry(ja - jb, passes=2)),
        "strict_carry": (F.strict_carry(ta + torch.tensor(F.SUB_K)),
                         JF.strict_carry(ja + JF.SUB_K)),
        "mul_small": (F.mul_small(ta, 121666), JF.mul_small(ja, 121666)),
        "freeze": (fz, JF.freeze(ja)),
        "eq_mod_p": (F.eq_mod_p(ta, tb), JF.eq_mod_p(ja, jb)),
        "eq_mod_p_self": (F.eq_mod_p(ta, fz), JF.eq_mod_p(ja, JF.freeze(ja))),
        "is_zero": (F.is_zero(ta), JF.is_zero(ja)),
        "bytes": (F.limbs_to_bytes32(fz),
                  JF.limbs_to_bytes32(JF.freeze(ja))),
    }
    for name, (got, want) in pairs.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    # and against Python integers
    for row, out in zip(a, fz.numpy()):
        assert _value(out) == _value(row) % P
    assert F.is_zero(ta).tolist()[4:8] == [True, False, True, False]
    prod = F.mul(ta, tb).numpy()
    for i in range(len(a)):
        assert _value(prod[i]) % P == _value(a[i]) * _value(b[i]) % P


@pytest.mark.parametrize("e", [2, 65537, (P - 5) // 8],
                         ids=["2", "65537", "(p-5)/8"])
def test_pow_plain_vs_pallas_interpret_and_python(e):
    x = _weak_inputs(2, n=16)
    got = F.pow_plain(torch.from_numpy(x), e).numpy()
    want = np.asarray(pk.pow_p_pallas(jnp.asarray(x), e, interpret=True,
                                      b_tile=128))
    np.testing.assert_array_equal(got, want)
    # the wrapper's CPU path: the plain power, frozen
    frozen = F.pow_p(torch.from_numpy(x), e).numpy()
    for row, out in zip(x, frozen):
        assert all(0 <= v < 8192 for v in out)
        assert _value(out) == pow(_value(row) % P, e, P)


def test_pow_wrapper_rejects_bad_inputs():
    x = torch.zeros((3, 20), dtype=torch.int32)
    with pytest.raises(ValueError):
        F.pow_p(x.long(), 5)
    with pytest.raises(ValueError):
        F.pow_p(x[:, :19], 5)
    with pytest.raises(ValueError):
        F.pow_p(x, 0)
    assert F.pow_int32_ops((P - 5) // 8) == 14_905     # the kernel's chain
    assert F.inv(torch.tensor([_limbs(3)], dtype=torch.int32)).tolist() == \
        [_limbs(pow(3, P - 2, P))]


def _ref10_chain(tail):
    """ref10's pow22523 (tail "p58") or invert (tail "inv") replayed on
    exponents: (exponent, squarings, multiplies)."""
    n = {"sqr": 0, "mul": 0}

    def pow2k(x, k):
        n["sqr"] += k
        return x << k

    def mul(a, b):
        n["mul"] += 1
        return a + b

    z2 = pow2k(1, 1)
    z9 = mul(1, pow2k(z2, 2))
    z11 = mul(z2, z9)
    x5 = mul(z9, pow2k(z11, 1))                   # 2^5 - 1
    x10 = mul(pow2k(x5, 5), x5)
    x20 = mul(pow2k(x10, 10), x10)
    x50 = mul(pow2k(mul(pow2k(x20, 20), x20), 10), x10)
    x100 = mul(pow2k(x50, 50), x50)
    x250 = mul(pow2k(mul(pow2k(x100, 100), x100), 50), x50)
    e = mul(pow2k(x250, 2), 1) if tail == "p58" else mul(pow2k(x250, 5), z11)
    return e, n["sqr"], n["mul"]


@pytest.mark.parametrize("tail,e", [("p58", (P - 5) // 8), ("inv", P - 2)])
def test_pow_least_counts_follow_their_chains(tail, e):
    """The pow kernel's bound counts the shortest known chain of its
    exponent, not the TPU kernel's square-and-multiply loop; the CUDA
    kernel runs that chain, so its own count is the bound's."""
    assert _ref10_chain(tail) == (e,) + F.POW_CHAINS[e]
    least = F.pow_least_int32_ops(e)
    assert least == 55 * F.POW_CHAINS[e][0] + 100 * F.POW_CHAINS[e][1]
    assert least == F.pow_int32_ops(e)
    bits = F.exponent_bits(e)
    assert least < 55 * len(bits) + 100 * sum(bits)
    assert F.pow_least_int32_ops((P - 5) // 8) == 14_905


def test_columns_limbs_first_equals_limbs_last():
    """`columns` gives the same integers in both layouts (crypto/ed25519_verify.py
    uses limbs first), and they are the schoolbook's."""
    rng = np.random.RandomState(11)
    a = torch.from_numpy(rng.randint(-8800, 8801, (6, 20)).astype(np.int32))
    b = torch.from_numpy(rng.randint(-8800, 8801, (6, 20)).astype(np.int32))
    last = F.columns(a, b)
    assert last.shape == (6, 39)
    assert torch.equal(F.columns(a.t(), b.t(), dim=0), last.t())
    an, bn = a.long().numpy(), b.long().numpy()
    want = np.stack([np.convolve(x, y) for x, y in zip(an, bn)])
    np.testing.assert_array_equal(last.numpy(), want)
    with pytest.raises(ValueError):
        F.columns(a, b, dim=1)


def test_bits_msb_first_vs_scalar_jax():
    rng = np.random.RandomState(3)
    s = rng.randint(0, 8192, (5, 20)).astype(np.int32)
    got = S.bits_msb_first(torch.from_numpy(s))
    want = np.asarray(JS.bits_msb_first(jnp.asarray(s)))
    assert got.dtype == torch.bool and got.shape == (260, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_parse_ptxas_reads_each_kernel():
    """Registers, stack frame and spills of each kernel function in a
    `ptxas -v` report (the lines chip_smoke.py puts in its kernel rows)."""
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3k_aILi5EEvPi' for 'sm_90a'
ptxas info    : Function properties for _Z3k_aILi5EEvPi
    2176 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, 1728 bytes smem, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3k_bPi' for 'sm_90a'
ptxas info    : Function properties for _Z3k_bPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 372 bytes cmem[0]
"""
    assert cuda_build.parse_ptxas(report) == {
        "_Z3k_aILi5EEvPi": {"registers": 168, "stack_bytes": 2176,
                            "spill_bytes": 20},
        "_Z3k_bPi": {"registers": 40, "stack_bytes": 0, "spill_bytes": 0}}


def test_build_key_covers_shared_headers(tmp_path):
    """An edited header must rebuild every kernel that includes it: the
    build key hashes the source and all csrc/*.cuh."""
    for f in cuda_build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    src = tmp_path / "ed25519_pow.cu"
    key = cuda_build.build_key(src)
    assert key == cuda_build.build_key(src)
    hdr = tmp_path / "fe25519.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    assert cuda_build.build_key(src) != key
    (tmp_path / "extra.cuh").write_text("// new header\n")
    keys = {cuda_build.build_key(src)}
    src.write_bytes(src.read_bytes() + b"\n")
    keys.add(cuda_build.build_key(src))
    assert len(keys) == 2 and key not in keys
