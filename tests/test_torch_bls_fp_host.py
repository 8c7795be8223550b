"""Host check of the BLS12-381 field kernels' lane math
(`csrc/bls_fp.cu`) with g++.

The kernels spread one field element over a group of G lanes whose
cooperative steps are written once (`agbls::Team`, `AG_EACH_LANE`): one
thread's own lane between two `__syncwarp`s on the card, every lane of
the group in turn, phase by phase, under a host compiler.  A small C
harness includes the kernel source, is compiled with g++ into a scratch
directory (test-only: the package never loads it) and is driven with
ctypes: for every group size the kernels launch with, `mul_elem` and
`reduce_elem` (at 1 and 2 carry passes) against `bls_field.mul_plain` /
`reduce_plain`, limb for limb, on the boundary values 0, 1, p - 1, p,
4p - 1 and a few hundred random rows.  Beside it, the reduce's contract
on the plain path: the quotient limbs 3 and up, which its q * p skips,
are exactly zero on the same rows.  The g++ tests skip only where g++
is absent.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from agnes_tpu_torch.crypto import bls_field as F
from agnes_tpu_torch.crypto.bls_ref import P
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(F.__file__).resolve().parents[1] / "csrc"
EDGES = [0, 1, P - 1, P, 4 * P - 1]
N_RANDOM = 300

HARNESS = r"""
#include "bls_fp.cu"

using namespace agbls;

template <int G>
static void mul_rows(const int32_t* xa, const int32_t* ya, int32_t* out,
                     int64_t R) {
  for (int64_t row = 0; row < R; ++row) {
    MulSmem<G> S = {};
    for (int l = 0; l < kN; ++l) {
      S.a[MulSmem<G>::kAPad + l] = xa[row * kN + l];
      S.b[l] = ya[row * kN + l];
    }
    mul_elem<G>(Team<G>{0}, S);
    for (int l = 0; l < kN; ++l) out[row * kN + l] = S.a[kLow + l];
  }
}

template <int G>
static void reduce_rows(const int32_t* cols, int32_t* out, int64_t R,
                        int passes) {
  for (int64_t row = 0; row < R; ++row) {
    RedSmem<G> S = {};
    reduce_elem<G>(Team<G>{0}, S, passes, cols + row * kN);
    for (int l = 0; l < kN; ++l) out[row * kN + l] = S.out[l];
  }
}

#define AG_T_GROUPS(F, ...) \
  switch (g) { case 2: F<2>(__VA_ARGS__); return 0; \
               case 4: F<4>(__VA_ARGS__); return 0; \
               case 8: F<8>(__VA_ARGS__); return 0; \
               case 16: F<16>(__VA_ARGS__); return 0; \
               case 32: F<32>(__VA_ARGS__); return 0; \
               default: return 1; }

extern "C" int ag_t_mul(int g, const int32_t* xa, const int32_t* ya,
                        int32_t* out, int64_t R) {
  AG_T_GROUPS(mul_rows, xa, ya, out, R)
}

extern "C" int ag_t_reduce(int g, const int32_t* cols, int32_t* out,
                           int64_t R, int passes) {
  AG_T_GROUPS(reduce_rows, cols, out, R, passes)
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' host path")
    d = tmp_path_factory.mktemp("bls_fp_host")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(so),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=120)
    h = ctypes.CDLL(str(so))
    h.ag_t_mul.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64]
    h.ag_t_reduce.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_int]
    return h


def _below(rng, bound):
    return int.from_bytes(rng.bytes(56), "little") % bound


def _operands(rng):
    """[5 + N_RANDOM, 33]: the edges, then loose rows a + b (a, b < 2p),
    the operand envelope of fv_mul_pairs."""
    rows = [F.to_limbs(v) for v in EDGES] + [
        F.to_limbs(_below(rng, 2 * P)) + F.to_limbs(_below(rng, 2 * P))
        for _ in range(N_RANDOM)]
    return np.ascontiguousarray(np.stack(rows).astype(np.int32))


def _columns(rng, k):
    """The edges, then k-fold sums of strict encodings of values < 4p/k
    (fv_reduce's sums for k = 3 at one pass, fv_mul_small's multiples of
    12 at two)."""
    rows = [F.to_limbs(v) for v in EDGES] + [
        sum(F.to_limbs(_below(rng, 4 * P // k)) for _ in range(k))
        for _ in range(N_RANDOM)]
    return np.ascontiguousarray(np.stack(rows).astype(np.int32))


@pytest.mark.parametrize("group", F.GROUP_SIZES)
def test_mul_lanes_match_plain(lib, group):
    rng = np.random.RandomState(40 + group)
    xa = _operands(rng)
    ya = np.ascontiguousarray(_operands(rng)[::-1])
    out = np.full_like(xa, -7)
    assert lib.ag_t_mul(group, xa.ctypes.data, ya.ctypes.data,
                        out.ctypes.data, len(xa)) == 0
    want = F.mul_plain(torch.from_numpy(xa), torch.from_numpy(ya)).numpy()
    np.testing.assert_array_equal(out, want)


def _reduce_inputs(passes):
    """One pass: fv_reduce's sums.  Two: fv_mul_small's multiples of 12,
    then columns up to the kernel's contract, 2^19 - 1, whose quotient
    reaches its second limb."""
    rng = np.random.RandomState(50 + passes)
    if passes == 1:
        return _columns(rng, 3)
    wide = rng.randint(0, 2**19, (N_RANDOM, F.NLIMBS)).astype(np.int32)
    wide[0] = 2**19 - 1
    return np.ascontiguousarray(np.concatenate([_columns(rng, 1) * 12,
                                                wide]))


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("group", F.GROUP_SIZES)
def test_reduce_lanes_match_plain(lib, group, passes):
    cols = _reduce_inputs(passes)
    assert F._passes_needed(int(cols.max())) <= passes
    out = np.full_like(cols, -7)
    assert lib.ag_t_reduce(group, cols.ctypes.data, out.ctypes.data,
                           len(cols), passes) == 0
    want = F.reduce_plain(torch.from_numpy(cols), passes).numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("passes", [1, 2])
def test_reduce_quotient_beyond_three_limbs_is_zero(passes):
    """The rolled path's quotient q = t[64:97] on the reduce's inputs:
    limbs 3..32, which the kernel's q * p skips, are exactly zero."""
    x = torch.from_numpy(_reduce_inputs(passes))
    for _ in range(passes):
        x = F._vpass(x)
    x = torch.nn.functional.pad(x, (0, F._N65 - F.NLIMBS))
    t = F._conv_const(x, F._MU_LIMBS, F._N65 + len(F._MU_LIMBS))
    for _ in range(F._MU_PASSES):
        t = F._vpass(t)
    q = t[:, F.MU_SHIFT_LIMBS:F.MU_SHIFT_LIMBS + F.NLIMBS]
    assert (q >= 0).all() and (q[:, 3:] == 0).all()
    assert (q[:, passes - 1] != 0).any()          # the rows reach limb 1


def test_probe_variants_edit_the_kernel_source(tmp_path):
    """`scripts/bls_fp_probe.py` times the kernels at other CTA sizes by
    editing copies of the source: every edit must still apply."""
    from agnes_tpu_torch.scripts import bls_fp_probe

    parent = tmp_path / "parent_csrc"
    parent.mkdir()
    (parent / "bls_fp.cu").write_text("// an earlier source\n")
    vs = bls_fp_probe.variants(parent, tmp_path / "out")
    assert list(vs) == [f"t{t}" for t in bls_fp_probe.THREADS] + [
        "nochain", "parent"]
    for t in bls_fp_probe.THREADS:
        assert f"constexpr int kThreads = {t};" in vs[f"t{t}"].read_text()
    assert "k < 0; ++k" in vs["nochain"].read_text()
    assert vs["parent"].read_text() == "// an earlier source\n"
