"""Host check of the pow and Straus kernels' lane math
(`csrc/ed25519_pow.cu`, `csrc/ed25519_straus.cu` over
`csrc/fe25519_r32.cuh`) with g++.

Both kernels compute in radix 2^32 over carry-chain primitives that are
PTX on the card and an exact emulation of the carry flag elsewhere, so a
host compiler runs the very chains the card runs.  A small C harness
includes both kernel sources, is compiled once with g++ into a scratch
directory (test-only: the package never loads it) and is driven with
ctypes:

  - the weak signed load from 13-bit limbs and the frozen store against
    Python integers on the edge values (limbs of +-(2^20 - 1), p - 1, p,
    2^255 - 1, 2^260 - 1) and random weak limbs;
  - the pow lane on every schedule (`fe_invert` for p - 2, `fe_pow22523`
    for (p-5)/8, fixed 4-bit windows for other exponents) against
    Python's `pow` and against `field.freeze(field.pow_plain(...))` on 64
    seeded lanes;
  - the Straus lane against `straus_plain` by group equality and
    X Y = Z T, and against the RFC 8032 oracle's encoding of
    [s]B - [k]A, on the edge scalars (s = 0, 1, L - 1, 2^260 - 1 against
    k = 0, 1, 2^260 - 1), a torsioned A (a B plus the order-4 point), A
    = the identity with k != 0, A at a random projective scale and 32
    seeded lanes.  The harness runs each lane as a warp of its own (the
    walk skipped where k = 0, zero comb digits skipped) and as a lane of
    a warp whose other lanes need every step (the walk and the identity
    adds always run), and a lane past the batch (no loads, [0]B - [0]O).

The tests skip only where g++ is absent; the build and the whole file
take well under a minute.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from agnes_tpu_torch.crypto import ed25519_point as E
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import field as F
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = 2**255 - 19
L = ref.L
CSRC = Path(F.__file__).resolve().parents[1] / "csrc"
P58 = (P - 5) // 8

HARNESS = r"""
#include "ed25519_pow.cu"
#include "ed25519_straus.cu"

using namespace ag::r32;

struct Solo {            // a warp of one lane
  static bool all(bool p) { return p; }
  static bool any(bool p) { return p; }
};
struct Busy {            // other lanes of the warp need every step
  static bool all(bool) { return false; }
  static bool any(bool) { return true; }
};

extern "C" void ag_t_load_store(const int32_t* a, uint32_t* words,
                                int32_t* limbs, int n) {
  for (int i = 0; i < n; ++i) {
    fe h;
    fe_load13_weak(h, a + 20 * i);
    for (int k = 0; k < 8; ++k) words[8 * i + k] = h.v[k];
    fe_store13(h, limbs + 20 * i);
  }
}

extern "C" void ag_t_pow(int chain, const int32_t* x, int32_t* out,
                         const int32_t* digits, int n_digits, int n) {
  for (int i = 0; i < n; ++i) {
    if (chain == ag::kChainP58)
      ag::pow_lane<ag::kChainP58>(x + 20 * i, out + 20 * i, digits, n_digits);
    else if (chain == ag::kChainInvert)
      ag::pow_lane<ag::kChainInvert>(x + 20 * i, out + 20 * i, digits,
                                     n_digits);
    else
      ag::pow_lane<ag::kChainWindow>(x + 20 * i, out + 20 * i, digits,
                                     n_digits);
  }
}

extern "C" void ag_t_straus(int busy, int active, const int32_t* s,
                            const int32_t* k, const int32_t* ax,
                            const int32_t* ay, const int32_t* az,
                            const int32_t* at, const int32_t* consts,
                            int32_t* out, int64_t B) {
  const uint32_t* c = (const uint32_t*)consts;
  for (int64_t l = 0; l < B; ++l) {
    ext q;
    const int64_t o = 20 * l;
    if (busy)
      ag::straus_lane<Busy>(s + o, k + o, ax + o, ay + o, az + o, at + o, c,
                            active != 0, q);
    else
      ag::straus_lane<Solo>(s + o, k + o, ax + o, ay + o, az + o, at + o, c,
                            active != 0, q);
    fe_store13(q.X, out + o);
    fe_store13(q.Y, out + 20 * (B + l));
    fe_store13(q.Z, out + 20 * (2 * B + l));
    fe_store13(q.T, out + 20 * (3 * B + l));
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' host path")
    d = tmp_path_factory.mktemp("pow_straus_host")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(so),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=120)
    h = ctypes.CDLL(str(so))
    h.ag_t_load_store.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    h.ag_t_pow.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 2)
    h.ag_t_straus.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                              + [ctypes.c_int64])
    return h


def _limbs(v):
    return [(v >> (13 * i)) & 0x1FFF for i in range(20)]


def _value(row):
    return sum(int(x) << (13 * i) for i, x in enumerate(row))


def _weak_rows(seed, n):
    """[n, 20] int32 weak signed limbs: the edges, then random limbs."""
    rng = np.random.RandomState(seed)
    big = (1 << 20) - 1
    rows = [_limbs(v) for v in (0, 1, P - 1, P, P + 1, 2**255 - 1,
                                2**260 - 1)]
    rows += [[big] * 20, [-big] * 20, [big, -big] * 10, [-big, big] * 10,
             [0] * 19 + [-big], [-big] + [0] * 19]
    rows = np.array(rows, np.int32)
    rand = rng.randint(-big, big + 1, (n - len(rows), 20)).astype(np.int32)
    rand[: (n - len(rows)) // 2] //= 119     # the MSM path's |limb| < 8800
    return np.concatenate([rows, rand])


def test_weak_load_and_frozen_store_vs_python_ints(lib):
    a = _weak_rows(1, 64)
    words = np.zeros((len(a), 8), np.uint32)
    limbs = np.zeros((len(a), 20), np.int32)
    lib.ag_t_load_store(a.ctypes.data, words.ctypes.data, limbs.ctypes.data,
                        len(a))
    for row, w, out in zip(a, words, limbs):
        want = _value(row) % P
        got = sum(int(x) << (32 * i) for i, x in enumerate(w))
        assert got < 2**256 and got % P == want      # weak: any representative
        assert out.tolist() == _limbs(want)           # frozen, strict limbs


def _pow(lib, x, e):
    chain, digits = F.pow_schedule(e)
    dig = np.array(digits or (0,), np.int32)
    out = np.zeros_like(x)
    lib.ag_t_pow(chain, x.ctypes.data, out.ctypes.data, dig.ctypes.data,
                 len(digits), len(x))
    return out


@pytest.mark.parametrize("e", [P - 2, P58, 1, 3, 16, 65537, P - 1,
                               2**200 + 12345],
                         ids=["inv", "p58", "1", "3", "16", "65537", "p-1",
                              "2^200+12345"])
def test_pow_lane_vs_python_pow(lib, e):
    x = _weak_rows(2, 64)
    out = _pow(lib, x, e)
    for row, o in zip(x, out):
        assert o.tolist() == _limbs(pow(_value(row) % P, e, P))


@pytest.mark.parametrize("e", [P - 2, P58, 65537], ids=["inv", "p58", "65537"])
def test_pow_lane_vs_plain(lib, e):
    rng = np.random.RandomState(3)
    x = rng.randint(-8800, 8801, (64, 20)).astype(np.int32)
    want = F.freeze(F.pow_plain(torch.from_numpy(x), e)).numpy()
    np.testing.assert_array_equal(_pow(lib, x, e), want)


def test_pow_schedule_and_counts():
    """The kernel follows the shortest known chain of each exponent the
    port raises to, so its own count is the bound's."""
    for e in F.POW_CHAINS:
        assert F.pow_schedule(e)[0] != 0
        assert F.pow_int32_ops(e) == F.pow_least_int32_ops(e)
    assert F.pow_schedule(65537) == (0, (1, 0, 0, 0, 1))
    assert F.pow_int32_ops(65537) == 55 * (7 + 16) + 100 * (7 + 1)


def _ref_rows(pts):
    """ref points -> four [B, 20] int32 coordinate rows (canonical)."""
    return [np.array([_limbs(p[c] % P) for p in pts], np.int32)
            for c in range(4)]


def _neg(p):
    return (-p[0] % P, p[1], p[2], -p[3] % P)


def _cases():
    """(s values, k values, A as ref points, A's rows (weak limbs))."""
    rng = np.random.RandomState(4)
    a1 = ref._mul(int(rng.randint(1, 2**31)) * 1000003 + 7, ref.BASE)
    tors = ref._add(ref._mul(12345, ref.BASE), ref._decompress(bytes(32)))
    sv, kv, av = [], [], []
    for s in (0, 1, L - 1, 2**260 - 1):
        for k in (0, 1, 2**260 - 1):
            sv.append(s)
            kv.append(k)
            av.append(a1)
    for s, k in ((5, 0), (0, 7), (L - 1, 2**260 - 1), (2**259, L + 3)):
        sv.append(s)
        kv.append(k)
        av.append(tors)
    sv += [L - 2, 9]
    kv += [2**260 - 1, 3]
    av += [ref.IDENTITY, ref.IDENTITY]
    for i in range(32):
        sv.append(int.from_bytes(rng.bytes(32), "little") % L)
        kv.append(0 if i % 4 == 0 else
                  int.from_bytes(rng.bytes(33), "little") % 2**260)
        av.append(ref._mul(int.from_bytes(rng.bytes(32), "little") % L,
                           ref.BASE))
    rows = _ref_rows(av)
    # A at a random projective scale, its limbs weak and signed as the
    # field multiply leaves them
    lam = torch.from_numpy(rng.randint(-8800, 8801, (len(av), 20))
                           .astype(np.int32))
    lam[:len(av) // 2] = torch.tensor(_limbs(1))
    rows = [F.mul(torch.from_numpy(r), lam).numpy() for r in rows]
    return sv, kv, av, rows


def _ints(rows):
    return [_value(r) % P for r in rows]


def _straus(lib, s, k, rows, busy, active=True):
    B = len(s)
    out = np.zeros((4, B, 20), np.int32)
    consts = np.array(E.straus_consts(), np.int32)
    lib.ag_t_straus(int(busy), int(active), s.ctypes.data, k.ctypes.data,
                    *(np.ascontiguousarray(r).ctypes.data for r in rows),
                    consts.ctypes.data, out.ctypes.data, B)
    return out


def test_straus_lane_vs_plain_and_oracle(lib):
    sv, kv, av, rows = _cases()
    s = np.array([_limbs(v) for v in sv], np.int32)
    k = np.array([_limbs(v) for v in kv], np.int32)
    plain = E.straus_plain(torch.from_numpy(s), torch.from_numpy(k),
                           E.Point(*(torch.from_numpy(r) for r in rows)))
    pq = list(zip(*(_ints(c.numpy()) for c in plain)))
    for busy in (False, True):
        out = _straus(lib, s, k, rows, busy)
        assert ((out >= 0) & (out < 8192)).all()
        got = list(zip(*(_ints(c) for c in out)))
        for i, (g, w) in enumerate(zip(got, pq)):
            x, y, z, t = g
            assert z % P and (x * y - z * t) % P == 0, (busy, i)
            assert ref.point_equal(g, w), (busy, i)
            want = ref._add(ref._mul(sv[i], ref.BASE),
                            _neg(ref._mul(kv[i], av[i])))
            assert ref._compress(g) == ref._compress(want), (busy, i)


def test_straus_lane_past_the_batch_reads_nothing(lib):
    """A lane past B computes [0]B - [0]O (the identity) from no input."""
    nan = np.full((3, 20), 0x7FFF0000, np.int32)   # never a valid limb
    for busy in (False, True):
        out = _straus(lib, nan, nan, [nan] * 4, busy, active=False)
        for c in range(3):
            got = tuple(_ints(out[j])[c] for j in range(4))
            assert ref.point_equal(got, ref.IDENTITY)
            assert got[0] == 0 and got[3] == 0
