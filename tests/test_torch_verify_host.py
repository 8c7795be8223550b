"""Host check of the verify kernel's lane math (`csrc/fe25519_r32.cuh`,
`csrc/ed25519_verify.cu`) with g++.

The kernel's field code is written once over carry-chain primitives that
are PTX on the card and an exact emulation of the carry flag elsewhere, so
a host compiler runs the same chains.  A small C harness includes the
kernel source, is compiled with g++ into a scratch directory (test-only:
the package never loads it) and is driven with ctypes:

  - the field's mul, sq, add, sub, neg and freeze against Python integers
    on the edge values 0, 1, 19, p-1, p, p+1, 2p-1, 2^255-1 and 2^256-1
    (every pair) and 200 seeded random values;
  - the whole `verify_lane<5>` and `verify_lane<4>` against
    `ed25519_verify.verify_plain`, fed by the same CPU prologue outputs, on the
    adversarial grid, the torsion and flipped-sign lanes and 32 seeded
    random lanes, and the verdicts against the RFC 8032 oracle;

and that the edits `scripts/verify_probe.py` makes to copies of the
kernel source still apply.  The g++ tests skip only where g++ is absent.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from agnes_tpu.crypto import ed25519_ref as jref
from agnes_tpu_torch.crypto import ed25519
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import ed25519_verify as V
from agnes_tpu_torch.harness.fixtures import adversarial_grid, torsioned_sig
from agnes_tpu_torch.scripts import verify_probe
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = 2**255 - 19
CSRC = Path(V.__file__).resolve().parents[1] / "csrc"
EDGES = [0, 1, 19, P - 1, P, P + 1, 2 * P - 1, 2**255 - 1, 2**256 - 1]
OPS = {"mul": 0, "sq": 1, "add": 2, "sub": 3, "neg": 4, "freeze": 5}

HARNESS = r"""
#include "ed25519_verify.cu"

using namespace ag::r32;

extern "C" void ag_t_field(int op, const uint32_t* a, const uint32_t* b,
                           uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    fe x, y, h;
    fe_load(x, a + 8 * i);
    fe_load(y, b + 8 * i);
    switch (op) {
      case 0: fe_mul(h, x, y); break;
      case 1: fe_sq(h, x); break;
      case 2: fe_add(h, x, y); break;
      case 3: fe_sub(h, x, y); break;
      case 4: fe_neg(h, x); break;
      default: fe_freeze(h, x); break;
    }
    for (int k = 0; k < 8; ++k) out[8 * i + k] = h.v[k];
  }
}

extern "C" void ag_t_verify(int w, const int32_t* ya, const int32_t* sa,
                            const int32_t* yr, const int32_t* sr,
                            const int32_t* sdig, const int32_t* kdig,
                            const int32_t* consts, int32_t* out, int64_t B) {
  const uint32_t* c = (const uint32_t*)consts;
  for (int64_t lane = 0; lane < B; ++lane)
    out[lane] = w == 5
        ? ag::verify_lane<5>(ya, sa, yr, sr, sdig, kdig, c, B, lane)
        : ag::verify_lane<4>(ya, sa, yr, sr, sdig, kdig, c, B, lane);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's host path")
    d = tmp_path_factory.mktemp("verify_host")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(so),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=120)
    h = ctypes.CDLL(str(so))
    h.ag_t_field.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int]
    h.ag_t_verify.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int64]
    return h


def _words(vals):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * i) for i, w in enumerate(row))
            for row in words]


def _field(lib, op, a, b):
    aw, bw = _words(a), _words(b)
    out = np.zeros_like(aw)
    lib.ag_t_field(OPS[op], aw.ctypes.data, bw.ctypes.data, out.ctypes.data,
                   len(a))
    return _ints(out)


def test_field_ops_vs_python_ints(lib):
    rng = np.random.RandomState(11)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(200)]
    a = [x for x in EDGES for _ in EDGES] + rand
    b = [y for _ in EDGES for y in EDGES] + rand[::-1]
    want = {"mul": [x * y % P for x, y in zip(a, b)],
            "sq": [x * x % P for x in a],
            "add": [(x + y) % P for x, y in zip(a, b)],
            "sub": [(x - y) % P for x, y in zip(a, b)],
            "neg": [-x % P for x in a]}
    for op, w in want.items():
        got = _field(lib, op, a, b)
        assert [g % P for g in got] == w, op      # weak: any representative
    assert _field(lib, "freeze", a, b) == [x % P for x in a]


def _lanes():
    pubs, msgs, sigs = adversarial_grid()
    sk, pk = ref.keypair(bytes([1]) * 32)
    msg = b"\x05" * 45
    honest = ref.sign(sk, msg)
    tors = torsioned_sig(bytes([7]) * 32, msg)
    pubs += [pk, tors[0], pk]
    msgs += [msg, msg, msg]
    sigs += [honest, tors[2], bytes([honest[0] ^ 1]) + honest[1:]]
    rng = np.random.RandomState(12)
    for k in range(32):
        sk, pk = ref.keypair(rng.bytes(32))
        s = bytearray(ref.sign(sk, msg))
        if k % 3 == 1:
            s[rng.randint(32)] ^= 1 << rng.randint(8)
        elif k % 3 == 2:
            s[32 + rng.randint(31)] ^= 1 << rng.randint(8)
        pubs.append(pk)
        msgs.append(msg)
        sigs.append(bytes(s))
    return pubs, msgs, sigs


@pytest.mark.parametrize("window", [5, 4])
def test_verify_lane_vs_plain_and_oracle(lib, window):
    pubs, msgs, sigs = _lanes()
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs, msgs, sigs,
                                                  device="cpu")
    args, ok_s = V.prologue(pub, sig, blocks, window)
    consts = np.array(V.kernel_consts(), np.int32)
    out = np.zeros(len(pubs), np.int32)
    lib.ag_t_verify(window, *(a.data_ptr() for a in args), consts.ctypes.data,
                    out.ctypes.data, len(pubs))
    np.testing.assert_array_equal(
        out, V.verify_plain(*args, window=window).numpy())
    want = [jref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert ((torch.from_numpy(out) > 0) & ok_s).tolist() == want
    assert 0 < sum(want) < len(want)


def test_probe_variants_edit_the_kernel_source(tmp_path):
    """`scripts/verify_probe.py` times the kernel at other launch shapes by
    editing copies of its source: every edit must still apply."""
    vs = verify_probe.variants(None, tmp_path)
    assert len(vs) == len(verify_probe.CONFIGS) + 1
    for (t, m), d in zip(verify_probe.CONFIGS, vs.values()):
        src = (d / "ed25519_verify.cu").read_text()
        assert f"constexpr int kThreads = {t};" in src
        assert (f"__launch_bounds__(kThreads, {m})" in src) == bool(m)
        assert (d / "fe25519_r32.cuh").exists()
    assert "ag_dyn" in (vs["t64_smem_table"] / "ed25519_verify.cu").read_text()
    with pytest.raises(ValueError):
        verify_probe._edit("int x;", [("kThreads", "")])
