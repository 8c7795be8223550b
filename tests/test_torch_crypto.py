"""Port differential: the Ed25519 verify path of `agnes_tpu_torch.crypto`
against the JAX package (each JAX function called eagerly at B <= 16)
and the RFC 8032 oracle.

SHA-512 vs `sha512_jax` and hashlib; `barrett_reduce` / `is_canonical`
vs `scalar_jax`; `_digits52_signed` vs `pallas_verify`; the plain
kernel's field helpers vs `pallas_verify`'s jnp helpers, limb for limb;
the plain verify vs `ed25519_ref.verify` on the adversarial grid and the
torsioned case.  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, skipped elsewhere); `chip_smoke.py` holds it
against the plain version at the main path's shape.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agnes_tpu.crypto import ed25519_ref as jref
from agnes_tpu.crypto import pallas_verify as pv
from agnes_tpu.crypto import scalar_jax as jscalar
from agnes_tpu.crypto import sha512_jax as jsha
from agnes_tpu_torch.crypto import ed25519
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import scalar, sha512
from agnes_tpu_torch.crypto import ed25519_verify as V
from agnes_tpu_torch.harness.fixtures import adversarial_grid, torsioned_sig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = 2**255 - 19


def _blocks(msgs):
    """Equal-length messages -> padded SHA-512 words [B, n, 32] uint32."""
    return np.asarray(jsha.pack_padded_host(msgs))


def test_sha512_vs_jax_and_hashlib():
    rng = np.random.RandomState(0)
    for n in (0, 45, 109, 200):           # 1, 1, 1 and 2 blocks
        msgs = [rng.bytes(n) for _ in range(6)]
        blocks = _blocks(msgs)
        got = sha512.sha512_blocks(torch.from_numpy(blocks.view(np.int32).copy()))
        want = np.asarray(jsha.sha512_blocks(jnp.asarray(blocks)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        for i, m in enumerate(msgs):
            assert jsha.digest_to_le_bytes_host(got[i].numpy()) == \
                hashlib.sha512(m).digest()


def test_barrett_and_canonical_vs_scalar_jax():
    rng = np.random.RandomState(1)
    L = jscalar.L
    hashes = [int.from_bytes(rng.bytes(64), "little") for _ in range(10)]
    hashes += [0, L - 1, L, 2**512 - 1, 3 * L + 5, L * (2**259 // L)]
    k = np.array([[(h >> (13 * i)) & 0x1FFF for i in range(40)]
                  for h in hashes], np.int32)
    got = scalar.barrett_reduce(torch.from_numpy(k)).numpy()
    want = np.asarray(jscalar.barrett_reduce(jnp.asarray(k)))
    np.testing.assert_array_equal(got, want)
    for row, h in zip(got, hashes):
        assert sum(int(v) << (13 * i) for i, v in enumerate(row)) == h % L

    vals = [0, 1, L - 1, L, L + 1, 2**256 - 1, 2**255]
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(8)]
    b = np.array([list(v.to_bytes(32, "little")) for v in vals], np.int32)
    s_t = scalar.scalar_from_bytes32(torch.from_numpy(b))
    s_j = jscalar.scalar_from_bytes32(jnp.asarray(b))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(scalar.is_canonical(s_t).numpy(),
                                  np.asarray(jscalar.is_canonical(s_j)))
    assert scalar.is_canonical(s_t).tolist() == [v < L for v in vals]


def test_digits52_signed_vs_pallas_verify():
    rng = np.random.RandomState(5)
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(10)]
    vals += [0, 1, jref.L - 1, 1 << 255, (1 << 256) - 1]
    limbs = np.array([[(v >> (13 * i)) & 0x1FFF for i in range(20)]
                      for v in vals], np.int32)
    got = V._digits52_signed(torch.from_numpy(limbs)).numpy()
    want = np.asarray(pv._digits52_signed(jnp.asarray(limbs)))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -16 and got.max() <= 15


def _fe_batch(rng, B=8):
    """[20, B] weak signed limbs as the kernel carries them (|limb| <=
    8800), both as torch and jnp."""
    a = rng.randint(-8800, 8801, (20, B)).astype(np.int32)
    return torch.from_numpy(a), jnp.asarray(a)


def test_plain_field_helpers_vs_pallas_limb_for_limb():
    rng = np.random.RandomState(2)
    at, aj = _fe_batch(rng)
    bt, bj = _fe_batch(rng)
    pairs = [
        (V._fmul(at, bt), pv._fmul(aj, bj)),
        (V._fsqr(at), pv._fsqr(aj)),
        (V._fmul_const(at, V._D2), pv._fmul_const(aj, pv._D2)),
        (V._freeze(at), pv._freeze(aj)),
        (V._fsub(at, bt), pv._fsub(aj, bj)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fz = V._freeze(at).numpy()
    for j in range(fz.shape[1]):
        val = sum(int(at[i, j]) << (13 * i) for i in range(20)) % P
        assert sum(int(fz[i, j]) << (13 * i) for i in range(20)) == val


def test_plain_decompress_vs_pallas():
    pubs, _, sigs = adversarial_grid()
    encs = [p for p in pubs[:12]] + [s[:32] for s in sigs[:4]]
    b = torch.tensor([list(e) for e in encs], dtype=torch.int32)
    y, sign = V._ysign(b)
    yt, st = y.t().contiguous(), sign.contiguous()
    xt, okt = V._decompress(yt, st)
    xj, okj = pv._decompress(jnp.asarray(yt.numpy()), jnp.asarray(st.numpy()))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert okt.numpy().tolist() == [ref._decompress(e) is not None
                                    for e in encs]


def test_btable_and_kernel_consts():
    """The B table in both limb layouts: the plain version's 13-bit rows
    equal pallas_verify._btable(17), and the CUDA kernel's radix-2^32
    constant block decodes to the same integers."""
    np.testing.assert_array_equal(V._btable13("cpu").numpy(),
                                  np.array(pv._btable(17), np.int32))
    c = V.kernel_consts()
    assert len(c) == 24 + 17 * 24

    def dec(limbs):
        return sum((int(x) & 0xFFFFFFFF) << (32 * i)
                   for i, x in enumerate(limbs))

    ints = [ref.D, 2 * ref.D % P, ref.SQRT_M1]
    ints += [x for ent in V._btable_ints() for x in ent]
    assert [dec(c[8 * i:8 * i + 8]) for i in range(len(ints))] == ints


def _grid_inputs():
    pubs, msgs, sigs = adversarial_grid()
    sk, pk = ref.keypair(bytes([1]) * 32)
    msg = b"\x05" * 45
    honest = ref.sign(sk, msg)
    tors = torsioned_sig(bytes([7]) * 32, msg)
    pubs += [pk, tors[0], pk]
    msgs += [msg, msg, msg]
    sigs += [honest, tors[2], bytes([honest[0] ^ 1]) + honest[1:]]
    return pubs, msgs, sigs


def test_plain_verify_vs_oracle_on_grid_and_torsion():
    pubs, msgs, sigs = _grid_inputs()
    want = [jref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert want[:4] == [True] * 4 and want[17] and not any(want[4:17])
    assert want[-3:] == [True, True, False]
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs, msgs, sigs,
                                                  device="cpu")
    got = ed25519.verify_batch(pub, sig, blocks)
    assert got.dtype == torch.bool
    assert got.tolist() == want
    # the port's oracle copy agrees with the JAX package's
    assert [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)] == want


def test_wrapper_rejects_bad_inputs():
    z = torch.zeros((20, 4), dtype=torch.int32)
    s = torch.zeros(4, dtype=torch.int32)
    d = torch.zeros((52, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        V.verify_signed5(z.long(), s, z, s, d, d)
    with pytest.raises(ValueError):
        V.verify_signed5(z, s, z, s, d[:51], d)
    with pytest.raises(ValueError):
        V.verify_signed5(z, s, z.t().contiguous().t(), s, d, d)
