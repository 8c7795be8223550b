"""Port differential: the MSM batch-verify slice of `agnes_tpu_torch`
against the JAX package and the RFC 8032 oracle, on the CPU.

- points: `decompress` vs `ed25519_jax.decompress` (ok flags and every
  coordinate, limb for limb), the plain Straus kernel vs
  `ed25519_jax.straus_sub` (frozen coordinates) and vs `ed25519_ref`
  (`compress` bytes of [s]B - [k]A);
- MSM: `mul_mod_L`, `sum_mod_L`, `window_digits`, `make_z` vs `msm_jax`
  limb for limb; `msm` and `bucket_sums` vs `ed25519_ref` point sums,
  projectively (the log-depth summation order differs from the twin's);
  `verify_batch_msm` on honest, forged and S >= L batches;
  `verify_batch_adaptive` verdict for verdict vs `ed25519_ref.verify`;
- the window-4 plain verify vs the oracle on the adversarial grid (the
  window-5 verify is held to the same oracle on a superset of that grid
  in tests/test_torch_crypto.py), and `_digits65` vs `pallas_verify`;
- the slice: VoteBatcher(verify_mode="msm") -> build_phases_device ->
  DeviceDriver.step_seq, leaf for leaf against the JAX VoteBatcher fed
  the votes `ed25519_ref` accepts, then JAX `consensus_step_seq`.

Every comparison is exact.  The `slow` cases compile the JAX MSM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agnes_tpu.bridge.ingest import VoteBatcher as JBatcher
from agnes_tpu.crypto import ed25519_jax as JE
from agnes_tpu.crypto import ed25519_ref as jref
from agnes_tpu.crypto import msm_jax as JM
from agnes_tpu.crypto import pallas_verify as pv
from agnes_tpu.device import step as js
from agnes_tpu.harness.device_driver import DeviceDriver as JDriver
from agnes_tpu_torch import convert
from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
from agnes_tpu_torch.crypto import ed25519
from agnes_tpu_torch.crypto import ed25519_point as E
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import msm as M
from agnes_tpu_torch.crypto import ed25519_verify as V
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P, L = ref.P, ref.L


def _limbs(v, n=20):
    return [(v >> (13 * i)) & 0x1FFF for i in range(n)]


def _ints(pt: E.Point):
    """Port point with [B, 20] coordinates -> list of ref points."""
    cols = [c.numpy() for c in pt]
    return [tuple(sum(int(v) << (13 * k) for k, v in enumerate(c[i])) % P
                  for c in cols) for i in range(cols[0].shape[0])]


def _ref_point(pts):
    """List of ref points -> port Point of [B, 20] limbs."""
    return E.Point(*(torch.tensor([_limbs(p[c] % P) for p in pts],
                                  dtype=torch.int32) for c in range(4)))


def _encodings():
    """Grid keys and R values, a non-canonical y (p + 1, sign 1), the
    x = 0 / sign = 1 encoding and random bytes."""
    pubs, _, sigs = fx.adversarial_grid()
    encs = pubs[:12] + [s[:32] for s in sigs[:4]] + [pubs[16]]
    noncanon = bytearray((P + 1).to_bytes(32, "little"))
    noncanon[31] |= 0x80
    encs.append(bytes(noncanon))
    return encs


def test_decompress_vs_jax():
    encs = _encodings()
    b = np.array([list(e) for e in encs], np.int32)
    pt, ok = E.decompress(torch.from_numpy(b))
    jpt, jok = JE.decompress(jnp.asarray(b))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    for name, t, j in zip("xyzt", pt, jpt):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert ok.tolist() == [ref._decompress(e) is not None for e in encs]
    assert not ok[-1] and not ok[-2]


def test_straus_plain_vs_jax_and_oracle():
    rng = np.random.RandomState(11)
    encs = [e for e in _encodings() if ref._decompress(e) is not None][:4]
    pt, _ = E.decompress(torch.tensor([list(e) for e in encs],
                                      dtype=torch.int32))
    sv = [int.from_bytes(rng.bytes(32), "little") % L for _ in encs]
    kv = [int.from_bytes(rng.bytes(32), "little") % L for _ in encs]
    sv[0], kv[1] = 0, 0
    s = np.array([_limbs(v) for v in sv], np.int32)
    k = np.array([_limbs(v) for v in kv], np.int32)
    q = E.straus_sub(torch.from_numpy(s), torch.from_numpy(k), pt)
    jq = JE.straus_sub(jnp.asarray(s), jnp.asarray(k),
                       JE.Point(*(jnp.asarray(c.numpy()) for c in pt)))
    # frozen coordinates: canonical limbs of the twin's values mod p
    assert _ints(q) == _ints(E.Point(*(torch.from_numpy(np.array(c))
                                       for c in jq)))
    assert all(((c >= 0) & (c < 8192)).all() for c in q)
    enc = E.compress(q).numpy()
    for i, e in enumerate(encs):
        a = ref._decompress(e)
        want = ref._add(ref._mul(sv[i], ref.BASE),
                        ref._mul((L - kv[i]) % L, a))
        assert bytes(enc[i].astype(np.uint8)) == ref._compress(want)


def _signed_digits(v, width, n):
    """v's signed radix-2^width digits in [-2^(width-1), 2^(width-1)),
    least significant first, by the carry recoding (Python ints)."""
    out, half = [], 1 << (width - 1)
    for _ in range(n):
        d = v & ((1 << width) - 1)
        v >>= width
        if d >= half:
            d -= 1 << width
            v += 1
        out.append(d)
    assert v == 0
    return out


def _joint_count(s, k):
    """The joint double-and-add's int32 operations, by hand."""
    n = max(s.bit_length(), k.bit_length())
    dbl = max(n - 1, 0)
    pairs = [(s >> i & 1, k >> i & 1) for i in range(n)]
    adds = max(sum(1 for p in pairs if p != (0, 0)) - 1, 0)
    muls = (3 * dbl + 8 * adds + (n > 1) + any(p == (0, 1) for p in pairs)
            + 9 * any(p == (1, 1) for p in pairs))
    return 100 * muls + 55 * 4 * dbl


def _kernel_count(s, k):
    """The CUDA kernel's method on this data, by hand: 7 multiplies per
    comb digit that is not 0, max(5 t, 4) doublings (t: k's top signed
    5-bit digit), and for k != 0 the table up to the largest |digit| m
    and an add of 8 per digit past the first."""
    es = _signed_digits(s, 4, E.COMB_DIGITS)
    kd = _signed_digits(k, 5, E.K_WINDOWS)
    nz = [i for i, d in enumerate(kd) if d]
    dbl = max(5 * nz[-1], 4) if nz else 4
    muls = 7 * sum(1 for d in es if d) + 3 * dbl
    if nz:
        m = max(abs(d) for d in kd)
        muls += m + 8 * (m - 1) + 8 * (len(nz) - 1)
    return 100 * muls + 55 * 4 * dbl


def test_straus_least_ops_hand_counts():
    """The Straus kernel's bound is, per lane, the less of the two methods
    the repo runs, on this data.  s = 5, k = 0: the joint walk takes 2
    doublings and 1 add (15 multiplies, 8 squarings), the comb 1 add and
    its 4 doublings (19, 16); s = 3, k = 1: the joint walk 1 doubling, 1
    add and the B - A entry (21, 4), the kernel 1 comb add, 4 doublings
    and -A's entry (20, 16); zero scalars take nothing; a random pair
    below L and a random s with k = 0 (the comb's case) match the hand
    count; the kernel's own count stays above."""
    s = torch.tensor([_limbs(5), _limbs(3), _limbs(0)], dtype=torch.int32)
    k = torch.tensor([_limbs(0), _limbs(1), _limbs(0)], dtype=torch.int32)
    joint, kernel = E.straus_ops_by_method(s, k)
    assert joint.tolist() == [100 * 15 + 55 * 8, 100 * 21 + 55 * 4, 0]
    assert kernel.tolist() == [100 * 19 + 55 * 16, 100 * 20 + 55 * 16,
                               100 * 12 + 55 * 16]
    assert E.straus_least_int32_ops(s, k) == (
        100 * (15 + 21) + 55 * (8 + 4))
    assert E.straus_least_int32_ops(s[2:], k[2:]) == 0
    rng = np.random.RandomState(5)
    sv = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(3)]
    kv = [int.from_bytes(rng.bytes(32), "little") % L, 0, 2**260 - 1]
    st = torch.tensor([_limbs(v) for v in sv], dtype=torch.int32)
    kt = torch.tensor([_limbs(v) for v in kv], dtype=torch.int32)
    joint, kernel = E.straus_ops_by_method(st, kt)
    assert joint.tolist() == [_joint_count(a, b) for a, b in zip(sv, kv)]
    assert kernel.tolist() == [_kernel_count(a, b) for a, b in zip(sv, kv)]
    assert kernel[1] < joint[1]               # k = 0: the comb wins
    assert E.straus_least_int32_ops(st, kt) == sum(
        min(_joint_count(a, b), _kernel_count(a, b)) for a, b in zip(sv, kv))
    assert kernel.max() < E.STRAUS_INT32_OPS_PER_LANE
    assert kernel[1] < E.STRAUS_COMB_INT32_OPS_PER_LANE
    big = torch.tensor([_limbs(int(rng.randint(1, 2**31)) * 2**220)
                        for _ in range(4)], dtype=torch.int32)
    assert 0 < E.straus_least_int32_ops(big, big) < (
        4 * E.STRAUS_INT32_OPS_PER_LANE)


def test_mod_L_helpers_vs_msm_jax():
    z = M.make_z(12, seed=5, device="cpu")
    jz = JM.make_z(12, seed=5)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert M.make_z(12, device="cpu").shape == (12, M.Z_LIMBS)
    rng = np.random.RandomState(6)
    kv = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(12)]
    kv[:2] = [L - 1, 0]
    k = np.array([_limbs(v) for v in kv], np.int32)
    zk = M.mul_mod_L(z, torch.from_numpy(k))
    jzk = JM.mul_mod_L(jz, jnp.asarray(k))
    np.testing.assert_array_equal(zk.numpy(), np.asarray(jzk))
    np.testing.assert_array_equal(M.sum_mod_L(zk).numpy(),
                                  np.asarray(JM.sum_mod_L(jzk)))
    np.testing.assert_array_equal(
        M.window_digits(torch.from_numpy(k), M.NW_FULL).numpy(),
        np.asarray(JM.window_digits(jnp.asarray(k), JM.NW_FULL)))
    zv = [sum(int(x) << (13 * i) for i, x in enumerate(r)) for r in z.numpy()]
    total = sum(a * b for a, b in zip(zv, kv)) % L
    assert M.sum_mod_L(zk).tolist() == _limbs(total)


def test_msm_and_bucket_sums_vs_oracle():
    rng = np.random.RandomState(7)
    pts = [ref._mul(int(v), ref.BASE) for v in rng.randint(1, 10**6, 8)]
    sc = rng.randint(0, 1 << 16, 8)
    sc[3], sc[5] = 0, sc[4]                 # a zero scalar, a shared digit
    scal = torch.tensor([_limbs(int(v), 2) for v in sc], dtype=torch.int32)
    want = ref.IDENTITY
    for p, s in zip(pts, sc):
        want = ref._add(want, ref._mul(int(s), p))
    got = M.msm(_ref_point(pts), scal, 2)
    assert ref.point_equal(_ints(E.Point(*(c[None] for c in got)))[0], want)

    digits = M.window_digits(scal, 2)
    buckets = _ints(M.bucket_sums(_ref_point(pts), digits[1],
                                    M.ED25519, M.N_BUCKETS))
    for d in range(M.N_BUCKETS):
        w = ref.IDENTITY
        for p, s in zip(pts, sc):
            if (int(s) >> 8) == d:
                w = ref._add(w, p)
        assert ref.point_equal(buckets[d], w), d


def _signed_batch(rng, n):
    keys = [ref.keypair(rng.bytes(32)) for _ in range(n)]
    msgs = [rng.bytes(45) for _ in range(n)]
    sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    return [pk for _, pk in keys], msgs, sigs


def test_verify_batch_msm_honest_forged_and_noncanonical():
    pubs, msgs, sigs = _signed_batch(np.random.RandomState(8), 4)
    z = M.make_z(4, seed=9, device="cpu")
    forged = list(sigs)                   # S changed: decodes, fails
    forged[1] = sigs[1][:40] + bytes([sigs[1][40] ^ 1]) + sigs[1][41:]
    s_big = list(sigs)                    # S + L: excluded, batch holds
    s_int = int.from_bytes(sigs[2][32:], "little")
    s_big[2] = sigs[2][:32] + (s_int + L).to_bytes(32, "little")
    results = []
    for ss in (sigs, forged, s_big):
        args = ed25519.pack_verify_inputs(pubs, msgs, ss, device="cpu")
        ok, lane_ok = M.verify_batch_msm(*args, z)
        results.append((bool(ok), lane_ok.tolist()))
    assert results[0] == (True, [True] * 4)
    assert results[1] == (False, [True] * 4)
    assert results[2] == (True, [True, True, False, True])


def test_verify_batch_adaptive_matches_oracle():
    """64 lanes, 2 forged: the MSM pass fails, bisection settles both
    halves (32 < leaf) on the per-lane verifier."""
    pubs, msgs, sigs = _signed_batch(np.random.RandomState(10), 8)
    pubs, msgs, sigs = pubs * 8, msgs * 8, list(sigs) * 8
    for j in (5, 40):
        sigs[j] = bytes([sigs[j][0] ^ 2]) + sigs[j][1:]
    args = ed25519.pack_verify_inputs(pubs, msgs, sigs, device="cpu")
    n0 = V.LAUNCHES
    got = M.verify_batch_adaptive(*args, seed=3, leaf=33)
    assert V.LAUNCHES == n0               # CPU tensors: plain versions
    want = [jref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.tolist() == want and sum(want) == 62


def test_verify_window4_vs_oracle():
    pubs, msgs, sigs = fx.adversarial_grid()
    want = [jref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    args = ed25519.pack_verify_inputs(pubs, msgs, sigs, device="cpu")
    n0 = V.LAUNCHES_W4
    assert ed25519.verify_batch(*args, window=4).tolist() == want
    assert V.LAUNCHES_W4 == n0            # CPU tensors: the plain version
    with pytest.raises(ValueError):
        ed25519.verify_batch(*args, window=3)

    rng = np.random.RandomState(12)
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(10)]
    vals += [0, 1, L - 1, 1 << 255, (1 << 256) - 1]
    limbs = np.array([_limbs(v) for v in vals], np.int32)
    got = V._digits65(torch.from_numpy(limbs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(pv._digits65(
        jnp.asarray(limbs))))
    assert got.shape == (65, len(vals)) and got.min() >= 0 and got.max() <= 15


# --- the slice: MSM-mode bridge -> step_seq, vs the JAX premasked twin ------

I, VN, FORGED, VALUE = 4, 8, 1, 7
CLASSES = (0, 1)


@pytest.fixture(scope="module")
def signed():
    seeds = fx.deterministic_seeds(VN)
    pubkeys = fx.validator_pubkeys(seeds)
    cols = [fx.full_mesh_cols(I, VN, seeds, 0, typ, VALUE,
                              forge_validator=FORGED) for typ in CLASSES]
    return pubkeys, cols


def _msm_batcher(signed, **kw):
    pubkeys, cols = signed
    bat = VoteBatcher(I, VN, n_slots=4, device="cpu", verify_mode="msm", **kw)
    for c in cols:
        bat.add_arrays(*c)
    return bat


def test_batcher_verify_mode_validation():
    with pytest.raises(ValueError):
        VoteBatcher(I, VN, n_slots=4, device="cpu", verify_mode="batch")
    with pytest.raises(ValueError):
        VoteBatcher(I, VN, n_slots=4, device="cpu", verify_mode="msm",
                    msm_leaf=1)


def test_msm_slice_vs_jax_premasked(signed):
    pubkeys, cols = signed
    bat = _msm_batcher(signed)
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
    assert lanes is None                    # MSM mode: host-verified build
    assert bat.rejected_signature == 2 * I
    assert [n for _, n in phases] == [I * (VN - 1)] * 2
    drv = DeviceDriver(I, VN, advance_height=True, device="cpu")
    seq = [drv.empty_phase()] + [p for p, _ in phases]
    msgs = drv.step_seq(seq)
    assert drv.all_decided()
    assert {bat.decode_slot(i, int(s))
            for i, s in enumerate(drv.stats.decision_value)} == {VALUE}

    # JAX: the same votes, unsigned, after the oracle drops the forged
    jbat = JBatcher(I, VN, n_slots=4)
    for c, typ in zip(cols, CLASSES):
        msg = vote_messages_np(*[np.full(1, x, np.int64)
                                    for x in (0, 0, typ, VALUE)])[0]
        keep = np.array([jref.verify(bytes(pubkeys[v]), msg.tobytes(),
                                     bytes(sig))
                         for v, sig in zip(c[1], c[6])])
        assert (~keep).sum() == I and not keep[c[1] == FORGED].any()
        jbat.add_arrays(*[a[keep] for a in c[:6]])
    jphases = jbat.build_phases()
    for (tp, tn), (jp, jn) in zip(phases, jphases):
        assert tn == jn
        for name, t, j in zip(tp._fields, tp, jp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
    jd = JDriver(I, VN, advance_height=True)
    jseq = [jd.empty_phase()] + [p for p, _ in jphases]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jseq)
    jexts = jax.tree.map(lambda *xs: jnp.stack(xs), *([jd.ext()] * 3))
    jout = js.consensus_step_seq_jit(
        jd.state, jd.tally, jexts, jst, jd.powers, jd.total,
        jd.proposer_flag, jd.propose_value, advance_height=True)
    for part, port in (("state", drv.state), ("tally", drv.tally),
                       ("msgs", msgs)):
        jt = getattr(jout, part)
        for name, j, t in zip(jt._fields, jt, convert.to_numpy(port)):
            np.testing.assert_array_equal(np.asarray(j), t,
                                          err_msg=f"{part}.{name}")


@pytest.mark.slow
def test_verify_batch_msm_vs_msm_jax():
    """The port's combined check against `msm_jax.verify_batch_msm_jit`
    (compiles the JAX MSM: minutes on a CPU) with the same z, on a batch
    with an S >= L lane, with and without a forged lane."""
    pubs, msgs, sigs = _signed_batch(np.random.RandomState(13), 32)
    s_int = int.from_bytes(sigs[9][32:], "little")
    sigs[9] = sigs[9][:32] + (s_int + L).to_bytes(32, "little")
    forged = list(sigs)                   # S changed: decodes, fails
    forged[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    z = M.make_z(32, seed=14, device="cpu")
    for ss in (sigs, forged):
        ok, lane_ok = M.verify_batch_msm(
            *ed25519.pack_verify_inputs(pubs, msgs, ss, device="cpu"), z)
        jok, jlane = JM.verify_batch_msm_jit(
            *JE.pack_verify_inputs_host(pubs, msgs, ss), jnp.asarray(z))
        assert bool(ok) == bool(jok)
        np.testing.assert_array_equal(lane_ok.numpy(), np.asarray(jlane))
        assert lane_ok.tolist() == [i != 9 for i in range(32)]
    assert not bool(jok)


@pytest.mark.slow
def test_msm_slice_vs_jax_msm_batcher(signed):
    """The slice against JAX VoteBatcher(verify_mode="msm") itself."""
    pubkeys, cols = signed
    bat = _msm_batcher(signed)
    phases = bat.build_phases(pubkeys)
    jbat = JBatcher(I, VN, n_slots=4, verify_mode="msm")
    for c in cols:
        jbat.add_arrays(*c)
    jphases = jbat.build_phases(pubkeys)
    assert bat.rejected_signature == jbat.rejected_signature == 2 * I
    for (tp, tn), (jp, jn) in zip(phases, jphases):
        assert tn == jn
        for name, t, j in zip(tp._fields, tp, jp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
