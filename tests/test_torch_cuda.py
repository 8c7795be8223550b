"""Card-only tests of the port (marker `cuda`): each CUDA kernel (verify
at windows 5 and 4, pow, Straus, the BLS12-381 field multiply and
reduce, the microbenchmark's field-multiply chain) against its plain
PyTorch version (and the verify against the RFC 8032 oracle; the BLS
field kernels at every group size and at odd shapes), one small
signed height, the verify chunked and unchunked, both verify windows at
a ragged batch (4,117 lanes), one
small MSM-mode height, one small BLS aggregate +
pairing product and a checkpoint round trip with signed evidence
through the default-device entry points.  They skip where
no GPU is present; on the card run

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports neither jax nor agnes_tpu, so it runs on a machine
that has only the port's dependencies.
"""

import numpy as np
import pytest
import torch

from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.crypto import ed25519
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import ed25519_verify as V
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _grid_plus_random(n_random=64):
    pubs, msgs, sigs = fx.adversarial_grid()
    rng = np.random.RandomState(3)
    for k in range(n_random):
        sk, pk = ref.keypair(rng.bytes(32))
        m = rng.bytes(45)
        s = ref.sign(sk, m)
        if k % 2:
            s = bytes([s[0] ^ 1 << (k % 8)]) + s[1:]
        pubs.append(pk)
        msgs.append(m)
        sigs.append(s)
    return pubs, msgs, sigs


def test_kernel_matches_plain_and_oracle(cuda):
    pubs, msgs, sigs = _grid_plus_random()
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs, msgs, sigs,
                                                  device=cuda)
    args, ok_s = V.prologue(pub, sig, blocks)
    n0 = V.LAUNCHES
    got = V.verify_signed5(*args)
    assert V.LAUNCHES == n0 + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  V.verify_plain(*args).cpu().numpy())
    want = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert ((got > 0) & ok_s).cpu().tolist() == want


def test_signed_height_on_default_device(cuda):
    I, Vn = 8, 4
    seeds = fx.deterministic_seeds(Vn)
    bat = VoteBatcher(I, Vn, n_slots=4)
    for typ in (0, 1):
        bat.add_arrays(*fx.full_mesh_cols(I, Vn, seeds, 0, typ, 9,
                                          forge_validator=0))
    phases, lanes = bat.build_phases_device(fx.validator_pubkeys(seeds),
                                            phase_offset=1, lane_floor=80)
    drv = DeviceDriver(I, Vn, advance_height=True)
    assert drv.state.round.is_cuda and lanes.pub.is_cuda
    n0 = V.LAUNCHES
    drv.step_seq_signed([drv.empty_phase()] + [p for p, _ in phases], lanes)
    assert V.LAUNCHES > n0
    assert drv.all_decided() and drv.rejected_signature_device == 2 * I
    assert {bat.decode_slot(i, int(s))
            for i, s in enumerate(drv.stats.decision_value)} == {9}


def test_chunked_verify_equals_unchunked_on_the_card(cuda):
    """The verify kernel over ragged chunks gives the unchunked verdicts,
    one launch a chunk; "auto" under a budget that forces 4 chunks
    decides as the unchunked driver does."""
    from agnes_tpu_torch.device import step as ts
    from agnes_tpu_torch.utils import budget

    I, Vn = 8, 4
    seeds = fx.deterministic_seeds(Vn)
    pubkeys = fx.validator_pubkeys(seeds)
    bat = VoteBatcher(I, Vn, n_slots=4)
    for typ in (0, 1):
        bat.add_arrays(*fx.full_mesh_cols(I, Vn, seeds, 0, typ, 9,
                                          forge_validator=0))
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
    n = int(lanes.pub.shape[0])
    full = ts._verify_lanes_chunked(lanes.pub, lanes.sig, lanes.blocks, None)
    n0 = V.LAUNCHES
    chunked = ts._verify_lanes_chunked(lanes.pub, lanes.sig, lanes.blocks, 20)
    assert V.LAUNCHES - n0 == -(-n // 20)
    assert full.tolist() == chunked.tolist() and int((~full).sum()) == 2 * I

    hbm = int((n * 512 + 20 * budget.VERIFY_WORKSPACE_LANE_BYTES) / 0.9) + 1
    assert budget.plan_lane_verify(n, hbm_bytes=hbm).n_chunks == 4
    drivers = [DeviceDriver(I, Vn, advance_height=True, **kw)
               for kw in ({}, {"verify_chunk": "auto",
                               "hbm_budget_bytes": hbm})]
    for d in drivers:
        d.step_seq_signed([d.empty_phase()] + [p for p, _ in phases], lanes)
        assert d.all_decided() and d.rejected_signature_device == 2 * I
    np.testing.assert_array_equal(drivers[0].stats.decision_value,
                                  drivers[1].stats.decision_value)
    for a, b in zip(tuple(drivers[0].tally), tuple(drivers[1].tally)):
        assert a.equal(b)


def test_pow_kernel_matches_plain(cuda):
    """Limb for limb with the frozen plain power on each schedule: the
    chains of (p-5)/8 and p-2 and the fixed windows of 65537."""
    from agnes_tpu_torch.crypto import field as F

    rng = np.random.RandomState(4)
    x = rng.randint(-8800, 8801, (300, 20)).astype(np.int32)
    p = 2**255 - 19
    x[0] = [((p + 3) >> (13 * i)) & 0x1FFF for i in range(20)]
    x[1] = 0
    xt = torch.from_numpy(x).to(cuda)
    for e in ((p - 5) // 8, p - 2, 65537):
        want = F.freeze(F.pow_plain(xt, e)).cpu().numpy()
        n0 = F.POW_LAUNCHES
        got = F.pow_p(xt, e)
        assert F.POW_LAUNCHES == n0 + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def _group_equal_and_valid(q, want):
    """q and want equal as group elements, and q's X Y = Z T."""
    from agnes_tpu_torch.crypto import ed25519_point as E
    from agnes_tpu_torch.crypto import field as F

    assert bool(E.point_equal(q, want).all())
    assert bool(F.eq_mod_p(F.mul(q.x, q.y), F.mul(q.z, q.t)).all())


def test_straus_kernel_matches_plain(cuda):
    """The kernel's [s]B - [k]A equals the plain version's as a group
    element (its projective representative differs by design), with
    X Y = Z T and the RFC 8032 oracle's encoding, at a ragged B of 67
    lanes: the edge scalars, a torsioned A, warps mixing k = 0 and
    k != 0, and one warp of all k = 0 (the walk skipped)."""
    from agnes_tpu_torch.crypto import ed25519_point as E

    L = ref.L

    def limbs(v):
        return [(v >> (13 * i)) & 0x1FFF for i in range(20)]

    rng = np.random.RandomState(5)
    B = 67
    sv = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(B)]
    kv = [int.from_bytes(rng.bytes(33), "little") % 2**260 for _ in range(B)]
    for i, (a, b) in enumerate([(0, 0), (1, 1), (L - 1, 2**260 - 1),
                                (2**260 - 1, 0), (2**260 - 1, 2**260 - 1),
                                (0, 1), (1, 0)]):
        sv[i], kv[i] = a, b
    for i in range(8, 32, 3):
        kv[i] = 0                       # warps mixing k = 0 and k != 0
    for i in range(32, 64):
        kv[i] = 0                       # a warp of all k = 0
    pts = [ref._mul(int.from_bytes(rng.bytes(32), "little") % L, ref.BASE)
           for _ in range(B)]
    pts[5] = ref._add(pts[5], ref._decompress(bytes(32)))   # torsion
    pts[6] = ref.IDENTITY
    a = E.Point(*(torch.tensor([limbs(pt[c] % (2**255 - 19)) for pt in pts],
                               dtype=torch.int32, device=cuda)
                  for c in range(4)))
    s = torch.tensor([limbs(v) for v in sv], dtype=torch.int32, device=cuda)
    k = torch.tensor([limbs(v) for v in kv], dtype=torch.int32, device=cuda)
    want = E.straus_plain(s, k, a)
    sample = range(0, B, 6)
    n0 = E.STRAUS_LAUNCHES
    got = E.straus_sub(s, k, a)
    assert E.STRAUS_LAUNCHES == n0 + 1
    assert all(bool(((c >= 0) & (c < 8192)).all()) for c in got)
    _group_equal_and_valid(got, want)
    enc = E.compress(got).cpu().numpy()
    for i in sample:
        q = ref._add(ref._mul(sv[i], ref.BASE),
                     ref._mul(kv[i], (-pts[i][0] % ref.P, pts[i][1],
                                      pts[i][2], -pts[i][3] % ref.P)))
        assert bytes(enc[i].astype(np.uint8)) == ref._compress(q), i


def test_window4_kernel_matches_plain_and_oracle(cuda):
    pubs, msgs, sigs = _grid_plus_random()
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs, msgs, sigs,
                                                  device=cuda)
    args, ok_s = V.prologue(pub, sig, blocks, window=4)
    n0 = V.LAUNCHES_W4
    got = V.verify_w4(*args)
    assert V.LAUNCHES_W4 == n0 + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), V.verify_plain(*args, window=4).cpu().numpy())
    want = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert ((got > 0) & ok_s).cpu().tolist() == want
    assert ed25519.verify_batch(pub, sig, blocks, window=4).cpu().tolist() \
        == want


def test_verify_kernels_at_a_ragged_batch(cuda):
    """Both windows at B = 4,117 (4,099 random lanes plus the grid), a
    count no CTA size divides, so the masked edge of the launch is
    checked: lane for lane against verify_plain."""
    pubs, msgs, sigs = fx.adversarial_grid()
    rng = np.random.RandomState(9)
    keys = [ref.keypair(rng.bytes(32)) for _ in range(32)]
    msg = b"\x06" * 45
    signed = [ref.sign(sk, msg) for sk, _ in keys]
    for _ in range(4099):
        v = rng.randint(len(keys))
        s = bytearray(signed[v])
        kind = rng.randint(4)
        if kind == 1:
            s[rng.randint(32)] ^= 1 << rng.randint(8)
        elif kind == 2:
            s[32 + rng.randint(31)] ^= 1 << rng.randint(8)
        pubs.append(keys[(v + (kind == 3)) % len(keys)][1])
        msgs.append(msg)
        sigs.append(bytes(s))
    assert len(pubs) == 4117 and all(len(pubs) % t for t in (64, 128, 256))
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs, msgs, sigs,
                                                  device=cuda)
    for window, kernel in ((5, V.verify_signed5), (4, V.verify_w4)):
        args, _ = V.prologue(pub, sig, blocks, window=window)
        got = kernel(*args).cpu().numpy()
        want = V.verify_plain(*args, window=window).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < len(want)


def test_msm_slice_on_default_device(cuda):
    from agnes_tpu_torch.crypto import ed25519_point as E
    from agnes_tpu_torch.crypto import field as F

    I, Vn = 4, 16
    seeds = fx.deterministic_seeds(Vn)
    bat = VoteBatcher(I, Vn, n_slots=4, verify_mode="msm", msm_leaf=16)
    for typ in (0, 1):
        bat.add_arrays(*fx.full_mesh_cols(I, Vn, seeds, 0, typ, 9,
                                          forge_validator=3))
    counts = (V.LAUNCHES, F.POW_LAUNCHES, E.STRAUS_LAUNCHES)
    phases, lanes = bat.build_phases_device(fx.validator_pubkeys(seeds))
    assert lanes is None and bat.rejected_signature == 2 * I
    assert V.LAUNCHES > counts[0] and F.POW_LAUNCHES > counts[1] \
        and E.STRAUS_LAUNCHES > counts[2]
    drv = DeviceDriver(I, Vn, advance_height=True)
    drv.step_seq([drv.empty_phase()] + [p for p, _ in phases])
    assert drv.all_decided()
    assert {bat.decode_slot(i, int(s))
            for i, s in enumerate(drv.stats.decision_value)} == {9}


def _bls_rows(rng, n):
    """[n, 33] strict limbs: the boundary values of
    tests/test_pallas_field.py, then random values < 4p."""
    from agnes_tpu_torch.crypto import bls_field as BF
    from agnes_tpu_torch.crypto.bls_ref import P

    vals = [0, 1, P - 1, P, 4 * P - 1] + [
        int.from_bytes(rng.bytes(48), "little") % (4 * P)
        for _ in range(n - 5)]
    return BF.ints_to_limbs(vals)


def _torch_ops(fn):
    """(result, the aten ops `fn()` dispatched): a wrapper whose ops are
    all views and allocations launches no kernel of PyTorch's, so its
    launch counter counts every kernel it launched."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log():
        out = fn()
    return out, ops


#: aten ops that launch no kernel (views and allocations)
_NO_KERNEL = ("aten.empty.", "aten.expand.", "aten.view.")


def test_bls_fp_kernels_match_plain(cuda, monkeypatch):
    from agnes_tpu_torch.crypto import bls_field as BF

    rng = np.random.RandomState(6)
    xa = torch.from_numpy(_bls_rows(rng, 300)).to(cuda)
    ya = torch.from_numpy(_bls_rows(rng, 300)[::-1].copy()).to(cuda)
    loose = xa + ya.flip(0)                      # limbs <= 2 * 4095, < 8p
    for g in BF.GROUP_SIZES:                     # every group size
        monkeypatch.setattr(BF, "MUL_GROUPS", ((0, g),))
        monkeypatch.setattr(BF, "REDUCE_GROUPS", ((0, g),))
        n0 = BF.MUL_LAUNCHES
        got = BF.mul_rows(loose, ya)
        assert BF.MUL_LAUNCHES == n0 + 1
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      BF.mul_plain(loose, ya).cpu().numpy())
        for cols, passes in ((xa * 3, 1), (xa * 12, 2)):
            n0 = BF.REDUCE_LAUNCHES
            got = BF.reduce_rows(cols, passes)
            assert BF.REDUCE_LAUNCHES == n0 + 1
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                BF.reduce_plain(cols, passes).cpu().numpy())


def test_bls_fp_kernels_at_odd_shapes(cuda, monkeypatch):
    """At every group size: broadcast operands read in place (a [33]
    constant beside [R, 33] rows, strided rows), R = 1, R off every
    CTA's element count, and R = 0; one kernel launch a call (the
    counters, and no PyTorch op but views and the output's allocation),
    into a contiguous [..., 33] output."""
    from agnes_tpu_torch.crypto import bls_field as BF

    rng = np.random.RandomState(7)
    big = torch.from_numpy(_bls_rows(rng, 70_001)).to(cuda)
    wide = big.repeat(2, 1)
    for g in BF.GROUP_SIZES:
        monkeypatch.setattr(BF, "MUL_GROUPS", ((0, g),))
        monkeypatch.setattr(BF, "REDUCE_GROUPS", ((0, g),))
        for R in (1, 301, 9_001, 70_001):
            x = big[:R]
            y = big[-R:].flip(0)
            const = big[R // 2]
            strided = wide[1:2 * R:2]            # rows 66 words apart
            for a, b in ((x, y), (const, y), (x, const), (strided, x),
                         (x.view(1, R, 33), const)):
                n0 = (BF.MUL_LAUNCHES, BF.MUL_ROWS[R])
                got, ops = _torch_ops(lambda: BF.mul_rows(a, b))
                assert (BF.MUL_LAUNCHES, BF.MUL_ROWS[R]) == (n0[0] + 1,
                                                             n0[1] + 1)
                assert all(o.startswith(_NO_KERNEL) for o in ops), ops
                assert got.is_contiguous() and got.shape[-1] == 33
                np.testing.assert_array_equal(
                    got.cpu().numpy(), BF.mul_plain(a, b).cpu().numpy(),
                    err_msg=f"mul G={g} R={R}")
            for cols in (x * 3, strided, strided * 12):
                passes = BF._passes_needed(int(cols.max()))
                n0 = BF.REDUCE_LAUNCHES
                got, ops = _torch_ops(lambda: BF.reduce_rows(cols, passes))
                assert BF.REDUCE_LAUNCHES == n0 + 1
                assert all(o.startswith(_NO_KERNEL) for o in ops), ops
                assert got.is_contiguous()
                np.testing.assert_array_equal(
                    got.cpu().numpy(),
                    BF.reduce_plain(cols, passes).cpu().numpy(),
                    err_msg=f"reduce G={g} R={R}")
    n0 = (BF.MUL_LAUNCHES, BF.REDUCE_LAUNCHES)
    empty = big[:0]
    assert BF.mul_rows(empty, empty).shape == (0, 33)
    assert BF.reduce_rows(empty, 1).shape == (0, 33)
    assert (BF.MUL_LAUNCHES, BF.REDUCE_LAUNCHES) == n0
    with pytest.raises(ValueError):
        BF.reduce_rows(big[:4], 3)               # the kernel takes 1 or 2


def test_bls_aggregate_and_pairing_on_default_device(cuda):
    from agnes_tpu_torch.crypto import bls as B
    from agnes_tpu_torch.crypto import bls_field as BF
    from agnes_tpu_torch.crypto import bls_pairing as BP
    from agnes_tpu_torch.crypto import bls_ref as bref

    msg = bref.hash_to_g2(b"cuda class")
    pks, shares, a, s = [], [], None, None
    for _ in range(4):
        a, s = bref.point_add(a, bref.G1), bref.point_add(s, msg)
        pks.append(a)
        shares.append(s)
    w = [3, 1, 2, 0]
    args = [torch.from_numpy(x).to(cuda) for x in
            (B.pack_g1_rows(pks), B.pack_g2_rows(shares),
             B.pack_weights(w))]
    n0 = (BF.MUL_LAUNCHES, BF.REDUCE_LAUNCHES)
    apk, asig = B.bls_aggregate(*args, n_windows=1)
    assert BF.MUL_LAUNCHES > n0[0] and BF.REDUCE_LAUNCHES > n0[1]
    want_pk = bref.point_mul(3 + 2 + 6, bref.G1)
    assert B.g1_from_device(apk) == want_pk
    assert B.g2_from_device(asig) == bref.point_mul(11, msg)
    p = torch.stack([torch.from_numpy(BP.NEG_G1_LIMBS).to(cuda),
                     torch.stack([apk.x, apk.y, apk.z])])
    q = torch.stack([torch.stack([asig.x, asig.y, asig.z]),
                     torch.from_numpy(BP.pack_g2_proj(msg)).to(cuda)])
    bad = torch.from_numpy(BP.pack_g2_proj(bref.point_mul(12, msg))).to(cuda)
    q_bad = torch.stack([bad, q[1]])
    ok = BP.bls_pairing_product(torch.stack([p, p]), torch.stack([q, q_bad]))
    assert ok.is_cuda and ok.cpu().tolist() == [True, False]


def test_fe13_chain_kernel_matches_plain(cuda):
    from agnes_tpu_torch.scripts import microbench_layout as MB

    for inputs, shape, block, n_chain in (
            (MB.row_inputs, (20, 1024), 512, 3),
            (MB.row_inputs, (20, 8, 128), 1024, 2),
            (MB.wrap_inputs, (20, 300), 128, 2)):    # ragged, wrapping
        x, y = (torch.from_numpy(a).to(cuda) for a in inputs(shape, 8))
        n0 = MB.LAUNCHES
        got = MB.chain(x, y, n_chain, block)
        assert MB.LAUNCHES == n0 + 1 and got.shape == x.shape
        np.testing.assert_array_equal(
            got.cpu().numpy(), MB.chain_plain(x, y, n_chain).cpu().numpy())


def test_checkpoint_round_trip_with_evidence_on_default_device(cuda,
                                                              tmp_path):
    from agnes_tpu_torch.utils import checkpoint as C

    I, Vn = 4, 4
    seeds = fx.deterministic_seeds(Vn)
    pubkeys = fx.validator_pubkeys(seeds)
    bat = VoteBatcher(I, Vn, n_slots=4)
    drv = DeviceDriver(I, Vn, advance_height=True)
    bat.add_arrays(*fx.full_mesh_cols(I, Vn, seeds, 0, 0, 9,
                                      forge_validator=0))
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
    drv.step_seq_signed([drv.empty_phase()] + [p for p, _ in phases], lanes)
    C.save_driver(drv, str(tmp_path / "d.npz"))
    C.save_batcher(bat, str(tmp_path / "b.npz"))
    drv2 = C.load_driver(str(tmp_path / "d.npz"))
    bat2 = C.load_batcher(str(tmp_path / "b.npz"))
    assert drv2.state.round.is_cuda and bat2.device.type == "cuda"
    for d, b in ((drv, bat), (drv2, bat2)):
        b.add_arrays(*fx.full_mesh_cols(I, Vn, seeds, 0, 1, 9,
                                        forge_validator=0))
        phases, lanes = b.build_phases_device(pubkeys)
        d.step_seq_signed([p for p, _ in phases], lanes)
        assert d.all_decided()
    np.testing.assert_array_equal(drv.stats.decision_value,
                                  drv2.stats.decision_value)
    n0 = V.LAUNCHES
    assert bat2.signed_evidence(0, 0) is None    # forged: re-verify fails
    assert V.LAUNCHES > n0
