"""Port differential: one signed consensus height end to end on the CPU.

Path: the port's VoteBatcher.add_arrays -> build_phases_device ->
DeviceDriver.step_seq_signed (fused verify on the plain path), with one
forged validator in both vote classes.  Held leaf for leaf against the
JAX `consensus_step_seq` run on phase masks pre-ANDed with
`ed25519_ref` verdicts — equivalent by construction to the JAX signed
step (device/step.py:431-436).  Also: the port's phases and lanes equal
the JAX bridge's, and chunked verification equals unchunked.  The
`slow` case compares against JAX `consensus_step_seq_signed` itself
(a fused-verify compile, minutes on a CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agnes_tpu.bridge.ingest import VoteBatcher as JBatcher
from agnes_tpu.crypto import ed25519_ref as jref
from agnes_tpu.device import step as js
from agnes_tpu.harness.device_driver import DeviceDriver as JDriver
from agnes_tpu_torch import convert
from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
from agnes_tpu_torch.device import step as ts
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V, FORGED, VALUE = 4, 4, 1, 7
CLASSES = (0, 1)


@pytest.fixture(scope="module")
def signed():
    seeds = fx.deterministic_seeds(V)
    pubkeys = fx.validator_pubkeys(seeds)
    sigs = [fx.sign_class(seeds, 0, typ, VALUE, forge_validator=FORGED)
            for typ in CLASSES]
    cols = [fx.full_mesh_cols(I, V, seeds, 0, typ, VALUE, sigs=sigs[c])
            for c, typ in enumerate(CLASSES)]
    return pubkeys, cols


def _build(batcher_cls, signed, **kw):
    pubkeys, cols = signed
    bat = batcher_cls(I, V, n_slots=4, **kw)
    for c in cols:
        bat.add_arrays(*c)
    return bat


def _np_lanes(lanes, n):
    return {f: np.asarray(getattr(lanes, f))[:n] for f in lanes._fields}


def test_port_bridge_matches_jax_bridge(signed):
    pubkeys, _ = signed
    tphases, tlanes = _build(VoteBatcher, signed, device="cpu") \
        .build_phases_device(pubkeys, phase_offset=1, lane_floor=40)
    jphases, jlanes = _build(JBatcher, signed).build_phases_device(
        pubkeys, phase_offset=1)
    n = 2 * I * V
    assert tlanes.pub.shape[0] == 40 and int(tlanes.real.sum()) == n
    assert [c for _, c in tphases] == [c for _, c in jphases] == [I * V] * 2
    for (tp, _), (jp, _) in zip(tphases, jphases):
        for name, t, j in zip(tp._fields, tp, jp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
    t, j = _np_lanes(tlanes, n), _np_lanes(jlanes, n)
    j["blocks"] = j["blocks"].view(np.int32)
    for f in t:
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    # padding lanes aim past the last phase and are not real
    assert (tlanes.phase_idx[n:] == 3).all() and not tlanes.real[n:].any()


def _oracle_vmask(phases_np, lanes, pubkeys):
    """[P, I, V] verdict mask from ed25519_ref over the real lanes."""
    P = phases_np.mask.shape[0]
    vm = np.zeros((P, I, V), bool)
    real = lanes.real.numpy()
    sig = lanes.sig.numpy()
    pidx, inst, val = (lanes.phase_idx.numpy(), lanes.inst.numpy(),
                       lanes.val.numpy())
    msgs = {}
    for j in np.nonzero(real)[0]:
        typ = CLASSES[pidx[j] - 1]
        if typ not in msgs:
            msgs[typ] = vote_messages_np(*[np.full(1, x, np.int64) for x in
                                           (0, 0, typ, VALUE)])[0].tobytes()
        ok = jref.verify(bytes(pubkeys[val[j]]), msgs[typ],
                         bytes(sig[j].astype(np.uint8)))
        vm[pidx[j], inst[j], val[j]] = ok
    return vm


def test_signed_height_vs_jax_premasked(signed):
    pubkeys, _ = signed
    bat = _build(VoteBatcher, signed, device="cpu")
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1,
                                            lane_floor=40)
    drv = DeviceDriver(I, V, advance_height=True, device="cpu")
    seq = [drv.empty_phase()] + [p for p, _ in phases]
    msgs = drv.step_seq_signed(seq, lanes)

    # the port's own decisions: every instance commits the value, the
    # forged validator's lanes are rejected in both classes
    assert drv.all_decided()
    assert {bat.decode_slot(i, int(s))
            for i, s in enumerate(drv.stats.decision_value)} == {VALUE}
    assert drv.rejected_signature_device == 2 * I
    assert drv.stats.votes_ingested == 2 * I * (V - 1)

    # JAX on pre-ANDed masks
    jd = JDriver(I, V, advance_height=True)
    phases_np = ts.VotePhase(*[np.stack([convert.to_numpy(getattr(p, f))
                                         for p in seq])
                               for f in ts.VotePhase._fields])
    vmask = _oracle_vmask(phases_np, lanes, pubkeys)
    vmask[0] = True                     # the entry phase carries no lanes
    assert vmask.sum() == 2 * I * (V - 1) + I * V
    jphases = js.VotePhase(*[jnp.asarray(x) for x in phases_np])
    jphases = jphases._replace(mask=jphases.mask & jnp.asarray(vmask))
    jexts = jax.tree.map(lambda *xs: jnp.stack(xs), *([jd.ext()] * 3))
    jout = js.consensus_step_seq_jit(
        jd.state, jd.tally, jexts, jphases, jd.powers, jd.total,
        jd.proposer_flag, jd.propose_value, advance_height=True)
    for part, port in (("state", drv.state), ("tally", drv.tally),
                       ("msgs", msgs)):
        jt = getattr(jout, part)
        for name, j, t in zip(jt._fields, jt, convert.to_numpy(port)):
            np.testing.assert_array_equal(np.asarray(j), t,
                                          err_msg=f"{part}.{name}")


def test_chunked_verify_equals_unchunked(signed):
    pubkeys, _ = signed
    _, lanes = _build(VoteBatcher, signed, device="cpu") \
        .build_phases_device(pubkeys, phase_offset=1)
    full = ts._verify_lanes_chunked(lanes.pub, lanes.sig, lanes.blocks, None)
    chunked = ts._verify_lanes_chunked(lanes.pub, lanes.sig, lanes.blocks,
                                       20)
    assert full.tolist() == chunked.tolist()
    assert int((~full).sum()) == 2 * I
    assert not full[lanes.val == FORGED].any()


def test_host_verified_build_drops_forged_votes(signed):
    """build_phases(pubkeys) verifies on the batcher's device first (the
    port's verify_batch) and drops the forged lanes before densifying."""
    pubkeys, _ = signed
    bat = _build(VoteBatcher, signed, device="cpu")
    phases = bat.build_phases(pubkeys)
    assert bat.rejected_signature == 2 * I
    assert [n for _, n in phases] == [I * (V - 1)] * 2
    for p, _ in phases:
        mask = p.mask.numpy()
        assert not mask[:, FORGED].any() and mask.sum() == I * (V - 1)


@pytest.mark.slow
def test_signed_height_vs_jax_fused(signed):
    """Against JAX consensus_step_seq_signed itself (compiles the fused
    jnp verify on the CPU: minutes)."""
    pubkeys, _ = signed
    jphases, jlanes = _build(JBatcher, signed).build_phases_device(
        pubkeys, phase_offset=1)
    jd = JDriver(I, V, advance_height=True)
    jseq = [jd.empty_phase()] + [p for p, _ in jphases]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jseq)
    jexts = jax.tree.map(lambda *xs: jnp.stack(xs), *([jd.ext()] * 3))
    jout = js.consensus_step_seq_signed_jit(
        jd.state, jd.tally, jexts, jst, jlanes, jd.powers, jd.total,
        jd.proposer_flag, jd.propose_value, advance_height=True)

    bat = _build(VoteBatcher, signed, device="cpu")
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
    drv = DeviceDriver(I, V, advance_height=True, device="cpu")
    msgs = drv.step_seq_signed([drv.empty_phase()] + [p for p, _ in phases],
                               lanes)
    assert int(jout.n_rejected) == drv.rejected_signature_device
    for part, port in (("state", drv.state), ("tally", drv.tally),
                       ("msgs", msgs)):
        jt = getattr(jout, part)
        for name, j, t in zip(jt._fields, jt, convert.to_numpy(port)):
            np.testing.assert_array_equal(np.asarray(j), t,
                                          err_msg=f"{part}.{name}")
