"""Port differential: the dense signed step on one device, on the CPU.

Path: the port's VoteBatcher.add_arrays -> build_phases_device_dense ->
DeviceDriver.step_seq_signed_dense (the dense [Ps, I, V] lanes, the
plain verify on the CPU), validator FORGED forged in both classes.
Held against the JAX package: the dense builder's arrays equal the JAX
builder's, honest and forged, and the step equals JAX
`consensus_step_seq` run on phase masks pre-ANDed with `ed25519_ref`
verdicts, leaf for leaf (equivalent by construction to the JAX dense
step, agnes_tpu/device/step.py:535-544).  On the port alone: the dense
path equals the packed-lane path; chunk 1, a ragged chunk, an oversize
chunk and "auto" under a small budget equal the unchunked step; and
`step_async` with DenseSignedPhases equals `step_seq_signed_dense`.
The `slow` case compares against JAX `consensus_step_seq_signed_dense`
itself (a fused-verify compile, minutes on a CPU).
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
from agnes_tpu_torch.utils import budget
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V, FORGED, VALUE = 3, 4, 1, 7
CLASSES = (0, 1)


@pytest.fixture(scope="module")
def fixture():
    seeds = fx.deterministic_seeds(V)
    pubkeys = fx.validator_pubkeys(seeds)
    cols = {forge: [fx.full_mesh_cols(I, V, seeds, 0, typ, VALUE,
                                      forge_validator=forge)
                    for typ in CLASSES]
            for forge in (None, FORGED)}
    return pubkeys, cols


def _batcher(cls, cols, **kw):
    bat = cls(I, V, n_slots=4, **kw)
    for c in cols:
        bat.add_arrays(*c)
    return bat


def _dense(fixture, forge=FORGED):
    pubkeys, cols = fixture
    phases, dense = _batcher(VoteBatcher, cols[forge], device="cpu") \
        .build_phases_device_dense(pubkeys)
    assert dense is not None and len(phases) == 2
    return [p for p, _ in phases], dense


def _drive(phases, dense, **kw):
    d = DeviceDriver(I, V, advance_height=True, device="cpu", **kw)
    msgs = d.step_seq_signed_dense([d.empty_phase()] + phases, dense)
    d.collect()
    return d, msgs


@pytest.fixture(scope="module")
def reference(fixture):
    """The unchunked dense height (forged), collected."""
    phases, dense = _dense(fixture)
    d, msgs = _drive(phases, dense)
    assert d.all_decided() and d.rejected_signature_device == 2 * I
    return phases, dense, d, msgs


def _same_port(a, b):
    for part in ("state", "tally"):
        for x, y in zip(getattr(a, part), getattr(b, part)):
            assert x.equal(y), part
    assert a.rejected_signature_device == b.rejected_signature_device
    for f in ("votes_ingested", "steps", "decisions_total"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f
    for f in ("decided", "decision_value", "decision_round"):
        np.testing.assert_array_equal(getattr(a.stats, f),
                                      getattr(b.stats, f), err_msg=f)


@pytest.mark.parametrize("forge", [None, FORGED], ids=["honest", "forged"])
def test_dense_builder_matches_jax_builder(fixture, forge):
    pubkeys, cols = fixture
    tphases, tdense = _batcher(VoteBatcher, cols[forge], device="cpu") \
        .build_phases_device_dense(pubkeys)
    jphases, jdense = _batcher(JBatcher, cols[forge]) \
        .build_phases_device_dense(pubkeys)
    assert [n for _, n in tphases] == [n for _, n in jphases] == [I * V] * 2
    for (tp, _), (jp, _) in zip(tphases, jphases):
        for name, t, j in zip(tp._fields, tp, jp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
    assert tdense.sig.shape == (2, I, V, 64)
    np.testing.assert_array_equal(tdense.pub.numpy(), np.asarray(jdense.pub))
    np.testing.assert_array_equal(tdense.sig.numpy(), np.asarray(jdense.sig))
    np.testing.assert_array_equal(tdense.blocks.numpy(),
                                  np.asarray(jdense.blocks).view(np.int32))


def _oracle_vmask(seq_np, dense, pubkeys):
    """[P, I, V] verdicts from ed25519_ref on every masked dense cell;
    the leading phases carry no lanes and pass."""
    P = seq_np.mask.shape[0]
    Ps = dense.sig.shape[0]
    vm = np.ones((P, I, V), bool)
    sig = dense.sig.numpy()
    for p in range(Ps):
        q = P - Ps + p
        for i, v in zip(*np.nonzero(seq_np.mask[q])):
            typ = int(seq_np.typ[q][i])
            msg = vote_messages_np(*[np.full(1, x, np.int64) for x in
                                     (0, 0, typ, VALUE)])[0].tobytes()
            vm[q, i, v] = jref.verify(bytes(pubkeys[v]), msg,
                                      bytes(sig[p, i, v].astype(np.uint8)))
    return vm


def test_dense_step_vs_jax_premasked(fixture, reference):
    pubkeys, _ = fixture
    phases, dense, drv, msgs = reference
    values = {b for b in drv.stats.decision_value.tolist()}
    assert len(values) == 1 and drv.stats.votes_ingested == 2 * I * (V - 1)

    jd = JDriver(I, V, advance_height=True)
    seq = [DeviceDriver(I, V, device="cpu").empty_phase()] + phases
    seq_np = ts.VotePhase(*[np.stack([convert.to_numpy(getattr(p, f))
                                      for p in seq])
                            for f in ts.VotePhase._fields])
    vmask = _oracle_vmask(seq_np, dense, pubkeys)
    assert (seq_np.mask & ~vmask).sum() == drv.rejected_signature_device
    jphases = js.VotePhase(*[jnp.asarray(x) for x in seq_np])
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


@pytest.mark.parametrize("forge", [None, FORGED], ids=["honest", "forged"])
def test_dense_equals_lane_path(fixture, forge):
    pubkeys, cols = fixture
    phases, dense = _dense(fixture, forge)
    d, _ = _drive(phases, dense)
    lphases, lanes = _batcher(VoteBatcher, cols[forge], device="cpu") \
        .build_phases_device(pubkeys, phase_offset=1)
    ref = DeviceDriver(I, V, advance_height=True, device="cpu")
    ref.step_seq_signed([ref.empty_phase()] + [p for p, _ in lphases],
                        lanes)
    ref.collect()
    _same_port(d, ref)
    assert d.all_decided()
    assert d.rejected_signature_device == (0 if forge is None else 2 * I)


def _auto_budget():
    """A budget under which "auto" tiles 2 of the 3 rows a launch."""
    plan = budget.plan_dense_verify(2, I, V, hbm_bytes=1 << 40)
    row = 2 * V * (budget.VERIFY_WORKSPACE_LANE_BYTES
                   + budget.SIG_LANE_BYTES + budget.BLOCK_LANE_BYTES
                   + budget.PUB_LANE_BYTES)
    return int((plan.resident_bytes + 2 * row) / 0.9) + 1


@pytest.mark.parametrize("chunk", [1, 2, 8, "auto"],
                         ids=["one-row", "ragged", "oversize", "auto"])
def test_chunked_dense_equals_unchunked(reference, monkeypatch, chunk):
    phases, dense, ref, ref_msgs = reference
    calls = []
    real = ts.ed25519.verify_batch

    def counted(pub, sig, blocks, *a, **k):
        calls.append(int(pub.shape[0]))
        return real(pub, sig, blocks, *a, **k)

    monkeypatch.setattr(ts.ed25519, "verify_batch", counted)
    kw = {"verify_chunk": chunk}
    if chunk == "auto":
        kw["hbm_budget_bytes"] = _auto_budget()
    d, msgs = _drive(phases, dense, **kw)
    _same_port(d, ref)
    for a, b in zip(msgs, ref_msgs):
        assert a.equal(b)
    tile = {1: 1, 2: 2, 8: I, "auto": 2}[chunk]
    n_tiles = -(-I // tile)
    # one verify call a tile, the ragged last tile padded to full size
    assert calls == [2 * tile * V] * n_tiles
    if chunk == "auto":
        plan = budget.plan_dense_verify(2, I, V,
                                        hbm_bytes=kw["hbm_budget_bytes"])
        assert (plan.tile, plan.n_chunks) == (2, 2)


def test_step_async_dense_with_auto_equals_step_seq_signed_dense(reference):
    phases, dense, ref, _ = reference
    d = DeviceDriver(I, V, advance_height=True, device="cpu",
                     verify_chunk="auto", hbm_budget_bytes=_auto_budget())
    d.step_async([d.empty_phase()] + phases, dense)
    assert d.stats.votes_ingested == 0 and d.rejected_signature_device == 0
    assert d.last_step_rejects.tolist() == [2] * I     # [I] on the dense path
    d.collect()
    _same_port(d, ref)


@pytest.mark.slow
def test_dense_step_vs_jax_fused(fixture, reference):
    """Against JAX consensus_step_seq_signed_dense itself (compiles the
    fused jnp verify on the CPU: minutes)."""
    pubkeys, cols = fixture
    _, _, drv, msgs = reference
    jphases, jdense = _batcher(JBatcher, cols[FORGED]) \
        .build_phases_device_dense(pubkeys)
    jd = JDriver(I, V, advance_height=True)
    jseq = [jd.empty_phase()] + [p for p, _ in jphases]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jseq)
    jexts = jax.tree.map(lambda *xs: jnp.stack(xs), *([jd.ext()] * 3))
    jout = js.consensus_step_seq_signed_dense_jit(
        jd.state, jd.tally, jexts, jst, jdense, jd.powers, jd.total,
        jd.proposer_flag, jd.propose_value, advance_height=True)
    assert int(np.asarray(jout.n_rejected).sum()) == \
        drv.rejected_signature_device
    for part, port in (("state", drv.state), ("tally", drv.tally),
                       ("msgs", msgs)):
        jt = getattr(jout, part)
        for name, j, t in zip(jt._fields, jt, convert.to_numpy(port)):
            np.testing.assert_array_equal(np.asarray(j), t,
                                          err_msg=f"{part}.{name}")
