"""The port's tooling against the JAX package's: tracing, checkpoint /
resume in both directions, and signed-evidence extraction.

* `Tracer` writes the twin's event structure for the same spans, flows
  and thread names, and `span` runs on the CPU (no NVTX without CUDA).
* Driver snapshots: a small unsigned height (I = 4, V = 4, host-built
  phases) runs in both packages side by side; their snapshots after the
  prevote phase are equal leaf for leaf (names, dtypes, values), each
  loads in the other package and finishes to the same decisions.
* Batcher snapshots: both packages' batchers take the same votes (a
  device-verify build with a double-signer, an unsigned build with a
  nil vote); their snapshots are equal leaf for leaf, and each loads in
  the other with equal log rows, pubkey epochs, slot maps and counters.
* `signed_evidence` returns the double-sign the RFC 8032 oracle (the
  JAX package's `ed25519_ref`) verifies, and None for a forger, before
  and after a restore; `clear_log` clears the pubkey tables with the
  log (ROADMAP §3: the twin's does not).

Only the JAX side's bridge and unsigned step run here: nothing compiles
the fused JAX verify.
"""

import json

import numpy as np
import pytest
import torch

from agnes_tpu.bridge.ingest import VoteBatcher as JaxBatcher
from agnes_tpu.crypto import ed25519_ref as oracle
from agnes_tpu.harness.device_driver import DeviceDriver as JaxDriver
from agnes_tpu.utils import checkpoint as jax_ckpt
from agnes_tpu.utils import tracing as jax_tracing
from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.utils import checkpoint as ckpt
from agnes_tpu_torch.utils import tracing
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V = 4, 4
EQUIV, FORGED = 1, 2


# --- tracing -----------------------------------------------------------------

def _drive_tracer(mod, path):
    tr = mod.Tracer(max_events=6)
    tr.name_thread("dispatch")
    with tr.span("outer"):
        with tr.span("inner"):
            tr.flow("tick", 3, mod.FLOW_START)
        tr.flow("tick", 3, mod.FLOW_STEP)
    tr.flow("tick", 3, mod.FLOW_END)
    with mod.span("device_scope", tr):
        pass
    with tr.span("late"):
        pass
    tr.write(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    shape = [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
             for e in events]
    return tr, shape


def test_tracer_writes_the_twins_event_structure(tmp_path):
    tr, got = _drive_tracer(tracing, tmp_path / "port.json")
    _, want = _drive_tracer(jax_tracing, tmp_path / "jax.json")
    assert got == want
    # 7 events in a ring of 6: the first, the flow's start, was evicted
    assert tr.dropped_events == 1 and tr.flow_phases(3) == {"t", "f"}
    assert {e["name"] for e in got if e["ph"] == "X"} == {
        "inner", "outer", "device_scope", "late"}
    assert tr.total_us("outer") >= tr.total_us("inner")
    with tracing.span("no_tracer"):              # CPU: no NVTX, no error
        torch.ones(2).sum()


# --- driver snapshots ----------------------------------------------------------

def _unsigned_cols(typ, value):
    inst, val = np.repeat(np.arange(I), V), np.tile(np.arange(V), I)
    z = np.zeros(I * V, np.int64)
    return inst, val, z, z, np.full(I * V, typ), np.full(I * V, value)


def _drive(drv, bat, typ, entry=False):
    bat.add_arrays(*_unsigned_cols(typ, 7))
    if entry:
        drv.step()
    for phase, _ in bat.build_phases():
        drv.step(phase=phase)


def _assert_same_npz(a_path, b_path):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _leaves(drv):
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in tuple(drv.state) + tuple(drv.tally)]


def test_driver_snapshots_cross_load_and_finish_alike(tmp_path):
    jb, pb = JaxBatcher(I, V, n_slots=4), VoteBatcher(I, V, 4, device="cpu")
    jd = JaxDriver(I, V, advance_height=True)
    pd = DeviceDriver(I, V, advance_height=True, device="cpu")
    _drive(jd, jb, 0, entry=True)
    _drive(pd, pb, 0, entry=True)
    jp, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ckpt.save_driver(jd, jp)
    ckpt.save_driver(pd, pp)
    _assert_same_npz(jp, pp)

    pd_from_jax = ckpt.load_driver(jp, device="cpu")
    jd_from_port = jax_ckpt.load_driver(pp)
    assert pd_from_jax.state.round.device.type == "cpu"
    for drv, bat in ((jd, jb), (jd_from_port, None), (pd, pb),
                     (pd_from_jax, None)):
        if bat is not None:
            bat.add_arrays(*_unsigned_cols(1, 7))
            phases = bat.build_phases()
        for phase, _ in phases:
            drv.step(phase=phase)
    for drv in (jd_from_port, pd, pd_from_jax):
        for f in ("decided", "decision_value", "decision_round"):
            np.testing.assert_array_equal(getattr(drv.stats, f),
                                          getattr(jd.stats, f))
        assert (drv.stats.decisions_total, drv.stats.votes_ingested,
                drv.stats.steps) == (jd.stats.decisions_total,
                                     jd.stats.votes_ingested, jd.stats.steps)
        for got, want in zip(_leaves(drv), _leaves(jd)):
            np.testing.assert_array_equal(got, want)
    assert jd.stats.decided.all() and {
        jb.decode_slot(i, int(s))
        for i, s in enumerate(jd.stats.decision_value)} == {7}


# --- batcher snapshots and evidence ----------------------------------------------

@pytest.fixture(scope="module")
def signed():
    """Seeds, pubkeys, the prevote class with validator FORGED forged,
    and validator EQUIV's second, valid prevote (value 8) everywhere."""
    seeds = fx.deterministic_seeds(V)
    pubkeys = fx.validator_pubkeys(seeds)
    cls = fx.full_mesh_cols(I, V, seeds, 0, 0, 7, forge_validator=FORGED)
    msg8 = vote_messages_np(*(np.zeros(1, np.int64),) * 3,
                            np.full(1, 8, np.int64))[0].tobytes()
    sig8 = np.frombuffer(oracle.sign(seeds[EQUIV], msg8), np.uint8)
    second = (np.arange(I), np.full(I, EQUIV), np.zeros(I, np.int64),
              np.zeros(I, np.int64), np.zeros(I, np.int64),
              np.full(I, 8, np.int64), np.tile(sig8, (I, 1)))
    return seeds, pubkeys, cls, second


def _feed(bat, signed, device_build):
    """Two device-verify ticks (the class, then the double-signs) and an
    unsigned tick with one nil precommit."""
    _, pubkeys, cls, second = signed
    for cols in (cls, second):
        bat.add_arrays(*cols)
        device_build(bat, pubkeys)
    bat.add_arrays([0], [3], [0], [0], [1], [-1])
    bat.build_phases()


def _assert_same_batcher(a, b):
    assert (a.I, a.V, a.W, a.held_cap, a.msm_leaf, a.verify_mode) == (
        b.I, b.V, b.W, b.held_cap, b.msm_leaf, b.verify_mode)
    for f in ("rejected_signature", "rejected_malformed", "overflow_votes",
              "dropped_stale_height", "dropped_held_overflow"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.slots.overflowed == b.slots.overflowed
    assert a.slots._maps == b.slots._maps
    for f in ("heights", "base_round", "powers"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(a._log) == len(b._log) == len(a._log_pk) == len(b._log_pk)
    for x, y, px, py in zip(a._log, b._log, a._log_pk, b._log_pk):
        for f in ("instance", "validator", "height", "round", "typ",
                  "value", "signature"):
            fx_, fy = getattr(x, f), getattr(y, f)
            assert (fx_ is None) == (fy is None), f
            if fx_ is not None:
                np.testing.assert_array_equal(fx_, fy, err_msg=f)
        assert (px is None) == (py is None)
        if px is not None:
            np.testing.assert_array_equal(np.asarray(px), np.asarray(py))


def test_batcher_snapshots_cross_load(tmp_path, signed):
    jb, pb = JaxBatcher(I, V, n_slots=4), VoteBatcher(I, V, 4, device="cpu")
    jb.held_cap = pb.held_cap = 77
    _feed(jb, signed, lambda b, pk: b.build_phases_device(pk))
    _feed(pb, signed, lambda b, pk: b.build_phases_device(pk))
    assert [p is None for p in pb._log_pk] == [False, False, True]
    jp, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ckpt.save_batcher(jb, jp)
    ckpt.save_batcher(pb, pp)
    _assert_same_npz(jp, pp)
    port_from_jax = ckpt.load_batcher(jp, device="cpu")
    jax_from_port = jax_ckpt.load_batcher(pp)
    # restores merge runs of one (signedness, epoch): the two signed
    # ticks come back as one batch in both packages
    _assert_same_batcher(port_from_jax, jax_ckpt.load_batcher(jp))
    _assert_same_batcher(jax_from_port, ckpt.load_batcher(pp, device="cpu"))
    assert len(port_from_jax._log) == 2
    assert port_from_jax.decode_slot(0, 1) == jb.decode_slot(0, 1) == 8


def _oracle_verifies(pubkeys, w):
    msg = vote_messages_np(*(np.full(1, x, np.int64) for x in (
        w.height, w.round, int(w.typ),
        -1 if w.value is None else w.value)))[0].tobytes()
    return oracle.verify(bytes(pubkeys[w.validator]), msg, w.signature)


def test_signed_evidence_returns_the_double_sign_not_the_forger(
        tmp_path, signed):
    _, pubkeys, _, _ = signed
    bat = VoteBatcher(I, V, 4, device="cpu")
    _feed(bat, signed, lambda b, pk: b.build_phases_device(pk))
    path = str(tmp_path / "bat.npz")
    ckpt.save_batcher(bat, path)
    restored = ckpt.load_batcher(path, device="cpu")
    for b in (bat, restored):
        ev = b.signed_evidence(2, EQUIV)
        assert ev is not None
        first, second = ev
        assert (first.instance, first.validator, first.value,
                second.value) == (2, EQUIV, 7, 8)
        assert all(_oracle_verifies(pubkeys, w) for w in ev)
        # the forger's pre-verdict vote fails its re-verify
        assert b.signed_evidence(2, FORGED) is None
    # an honest, single vote is no evidence
    assert restored.signed_evidence(2, 0) is None


def test_clear_log_clears_the_pubkey_tables_too(signed):
    """A host-built batch, clear_log, then a device-verify batch: the
    port's log and tables stay aligned, so the forger's pre-verdict row
    is re-verified (and fails); the twin's clear_log leaves the stale
    table entry, which then pairs with the new batch."""
    _, pubkeys, cls, _ = signed
    jb, pb = JaxBatcher(I, V, n_slots=4), VoteBatcher(I, V, 4, device="cpu")
    for b in (jb, pb):
        b.add_arrays([0], [3], [0], [0], [1], [-1])
        b.build_phases()
        b.clear_log()
        b.add_arrays(*cls)
        b.build_phases_device(pubkeys)
    assert len(pb._log) == len(pb._log_pk) == 1 and pb._log_pk[0] is not None
    assert len(jb._log) == 1 and len(jb._log_pk) == 2
    assert jb._log_pk[0] is None       # the twin would trust row 0's batch
    pb.add_arrays([0], [FORGED], [0], [0], [0], [9])   # unsigned: trusted
    pb.build_phases()
    assert pb.signed_evidence(0, FORGED) is None
