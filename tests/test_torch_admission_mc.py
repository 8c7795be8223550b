"""Port differential: the serve-plane admission model checker against the
JAX twin, and its corpus through the port's real VoteService on the CPU.

`agnes_tpu_torch.analysis.admission_mc` held against
`agnes_tpu.analysis.admission_mc`: the tiny scope exhaustively (visited
digest sets included) and the first 2,000 states of the smoke scope's
fairness-cap and BLS class-bucket configs (their full runs take ~11 s a
package); the mutation self-test's records; every admission corpus
entry replayed to the twin's digest; the emitter against the committed
corpus, byte for byte; and `BlsClassTable.mc_canonical` after the same
seeded folds.  Then every corpus schedule through the port's real
VoteService (`admission_service` / `drive_admission_service`) with the
device step and the host-fallback verify stubbed, as the twin's test
stubs its own: the dispatch stream — (n_phases, unsigned, slot bytes) a
dispatch — equals the twin's, native admission on and off;
`adm_dedup_roundtrip` also runs the real CPU step.  The BLS actions have
no serve counterpart in either replay.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

from agnes_tpu.analysis import admission_mc as jam
from agnes_tpu.serve import bls_lane as jbl
from agnes_tpu_torch.analysis import admission_mc as tam
from agnes_tpu_torch.analysis import modelcheck as tmc
from agnes_tpu_torch.crypto import ed25519_ref
from agnes_tpu_torch.crypto.encoding import vote_signing_bytes
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.serve import bls_lane as tbl
from test_admission_mc import _replay_on_serve as _twin_replay_on_serve
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "corpus", "admission")
CORPUS = tmc.load_corpus(CORPUS_DIR)
SEED = 20261018
HBM = 1 << 30


def _digests(rep):
    return rep.states, rep.transitions, rep.complete, rep.digests


def test_admission_tiny_explore_equals_twin():
    (cfg,) = tam.ADMISSION_SCOPES["tiny"]
    (twin_cfg,) = jam.ADMISSION_SCOPES["tiny"]
    assert cfg.to_json() == twin_cfg.to_json()
    got = tam.explore_admission(cfg, collect_digests=True)
    want = jam.explore_admission(twin_cfg, collect_digests=True)
    assert _digests(got) == _digests(want)
    assert got.complete and not got.violations
    assert got.to_json()["states"] == want.to_json()["states"]


@pytest.mark.parametrize("name", ["adm_fairness_cap", "adm_bls_classes"])
def test_admission_smoke_config_prefix_equals_twin(name):
    cfg = {c.name: c for c in tam.ADMISSION_SCOPES["smoke"]}[name]
    twin_cfg = {c.name: c for c in jam.ADMISSION_SCOPES["smoke"]}[name]
    assert cfg.to_json() == twin_cfg.to_json()
    got = tam.explore_admission(cfg, max_states=2000, collect_digests=True)
    want = jam.explore_admission(twin_cfg, max_states=2000,
                                 collect_digests=True)
    assert _digests(got) == _digests(want)
    assert got.states >= 2000 and not got.violations


def test_self_test_admission_equals_twin():
    got = tam.self_test_admission()
    want = jam.self_test_admission()
    assert set(got) == set(tam.ADMISSION_MUTANTS)
    assert got == want


@pytest.mark.parametrize("entry", CORPUS, ids=lambda e: e["name"])
def test_admission_entry_replays_to_twin_digest(entry):
    sys_, viols = tam.replay_admission_entry(entry)
    twin, twin_viols = jam.replay_admission_entry(entry)
    assert [v.property for v in viols] == [v.property for v in twin_viols]
    assert sys_.mc_canonical() == twin.mc_canonical()
    assert sys_.mc_digest() == twin.mc_digest()


def test_emit_admission_corpus_byte_for_byte(tmp_path):
    written = tam.emit_admission_corpus(str(tmp_path))
    assert sorted(os.path.basename(p) for p in written) == \
        sorted(os.listdir(CORPUS_DIR))
    for p in written:
        with open(p, "rb") as a, \
                open(os.path.join(CORPUS_DIR, os.path.basename(p)),
                     "rb") as b:
            assert a.read() == b.read(), p


def test_bls_class_table_canonical_equals_twin():
    """Seeded folds (duplicates, PoP-less and out-of-range validators,
    a class overflow) into both packages' tables, then a clone: the
    canonical bucket contents and counters equal after every fold, and
    a fold into the clone leaves the original untouched."""
    rng = np.random.RandomState(SEED)
    V, I = 5, 2
    tables = [mod.BlsClassTable(am._McBlsRegistry(V, no_pop=(3,)), I,
                                max_classes=3, clock=lambda: 0.0)
              for mod, am in ((tbl, tam), (jbl, jam))]
    for _ in range(6):
        n = rng.randint(1, 6)
        cols = (rng.randint(0, I + 1, n), rng.randint(0, V + 1, n),
                np.zeros(n, np.int64), rng.randint(0, 2, n),
                rng.randint(0, 2, n), 100 + rng.randint(0, 2, n))
        shares = np.stack([np.frombuffer(tam._bls_share_bytes(k), np.uint8)
                           for k in rng.randint(0, 4, n).tolist()])
        wire = tbl.pack_bls_wire(*cols, shares)
        assert wire == jbl.pack_bls_wire(*cols, shares)
        res = [t.fold(wire, decode=False) for t in tables]
        assert res[0] == res[1]
        assert tables[0].mc_canonical() == tables[1].mc_canonical()
        assert tables[0].counters == tables[1].counters
        assert tables[0].open_classes == len(tables[1].classes)
    clone = tables[0].mc_clone()
    assert clone.mc_canonical() == tables[0].mc_canonical()
    before = tables[0].mc_canonical()
    clone.flush()
    assert clone.mc_canonical() == () and tables[0].mc_canonical() == before


# ---------------------------------------------------------------------------
# the corpus through the port's real VoteService
# ---------------------------------------------------------------------------


def _ref_verify(b, pubkeys):
    """The batcher's host-fallback verify by the RFC 8032 oracle (as
    the twin's test does; the plain verify costs ~2 s a call here)."""
    out = np.zeros(len(b), bool)
    for j in range(len(b)):
        value = int(b.value[j])
        msg = vote_signing_bytes(int(b.height[j]), int(b.round[j]),
                                 int(b.typ[j]), None if value < 0 else value)
        out[j] = ed25519_ref.verify(
            bytes(np.asarray(pubkeys[int(b.validator[j])], np.uint8)), msg,
            bytes(b.signature[j]))
    return out


def _stub_step(self, phases, lanes=None, exts=None, tick=None):
    """`DeviceDriver.step_async` stubbed as the twin's test stubs its
    own: nothing launched, no rejected lane."""
    self.last_step_rejects = (None if lanes is None
                              else torch.zeros((), dtype=torch.int64))


def _serve(entry, native_admission=False, step=False):
    """The entry through the port's service: (svc, dispatch stream,
    recorded verifies); without the step, the host-fallback verify is
    the oracle too."""
    cfg = tam.AdmissionMCConfig.from_json(entry["config"])
    with contextlib.ExitStack() as stack:
        if not step:
            stack.enter_context(mock.patch.object(
                DeviceDriver, "step_async", _stub_step))
        svc, window, disp, verifies = tam.admission_service(
            cfg, device="cpu", native_admission=native_admission,
            hbm_bytes=HBM)
    if not step:
        svc.batcher._verify = _ref_verify
    tam.drive_admission_service(svc, window, cfg, entry["actions"])
    return svc, disp, verifies


@pytest.mark.parametrize("entry", CORPUS, ids=lambda e: e["name"])
def test_serve_replay_equals_twin_stream(entry):
    svc, disp, _ver = _serve(entry)
    _svc2, disp2, _ver2 = _serve(entry)
    assert disp == disp2, "serve replay not bit-identical"
    twin_cfg = jam.AdmissionMCConfig.from_json(entry["config"])
    _tsvc, twin_disp = _twin_replay_on_serve(twin_cfg, entry["actions"])
    assert disp == twin_disp
    if svc.pipeline.host_fallback_builds == 0:
        assert all(p in (2, 3) for p, _u, _b in disp), entry["name"]
    q = svc.queue.counters
    accounted = (svc.pipeline.dispatched_votes + svc.queue.depth
                 + svc.batcher.pending_votes + svc.batcher.held_votes)
    if not svc.batcher._host_tally and svc.batcher.rejected_signature == 0:
        assert q["admitted"] == accounted, entry["name"]
    else:
        assert q["admitted"] >= accounted, entry["name"]
    assert svc.batcher.rejected_malformed == 0


@pytest.mark.parametrize("entry", CORPUS, ids=lambda e: e["name"])
def test_serve_replay_native_admission_equals_python(entry):
    off, disp_off, _ = _serve(entry)
    on, disp_on, _ = _serve(entry, native_admission=True)
    assert disp_on == disp_off
    assert on.queue.counters == off.queue.counters
    assert on.queue.mc_canonical()[0] == off.queue.mc_canonical()[0]
    if off.cache is not None:
        assert on.cache.counters == off.cache.counters
    assert on.pipeline.dispatched_votes == off.pipeline.dispatched_votes


def test_serve_replay_dedup_roundtrip_through_the_real_cpu_step():
    """The milestone in the flesh, the device step run: fresh bytes
    dispatch signed, identical bytes after settle dispatch unsigned,
    the stream is the stubbed one, and every signature verifies."""
    (entry,) = [e for e in CORPUS if e["name"] == "adm_dedup_roundtrip"]
    svc, disp, verifies = _serve(entry, step=True)
    _stub, disp_stub, _ = _serve(entry)
    assert disp == disp_stub
    assert {u for _p, u, _b in disp} == {True, False}
    # one recorded verify a signed dispatch, its lanes the dispatch's
    assert [k for k, *_ in verifies] == \
        ["dispatch"] * sum(1 for _p, u, _b in disp if not u)
    assert all(int(real.sum()) > 0 for *_, real in verifies)
    svc.poll_decisions()
    assert svc.driver.rejected_signature_device == 0
    assert svc.batcher.rejected_signature == 0
    assert svc.driver.stats.votes_ingested == \
        svc.pipeline.dispatched_votes
