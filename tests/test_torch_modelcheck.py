"""Port differential: the consensus model checker and the deadline half
of the budget against the JAX twin, on the CPU.

`agnes_tpu_torch.analysis.modelcheck` held against
`agnes_tpu.analysis.modelcheck` (both jax-free): the tiny scope's
per-config reports (states, transitions, completeness, violations; the
admission and membership configs included) through the port's CLI
entry `main` against the twin's `run_scope`; one
exploration without partial-order and symmetry reduction, visited
digest sets included; the mutation self-test's records, minimized
counterexample schedules included; every committed consensus corpus
entry replayed on both packages to the same canonical form and digest,
and re-stamped byte for byte; one epoch-boundary entry replayed through
the device plane on the CPU; and (`slow`: about 20 s of ddmin over
milestone walks) the whole emitter against the committed corpus.
`agnes_tpu_torch.utils.budget`'s deadline half: the timeout parsers
over a table of tokens and argv lists, the env override, and the clean
partial an expired deadline leaves (the /proc discovery under a real
`timeout` runs in tests/test_torch_import.py's fresh interpreter).
"""

import contextlib
import dataclasses
import io
import json
import os
import time

import pytest

from agnes_tpu.analysis import modelcheck as jmc
from agnes_tpu.utils import budget as jb
from agnes_tpu_torch.analysis import modelcheck as tmc
from agnes_tpu_torch.utils import budget as tb
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_DIR = os.path.join(ROOT, "tests", "corpus")
CORPUS = jmc.load_corpus(CORPUS_DIR)


def _no_walls(x):
    """A report with its wall times dropped (the only fields that may
    differ between two correct runs)."""
    if isinstance(x, dict):
        return {k: _no_walls(v) for k, v in x.items() if k != "seconds"}
    if isinstance(x, list):
        return [_no_walls(v) for v in x]
    return x


@pytest.fixture(scope="module")
def port_cli():
    """The port's CLI on the tiny scope, in process, one worker (the
    deadline given, so the enclosing run's budget cannot cut it)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmc.main(["--scope", "tiny", "--json", "--workers", "1",
                       "--deadline-s", "600"])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def twin_scope():
    return jmc.run_scope("tiny", workers=1)


@pytest.mark.parametrize("name", [c.name for c in jmc.TINY_SCOPE]
                         + ["adm_tiny", "mem_tiny"])
def test_tiny_config_report_equals_twin(port_cli, twin_scope, name):
    _rc, rep = port_cli
    got = _no_walls(rep["configs"][name])
    want = _no_walls(twin_scope["configs"][name])
    assert got == want
    assert got["complete"] and not got["violations"]


def test_cli_tiny_scope_equals_twin_run_scope(port_cli, twin_scope):
    rc, rep = port_cli
    assert rc == 0 and rep["ok"] and rep["complete"]
    assert rep["violations"] == 0
    assert set(rep["configs"]) == set(twin_scope["configs"])
    for name, r in twin_scope["configs"].items():
        assert (rep["configs"][name]["states"],
                rep["configs"][name]["transitions"]) == \
            (r["states"], r["transitions"]), name
    keys = ("states_explored", "transitions", "consensus_states",
            "admission_states", "membership_states", "epoch_states",
            "churn_states", "sym_orbit_reduction", "epoch_orbit_reduction")
    assert {k: rep[k] for k in keys} == {k: twin_scope[k] for k in keys}
    assert rep["metrics"] == {
        "modelcheck_states_explored": rep["states_explored"],
        "modelcheck_violations": 0,
        "modelcheck_sym_orbit_reduction": rep["sym_orbit_reduction"],
        "modelcheck_admission_states": rep["admission_states"],
        "modelcheck_membership_states": rep["membership_states"],
        "modelcheck_epoch_states": rep["epoch_states"],
        "modelcheck_churn_states": rep["churn_states"],
        "modelcheck_epoch_orbit_reduction": rep["epoch_orbit_reduction"]}
    assert rep["deadline"] == {"source": "explicit", "budget_s": 600.0}


def test_unreduced_exploration_equals_twin_digest_for_digest():
    cfg = tmc.TINY_SCOPE[1]          # tiny_equivocator, the smallest
    got = tmc.explore(cfg, por=False, sym=False, collect_digests=True)
    want = jmc.explore(jmc.TINY_SCOPE[1], por=False, sym=False,
                       collect_digests=True)
    assert cfg.to_json() == jmc.TINY_SCOPE[1].to_json()
    assert (got.states, got.transitions, got.complete, got.deepest) == \
        (want.states, want.transitions, want.complete, want.deepest)
    assert got.digests == want.digests and not got.violations


def test_scopes_and_baselines_equal_twin():
    for scope in ("tiny", "smoke", "full"):
        assert [c.to_json() for c in tmc.SCOPES[scope]] == \
            [c.to_json() for c in jmc.SCOPES[scope]]
    assert tmc.SYM_BASELINE_STATES == jmc.SYM_BASELINE_STATES
    assert set(tmc.MUTANTS) == set(jmc.MUTANTS)
    assert set(tmc.DEEP_MUTANTS) == set(jmc.DEEP_MUTANTS)


def test_self_test_equals_twin():
    got = tmc.self_test()
    want = jmc.self_test()
    assert set(got) == set(tmc.MUTANTS) | set(tmc.DEEP_MUTANTS)
    assert _no_walls(got) == _no_walls(want)
    for name, r in got.items():
        assert r["counterexample"]["schedule"], name


@pytest.mark.parametrize("entry", CORPUS, ids=lambda e: e["name"])
def test_corpus_entry_replays_to_twin_canonical_form(entry):
    net, viols = tmc.replay_corpus_entry(entry)
    twin, twin_viols = jmc.replay_corpus_entry(entry)
    assert sorted({v.property for v in viols}) == \
        sorted({v.property for v in twin_viols})
    # the canonical forms agree, so the digests must too
    assert net.mc_canonical() == twin.mc_canonical()
    assert net.mc_digest() == twin.mc_digest()


@pytest.mark.parametrize("entry", CORPUS, ids=lambda e: e["name"])
def test_corpus_entry_restamps_byte_for_byte(entry):
    cfg = tmc.MCConfig.from_json(entry["config"])
    acts = [tmc.Network.action_from_json(a) for a in entry["actions"]]
    got = tmc.corpus_entry(entry["name"], cfg, acts, entry["origin"])
    with open(os.path.join(CORPUS_DIR, entry["name"] + ".json")) as f:
        want = f.read()
    assert json.dumps(got, indent=1, sort_keys=True) + "\n" == want


def test_device_replay_entry_on_the_cpu_crosses_the_epoch_boundary():
    """`device_replay_entry` on the plain versions: every node's device
    decisions at heights 0 and 1 (a validator-set change between them)
    equal the signed host replay's, which equal the entry's stamp."""
    (entry,) = [e for e in CORPUS
                if e["name"] == "mc_epoch_set_change_decides"]
    _net, results = tmc.device_replay_entry(entry, device="cpu")
    stamp = entry["expect"]["decided_heights"]
    assert len(results) == 4
    for j, host, rep in results:
        host_hr = {h: [d.round, d.value] for h, d in host.items()}
        assert {h: [r, v] for h, (r, v) in rep.decisions.items()} == \
            host_hr == {int(h): rv for h, rv in stamp[str(j)].items()}
        assert set(host_hr) == {0, 1}


@pytest.mark.slow
def test_emit_corpus_writes_the_committed_corpus(tmp_path):
    """The whole emitter (walks, ddmin, the three domains): ~20 s on one
    CPU core, hence `slow`; the re-stamp test above covers the stamps
    in tier-1."""
    written = tmc.emit_corpus(str(tmp_path))
    rel = sorted(os.path.relpath(p, tmp_path) for p in written)
    committed = sorted(
        os.path.relpath(os.path.join(d, f), CORPUS_DIR)
        for d, _, fs in os.walk(CORPUS_DIR) for f in fs
        if f.endswith(".json"))
    assert rel == committed
    for r in rel:
        with open(os.path.join(tmp_path, r), "rb") as a, \
                open(os.path.join(CORPUS_DIR, r), "rb") as b:
            assert a.read() == b.read(), r


def test_deadline_yields_clean_partial():
    cfg = tmc.MCConfig(name="dl", depth=10, max_round=1)
    rep = tmc.explore(cfg, deadline_at=time.time() - 1.0)
    assert not rep.complete
    assert rep.states > 0 and not rep.violations


# ---------------------------------------------------------------------------
# the deadline half of utils/budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tok", [
    "870", "30m", "1.5h", "2d", "10s", "0", "-5", "", "m", "abc", "1e3",
    "12x", "inf", "nan"])
def test_parse_timeout_duration_equals_twin(tok):
    got = tb.parse_timeout_duration(tok)
    want = jb.parse_timeout_duration(tok)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("argv", [
    ["timeout", "870", "python"],
    ["/usr/bin/timeout", "-k", "10", "870", "pytest"],
    ["timeout", "--kill-after=10", "30m", "x"],
    ["timeout", "-s", "TERM", "5", "x"],
    ["timeout", "--signal", "KILL", "2h", "x"],
    ["timeout", "--preserve-status", "-v", "9"],
    ["timeout", "-", "4"],
    ["timeout", "-k", "10"],
    ["timeout"],
    ["python", "870"],
    []])
def test_parse_timeout_argv_equals_twin(argv):
    assert tb.parse_timeout_argv(argv) == jb.parse_timeout_argv(argv)


def test_deadline_after_discover_and_env_override(monkeypatch):
    monkeypatch.setenv("AGNES_MODELCHECK_DEADLINE_S", "42")
    d = tb.Deadline.discover(env_var="AGNES_MODELCHECK_DEADLINE_S")
    assert d.source == "env:AGNES_MODELCHECK_DEADLINE_S"
    assert 40 < d.remaining() <= 42 and not d.expired()
    assert d.cap(10.0) == 10.0 and d.cap(100.0, margin=2.0) <= 40.0
    monkeypatch.setenv("AGNES_MODELCHECK_DEADLINE_S", "soon")
    assert tb.Deadline.discover(
        env_var="AGNES_MODELCHECK_DEADLINE_S").source in (
        "proc:timeout", "none")
    a = tb.Deadline.after(-1.0)
    assert a.source == "explicit" and a.expired()
    assert a.cap(3.0) == 0.0
    n = tb.Deadline.none()
    assert n.remaining() == float("inf") and not n.expired()
    assert n.cap(3.0) == 3.0
    assert [f.name for f in dataclasses.fields(tb.Deadline)] == \
        [f.name for f in dataclasses.fields(jb.Deadline)]
