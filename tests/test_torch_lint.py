"""Port differential: the static analyzers and the metrics CLI against
the JAX twin, on the CPU.

`agnes_tpu_torch.analysis.{lockcheck,lint,retrace,lint_cli}` and
`agnes_tpu_torch.utils.metrics_cli` held against their `agnes_tpu`
twins: the lock-order AST pass on the twin's synthetic fixtures (the
source strings copied as text), the lint rules the two packages share on
small trees under `tmp_path` (paths compared with the package prefix
rewritten), the retrace coverage proof on one ladder, the lint CLI's
report keys, and the metrics CLI's exit codes and output on heartbeat
trails written by the port's `Heartbeat`.  Port only: LINT001's torch
sync forms and their pragma, and the port's own tree coming out clean.
"""

import ast
import contextlib
import io
import json
import os
import textwrap

import pytest

from agnes_tpu.analysis import lint as jlint
from agnes_tpu.analysis import lint_cli as jcli
from agnes_tpu.analysis import lockcheck as jlock
from agnes_tpu.analysis import retrace as jret
from agnes_tpu.serve.batcher import ShapeLadder as JLadder
from agnes_tpu.utils import metrics_cli as jmcli
from agnes_tpu_torch.analysis import lint as tlint
from agnes_tpu_torch.analysis import lint_cli as tcli
from agnes_tpu_torch.analysis import lockcheck as tlock
from agnes_tpu_torch.analysis import retrace as tret
from agnes_tpu_torch.serve.batcher import ShapeLadder as TLadder
from agnes_tpu_torch.utils import flightrec
from agnes_tpu_torch.utils import metrics_cli as tmcli
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- lockcheck: the twin's synthetic fixtures, copied as text -----------------

_BARE_ACQUIRE = """
import threading
lock = threading.Lock()
def f():
    lock.acquire()
    work()
    lock.release()
"""

_INVERSION = """
class S:
    def good(self):
        with self._admission:
            close()
        with self._device:
            pump()
    def bad(self):
        with self._device:
            with self._admission:      # device -> admission: inverted
                close()
"""

_ADMISSION_DISPATCH = """
class S:
    def bad(self):
        with self._admission:
            self.driver.step_async(phases)
"""

_NESTED_HOLD = """
class S:
    def bad(self):
        with self._admission:
            with self._device:
                pump()
"""

_NESTED_HOLD_PRAGMA = """
class S:
    def quiescent(self):
        with self._admission, self._device:  # lockcheck: allow (threads joined)
            pump()
"""

_NATIVE_UNDER_ADMISSION = """
class S:
    def bad(self):
        with self._admission:
            self._lib.ag_adm_submit(buf, n)
"""


def _codes_lines(findings):
    return [(f.code, int(f.where.rsplit(":", 1)[1])) for f in findings]


@pytest.mark.parametrize("src,want", [
    (_BARE_ACQUIRE, ["LOCK001", "LOCK001"]),
    (_INVERSION, ["LOCK002"]),
    (_ADMISSION_DISPATCH, ["LOCK003"]),
    (_NESTED_HOLD, ["LOCK004"]),
    (_NESTED_HOLD_PRAGMA, []),
    (_NATIVE_UNDER_ADMISSION, ["LOCK005"]),
], ids=["bare", "inversion", "dispatch", "nested", "pragma", "native"])
def test_lockcheck_fixtures_match_twin(src, want):
    got = _codes_lines(tlock.check_source(src))
    assert got == _codes_lines(jlock.check_source(src))
    assert [c for c, _ in got] == want


def test_lockcheck_port_tree_clean_and_runtime_hooks():
    paths = tlock.default_paths(ROOT)
    assert paths and all("agnes_tpu_torch" + os.sep in p for p in paths)
    findings = tlock.check_paths(paths)
    assert findings == [], [str(f) for f in findings]
    assert tlock.NATIVE_LOCK_ORDER == jlock.NATIVE_LOCK_ORDER
    assert tlock.NATIVE_CAPI_PREFIXES == ("ag_",)
    assert not {"device_put"} & tlock.DISPATCH_CALLS
    assert "synchronize" in tlock.DISPATCH_CALLS
    # the hooks are called in the twin's order, and a lock_factory
    # replaces every registry lock
    events = []

    class Spy(tlock.InstrumentedLock):
        def _sched_point(self, event):
            events.append(event)

    st = tlock.LockOrderState()
    with Spy("a", 0, st):
        pass
    assert events == ["acquire", "release"] and st.acquisitions == 1

    class Host:
        pass

    h = Host()
    h._admission = h._device = None
    state = tlock.instrument(h, lock_factory=lambda n, r, s, strict:
                             Spy(n, r, s, strict))
    assert type(h._admission) is Spy and type(h._device) is Spy
    assert state.violations == []


# -- lint: the shared rules on tmp_path trees ---------------------------------

def _tree(root, pkg, rel, body):
    path = root / pkg / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(body))


def _where(findings, pkg):
    return [(f.code, f.where.replace(os.sep, "/").replace(pkg + "/", "", 1))
            for f in findings]


_SHARED_HOT = """\
import numpy as np

class P:
    def stage(self, batch):
        x = np.asarray(self.driver.window)
        y = np.asarray(batch.cols)  # lint: allow (host-built columns)
        return float(x)
    def cold(self):
        return np.asarray(self.anything)    # not a hot function
"""


def test_lint001_shared_forms_match_twin(tmp_path):
    out = {}
    for pkg, mod in (("agnes_tpu", jlint), ("agnes_tpu_torch", tlint)):
        _tree(tmp_path, pkg, "serve/pipeline.py", _SHARED_HOT)
        rel = f"{pkg}/serve/pipeline.py"
        out[pkg] = _where(mod.check_hot_paths(str(tmp_path),
                                              {rel: {"stage"}}), pkg)
    assert out["agnes_tpu"] == out["agnes_tpu_torch"] == [
        ("LINT001", "serve/pipeline.py:5"), ("LINT001", "serve/pipeline.py:7")]


@pytest.mark.parametrize("case", ["capi", "thread", "thread_pragma",
                                  "thread_wrapper"])
def test_lint004_lint005_match_twin(tmp_path, case):
    rel, body = {
        "capi": ("serve/rogue.py",
                 "def f():\n    return _lib().ag_x(1)\n"),
        "thread": ("mod.py", """\
            import threading

            def spawn(fn):
                t = threading.Thread(target=fn, daemon=True)
                t.start()
                return t
            """),
        "thread_pragma": ("mod.py", """\
            import threading

            def spawn(fn):
                t = threading.Thread(
                    target=fn,
                    daemon=True)  # lint: allow-thread (owns containment)
                return t
            """),
        "thread_wrapper": ("serve/threaded.py",
                           "import threading\ndef spawn(fn):\n"
                           "    return threading.Thread(target=fn)\n"),
    }[case]
    out = {}
    for pkg, mod in (("agnes_tpu", jlint), ("agnes_tpu_torch", tlint)):
        root = tmp_path / pkg
        _tree(root, pkg, rel, body)
        out[pkg] = _where(mod.check_capi_wrappers(str(root))
                          + mod.check_threads(str(root)), pkg)
    assert out["agnes_tpu"] == out["agnes_tpu_torch"]
    want = {"capi": [("LINT004", "serve/rogue.py:2")],
            "thread": [("LINT005", "mod.py:4")]}.get(case, [])
    assert out["agnes_tpu_torch"] == want


@pytest.mark.parametrize("expr", [
    "self.n_rejected.item()", "mask.sum().tolist()", "x.cpu()",
    "x.numpy()", "torch.cuda.synchronize()", "self.stream.synchronize()",
    "torch.tensor([a, b], device=dev)",
    "torch.tensor([h for h in hts], device=self.device)",
])
def test_lint001_torch_forms(tmp_path, expr):
    """Each torch sync form is flagged on its line inside a hot function,
    and a `# lint: allow` pragma clears it."""
    rel = "agnes_tpu_torch/serve/pipeline.py"
    hot = {rel: {"stage"}}
    body = ("import torch\n\nclass P:\n    def stage(self, x):\n"
            f"        y = {expr}\n        return y\n"
            f"    def cold(self, x):\n        return {expr}\n")
    _tree(tmp_path, "agnes_tpu_torch", "serve/pipeline.py", body)
    found = tlint.check_hot_paths(str(tmp_path), hot)
    assert [(f.code, f.where) for f in found] == [("LINT001", f"{rel}:5")]
    _tree(tmp_path, "agnes_tpu_torch", "serve/pipeline.py",
          body.replace(f"y = {expr}\n",
                       f"y = {expr}  # lint: allow (host tensor)\n"))
    assert tlint.check_hot_paths(str(tmp_path), hot) == []


def test_lint001_not_flagged_in_port(tmp_path):
    """Forms that do not sync: a host tensor built without a device, and
    jax's `.block_until_ready()`, which the port's rules leave out."""
    rel = "agnes_tpu_torch/serve/pipeline.py"
    _tree(tmp_path, "agnes_tpu_torch", "serve/pipeline.py",
          "class P:\n    def stage(self, x):\n"
          "        a = torch.tensor([1, 2])\n"
          "        x.block_until_ready()\n        return a\n")
    assert tlint.check_hot_paths(str(tmp_path), {rel: {"stage"}}) == []


def test_lint_port_tree_clean_and_hot_paths_exist():
    findings = tlint.check_repo(ROOT)
    assert findings == [], [str(f) for f in findings]
    for rel, funcs in tlint.HOT_PATHS.items():
        assert rel.startswith("agnes_tpu_torch/")
        with open(os.path.join(ROOT, rel)) as f:
            tree = ast.parse(f.read())
        names = {n.name for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        assert funcs <= names, (rel, funcs - names)
    for rel in tlint.AUDITED_CAPI_MODULES | tlint.THREAD_WRAPPER_MODULES:
        assert os.path.exists(os.path.join(ROOT, rel)), rel


# -- retrace: the static coverage proof ---------------------------------------

@pytest.mark.parametrize("dense,dedup", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_retrace_coverage_matches_twin(dense, dedup):
    tl = TLadder.plan(64, 32, min_rung=256, hbm_bytes=tcli.PLAN_HBM)
    jl = JLadder.plan(64, 32, min_rung=256)
    assert tl.rungs == jl.rungs
    kw = dict(dense=dense, dedup=dedup)
    assert tret.dispatchable_shapes(tl, **kw) == \
        jret.dispatchable_shapes(jl, **kw)
    for n_phases in ((2, 3), (2,), 3):
        assert tret.warmup_shapes(tl, n_phases, **kw) == \
            jret.warmup_shapes(jl, n_phases, **kw)
        assert tret.warmup_covers(tl, n_phases, **kw) == \
            jret.warmup_covers(jl, n_phases, **kw)
    for n_phases in ((2, 3), (2,), (3,)):
        t = tret.coverage_findings(tl, n_phases, **kw)
        j = jret.coverage_findings(jl, n_phases, **kw)
        assert [(f.pass_name, f.code, f.where) for f in t] == \
            [(f.pass_name, f.code, f.where) for f in j]
    assert [f.code for f in tret.coverage_findings(tl, (2,), **kw)] \
        == ["RET001"]
    assert tret.coverage_findings(tl, (2, 3), **kw) == []


def test_observed_shapes_reads_what_a_sentinel_saw():
    """`observed_shapes` maps a sentinel's signatures back to the static
    proof's shapes: a warmed CPU service with the dedup cache observes
    exactly its dispatchable set, and a BLS entry's signature (not a
    step) is left out (port only: the twin keeps no observed set)."""
    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve.cache import VerifiedCache
    from agnes_tpu_torch.serve.service import VoteService

    d = DeviceDriver(2, 4, advance_height=True, defer_collect=True,
                     audit=True, device="cpu")
    svc = VoteService(d, VoteBatcher(2, 4, n_slots=4, device="cpu"),
                      fx.validator_pubkeys(fx.deterministic_seeds(4)),
                      max_delay_s=0.0, dedup_cache=VerifiedCache(),
                      ladder=TLadder.plan(2, 4, min_rung=16,
                                          hbm_bytes=1 << 30))
    d.sentinel.observe("bls_aggregate", tret.signature(((1, 2),), (1,)))
    svc.pipeline.warmup()
    seen = tret.observed_shapes(d.sentinel)
    assert seen == tret.dispatchable_shapes(svc.ladder, dedup=True) == {
        (2, 16), (3, 16), ("unsigned", 2), ("unsigned", 3)}


# -- the lint CLI ---------------------------------------------------------------

def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, json.loads(out.getvalue().splitlines()[-1])


def test_lint_cli_report_matches_twin_keys(monkeypatch):
    rc, rep = _cli(tcli.main, ["--pass", "all", "--json"])
    assert rc == 0 and rep["ok"] and rep["findings"] == []
    assert set(rep["passes"]) == {"retrace", "locks", "lint"}
    # the twin's report for the same passes; its LINT002 half imports
    # every jit entry (seconds of jax import), which has no port subject
    monkeypatch.setattr(jlint, "check_import_time_jits", lambda root: [])
    for name in ("retrace", "locks", "lint"):
        jrc, jrep = _cli(jcli.main, ["--pass", name, "--json"])
        assert jrc == 0 and set(jrep) == set(rep)
        assert set(jrep["passes"][name]) == set(rep["passes"][name])
        if name == "retrace":
            assert jrep["passes"][name]["ladder_rungs"] == \
                rep["passes"][name]["ladder_rungs"]
    assert rep["passes"]["retrace"]["covered"]
    with pytest.raises(SystemExit):
        _cli(tcli.main, ["--pass", "jaxpr"])


# -- the metrics CLI ------------------------------------------------------------

def _trail(path, beats, host_id=None):
    hb = flightrec.Heartbeat(str(path), recorder=flightrec.FlightRecorder(),
                             host_id=host_id)
    for _ in range(beats):
        hb.beat()
    return str(path)


def _run_mcli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("case", ["good", "trailing_bad", "interior_bad",
                                  "missing", "merge"])
def test_metrics_cli_matches_twin(tmp_path, case):
    a = _trail(tmp_path / "hb0.ndjson", 3, host_id=0)
    b = _trail(tmp_path / "hb1.ndjson", 2, host_id=1)
    if case == "trailing_bad":
        with open(a, "a") as f:
            f.write('{"v": 2, "kind": "hb", "se')
    if case == "interior_bad":
        lines = open(a).read().splitlines()
        lines.insert(1, "not json")
        open(a, "w").write("\n".join(lines) + "\n")
    paths = {"missing": [str(tmp_path / "absent.ndjson")],
             "merge": [a, b]}.get(case, [a])
    want_rc = {"good": 0, "trailing_bad": 0, "interior_bad": 1,
               "missing": 2, "merge": 0}[case]
    for argv in (["--check", *paths], ["--json", *paths]):
        t = _run_mcli(tmcli.main, argv)
        j = _run_mcli(jmcli.main, argv)
        assert t == j, (argv, t, j)
    assert _run_mcli(tmcli.main, ["--check", *paths])[0] == want_rc
    if case == "merge":
        rc, out = _run_mcli(tmcli.main, ["--json", *paths])
        files = json.loads(out)["files"]
        assert rc == 0 and [f["last"]["host_id"] for f in files] == [0, 1]
        rc, out = _run_mcli(tmcli.main, paths)
        assert rc == 0 and out.startswith("pod heartbeat merge: 2 trail(s)")
