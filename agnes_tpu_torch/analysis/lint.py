"""Repo lint: AST rules for the mistakes that cost device time (twin of
`agnes_tpu.analysis.lint`).

  LINT001  host sync inside a serve hot path: in the functions that run
           between dispatches (HOT_PATHS), a call that waits for the
           card or copies from it stalls the path whose point is never
           to wait on the device.  The forms: ``np.asarray(...)`` and
           ``float(...)`` (the twin's), and torch's ``.item()``,
           ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.synchronize()``
           (``torch.cuda.synchronize()`` included) and
           ``torch.tensor(<list or comprehension>, device=...)``, which
           builds on the host and copies synchronously.  A use that is
           host-side (a host tensor or numpy value) or already proven
           sync-free on the card carries a ``# lint: allow`` pragma with
           the reason.
  LINT004  raw native C call outside the audited wrappers: the ``ag_*``
           ctypes surface takes raw pointers and trusts its caller's
           screens of length, shape, device, dtype and contiguity.
           Every call goes through an audited wrapper module
           (AUDITED_CAPI_MODULES): the host core's three wrappers, and
           the CUDA kernels' launch wrappers, which screen a tensor
           before its pointer leaves Python.  Paired with lockcheck's
           LOCK005 (no ``ag_*`` call under the admission lock).
  LINT005  bare ``threading.Thread(...)`` outside the thread-wrapper
           modules: a thread spawned anywhere else bypasses the host's
           failure containment (serve/threaded.py's `_guard` fails the
           host closed when a loop dies; a bare daemon thread dies
           silently) and is invisible to the schedule checker, whose
           `thread_factory` seam serializes only the threads made
           through it.  Annotate ``# lint: allow-thread (reason)``
           anywhere in the call's span for a justified case (the
           schedule checker's own turnstile workers are one).

The twin's LINT002 (an import-time ``jax.jit`` outside the entry
registry) and LINT003 (an unhashable literal passed to a static
argnum) have nothing to check here: the port has no jit and no static
argnums, so `check_repo` runs LINT001, LINT004 and LINT005.

Pragma: ``# lint: allow`` on the offending line (reason after the
marker), as lockcheck's; LINT005 takes the narrower
``# lint: allow-thread`` so a generic allow cannot silence it.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from agnes_tpu_torch.analysis.findings import Finding

PRAGMA = "lint: allow"

#: the package the repo-wide passes scan
PACKAGE = "agnes_tpu_torch"

#: hot-path functions per file (repo-relative): the code that runs
#: between dispatches on the serve plane.  The names are the twin's
#: where the port keeps them; a comment names the twin function a
#: differently named one stands for.
HOT_PATHS: Dict[str, Set[str]] = {
    "agnes_tpu_torch/serve/pipeline.py": {
        "stage", "_build_all", "_build_one", "dispatch_staged", "pump",
        "_sync_window", "_entry_phase",
    },
    "agnes_tpu_torch/serve/service.py": {
        "submit", "pump", "_close_batch", "_pump_batch",
    },
    "agnes_tpu_torch/serve/threaded.py": {
        "submit", "_submit_loop", "_dispatch_loop",
    },
    "agnes_tpu_torch/serve/native_admission.py": {
        "submit", "drain",
    },
    "agnes_tpu_torch/harness/device_driver.py": {
        "step_async",
        # the twin's distributed/driver.py::_lift: the port's mesh
        # path cuts a rank's block out of the host tensors here
        "_block",
    },
    # the pod's between-dispatch code: the front door's screen and
    # rebase, and the local decision frame every host packs per tick
    "agnes_tpu_torch/distributed/shard.py": {
        "submit", "submit_local", "pump",
        # the twin keeps _local_decision_frame in elastic.py; the port
        # defines it once, on HostShard, and ElasticShard inherits it
        "_local_decision_frame",
    },
    # the elastic tick's host work: front-door routing, held-gossip
    # bookkeeping and the frame pack / unpack around the allgather
    "agnes_tpu_torch/distributed/elastic.py": {
        "submit", "tick", "_hold", "_take_reroute", "_ingest_reroute",
    },
    "agnes_tpu_torch/distributed/driver.py": {
        "_dense_dispatch_fn", "step_async", "_agree",
        # the twin's _make_sharded_seq: the port's unsigned sharded
        # sequence, agreed and launched here
        "_unsigned",
        # the twin's _plan_sig method is a module function here
        "plan_sig",
    },
}

#: the audited ctypes wrapper modules, the only places a raw ``ag_*``
#: call may appear (LINT004): each pairs every call with the screens
#: the raw ABI trusts its caller for
AUDITED_CAPI_MODULES = frozenset({
    # the native host core's wrappers (core/native/*.cpp)
    "agnes_tpu_torch/core/native.py",
    "agnes_tpu_torch/bridge/native_ingest.py",
    "agnes_tpu_torch/serve/native_admission.py",
    # the CUDA kernels' launch wrappers (csrc/*.cu): each screens a
    # tensor's device, dtype, contiguity and shape before its pointer
    # leaves Python
    "agnes_tpu_torch/crypto/ed25519_verify.py",
    "agnes_tpu_torch/crypto/field.py",
    "agnes_tpu_torch/crypto/ed25519_point.py",
    "agnes_tpu_torch/crypto/bls_field.py",
    # the probes that build and launch kernel variants
    "agnes_tpu_torch/scripts/bls_fp_probe.py",
    "agnes_tpu_torch/scripts/microbench_layout.py",
    "agnes_tpu_torch/scripts/verify_probe.py",
})

#: LINT005 pragma: deliberately not the generic PRAGMA, since a thread
#: spawn is a structural decision the annotation must name
THREAD_PRAGMA = "lint: allow-thread"

#: the modules that may construct OS threads directly, each wrapping
#: its threads in a containment story (the serve host's `_guard` fails
#: closed, the flight recorder's writer is crash-isolated, the metrics
#: exporter owns its server thread's lifecycle)
THREAD_WRAPPER_MODULES = frozenset({
    "agnes_tpu_torch/serve/threaded.py",
    "agnes_tpu_torch/utils/flightrec.py",
    "agnes_tpu_torch/utils/metrics_http.py",
})

#: LINT001's attribute-call sync forms: reading a device tensor's value
#: on the host, or waiting for the card
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")


def _has_pragma(lines, lineno: int) -> bool:
    return lineno - 1 < len(lines) and PRAGMA in lines[lineno - 1]


def package_modules(repo_root: str) -> List[str]:
    """Every .py file of the port's package tree, repo-relative, sorted:
    the scan-root derivation every repo-wide pass shares, so a new
    module is scanned the moment the file exists."""
    pkg_root = os.path.join(repo_root, PACKAGE)
    out: List[str] = []
    for root, dirs, names in os.walk(pkg_root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out.extend(os.path.relpath(os.path.join(root, n), repo_root)
                   for n in names if n.endswith(".py"))
    return sorted(out)


# -- LINT001: host syncs in hot paths ----------------------------------------

def _is_torch_tensor_of_list(node: ast.Call) -> bool:
    """`torch.tensor(<list | comprehension>, ..., device=...)`: built on
    the host element by element, then copied to the device
    synchronously."""
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "tensor"
            and isinstance(f.value, ast.Name) and f.value.id == "torch"
            and bool(node.args)
            and isinstance(node.args[0], (ast.List, ast.ListComp,
                                          ast.GeneratorExp))
            and any(kw.arg == "device" for kw in node.keywords))


class _HotPathVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str, hot: Set[str]):
        self.relpath = relpath
        self.lines = source.splitlines()
        self.hot = hot
        self.findings: List[Finding] = []
        self._depth = 0                # inside a hot function?

    def _find(self, node, what: str) -> None:
        if _has_pragma(self.lines, node.lineno):
            return
        self.findings.append(Finding(
            "lint", "LINT001", f"{self.relpath}:{node.lineno}",
            f"{what} inside serve hot path — a host sync on the "
            f"never-wait-on-device path (annotate `# {PRAGMA} "
            f"(reason)` if provably host-side)"))

    def visit_FunctionDef(self, node) -> None:
        inside = node.name in self.hot
        if inside:
            self._depth += 1
        self.generic_visit(node)
        if inside:
            self._depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        if self._depth:
            f = node.func
            if isinstance(f, ast.Attribute):
                if (f.attr == "asarray"
                        and isinstance(f.value, ast.Name)
                        and f.value.id in ("np", "numpy")):
                    self._find(node, "np.asarray(...)")
                elif f.attr in _SYNC_METHODS:
                    self._find(node, f".{f.attr}()")
                elif _is_torch_tensor_of_list(node):
                    self._find(node, "torch.tensor(<list>, device=...)")
            elif isinstance(f, ast.Name) and f.id == "float" \
                    and node.args:
                self._find(node, "float(...) on a possibly-device value")
        self.generic_visit(node)


def check_hot_paths(repo_root: str,
                    hot_paths: Optional[Dict[str, Set[str]]] = None
                    ) -> List[Finding]:
    """LINT001 needs per-function knowledge (which bodies run between
    dispatches), so HOT_PATHS stays a curated map; a key naming a
    module that no longer exists is reported, not skipped."""
    findings: List[Finding] = []
    for rel, hot in (hot_paths or HOT_PATHS).items():
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            findings.append(Finding(
                "lint", "LINT001", rel,
                "HOT_PATHS names a module that does not exist — the "
                "curated hot-path map has rotted; update lint.HOT_PATHS"))
            continue
        with open(path) as fh:
            src = fh.read()
        v = _HotPathVisitor(rel, src, hot)
        v.visit(ast.parse(src, filename=rel))
        findings.extend(v.findings)
    return findings


# -- LINT004: raw C calls outside the audited wrappers ------------------------

class _CapiVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.lines = source.splitlines()
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr.startswith("ag_") \
                and not _has_pragma(self.lines, node.lineno):
            self.findings.append(Finding(
                "lint", "LINT004", f"{self.relpath}:{node.lineno}",
                f"raw native C-API call .{f.attr}() outside the "
                f"audited wrapper modules — the ctypes surface takes "
                f"raw pointers and trusts its caller's screens (route "
                f"through a module of lint.AUDITED_CAPI_MODULES)"))
        self.generic_visit(node)


def check_capi_wrappers(repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel in package_modules(repo_root):
        if rel.replace(os.sep, "/") in AUDITED_CAPI_MODULES:
            continue
        with open(os.path.join(repo_root, rel)) as fh:
            src = fh.read()
        v = _CapiVisitor(rel, src)
        v.visit(ast.parse(src, filename=rel))
        findings.extend(v.findings)
    return findings


# -- LINT005: bare thread construction outside the wrapper modules ------------

def _span_pragma(lines, node, pragma: str) -> bool:
    """Pragma anywhere in the call's line span: thread spawns are often
    multi-line calls with the annotation on the closing line."""
    end = getattr(node, "end_lineno", None) or node.lineno
    return any(pragma in lines[i]
               for i in range(node.lineno - 1, min(end, len(lines))))


class _ThreadVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.lines = source.splitlines()
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "Thread" \
                and isinstance(f.value, ast.Name) \
                and f.value.id == "threading" \
                and not _span_pragma(self.lines, node, THREAD_PRAGMA):
            self.findings.append(Finding(
                "lint", "LINT005", f"{self.relpath}:{node.lineno}",
                f"bare threading.Thread(...) outside the thread-"
                f"wrapper modules — bypasses failure containment "
                f"(a dead daemon thread is silent; serve/threaded.py "
                f"fails closed) and the schedule checker's "
                f"thread_factory seam cannot serialize it (annotate "
                f"`# {THREAD_PRAGMA} (reason)` if the spawn owns its "
                f"own containment)"))
        self.generic_visit(node)


def check_threads(repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel in package_modules(repo_root):
        if rel.replace(os.sep, "/") in THREAD_WRAPPER_MODULES:
            continue
        with open(os.path.join(repo_root, rel)) as fh:
            src = fh.read()
        v = _ThreadVisitor(rel, src)
        v.visit(ast.parse(src, filename=rel))
        findings.extend(v.findings)
    return findings


def check_repo(repo_root: str) -> List[Finding]:
    """The port's three rules over the repo (module docstring)."""
    return (check_hot_paths(repo_root)
            + check_capi_wrappers(repo_root)
            + check_threads(repo_root))
