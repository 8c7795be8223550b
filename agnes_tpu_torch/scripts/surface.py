"""The port's public surface held against the JAX package's, name for name.

    python3 -m agnes_tpu_torch.scripts.surface

reads the twin package, `agnes_tpu/` beside this package, as source text
with `ast` (nothing of it is imported, so no jax either) and collects
the names a user of it can reach:

* for every package `__init__.py`: the names it imports, the names in
  its `__all__`, the keys of its lazy maps (dict literals, and dict
  comprehensions over literal tuples) and its own public functions and
  classes;
* for every module: its public top-level functions and classes and the
  public methods (properties included) of its public classes.

Each name must resolve in `agnes_tpu_torch` at the same relative path,
by import and `hasattr` (so inherited methods count; nothing is called),
or stand in `NOT_PORTED` with its reason.  A twin module without a file
of the same path in the port must stand in `NOT_PORTED` itself, or have
every public name there.  A package export is covered by the entry of
the module or name it is imported from.  An entry is stale when the twin
lacks its place or the port has it.  Prints one line a missing name or
stale entry and a count, and exits 1 if there is any missing name or
stale entry.  `tests/test_torch_surface.py` runs the same comparison
case by case, and `chip_smoke.py` phase 16 runs `check()`.
"""

from __future__ import annotations

import ast
import importlib
import os
import sys
import types
from typing import Dict, List, Optional, Tuple

PORT = "agnes_tpu_torch"
TWIN = "agnes_tpu"

#: ROADMAP §1 item 7a: these wait for the port's bench entry
BENCH = "waits for the bench entry (item 7a): its only caller is bench.py"

#: twin places the port does not offer, each with its reason: a module
#: path relative to the package root, or "path::name" for a top-level
#: name ("path::Class.method" for a method).  ROADMAP §1's "Needs no
#: port" list names the same places.
NOT_PORTED: Dict[str, str] = {
    "analysis/jaxpr_audit.py":
        "audits jaxprs (donation, collective census, host callbacks, "
        "dtype policy) and the package exports its `audit`; the port has "
        "no jaxpr, its collective count is ShardedStep's census and its "
        "Finding is analysis/findings.py",
    "analysis/pallas_support.py":
        "audits Pallas lowering per JAX backend; the port's kernels are "
        "CUDA sources built by nvcc",
    "device/registry.py":
        "the registry of jit entries and their XLA compile times; the "
        "port has no jit, and its kernel builds are cuda_build.py's "
        "(first-build events: cuda_build.on_build)",
    "utils/compile_cache.py":
        "XLA's persistent compile cache; cuda_build.py caches the port's "
        "builds",
    "crypto/bls_field_jax.py": "twin: crypto/bls_field.py + csrc/bls_fp.cu",
    "crypto/bls_jax.py": "twin: crypto/bls.py",
    "crypto/bls_pairing_jax.py": "twin: crypto/bls_pairing.py",
    "crypto/bls_tower_jax.py": "twin: crypto/bls_tower.py",
    "crypto/ed25519_jax.py":
        "twin: crypto/ed25519.py + crypto/ed25519_verify.py",
    "crypto/field_jax.py": "twin: crypto/field.py",
    "crypto/msm_jax.py": "twin: crypto/msm.py",
    "crypto/scalar_jax.py": "twin: crypto/scalar.py",
    "crypto/sha512_jax.py": "twin: crypto/sha512.py",
    "crypto/pallas_ed25519.py":
        "TPU kernels; twins: csrc/ed25519_pow.cu and csrc/ed25519_straus.cu "
        "behind crypto/field.py and crypto/ed25519_point.py",
    "crypto/pallas_field.py":
        "TPU kernels; twin: csrc/bls_fp.cu behind crypto/bls_field.py",
    "crypto/pallas_verify.py":
        "TPU kernel; twin: csrc/ed25519_verify.cu behind "
        "crypto/ed25519_verify.py",
    "utils/lazy.py::make_lazy_getattr":
        "the twin's lazy-export helper (bridge, serve and utils import "
        "it); each port package keeps its lazy names with its own module "
        "__getattr__",
    "analysis/lint.py::check_import_time_jits":
        "LINT002, an import-time jax.jit outside the entry registry; the "
        "port has no jit",
    "analysis/lint.py::check_static_kwargs":
        "LINT003, an unhashable literal passed to a static argnum; the "
        "port has no static argnums",
    "analysis/lint_cli.py::run_jaxpr":
        "the jaxpr pass traces jit entries the port does not have",
    "analysis/lint_cli.py::run_pallas":
        "the pallas pass audits Pallas lowering per JAX backend",
    "analysis/lint_cli.py::run_census":
        "the census pass counts jit entries' ops; the port's collective "
        "count is ShardedStep's census",
    "analysis/lint_cli.py::setup_backend_env":
        "sets up a JAX platform for the jaxpr passes",
    "utils/budget.py::compiled_peak_bytes":
        "reads an XLA executable's memory analysis; the port measures "
        "peaks with torch.cuda.max_memory_allocated",
    "distributed/driver.py::fetch_local_block":
        "assembles a host's block of a JAX global array from its "
        "addressable shards; a port rank holds its block as a tensor and "
        "read-outs are gathered by parallel/sharded.py::gather_tree",
    "distributed/smoke.py::free_port":
        "picks a TCP port for jax.distributed's coordinator; the port's "
        "pods rendezvous through a file:// store",
    "parallel/sharded.py::seq_in_specs":
        "shard_map PartitionSpecs of the stacked step arguments; the port "
        "cuts a rank's blocks with shard_step_args and its layout table",
    "serve/bls_lane.py::BlsLane.uses_pallas_field":
        "resolves whether the lane's BLS field runs on the Pallas kernels "
        "(TPU only); the port's lane runs the CUDA field kernels on the "
        "card and their plain versions on the CPU, so there is no choice",
    "utils/config.py::RunConfig": BENCH,
    "utils/budget.py::deadline_margin_s": BENCH,
    "utils/budget.py::install_deadline_signals": BENCH,
}


REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TWIN_DIR = os.path.join(REPO, TWIN)


def twin_modules() -> List[str]:
    """Every .py of the twin package, relative to it, sorted."""
    out = []
    for dirpath, dirnames, filenames in os.walk(TWIN_DIR):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "build"))
        for f in filenames:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f),
                                           TWIN_DIR).replace(os.sep, "/"))
    return sorted(out)


def parse(rel: str) -> ast.Module:
    with open(os.path.join(TWIN_DIR, rel)) as f:
        return ast.parse(f.read(), rel)


def _module_rel(dotted: str) -> Optional[str]:
    """"agnes_tpu.a.b" -> "a/b.py" (None outside the twin package)."""
    parts = dotted.split(".")
    if parts[0] != TWIN:
        return None
    return "/".join(parts[1:]) + ".py" if len(parts) > 1 else "__init__.py"


def module_names(tree: ast.Module) -> List[str]:
    """Public top-level functions and classes, and "Class.method" for
    the public methods of the public classes."""
    out = []
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        out.append(node.name)
        if isinstance(node, ast.ClassDef):
            out += [f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_")]
    return out


def _lazy_entry(value: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
    """A lazy map's value ("module", "name"): (module, name), the name
    None where it is not a literal (a comprehension's variable)."""
    if isinstance(value, ast.Tuple) and len(value.elts) == 2 and \
            isinstance(value.elts[0], ast.Constant):
        name = value.elts[1]
        return (value.elts[0].value,
                name.value if isinstance(name, ast.Constant) else None)
    return None


def package_names(rel: str, tree: ast.Module) -> Dict[str, Optional[str]]:
    """The public names a package `__init__` offers -> the twin place
    each comes from ("path" or "path::name"; None for its own names and
    for `__all__` entries defined elsewhere)."""
    out: Dict[str, Optional[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            src = _module_rel(node.module)
            for a in node.names:
                out[a.asname or a.name] = (
                    f"{src}::{a.name}" if src else None)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            out[node.name] = f"{rel}::{node.name}"
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            for e in getattr(node.value, "elts", []):
                if isinstance(e, ast.Constant):
                    out.setdefault(e.value, None)
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    ent = _lazy_entry(v)
                    src = _module_rel(ent[0]) if ent else None
                    out[k.value] = (f"{src}::{ent[1] or k.value}"
                                    if src else None)
        elif isinstance(node, ast.DictComp):
            ent = _lazy_entry(node.value)
            src = _module_rel(ent[0]) if ent else None
            for gen in node.generators:
                for e in getattr(gen.iter, "elts", []):
                    if isinstance(e, ast.Constant):
                        out[e.value] = f"{src}::{e.value}" if src else None
    return {n: s for n, s in sorted(out.items()) if not n.startswith("_")}


def port_module(rel: str) -> str:
    """"a/b.py" -> "agnes_tpu_torch.a.b" ("a/__init__.py" -> the package)."""
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PORT] + parts)


def resolves(module: str, qualname: str) -> bool:
    """Import `module` and walk `qualname` by `hasattr`.  A submodule of
    that name does not count: every name collected is a function, class
    or value, and a package attribute that a submodule's import rebinds
    is not one a caller can rely on."""
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return not isinstance(obj, types.ModuleType)


def excluded(place: Optional[str]) -> Optional[str]:
    """The NOT_PORTED reason covering a twin place ("path" or
    "path::name"), if any."""
    if place is None:
        return None
    rel, _, qual = place.partition("::")
    # the name itself, its class (for a method), its module
    for key in (place, f"{rel}::{qual.split('.')[0]}", rel):
        if key in NOT_PORTED:
            return NOT_PORTED[key]
    return None


def check_module(rel: str) -> dict:
    """One twin module: its names (the package exports for an
    `__init__.py`, its definitions otherwise) and which of them are
    missing from the port or stand in NOT_PORTED, as qualified names."""
    tree = parse(rel)
    mod = port_module(rel)
    exists = os.path.exists(os.path.join(REPO, PORT, rel))
    if rel.endswith("__init__.py"):
        names = package_names(rel, tree)
    else:
        names = {n: f"{rel}::{n}" for n in module_names(tree)}
    missing, skipped = [], []
    for name, place in names.items():
        if exists and resolves(mod, name):
            continue
        if excluded(place):
            skipped.append(f"{mod}.{name}")
        else:
            missing.append(f"{mod}.{name}")
    if not exists and not names and rel not in NOT_PORTED:
        missing.append(mod)
    return {"names": len(names), "missing": missing, "excluded": skipped}


def entry_problem(key: str) -> Optional[str]:
    """Why a NOT_PORTED entry is stale (None when it holds): the twin
    must have the module or name, and the port must not."""
    rel, _, qual = key.partition("::")
    if not NOT_PORTED.get(key, "").strip():
        return "no reason given"
    if not os.path.exists(os.path.join(TWIN_DIR, rel)):
        return f"the twin has no {rel}"
    exists = os.path.exists(os.path.join(REPO, PORT, rel))
    if not qual:
        return f"the port has {rel}" if exists else None
    if qual not in module_names(parse(rel)):
        return f"the twin's {rel} defines no {qual}"
    if exists and resolves(port_module(rel), qual):
        return f"the port has {port_module(rel)}.{qual}"
    return None


def check() -> dict:
    """The whole comparison: counts, the missing names and the stale
    NOT_PORTED entries."""
    mods = twin_modules()
    reps = [check_module(rel) for rel in mods]
    stale = {k: p for k in NOT_PORTED if (p := entry_problem(k)) is not None}
    return {"modules": len(mods), "names": sum(r["names"] for r in reps),
            "excluded": sum(len(r["excluded"]) for r in reps),
            "missing": [n for r in reps for n in r["missing"]],
            "stale": stale}


def main() -> int:
    rep = check()
    for name in rep["missing"]:
        print(f"missing: {name}")
    for key, why in rep["stale"].items():
        print(f"stale NOT_PORTED entry {key}: {why}")
    print(f"{rep['modules']} twin modules, {rep['names']} names, "
          f"{rep['excluded']} not ported by NOT_PORTED, "
          f"{len(rep['missing'])} missing, {len(rep['stale'])} stale")
    return 1 if rep["missing"] or rep["stale"] else 0


if __name__ == "__main__":
    sys.exit(main())
