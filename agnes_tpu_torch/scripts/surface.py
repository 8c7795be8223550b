"""The port's public surface held against the JAX package's, name for
name and parameter for parameter.

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
lacks its place or the port has it.

Parameters: every callable both packages have (a public function, and
`__init__` and the public methods of a public class; a dataclass's or
NamedTuple's fields count as its parameters) is held against the twin's
signature (`param_problems`): the twin's positional parameters, in
order, must be the port's leading positional ones; its keyword-only
parameters must be keyword-only in the port; a default must be there
where the twin has one, and equal where `ast.literal_eval` reads the
twin's; `*args` / `**kwargs` must be there exactly where the twin has
them.  A port-only parameter must come after the twin's positional
parameters with a default, or be keyword-only.  Each difference stands
in `DEPARTS` with its reason, or is a problem.  A `DEPARTS` entry is
stale when the twin lacks the parameter or the port no longer differs
on it.

Prints one line a missing name, parameter problem or stale entry and the
counts, and exits 1 if there is any.  `tests/test_torch_surface.py` runs
the same comparison case by case, and `chip_smoke.py` phases 16 and 17
run `check()`.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import os
import sys
import types
from typing import Dict, List, NamedTuple, Optional, Tuple

PORT = "agnes_tpu_torch"
TWIN = "agnes_tpu"

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
}


#: twin parameters the port departs from by design: "path::qualname" of a
#: callable both packages have (qualname "Class" for a dataclass's
#: fields, "Class.method" for a method) -> {twin parameter: reason}.  A
#: twin parameter listed here that the port lacks is taken out of the
#: twin's order before positions are compared, so the reason says what a
#: positional caller past it meets.
_AXIS = ("the twin's shard_map axis name; the port's collective is an "
         "all_reduce over a process group, `group=` (None: no reduction), "
         "which follows advance_height and verify_chunk as a keyword")
_DONATE = ("buffer donation is XLA's; the port's step writes its outputs "
           "to fresh tensors, so there is nothing to donate, and a "
           "positional caller past it meets the next parameter")
_DEVICES = ("JAX's device list; a port mesh is one process a device over "
            "the initialized process group, and `device_type` ('cuda' or "
            "'cpu') takes its place")
DEPARTS: Dict[str, Dict[str, str]] = {
    "device/step.py::consensus_step": {"axis_name": _AXIS},
    "device/step.py::consensus_step_seq": {"axis_name": _AXIS},
    "device/step.py::consensus_step_seq_signed_dense": {"axis_name": _AXIS},
    "device/step.py::honest_heights": {"axis_name": _AXIS},
    "device/tally.py::add_votes": {"axis_name": _AXIS},
    "harness/device_driver.py::DeviceDriver.step_async": {"donate": _DONATE},
    "distributed/driver.py::DistributedDriver.step_async": {
        "donate": _DONATE},
    "parallel/sharded.py::make_sharded_step_seq": {"donate": _DONATE},
    "parallel/sharded.py::make_sharded_step_seq_signed": {
        "donate": _DONATE},
    "serve/pipeline.py::ServePipeline.__init__": {"donate": _DONATE},
    "serve/service.py::VoteService.__init__": {"donate": _DONATE},
    "parallel/mesh.py::make_mesh": {"devices": _DEVICES},
    "parallel/mesh.py::make_hierarchical_mesh": {"devices": _DEVICES},
    "parallel/sharded.py::dense_lane_specs": {
        "mesh": "the twin's PartitionSpecs name mesh axes; the port's "
                "layout table is the same for every mesh, so it takes "
                "none"},
    "distributed/driver.py::make_pod_mesh": {
        "n_val": "no default: `per_host`, the ranks of a host, follows "
                 "it without one, since a port process is one device and "
                 "nothing counts a host's devices as JAX does; a twin "
                 "call without arguments raises TypeError",
        "devices": "JAX's device list; `per_host` takes its place "
                   "(the ranks of one host, one process a device)"},
    "distributed/pod.py::initialize_pod": {
        "coordinator_address": "jax.distributed's coordinator address; "
                               "torch.distributed takes an init_method "
                               "(`file://` or `tcp://localhost:<port>`)",
        "num_processes": "a port process is a rank, one a device: the "
                         "world size (`world_size`)",
        "process_id": "a port process is a rank (`rank`)"},
    "distributed/pod.py::PodCoordinator.__init__": {
        "n_hosts": "the coordinator's peers are ranks, one a device "
                   "(`n_processes`), not JAX processes of several "
                   "devices",
        "host": "this process's rank (`process`)"},
    "serve/bls_lane.py::BlsLane.__init__": {
        "pallas_field": "picks the Pallas BLS field kernels on a TPU; the "
                        "port's lane runs the CUDA field kernels on the "
                        "card and their plain versions on the CPU, so "
                        "there is no choice, and a positional caller past "
                        "it meets `clock`"},
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


# -- parameters ----------------------------------------------------------------

class Param(NamedTuple):
    """One parameter: `kind` is "pos" (positional or keyword), "kw"
    (keyword-only), "*" or "**"; `default` is NO_DEFAULT when there is
    none and UNREAD when the twin's is not a literal."""

    name: str
    kind: str
    default: object


NO_DEFAULT = object()
UNREAD = object()


def _literal(node: Optional[ast.AST]) -> object:
    if node is None:
        return NO_DEFAULT
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError, MemoryError,
            RecursionError):
        return UNREAD


def _decorators(node) -> List[str]:
    out = []
    for d in node.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        out.append(f.attr if isinstance(f, ast.Attribute)
                   else getattr(f, "id", ""))
    return out


def _args_params(a: ast.arguments, drop_first: bool) -> List[Param]:
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [Param(p.arg, "pos", _literal(d)) for p, d in zip(pos, defaults)]
    out = out[1:] if drop_first else out
    if a.vararg is not None:
        out.append(Param(a.vararg.arg, "*", NO_DEFAULT))
    out += [Param(p.arg, "kw", _literal(d))
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg is not None:
        out.append(Param(a.kwarg.arg, "**", NO_DEFAULT))
    return out


def _fields(node: ast.ClassDef) -> List[Param]:
    return [Param(st.target.id, "pos", _literal(st.value))
            for st in node.body
            if isinstance(st, ast.AnnAssign)
            and isinstance(st.target, ast.Name)
            and "ClassVar" not in ast.unparse(st.annotation)]


def twin_callables(tree: ast.Module) -> Dict[str, List[Param]]:
    """qualname -> the twin's parameters, for its public functions, the
    fields of its public dataclasses and NamedTuples ("Class"), and the
    `__init__` and public methods of its public classes (properties
    take no arguments and are left out)."""
    out: Dict[str, List[Param]] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            out[node.name] = _args_params(node.args, False)
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        if "dataclass" in _decorators(node) or any(
                getattr(b, "id", getattr(b, "attr", None)) == "NamedTuple"
                for b in node.bases):
            out[node.name] = _fields(node)
        for m in node.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or (m.name.startswith("_") and m.name != "__init__"):
                continue
            decs = _decorators(m)
            if "property" in decs or "setter" in decs:
                continue
            out[f"{node.name}.{m.name}"] = _args_params(
                m.args, "staticmethod" not in decs)
    return out


_KINDS = {inspect.Parameter.POSITIONAL_ONLY: "pos",
          inspect.Parameter.POSITIONAL_OR_KEYWORD: "pos",
          inspect.Parameter.VAR_POSITIONAL: "*",
          inspect.Parameter.KEYWORD_ONLY: "kw",
          inspect.Parameter.VAR_KEYWORD: "**"}


def port_params(module: str, qualname: str) -> List[Param]:
    """The port's parameters of `qualname` in `module`, by
    `inspect.signature` (a method's `self` dropped)."""
    obj = owner = importlib.import_module(module)
    for part in qualname.split("."):
        owner, obj = obj, getattr(obj, part)
    drop = (isinstance(owner, type) and "." in qualname
            and not isinstance(inspect.getattr_static(
                owner, qualname.rsplit(".", 1)[1]),
                (staticmethod, classmethod)))
    params = list(inspect.signature(obj).parameters.values())
    return [Param(p.name, _KINDS[p.kind],
                  NO_DEFAULT if p.default is inspect.Parameter.empty
                  else p.default)
            for p in params[1 if drop else 0:]]


def _same(a, b) -> bool:
    return type(a) is type(b) and a == b


def param_problems(twin: List[Param], port: List[Param],
                   departs: Optional[Dict[str, str]] = None
                   ) -> Dict[str, str]:
    """{parameter: what differs} between the twin's and the port's
    parameters of one callable (module docstring).  `departs` names the
    twin parameters the port departs from by design: one the port lacks
    leaves the twin's order before positions are compared, unless a
    port-only positional parameter takes its place (a rename: that
    parameter passes, and the twin's is reported at its position)."""
    departs = departs or {}
    out: Dict[str, str] = {}
    pnames = {p.name: p for p in port}
    tnames = {p.name for p in twin}
    ppos = [p for p in port if p.kind == "pos"]
    # a departed twin parameter the port lacks: a port-only parameter in
    # its place stands in for it (a rename); otherwise it is dropped
    tpos: List[Param] = []
    stand_ins = set()
    for t in twin:
        if t.kind != "pos":
            continue
        if t.name in departs and t.name not in pnames:
            i = len(tpos)
            if i < len(ppos) and ppos[i].name not in tnames:
                stand_ins.add(ppos[i].name)
                tpos.append(t)
            continue
        tpos.append(t)
    for i, t in enumerate(tpos):
        if i >= len(ppos) or ppos[i].name != t.name:
            there = ppos[i].name if i < len(ppos) else "nothing"
            out[t.name] = (f"positional {i} in the twin; the port has "
                           f"{there} there")
    for t in twin:
        p = pnames.get(t.name)
        if t.kind in ("*", "**"):
            if not any(q.kind == t.kind for q in port):
                out[t.name] = f"the twin takes {t.kind}{t.name}"
            continue
        if p is None:
            out.setdefault(t.name, "the port lacks it")
            continue
        if t.kind == "kw" and p.kind != "kw":
            out[t.name] = "keyword-only in the twin, not in the port"
        if t.default is not NO_DEFAULT:
            if p.default is NO_DEFAULT:
                out.setdefault(t.name, "the twin has a default, the port "
                               "none")
            elif t.default is not UNREAD and not _same(t.default,
                                                       p.default):
                out.setdefault(t.name, f"default {t.default!r} in the "
                               f"twin, {p.default!r} in the port")
    for p in port:
        if p.kind in ("*", "**"):
            if not any(t.kind == p.kind for t in twin):
                out[p.name] = f"the port takes {p.kind}{p.name}, the " \
                              f"twin does not"
            continue
        if p.name in tnames or p.name in stand_ins or p.kind == "kw":
            continue
        i = ppos.index(p)
        if i < len(tpos) or p.default is NO_DEFAULT:
            out[p.name] = (f"port-only positional {i} must come after the "
                           f"twin's {len(tpos)} with a default, or be "
                           f"keyword-only")
    return out


def _port_callables(rel: str) -> Dict[str, List[Param]]:
    """The twin's callables of `rel` that the port has too and no
    NOT_PORTED entry covers -> the twin's parameters."""
    if not os.path.exists(os.path.join(REPO, PORT, rel)):
        return {}
    mod = port_module(rel)
    return {q: ps for q, ps in twin_callables(parse(rel)).items()
            if not excluded(f"{rel}::{q}") and resolves(mod, q)}


def check_params(rel: str) -> dict:
    """One twin module's callables against the port's: how many, the
    differences DEPARTS does not cover ("module.qualname: parameter:
    what differs") and the number it does."""
    mod = port_module(rel)
    problems, departed = [], 0
    calls = _port_callables(rel)
    for q, twin in calls.items():
        dep = DEPARTS.get(f"{rel}::{q}", {})
        for name, why in param_problems(twin, port_params(mod, q),
                                        dep).items():
            if name in dep:
                departed += 1
            else:
                problems.append(f"{mod}.{q}: {name}: {why}")
    return {"callables": len(calls), "problems": problems,
            "departed": departed}


def departs_problem(key: str) -> Optional[str]:
    """Why a DEPARTS entry is stale (None when it holds): the twin and
    the port must both have the callable, each parameter must be the
    twin's, and the port must still differ on it, with a reason."""
    rel, _, qual = key.partition("::")
    if not os.path.exists(os.path.join(TWIN_DIR, rel)):
        return f"the twin has no {rel}"
    twin = twin_callables(parse(rel)).get(qual)
    if twin is None:
        return f"the twin's {rel} has no callable {qual}"
    if qual not in _port_callables(rel):
        return f"the port has no {port_module(rel)}.{qual}"
    entry = DEPARTS[key]
    found = param_problems(twin, port_params(port_module(rel), qual), entry)
    for name, why in entry.items():
        if not why.strip():
            return f"{name}: no reason given"
        if name not in {p.name for p in twin}:
            return f"the twin's {qual} takes no {name}"
        if name not in found:
            return f"the port no longer differs on {name}"
    return None


def check() -> dict:
    """The whole comparison: counts, the missing names, the stale
    NOT_PORTED entries, the parameter problems and the stale DEPARTS
    entries."""
    mods = twin_modules()
    reps = [check_module(rel) for rel in mods]
    params = [check_params(rel) for rel in mods
              if not excluded(rel)]
    stale = {k: p for k in NOT_PORTED if (p := entry_problem(k)) is not None}
    stale_departs = {k: p for k in DEPARTS
                     if (p := departs_problem(k)) is not None}
    return {"modules": len(mods), "names": sum(r["names"] for r in reps),
            "excluded": sum(len(r["excluded"]) for r in reps),
            "missing": [n for r in reps for n in r["missing"]],
            "stale": stale,
            "callables": sum(r["callables"] for r in params),
            "departed": sum(r["departed"] for r in params),
            "param_problems": [n for r in params for n in r["problems"]],
            "stale_departs": stale_departs}


def main() -> int:
    rep = check()
    for name in rep["missing"]:
        print(f"missing: {name}")
    for key, why in rep["stale"].items():
        print(f"stale NOT_PORTED entry {key}: {why}")
    for line in rep["param_problems"]:
        print(f"parameter: {line}")
    for key, why in rep["stale_departs"].items():
        print(f"stale DEPARTS entry {key}: {why}")
    print(f"{rep['modules']} twin modules, {rep['names']} names, "
          f"{rep['excluded']} not ported by NOT_PORTED, "
          f"{len(rep['missing'])} missing, {len(rep['stale'])} stale; "
          f"{rep['callables']} callables, {rep['departed']} parameters "
          f"departed by DEPARTS, {len(rep['param_problems'])} parameter "
          f"problems, {len(rep['stale_departs'])} stale")
    return 1 if (rep["missing"] or rep["stale"] or rep["param_problems"]
                 or rep["stale_departs"]) else 0


if __name__ == "__main__":
    sys.exit(main())
