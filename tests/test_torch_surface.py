"""The port's public surface against the JAX package's, name for name
and parameter for parameter (`agnes_tpu_torch/scripts/surface.py`).

The JAX package is read as source text with `ast`, never imported.  One
case a package `__init__.py` (the names it imports, its `__all__`, the
keys of its lazy maps), one a module (its public functions and classes
and their public methods): each name must resolve in `agnes_tpu_torch`
at the same relative path, by import and `hasattr`, or stand in
`surface.NOT_PORTED` with its reason.  One case a `NOT_PORTED` entry:
the twin has its place, the port has not, and the reason is stated.
One case a module's parameters: every callable both packages have takes
the twin's parameters (order, keyword-only names, literal defaults,
`*args` / `**kwargs`), or the difference stands in `surface.DEPARTS`;
one case a `DEPARTS` entry: the twin has the parameter and the port
still differs on it.
"""

import pytest

from agnes_tpu_torch.scripts import surface

MODULES = surface.twin_modules()
PACKAGES = [m for m in MODULES if m.endswith("__init__.py")]
PLAIN = [m for m in MODULES if not m.endswith("__init__.py")]


@pytest.mark.parametrize("rel", PACKAGES)
def test_package_exports_resolve_in_the_port(rel):
    rep = surface.check_module(rel)
    assert rep["missing"] == [], rep


@pytest.mark.parametrize("rel", PLAIN)
def test_module_names_resolve_in_the_port(rel):
    rep = surface.check_module(rel)
    assert rep["missing"] == [], rep


@pytest.mark.parametrize("key", sorted(surface.NOT_PORTED))
def test_not_ported_entry_holds(key):
    assert surface.entry_problem(key) is None


def test_only_the_bench_entry_names_wait():
    """No NOT_PORTED entry waits for the bench entry: RunConfig and the
    budget's deadline half are ported, and the bench entry itself is no
    name of the twin package."""
    waiting = sorted(k for k, why in surface.NOT_PORTED.items()
                     if "bench" in why.lower())
    assert waiting == []
    for key in ("utils/config.py::RunConfig",
                "utils/budget.py::deadline_margin_s",
                "utils/budget.py::install_deadline_signals"):
        assert surface.excluded(key) is None
        rel, _, name = key.partition("::")
        assert surface.resolves(surface.port_module(rel), name)


def test_collector_reads_imports_all_and_lazy_maps():
    """The collector sees each way a twin package offers a name, with
    the place it comes from."""
    def names(rel):
        return surface.package_names(rel, surface.parse(rel))

    bridge = names("bridge/__init__.py")
    assert bridge["VoteBatcher"] == "bridge/ingest.py::VoteBatcher"   # map
    assert bridge["SlotMap"] == "bridge/value_table.py::SlotMap"     # import
    assert bridge["make_lazy_getattr"] == "utils/lazy.py::make_lazy_getattr"
    utils = names("utils/__init__.py")
    assert utils["save_driver"] == "utils/checkpoint.py::save_driver"  # comp
    assert names("harness/__init__.py")["DeviceDriver"] == \
        "harness/device_driver.py::DeviceDriver"
    assert names("distributed/__init__.py")["fetch_local_block"] == \
        "distributed/driver.py::fetch_local_block"
    crypto = names("crypto/__init__.py")
    assert crypto["host_sign"] == "crypto/__init__.py::host_sign"     # def
    assert len(PACKAGES) == 11 and "types.py" in PLAIN
    assert "BlsClassTable.pending_shares" in surface.module_names(
        surface.parse("serve/bls_lane.py"))
    assert surface.excluded("utils/config.py::RunConfig.from_args") is None
    assert surface.excluded("crypto/msm_jax.py::verify_batch_msm_jit")
    assert surface.excluded("serve/bls_lane.py::BlsLane.poll") is None


PORTED = [m for m in MODULES if not surface.excluded(m)]


@pytest.mark.parametrize("rel", PORTED)
def test_module_parameters_match_the_twin(rel):
    rep = surface.check_params(rel)
    assert rep["problems"] == [], rep


@pytest.mark.parametrize("key", sorted(surface.DEPARTS))
def test_departs_entry_holds(key):
    assert surface.departs_problem(key) is None


P = surface.Param
NO = surface.NO_DEFAULT


@pytest.mark.parametrize("twin, port, want", [
    # the twin's 4th positional lands elsewhere in the port
    ([P("a", "pos", NO), P("heights", "pos", None), P("n", "pos", 4)],
     [P("a", "pos", NO), P("n", "pos", 4), P("device", "pos", "cuda")],
     {"heights", "n", "device"}),
    # the same with the port's extra keyword-only: closed
    ([P("a", "pos", NO), P("heights", "pos", None)],
     [P("a", "pos", NO), P("heights", "pos", None),
      P("device", "kw", "cuda")], set()),
    # a port-only positional with no default
    ([P("n", "pos", NO)], [P("n", "pos", NO), P("device", "pos", NO)],
     {"device"}),
    # keyword-only in the twin, positional in the port
    ([P("a", "pos", NO), P("clock", "kw", surface.UNREAD)],
     [P("a", "pos", NO), P("clock", "pos", None)], {"clock"}),
    # a different literal default; a missing default; an unread one
    ([P("x", "pos", 1.0), P("y", "pos", None), P("z", "pos",
                                                 surface.UNREAD)],
     [P("x", "pos", 1), P("y", "pos", NO), P("z", "pos", object())],
     {"x", "y"}),
    # **kwargs on one side only
    ([P("a", "pos", NO)], [P("a", "pos", NO), P("kw", "**", NO)], {"kw"}),
    ([P("a", "pos", NO), P("kw", "**", NO)], [P("a", "pos", NO)], {"kw"}),
])
def test_param_problems_find_each_kind_of_difference(twin, port, want):
    assert set(surface.param_problems(twin, port)) == want


def test_departed_parameter_leaves_the_order_or_is_renamed():
    """A departed twin parameter the port lacks is dropped from the
    twin's order (no cascade), or, with a port-only parameter in its
    place, renamed; either way only it is reported."""
    twin = [P("a", "pos", NO), P("donate", "pos", True),
            P("tick", "pos", None)]
    dropped = [P("a", "pos", NO), P("tick", "pos", None)]
    assert set(surface.param_problems(twin, dropped,
                                      {"donate": "x"})) == {"donate"}
    assert set(surface.param_problems(twin, dropped)) == {"donate", "tick"}
    renamed = [P("a", "pos", NO), P("device_type", "pos", "cuda"),
               P("tick", "pos", None)]
    assert set(surface.param_problems(twin, renamed,
                                      {"donate": "x"})) == {"donate"}


def test_twin_callables_read_functions_methods_and_fields():
    calls = surface.twin_callables(surface.parse("bridge/ingest.py"))
    names = [p.name for p in calls["VoteBatcher.__init__"]]
    assert names[:4] == ["n_instances", "n_validators", "n_slots",
                         "heights"]
    fields = surface.twin_callables(surface.parse("utils/config.py"))
    assert [p.name for p in fields["RunConfig"]][:2] == ["n_validators",
                                                         "n_instances"]
    assert fields["RunConfig"][0].default == 1000
    assert fields["RunConfig"][5].default is surface.UNREAD   # timeouts
    tick = surface.twin_callables(surface.parse("distributed/elastic.py"))
    assert [p.name for p in tick["ElasticShard.tick"]] == ["now",
                                                           "boundary"]
