"""The port's public surface against the JAX package's, name for name
(`agnes_tpu_torch/scripts/surface.py`).

The JAX package is read as source text with `ast`, never imported.  One
case a package `__init__.py` (the names it imports, its `__all__`, the
keys of its lazy maps), one a module (its public functions and classes
and their public methods): each name must resolve in `agnes_tpu_torch`
at the same relative path, by import and `hasattr`, or stand in
`surface.NOT_PORTED` with its reason.  One case a `NOT_PORTED` entry:
the twin has its place, the port has not, and the reason is stated.
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
    waiting = sorted(k for k, why in surface.NOT_PORTED.items()
                     if why == surface.BENCH)
    assert waiting == ["utils/budget.py::deadline_margin_s",
                       "utils/budget.py::install_deadline_signals",
                       "utils/config.py::RunConfig"]


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
    assert surface.excluded("utils/config.py::RunConfig.from_args") == \
        surface.BENCH
    assert surface.excluded("crypto/msm_jax.py::verify_batch_msm_jit")
    assert surface.excluded("serve/bls_lane.py::BlsLane.poll") is None
