"""Port differential: the verify-chunk planner (`agnes_tpu_torch.utils.
budget`) against its JAX twin (`agnes_tpu.utils.budget`).

Given the twin's workspace constant, the port's `plan_lane_verify`
returns the twin's `VerifyPlan` field for field, over a grid that holds
the north-star shape (2 x 10,000 x 1,000 = 20,000,000 packed lanes, and
20,480,000 as an extra point) at 16, 40 and 80 GiB, and both raise
BudgetError where the twin does.  With the port's own constant the
north-star height fits an 80 GB card in one chunk and takes two under
half of it.  The dense planner (`dense_resident_bytes`,
`plan_dense_verify`, its BudgetError) and `mesh_local_shape` (with the
pod's `n_hosts` and `n_live`) equal the twin's over a small grid, the
mesh read through its axis names and sizes; with the port's own dense
workspace the north-star dense height is one tile on an 80 GB card and
several under half of it.  Pure arithmetic: no tensor is made.
"""

import dataclasses
import types

import pytest

from agnes_tpu.utils import budget as jb
from agnes_tpu_torch.utils import budget as tb

GIB = 1 << 30
TWIN_WS = jb.VERIFY_WORKSPACE_LANE_BYTES


def _same(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.peak_bytes, t.chunked, t.fits(), t.describe()) == (
        j.peak_bytes, j.chunked, j.fits(), j.describe())


@pytest.mark.parametrize("hbm", [16 * GIB, 40 * GIB, 80 * GIB,
                                 79 * GIB + 12345])
@pytest.mark.parametrize("n_lanes,nb", [
    (1, 1), (4096, 1), (2_048_000, 1), (2_048_000, 2), (20_480_000, 1),
    (2 * 10_000 * 1_000, 1), (2 * 10_000 * 1_000 + 17, 1),
    (2 * 10_000 * 1_000, 2)])
def test_lane_plan_equals_twin(n_lanes, nb, hbm):
    _same(tb.plan_lane_verify(n_lanes, n_blocks=nb, hbm_bytes=hbm,
                              workspace_lane_bytes=TWIN_WS),
          jb.plan_lane_verify(n_lanes, n_blocks=nb, hbm_bytes=hbm))


def test_north_star_plans_chunk_at_both_budgets():
    for hbm in (16 * GIB, 80 * GIB):
        p = tb.plan_lane_verify(20_480_000, hbm_bytes=hbm,
                                workspace_lane_bytes=TWIN_WS)
        assert p.chunked and p.fits() and p.resident_bytes == \
            20_480_000 * 512
    # at 80 GiB the twin's constant gives a tile of 4,194,304 lanes
    assert tb.plan_lane_verify(20_480_000, hbm_bytes=80 * GIB,
                               workspace_lane_bytes=TWIN_WS).n_chunks == 5


@pytest.mark.parametrize("call", [
    lambda m: m.plan_lane_verify(32_000_000, hbm_bytes=16 * GIB),
    lambda m: m.plan_lane_verify(1, hbm_bytes=100),
    lambda m: m.plan_lane_verify(2 * 10_000 * 1_000, hbm_bytes=4 * GIB),
    lambda m: m.plan_lane_verify(2 * 10_000 * 1_000, n_blocks=8,
                                 hbm_bytes=16 * GIB),
], ids=["lanes-resident", "lanes-tiny", "north-star-4gib",
        "north-star-8-blocks"])
def test_budget_errors_match_twin(call):
    with pytest.raises(jb.BudgetError):
        call(jb)
    with pytest.raises(tb.BudgetError):
        call(tb)


@pytest.mark.parametrize("call", [
    lambda m: m.plan_lane_verify(0, hbm_bytes=GIB),
    lambda m: m.plan_lane_verify(-1, hbm_bytes=GIB),
], ids=["zero", "negative"])
def test_empty_shapes_raise_value_error(call):
    with pytest.raises(ValueError):
        call(jb)
    with pytest.raises(ValueError):
        call(tb)


def test_no_budget_on_the_cpu():
    with pytest.raises(ValueError):
        tb.device_hbm_bytes("cpu")


def test_north_star_plan_with_the_ports_constant():
    n, card = 2 * 10_000 * 1_000, 79 * GIB   # an 80 GB H100 has 79.2 GiB
    whole = tb.plan_lane_verify(n, hbm_bytes=card)
    assert (whole.n_chunks, whole.tile) == (1, n) and whole.fits()
    half = tb.plan_lane_verify(n, hbm_bytes=card // 2)
    assert (half.n_chunks, half.tile) == (2, 1 << 24) and half.fits()


# -- the dense planner and the mesh's local shape ------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 4), (1, 1024, 1000),
                                   (2, 1024, 1000), (2, 10_000, 1000),
                                   (3, 5_000, 500)])
@pytest.mark.parametrize("nb", [1, 2])
def test_dense_resident_bytes_equals_twin(shape, nb):
    assert tb.dense_resident_bytes(*shape, n_blocks=nb) == \
        jb.dense_resident_bytes(*shape, n_blocks=nb)
    assert tb.dense_resident_bytes(*shape, n_seq_phases=5) == \
        jb.dense_resident_bytes(*shape, n_seq_phases=5)


@pytest.mark.parametrize("hbm", [16 * GIB, 40 * GIB, 80 * GIB,
                                 79 * GIB + 12345])
@pytest.mark.parametrize("shape,nb", [
    ((2, 3, 4), 1), ((1, 1024, 1000), 1), ((2, 1024, 1000), 1),
    ((2, 1024, 1000), 2), ((2, 10_000, 1000), 1), ((2, 5_000, 500), 1)])
def test_dense_plan_equals_twin(shape, nb, hbm):
    _same(tb.plan_dense_verify(*shape, n_blocks=nb, hbm_bytes=hbm,
                               workspace_lane_bytes=TWIN_WS),
          jb.plan_dense_verify(*shape, n_blocks=nb, hbm_bytes=hbm))


@pytest.mark.parametrize("call", [
    lambda m, **k: m.plan_dense_verify(2, 10_000, 1000, hbm_bytes=4 * GIB,
                                       **k),
    lambda m, **k: m.plan_dense_verify(2, 3, 4, hbm_bytes=100, **k),
    lambda m, **k: m.plan_dense_verify(2, 40_000, 1000,
                                       hbm_bytes=16 * GIB, **k),
], ids=["north-star-4gib", "tiny", "resident"])
def test_dense_budget_errors_match_twin(call):
    with pytest.raises(jb.BudgetError):
        call(jb)
    with pytest.raises(tb.BudgetError):
        call(tb, workspace_lane_bytes=TWIN_WS)
    with pytest.raises(tb.BudgetError):
        call(tb)


def test_dense_empty_shape_raises_value_error():
    for m in (jb, tb):
        with pytest.raises(ValueError):
            m.plan_dense_verify(2, 0, 4, hbm_bytes=GIB)


def test_north_star_dense_plan_with_the_ports_workspace():
    card = 79 * GIB
    whole = tb.plan_dense_verify(2, 10_000, 1000, hbm_bytes=card)
    assert (whole.n_chunks, whole.tile) == (1, 10_000) and whole.fits()
    half = tb.plan_dense_verify(2, 10_000, 1000, hbm_bytes=card // 2)
    assert half.n_chunks >= 2 and half.fits()
    # a lane of a tile: the measured workspace, the tile's sig and block
    # copy, and the pub broadcast
    assert half.chunk_bytes == half.lanes_per_chunk * (
        tb.VERIFY_WORKSPACE_LANE_BYTES + tb.SIG_LANE_BYTES
        + tb.BLOCK_LANE_BYTES + tb.PUB_LANE_BYTES)


def _meshes():
    """(port mesh, twin mesh) pairs: the port's read through its axis
    names and sizes, as a DeviceMesh gives them; the twin's a JAX Mesh
    on the virtual CPU devices."""
    import jax

    from agnes_tpu.parallel import mesh as jm

    devs = jax.devices()

    def pair(names, shape):
        return (types.SimpleNamespace(mesh_dim_names=names, shape=shape),
                jm.make_hierarchical_mesh(*shape, devices=devs)
                if len(shape) == 3 else jm.make_mesh(*shape, devices=devs))

    return [pair(("data", "val"), (2, 2)), pair(("data", "val"), (4, 2)),
            pair(("data", "val"), (1, 4)),
            pair(("slice", "data", "val"), (2, 2, 2)),
            pair(("slice", "data", "val"), (2, 1, 2))]


@pytest.mark.parametrize("hosts", [(1, None), (2, None), (2, 1), (2, 2),
                                   (4, 2), (3, 1), (2, 3)])
def test_mesh_local_shape_equals_twin(hosts):
    n_hosts, n_live = hosts
    assert tb.mesh_local_shape(None, 10, 7) == jb.mesh_local_shape(
        None, 10, 7) == (10, 7)
    for tm, jmesh in _meshes():
        for I, V in ((1024, 1000), (10_000, 1000), (96, 8)):
            try:
                want = jb.mesh_local_shape(jmesh, I, V, n_hosts=n_hosts,
                                           n_live=n_live)
            except ValueError:
                with pytest.raises(ValueError):
                    tb.mesh_local_shape(tm, I, V, n_hosts=n_hosts,
                                        n_live=n_live)
                continue
            assert tb.mesh_local_shape(tm, I, V, n_hosts=n_hosts,
                                       n_live=n_live) == want
