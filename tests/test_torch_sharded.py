"""Port differential: the sharded step over `torch.distributed`, on the CPU.

Two `gloo` worlds of four spawned ranks each (a `file://` rendezvous in
the test's tmp dir, no network), a flat 2 x 2 (data x val) and a
hierarchical 2 x 1 x 2 (slice x data x val) mesh, run every scenario of
`tests/torch_sharded_worker.py`: the scripted steps of
tests/test_sharded.py (the happy path, the round-skip all_reduce, the
nil-timeout round, equivocation, window rotation, two heights with the
height advance) through `make_sharded_step` on `shard_step_args`, the
driver's `step_seq`, `run_heights_fused` and config 3's closed loop, and
a dense signed height (validator 1 forged) unchunked, a row a launch
and in ragged tiles.  Rank 0 gathers each result (`gather_step_outputs`,
the driver's read-outs) and every one is held leaf for leaf against the
port's unsharded run; the sharded `step_seq` also against JAX
`make_sharded_step_seq` on the 2 x 2 virtual CPU mesh of
tests/conftest.py.  The collective census is pinned: all_reduces on
`val` only (two a step, and the dense step's rejected count), none on
`data` or `slice`, chunked as many as unchunked.
"""

import time

import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_sharded_worker as W
from agnes_tpu_torch.core.state_machine import Step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KINDS = ("flat", "hier")
JOIN_S = 240


def _spawn(tmp, kind):
    d = tmp / kind
    d.mkdir()
    ctx = mp.start_processes(
        W.run_world, args=(4, str(d / "rendezvous"), str(d / "out.npz"),
                           kind),
        nprocs=4, join=False, start_method="spawn")
    return ctx, d / "out.npz"


def _join(ctx, deadline):
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"a gloo world did not finish in {JOIN_S} s")
    assert not any(p.is_alive() for p in ctx.processes)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{kind: the gathered results of its world}: both worlds run at
    once, each join bounded."""
    tmp = tmp_path_factory.mktemp("gloo")
    started = {k: _spawn(tmp, k) for k in KINDS}
    deadline = time.monotonic() + JOIN_S
    out = {}
    for kind, (ctx, path) in started.items():
        _join(ctx, deadline)
        out[kind] = dict(np.load(path))
    return out


@pytest.fixture(scope="module")
def reference():
    """Every scenario on one device (the dense height unchunked)."""
    return W.run_all(None, chunks=(None,))


SCENARIOS = (list(W.SCRIPTS) + list(W.DRIVES)
             + [f"dense_chunk_{c}" for c in W.DENSE_CHUNKS])


def _leaves(res, name):
    p = name + "/"
    return {k[len(p):]: v for k, v in res.items() if k.startswith(p)}


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_equals_unsharded(worlds, reference, kind, name):
    ref_name = "dense_chunk_None" if name.startswith("dense") else name
    got, want = _leaves(worlds[kind], name), _leaves(reference, ref_name)
    assert want and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _census(res, name):
    out = {}
    for k, v in res.items():
        if k.startswith(f"census/{name}/"):
            _, _, entry, axis = k.split("/")
            out.setdefault(entry, {})[axis] = int(v)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_collectives_are_val_all_reduces_only(worlds, kind):
    res = worlds[kind]
    axes = {"data", "val", "other"} | ({"slice"} if kind == "hier" else set())
    steps = {name: len(script) for name, (script, _) in W.SCRIPTS.items()}
    want = {**{n: {"make_sharded_step": 2 * k} for n, k in steps.items()},
            "step_seq": {"make_sharded_step_seq": 2 * len(W.JAX_PHASES)},
            "run_heights_fused": {"make_sharded_honest_heights": 2 * 3 * 3},
            # run_nil_round 5 steps + run_proposed_round 4: two a step
            "closed_loop": {"make_sharded_step": 2 * 9}}
    # the entry step (2), then one dense dispatch of P = 2 phases: two a
    # phase and the rejected count, whatever the tile
    for c in W.DENSE_CHUNKS:
        want[f"dense_chunk_{c}"] = {"make_sharded_step": 2,
                                    "make_sharded_step_seq_signed": 5}
    for name, entries in want.items():
        got = _census(res, name)
        if name in steps:
            got = {"make_sharded_step": got["step"]}
        assert set(got) == set(entries), name
        for entry, n_val in entries.items():
            c = got[entry]
            assert set(c) == axes, (name, c)
            assert c["val"] == n_val, (name, entry, c)
            assert all(c[a] == 0 for a in axes - {"val"}), (name, c)


def test_sharded_step_seq_equals_jax_sharded_step_seq(worlds):
    """The flat world's driver step_seq against the JAX driver on its
    2 x 2 virtual CPU mesh (make_sharded_step_seq)."""
    import jax

    from agnes_tpu.harness.device_driver import DeviceDriver as JDriver
    from agnes_tpu.parallel import make_mesh as jmake_mesh

    if len(jax.devices()) < 4:
        pytest.fail("tests/conftest.py's virtual CPU mesh is missing")
    j = JDriver(8, 8, mesh=jmake_mesh(2, 2))
    j.step_seq([j.phase(r, t, s) for r, t, s in W.JAX_PHASES])
    j.block_until_ready()
    got = _leaves(worlds["flat"], "step_seq")
    for part in ("state", "tally"):
        jt = getattr(j, part)
        for f, x in zip(jt._fields, jt):
            np.testing.assert_array_equal(got[f"{part}.{f}"], np.asarray(x),
                                          err_msg=f"{part}.{f}")
    for f in ("decided", "decision_value", "decision_round"):
        np.testing.assert_array_equal(got[f"stats.{f}"],
                                      getattr(j.stats, f), err_msg=f)
    assert got["stats.counts"][2] == j.stats.decisions_total


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_outcomes(worlds, kind):
    """What the scenarios must decide, read from the gathered results."""
    res = worlds[kind]
    hp = _leaves(res, "happy_path")
    assert (hp["2.state.step"] == int(Step.COMMIT)).all()
    assert (_leaves(res, "round_skip")["0.state.round"] == 2).all()
    eq = _leaves(res, "equivocation")["2.tally.equiv"]
    assert eq[:, [0, 3]].all() and not eq[:, [1, 2]].any()
    wr = _leaves(res, "window_rotation")
    assert (wr["4.state.round"] == 5).all() and (wr["4.tally.base_round"]
                                                 == 4).all()
    assert (_leaves(res, "multi_height")["5.state.height"] == 2).all()
    for c in W.DENSE_CHUNKS:
        dense = _leaves(res, f"dense_chunk_{c}")
        assert dense["stats.decided"].all()
        assert dense["stats.counts"][3] == 2 * W.I_DENSE      # rejected
    assert _leaves(res, "closed_loop")["stats.decided"].all()
