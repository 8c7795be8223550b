"""The port's layout microbenchmark against the JAX script.

`chain_plain` (the plain version of `csrc/fe13_chain.cu`) against the
JAX `_chain_kernel` run through `pl.pallas_call(..., interpret=True)`
on both layouts, exact; the port's `_fe_mul` against the JAX `_fe_mul`
on limbs whose columns wrap int32, exact; the script's CPU path at a
tiny size.  The JAX chain runs at `N_CHAIN = 2`: the interpreter takes
seconds a round on this shape (the kernel itself runs the script's 64
and 128 on the card, `chip_smoke.py` phase 2d).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from agnes_tpu_torch.scripts import microbench_layout as mb
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_microbench_layout", ROOT / "scripts" / "microbench_layout.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape,block", [((20, 256), (20, 128)),
                                         ((20, 2, 128), (20, 1, 128))])
def test_chain_plain_matches_jax_chain_kernel(jax_script, monkeypatch,
                                              shape, block):
    n_chain = 2
    monkeypatch.setattr(jax_script, "N_CHAIN", n_chain)
    x, y = mb.row_inputs(shape, seed=5)
    nb = len(block) - 1
    spec = pl.BlockSpec(block, lambda g: (0, g) + (0,) * (nb - 1))
    f = pl.pallas_call(jax_script._chain_kernel,
                       grid=(shape[1] // block[1],), in_specs=[spec, spec],
                       out_specs=spec,
                       out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
                       interpret=True)
    want = np.asarray(f(jnp.asarray(x), jnp.asarray(y)))
    got = mb.chain(torch.from_numpy(x), torch.from_numpy(y), n_chain)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fe_mul_matches_jax_where_columns_wrap(jax_script):
    x, y = mb.wrap_inputs((20, 64), seed=6)
    # the columns overflow int32: 20 products of limbs near 2^15
    assert (x.astype(np.int64) * y).max() * 20 > 2**31
    want = np.asarray(jax.jit(jax_script._fe_mul)(jnp.asarray(x),
                                                  jnp.asarray(y)))
    got = mb.fe_mul(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    # and on the whole int32 range, chained
    rng = np.random.RandomState(7)
    a, b = (rng.randint(-2**31, 2**31, (20, 32), np.int64).astype(np.int32)
            for _ in range(2))
    want = jax.jit(jax_script._fe_mul)(jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(jax.jit(jax_script._fe_mul)(want, jnp.asarray(b)))
    got = mb.fe_mul(mb.fe_mul(torch.from_numpy(a), torch.from_numpy(b)),
                    torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_main_cpu_path_at_a_tiny_size(capsys):
    rows = mb.main(["--device", "cpu", "--lanes", "2048", "--n-chain", "1",
                    "--iters", "1"])
    out = capsys.readouterr().out
    assert [r["label"] for r in rows] == [
        "A [20,512] sublane", "A [20,1024] sublane",
        "B [20,8,128] vreg-plane", "B [20,16,128] vreg-plane",
        "A [20,512] 2x chain", "B [20,8,128] 2x chain"]
    assert [r["n_chain"] for r in rows] == [1, 1, 1, 1, 2, 2]
    assert [r["block_lanes"] for r in rows] == [512, 1024, 1024, 2048,
                                                512, 1024]
    assert all(r["lanes"] == 2048 and r["device"] == "cpu"
               and "bound_ms" not in r for r in rows)
    assert out.count("ns/mul/lane") == 6 and "no card bound" in out
    assert mb.LAUNCHES == 0          # the plain version ran, not the kernel


def test_chain_wrapper_refuses_bad_input_and_counts_products():
    x = torch.zeros((20, 8), dtype=torch.int32)
    for bad in (x.long(), x[:19], x[0]):
        with pytest.raises(ValueError):
            mb.chain(bad, bad)
    with pytest.raises(ValueError):
        mb.chain(x, x, n_chain=-1)
    assert mb.PRODUCTS_PER_FE_MUL == 20 * 20 + 20 + 4
    assert mb.least_products(16384, 64) == 16384 * 64 * 4 * 424
    src = (ROOT / "agnes_tpu_torch" / "csrc" / "fe13_chain.cu").read_text()
    for const in ("kN = 20;", "kBits = 13;", "kMask = 8191;",
                  "kFold = 608;", "kHiPasses = 3;", "kCarryPasses = 4;",
                  "kPar = 4;"):
        assert const in src, const
