"""Port differential: the dense tally (`agnes_tpu_torch.device.tally`)
against `agnes_tpu.device.tally`, leaf for leaf.  Seeded random phase
streams cover dedup, equivocation (a validator re-voting another slot),
out-of-window rounds on both sides, invalid slots, weighted powers,
round skips, window rotation and the threshold re-query.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agnes_tpu.device import tally as jt
from agnes_tpu_torch.convert import array_from_jax, tally_from_jax, to_numpy
from agnes_tpu_torch.device import tally as tt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V, W, S = 8, 8, 4, 4

_jadd = jax.jit(jt.add_votes)
_jcur = jax.jit(jt.current_threshold)
_jrot = jax.jit(jt.rotate_window)


def _t(x):
    return array_from_jax(np.asarray(x), "cpu")


def _assert_tree(jax_tree, port_tree, what):
    for name, j, t in zip(jax_tree._fields, jax_tree, to_numpy(port_tree)):
        np.testing.assert_array_equal(np.asarray(j), t,
                                      err_msg=f"{what}.{name}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_phase_stream_vs_jax(seed):
    rng = np.random.RandomState(seed)
    cfg = jt.TallyConfig(n_validators=V, n_rounds=W, n_slots=S)
    jtal = jt.TallyState.new(I, cfg)
    ttal = tally_from_jax([np.asarray(x) for x in jtal], "cpu")
    powers = rng.randint(1, 6, V).astype(np.int32)
    total = np.int32(powers.sum())
    cur = np.zeros(I, np.int32)
    n_events = n_equiv = 0
    for step in range(24):
        base = np.asarray(jtal.base_round)
        round_idx = (base + rng.randint(-1, W + 2, I)).astype(np.int32)
        typ = rng.randint(0, 2, I).astype(np.int32)
        # mostly valid slots, some nil, some invalid (-2 and >= S)
        slots = rng.choice([-2, -1, 0, 0, 1, 1, 2, 3, S, S + 1],
                           (I, V)).astype(np.int32)
        mask = rng.rand(I, V) < 0.7
        cur = np.maximum(cur, (base + rng.randint(0, 2, I))).astype(np.int32)
        jtal, jev = _jadd(jtal, jnp.asarray(powers), jnp.asarray(total),
                          jnp.asarray(round_idx), jnp.asarray(typ),
                          jnp.asarray(slots), jnp.asarray(mask),
                          jnp.asarray(cur))
        ttal, tev = tt.add_votes(ttal, _t(powers), _t(total), _t(round_idx),
                                 _t(typ), _t(slots), _t(mask), _t(cur))
        _assert_tree(jtal, ttal, f"step{step}.tally")
        _assert_tree(jev, tev, f"step{step}.events")
        n_events += int((np.asarray(jev.tag) >= 0).sum())
        n_equiv = int(np.asarray(jtal.equiv).sum())

        q_round = (base + rng.randint(-1, W + 1, I)).astype(np.int32)
        q_typ = rng.randint(0, 2, I).astype(np.int32)
        jc = _jcur(jtal, jnp.asarray(q_round), jnp.asarray(q_typ),
                   jnp.asarray(total))
        tc = tt.current_threshold(ttal, _t(q_round), _t(q_typ), _t(total))
        for j, t in zip(jc, tc):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())

        if step % 3 == 2:
            new_base = (base + rng.randint(0, 3, I)).astype(np.int32)
            jtal = _jrot(jtal, jnp.asarray(new_base))
            ttal = tt.rotate_window(ttal, _t(new_base))
            _assert_tree(jtal, ttal, f"step{step}.rotated")
    # the stream must have exercised what it claims to
    assert n_events > 0 and n_equiv > 0


def test_thresh_code_first_occurrence_ties():
    """Two slots over quorum with equal weight (adversarial, identity-free
    stream): both pick the FIRST slot, as jnp.argmax does."""
    rows = np.array([[0, 7, 7, 0, 0], [9, 0, 0, 0, 0], [2, 3, 2, 0, 0],
                     [0, 0, 7, 7, 7]], np.int32)
    total = np.int32(9)
    jc, jv = jt._thresh_code(jnp.asarray(rows), jnp.asarray(total))
    tc, tv = tt._thresh_code(_t(rows), _t(total))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert tv.tolist() == [0, -1, -1, 1]
