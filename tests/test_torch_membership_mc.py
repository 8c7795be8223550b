"""Port differential: the pod-membership model checker against the JAX
twin, on the CPU.

`agnes_tpu_torch.analysis.membership_mc` (over the port's
`distributed/membership.py`) held against
`agnes_tpu.analysis.membership_mc`: the tiny scope exhaustively, visited
digest sets included, and the first 3,000 states of each smoke config;
the mutation self-test's records; every membership corpus entry
replayed to the twin's canonical form and digest; the emitter against
the committed corpus, byte for byte.  And the device-plane leg: along
every repartition a corpus entry's honest replay crossed, seeded global
leaves shaped by the port's own `seq_specs()` / `dense_lane_specs()`
trees are cut into per-host blocks on the old partition, re-lifted with
the port's `relift_tree` onto the new one (equal to the twin's
`relift_tree` on the same blocks, leaf for leaf), and assemble to the
same global leaves, both ways.
"""

import os

import numpy as np
import pytest

from agnes_tpu.analysis import membership_mc as jmm
from agnes_tpu.distributed import membership as jdm
from agnes_tpu_torch.analysis import membership_mc as tmm
from agnes_tpu_torch.analysis import modelcheck as tmc
from agnes_tpu_torch.distributed import membership as tdm
from agnes_tpu_torch.parallel import sharded as ts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "corpus",
                          "membership")
CORPUS = tmc.load_corpus(CORPUS_DIR)
SEED = 20261018


def _digests(rep):
    return rep.states, rep.transitions, rep.complete, rep.digests


@pytest.mark.parametrize("scope,max_states", [("tiny", None),
                                              ("smoke", 3000)])
def test_membership_scope_explore_equals_twin(scope, max_states):
    pairs = list(zip(tmm.MEMBERSHIP_SCOPES[scope],
                     jmm.MEMBERSHIP_SCOPES[scope]))
    assert len(pairs) == len(jmm.MEMBERSHIP_SCOPES[scope])
    for cfg, twin_cfg in pairs:
        assert cfg.to_json() == twin_cfg.to_json()
        got = tmm.explore_membership(cfg, max_states=max_states,
                                     collect_digests=True)
        want = jmm.explore_membership(twin_cfg, max_states=max_states,
                                      collect_digests=True)
        assert _digests(got) == _digests(want), cfg.name
        assert not got.violations
        assert got.complete == (max_states is None)


def test_self_test_membership_equals_twin():
    got = tmm.self_test_membership()
    assert set(got) == set(tmm.MEMBERSHIP_MUTANTS)
    assert got == jmm.self_test_membership()


@pytest.mark.parametrize("entry", CORPUS, ids=lambda e: e["name"])
def test_membership_entry_replays_to_twin_digest(entry):
    sys_, viols = tmm.replay_membership_entry(entry)
    twin, twin_viols = jmm.replay_membership_entry(entry)
    assert [v.property for v in viols] == [v.property for v in twin_viols]
    assert sys_.mc_canonical() == twin.mc_canonical()
    assert sys_.mc_digest() == twin.mc_digest()


def test_emit_membership_corpus_byte_for_byte(tmp_path):
    written = tmm.emit_membership_corpus(str(tmp_path))
    assert sorted(os.path.basename(p) for p in written) == \
        sorted(os.listdir(CORPUS_DIR))
    for p in written:
        with open(p, "rb") as a, \
                open(os.path.join(CORPUS_DIR, os.path.basename(p)),
                     "rb") as b:
            assert a.read() == b.read(), p


def _spec_leaves():
    """The port's step-sequence and dense-lane specs, flat, with the
    instance axis of each (None for a replicated leaf)."""
    specs = []
    for x in (*ts.seq_specs(), ts.dense_lane_specs()):
        specs.extend(x if hasattr(x, "_fields") else [x])
    axes = [tdm.instance_axis_of(s) for s in specs]
    assert any(a is not None for a in axes)      # instance-dim leaves
    assert any(a is None for a in axes)          # replicated leaves
    return specs, axes


@pytest.mark.parametrize(
    "entry", [e for e in CORPUS if e["expect"]["repartitions"]],
    ids=lambda e: e["name"])
def test_corpus_repartitions_relift_the_port_spec_trees(entry):
    specs, axes = _spec_leaves()
    n = entry["config"]["n_instances"]
    rng = np.random.default_rng(SEED)
    for rep in entry["expect"]["repartitions"]:
        old = {h: (lo, hi) for h, lo, hi in rep["old"]}
        new = {h: (lo, hi) for h, lo, hi in rep["new"]}
        globals_ = []
        for k, (spec, ax) in enumerate(zip(specs, axes)):
            shape = [2 + (k + d) % 3 for d in range(max(len(spec), 1))]
            if ax is not None:
                shape[ax] = n
            globals_.append(rng.integers(0, 2**31, size=shape))
        blocks = {h: [g if ax is None else
                      np.ascontiguousarray(np.take(g, np.arange(lo, hi),
                                                   axis=ax))
                      for g, ax in zip(globals_, axes)]
                  for h, (lo, hi) in old.items()}
        out = tdm.relift_tree(blocks, old, new, axes)
        twin = jdm.relift_tree(blocks, old, new, axes)
        assert set(out) == set(new) == set(twin)
        for h in new:
            for a, b in zip(out[h], twin[h]):
                np.testing.assert_array_equal(a, b)
        for k, (g, ax) in enumerate(zip(globals_, axes)):
            if ax is None:
                for h in new:
                    np.testing.assert_array_equal(out[h][k], g)
                continue
            assembled = np.empty_like(g)
            for h, (lo, hi) in new.items():
                sel = [slice(None)] * g.ndim
                sel[ax] = slice(lo, hi)
                assembled[tuple(sel)] = out[h][k]
            np.testing.assert_array_equal(assembled, g)
        back = tdm.relift_tree(out, new, old, axes)
        for h in old:
            for a, b in zip(back[h], blocks[h]):
                np.testing.assert_array_equal(a, b)
