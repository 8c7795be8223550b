"""Port differential: the host plane (`agnes_tpu_torch.core.validators`,
`core.vote_executor`, `core.executor`, `harness.simulator`, the executor
snapshot of `utils.checkpoint`) against the JAX package's jax-free twins.

Validator sets and proposer rotations for seeded power vectors, a seeded
vote stream through `VoteExecutor`, signed 4-node networks (honest and
each Byzantine behaviour) whose outboxes must be the twin's byte for
byte, signatures included, the partition/heal drill, and an executor
snapshot that must be the twin's JSON document and whose restored node
must catch up and decide the twin's value.
"""

import dataclasses
import json

import numpy as np
import pytest

from agnes_tpu.core import executor as jex
from agnes_tpu.core import validators as jval
from agnes_tpu.core import vote_executor as jvx
from agnes_tpu.harness import simulator as jsim
from agnes_tpu.types import Vote as JVote
from agnes_tpu.types import VoteType as JVoteType
from agnes_tpu.utils import checkpoint as jck
from agnes_tpu_torch.core import executor as ex
from agnes_tpu_torch.core import validators as val
from agnes_tpu_torch.core import vote_executor as vx
from agnes_tpu_torch.harness import simulator as sim
from agnes_tpu_torch.types import Vote, VoteType
from agnes_tpu_torch.utils import checkpoint as ck


def _fields(x):
    return None if x is None else dataclasses.astuple(x)


def _sets(seed, n):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32) for _ in range(n)]
    powers = [int(p) for p in rng.integers(0, 50, n)]
    keys.append(keys[0])              # a duplicate address: latest wins
    powers.append(7)
    return (val.ValidatorSet([val.Validator(k, p)
                              for k, p in zip(keys, powers)]),
            jval.ValidatorSet([jval.Validator(k, p)
                               for k, p in zip(keys, powers)]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validator_set_and_rotation_equal_the_twin(seed):
    mine, theirs = _sets(seed, 9)
    assert [(v.public_key, v.voting_power) for v in mine] == \
        [(v.public_key, v.voting_power) for v in theirs]
    assert mine.hash() == theirs.hash()
    assert mine.total_power == theirs.total_power
    for a, b in zip(mine.device_arrays(), theirs.device_arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(
        val.proposer_table(mine, 5, 6, start_height=2),
        jval.proposer_table(theirs, 5, 6, start_height=2))
    rm, rt = val.ProposerRotation(mine), jval.ProposerRotation(theirs)
    seq = [(rm.step(), rt.step()) for _ in range(40)]
    assert all(a == b for a, b in seq)
    # mutation keeps both sets and rotations in step
    for s in (mine, theirs):
        s.remove(s[3].address)
    assert [rm.step() for _ in range(10)] == [rt.step() for _ in range(10)]


@pytest.mark.parametrize("edge", [False, True])
def test_vote_stream_events_and_equivocations_equal_the_twin(edge):
    rng = np.random.default_rng(5)
    n = 7
    powers = [int(p) for p in rng.integers(1, 6, n)]
    total = sum(powers)
    mine = vx.VoteExecutor(height=3, total_weight=total, edge_triggered=edge)
    theirs = jvx.VoteExecutor(height=3, total_weight=total,
                              edge_triggered=edge)
    got, want = [], []
    for _ in range(400):
        i, r, t = (int(rng.integers(0, n)), int(rng.integers(0, 4)),
                   int(rng.integers(0, 2)))
        value = [None, 10, 11][int(rng.integers(0, 3))]
        h = 3 if rng.random() < 0.95 else 4
        got.append(_fields(mine.apply(
            Vote(VoteType(t), r, value, validator=i, height=h), powers[i])))
        want.append(_fields(theirs.apply(
            JVote(JVoteType(t), r, value, validator=i, height=h), powers[i])))
        cur = int(rng.integers(0, 3))
        got.append(mine.check_round_skip(cur))
        want.append(theirs.check_round_skip(cur))
    assert got == want
    assert any(e is not None for e in got)
    for r in range(4):
        assert [_fields(e) for e in mine.threshold_events(r)] == \
            [_fields(e) for e in theirs.threshold_events(r)]
    eq_m = [_fields(e) for e in mine.votes.equivocations()]
    assert eq_m and eq_m == [_fields(e) for e in
                             theirs.votes.equivocations()]


def _run_pair(specs, until_height, **kw):
    """The same network on the port and on the twin, run until every
    honest node decided `until_height`."""
    mine = sim.Network(n=len(specs), specs=[sim.NodeSpec(behavior=b)
                                            for b in specs], **kw)
    theirs = jsim.Network(n=len(specs), specs=[jsim.NodeSpec(behavior=b)
                                               for b in specs], **kw)
    for net in (mine, theirs):
        net.start()
        net.run_until(lambda: net.decided(until_height))
    return mine, theirs


def _same_nodes(mine, theirs):
    for a, b in zip(mine.nodes, theirs.nodes):
        assert [_fields(m) for m in a.outbox] == \
            [_fields(m) for m in b.outbox]
        assert [_fields(d) for d in a.decisions] == \
            [_fields(d) for d in b.decisions]
        assert [_fields(c) for c in a.decision_certs] == \
            [_fields(c) for c in b.decision_certs]
        assert a.canonical_state() == b.canonical_state()
        assert [_fields(e) for e in a.all_equivocations()] == \
            [_fields(e) for e in b.all_equivocations()]


@pytest.mark.parametrize("behavior", ["honest", "silent", "equivocator",
                                      "nil_flood"])
def test_signed_network_outboxes_equal_the_twin(behavior):
    mine, theirs = _run_pair(["honest", behavior, "honest", "honest"], 1)
    assert mine.dropped == theirs.dropped
    _same_nodes(mine, theirs)
    sigs = [m.signature for nd in mine.nodes for m in nd.outbox]
    assert sigs and all(s is not None and len(s) == 64 for s in sigs)
    assert mine.decisions(1) == theirs.decisions(1) == [101] * len(
        mine.honest_nodes())
    if behavior == "equivocator":
        assert mine.equivocations()


def test_partition_heal_drill_equals_the_twin():
    mine, theirs = (sim.Network(n=4), jsim.Network(n=4))
    rounds = []
    for net in (mine, theirs):
        net.start()
        rounds.append(net.partition_heal_drill([0, 1], [2, 3]))
    assert rounds[0] == rounds[1] >= 1
    assert mine.held_partition == theirs.held_partition
    _same_nodes(mine, theirs)


def test_executor_snapshot_equals_the_twin_and_restores(tmp_path):
    mine, theirs = _run_pair(["equivocator", "honest", "honest", "honest"],
                             1)
    victim = next(i for i, s in enumerate(mine.specs)
                  if s.behavior == "honest")
    ck.save_executor(mine.nodes[victim], str(tmp_path / "port.json"))
    jck.save_executor(theirs.nodes[victim], str(tmp_path / "twin.json"))
    docs = [json.loads((tmp_path / f"{w}.json").read_text())
            for w in ("port", "twin")]
    assert docs[0] == docs[1] and docs[0]["evidence"]
    # crash the node and restore it from its snapshot; it rejoins with
    # the traffic still in its peers' outboxes and decides its live
    # height with them
    h0 = mine.nodes[victim].height
    decided = []
    for net, mod, cls, path in (
            (mine, ck, ex.ConsensusExecutor, "port.json"),
            (theirs, jck, jex.ConsensusExecutor, "twin.json")):
        fresh = cls(net.vset, index=victim, seed=net.seeds[victim],
                    get_value=net.get_value)
        h, _ = mod.load_executor_into(fresh, str(tmp_path / path))
        assert h == h0 >= 2 and fresh.all_equivocations()
        assert h0 - 1 in fresh.decided
        net.nodes[victim] = fresh
        net._delivered[victim] = 0
        net.run_until(lambda: net.decided(h0))
        decided.append([(n.decided[h0].round, n.decided[h0].value)
                        for n in net.honest_nodes()])
    assert decided[0] == decided[1]
    assert len(set(decided[0])) == 1 and decided[0][0][1] == 100 + h0
