"""Port differential: the cross-plane replay (`agnes_tpu_torch.harness.
replay`) against the host plane and the JAX replay.

The host plane is the JAX package's jax-free `Network` of consensus
executors; its `trace_network` taps each node's processing stream, which
is converted message by message into the port's wire types and replayed
through the port's `VoteBatcher` and `DeviceDriver` on the CPU.  On a
few seeded Byzantine schedules (`tests/test_cross_plane.py::_run_seed`),
two model-checker corpus schedules (one of them across a validator-set
epoch) and the hand-written epoch case, the port's decisions equal the
host's per (node, height), and device evidence stays within host
evidence.  On one schedule every node's `ReplayResult` also equals the
JAX `replay_trace`'s, field for field.
"""

import dataclasses
import os

import pytest

from agnes_tpu.core import executor as jex
from agnes_tpu.harness.replay import replay_trace as jax_replay
from agnes_tpu.harness.replay import trace_network
from agnes_tpu.types import Vote as JVote
from agnes_tpu.types import VoteType as JVoteType
from agnes_tpu_torch.core.executor import WireProposal, WireTimeout
from agnes_tpu_torch.core.state_machine import TimeoutStep
from agnes_tpu_torch.harness import replay as R
from agnes_tpu_torch.types import Vote, VoteType
from test_cross_plane import _run_seed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CORPUS = os.path.join(os.path.dirname(__file__), "corpus")
SEEDS = (0, 3, 11)


def _port_msg(m):
    """One host-plane wire message as the port's own type."""
    if isinstance(m, JVote):
        return Vote(typ=VoteType(int(m.typ)), round=m.round, value=m.value,
                    validator=m.validator, height=m.height,
                    signature=m.signature)
    if isinstance(m, jex.WireProposal):
        return WireProposal(m.height, m.round, m.value, m.pol_round,
                            m.proposer, m.signature)
    if isinstance(m, jex.WireTimeout):
        return WireTimeout(m.height, m.round, TimeoutStep(int(m.step)))
    raise TypeError(type(m))


def _replay(trace, n, **kw):
    return R.replay_trace([_port_msg(m) for m in trace], n_validators=n,
                          device="cpu", **kw)


def _agree(net, traces, ctx, **kw):
    """Port decisions == host decisions per (node, height); device
    evidence within host evidence.  Returns the port's results."""
    reps = []
    for j, node in enumerate(net.nodes):
        rep = _replay(traces[j], net.n, **kw)
        host = {h: [d.round, d.value] for h, d in sorted(node.decided.items())}
        dev = {h: [r, v] for h, (r, v) in rep.decisions.items()}
        assert dev == host, f"{ctx} node={j}: device {dev} != host {host}"
        host_ev = {e.validator for e in node.all_equivocations()}
        assert rep.equivocators <= host_ev, f"{ctx} node={j}"
        reps.append(rep)
    return reps


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_schedules_agree_with_the_host(seed):
    net, traces, scenario = _run_seed(seed)
    _agree(net, traces, f"seed={seed} {scenario}")


def test_port_replay_equals_jax_replay():
    net, traces, _ = _run_seed(SEEDS[0])
    for j in range(net.n):
        want = jax_replay(traces[j], n_validators=net.n)
        got = _replay(traces[j], net.n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            f"node={j}"


@pytest.mark.parametrize("name", ["mc_n4_equivocator_evidence",
                                  "mc_epoch_set_change_decides"])
def test_corpus_schedules_agree_with_the_host(name):
    from agnes_tpu.analysis import modelcheck as mc

    entry = next(e for e in mc.load_corpus(CORPUS) if e["name"] == name)
    cfg = mc.MCConfig.from_json(entry["config"])
    net = mc.build_network(cfg, sign=True, verify=True, start=False)
    powers = None
    if any(v.voting_power != 1 for v in net.vset):
        powers = net.vset.device_arrays()[1]
    epochs = ({h: list(pw) for h, pw in net.epochs.items()}
              if net.epochs else None)
    traces = trace_network(net)
    net.run_schedule(entry["actions"])
    reps = _agree(net, traces, f"corpus={name}", powers=powers,
                  epochs=epochs)
    assert any(r.decided for r in reps)
    if epochs:
        assert any(1 in r.decisions for r in reps)


def _executor(me=None, **kw):
    """A 4-validator host executor (signatures off) and its trace."""
    from agnes_tpu.core.executor import ConsensusExecutor
    from agnes_tpu.core.validators import Validator, ValidatorSet
    from agnes_tpu.crypto import ed25519_ref as ed

    seeds = [bytes([i + 1]) * 32 for i in range(4)]
    vset = ValidatorSet([Validator(ed.keypair(s)[1], 1) for s in seeds])
    ex = ConsensusExecutor(vset, index=me, seed=None,
                           get_value=lambda h: 7,
                           verify_signatures=False, **kw)
    trace = []
    orig = ex.execute
    ex.execute = lambda msg: (trace.append(msg), orig(msg))[1]
    return ex, trace


def test_commit_from_any_round_via_host_fallback():
    """`tests/test_cross_plane.py`'s host-fallback case on the port: the
    node skips to round 2, its device window rotates past round 0, and
    only then a round-0 precommit quorum arrives; the device decides
    through the batcher's host tally and a PRECOMMIT_VALUE event."""
    probe, _ = _executor()
    me = next(i for i in range(4)
              if all(probe.proposer(0, r) != i for r in range(3)))
    ex, trace = _executor(me)
    ex.start()
    others = [i for i in range(4) if i != me]

    def vote(validator, round_, typ, value):
        ex.execute(JVote(typ=typ, round=round_, value=value,
                         validator=validator, height=0))

    ex.execute(jex.WireTimeout(0, 0, jex.sm.TimeoutStep.PROPOSE))
    for r in (1, 2):                     # two round skips
        for v in others[:2]:
            vote(v, r, JVoteType.PREVOTE, 77)
    assert ex.state.round == 2
    for v in others:
        vote(v, 0, JVoteType.PRECOMMIT, 7)
    assert ex.decided[0].value == 7 and ex.decided[0].round == 0
    rep = _replay(trace, 4)
    assert (rep.decided, rep.value, rep.round) == (True, 7, 0)
    assert rep.host_fallback_decisions == 1


def test_epoch_table_threading_is_load_bearing():
    """`tests/test_cross_plane.py`'s epoch case on the port: height 0
    decides under the equal genesis set; at height 1 the epoch puts
    weight 3 on one peer, so three weight-1 precommits hold only 3/6 of
    the live power and neither plane decides, while the same trace
    replayed without the table decides height 1."""
    n = 4
    probe, _ = _executor()
    p0, p1 = probe.proposer(0, 0), probe.proposer(1, 0)
    me = next(i for i in range(n) if i not in (p0, p1))
    heavy = next(i for i in range(n) if i != me)
    epochs = {1: tuple(3 if i == heavy else 1 for i in range(n))}
    ex, trace = _executor(me, epochs=epochs)
    ex.start()
    peers = [i for i in range(n) if i != me]
    lights = [i for i in peers if i != heavy]

    def vote(validator, height, round_, typ, value):
        ex.execute(JVote(typ=typ, round=round_, value=value,
                         validator=validator, height=height))

    for v in peers:
        vote(v, 0, 0, JVoteType.PRECOMMIT, 7)
    ex.execute(jex.WireProposal(height=1, round=0, value=9, pol_round=-1,
                                proposer=p1))
    for v in peers:
        vote(v, 1, 0, JVoteType.PREVOTE, 9)
    for v in lights:
        vote(v, 1, 0, JVoteType.PRECOMMIT, 9)
    host = {h: [d.round, d.value] for h, d in ex.decided.items()}
    assert 0 in host and 1 not in host

    rep = _replay(trace, n, epochs={h: list(pw) for h, pw in epochs.items()})
    assert {h: [r, v] for h, (r, v) in rep.decisions.items()} == host
    blind = _replay(trace, n)           # table withheld
    assert 1 in blind.decisions
