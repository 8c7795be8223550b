"""Port differential: the cross-plane replay (`agnes_tpu_torch.harness.
replay`) against the host plane and the JAX replay.

The host plane is the port's own: its `Network` of consensus executors,
tapped by its `trace_network`.  Each schedule also runs on the JAX
package's jax-free twin network, and the port's traces must equal the
twin's message for message.  Each node's trace is replayed through the
port's `VoteBatcher` and `DeviceDriver` on the CPU.  On a few seeded
Byzantine schedules (the generator of `tests/test_cross_plane.py::
_run_seed`), two model-checker corpus schedules (one of them across a
validator-set epoch) and the hand-written epoch case, the port's
decisions equal the host's per (node, height), and device evidence stays
within host evidence.  On one schedule every node's `ReplayResult` also
equals the JAX `replay_trace`'s (on the twin's equal trace), field for
field.
"""

import dataclasses
import os

import numpy as np
import pytest

from agnes_tpu.harness.replay import replay_trace as jax_replay
from agnes_tpu.harness.replay import trace_network as jax_trace_network
from agnes_tpu_torch.core.executor import ConsensusExecutor, WireTimeout
from agnes_tpu_torch.core.executor import WireProposal
from agnes_tpu_torch.core.state_machine import TimeoutStep
from agnes_tpu_torch.core.validators import Validator, ValidatorSet
from agnes_tpu_torch.crypto import ed25519_ref as ed
from agnes_tpu_torch.harness import replay as R
from agnes_tpu_torch.harness.simulator import Network, NodeSpec
from agnes_tpu_torch.types import Vote, VoteType
from test_cross_plane import _run_seed as _twin_run_seed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CORPUS = os.path.join(os.path.dirname(__file__), "corpus")
SEEDS = (0, 3, 11)
_SEED_CACHE = {}


def _run_seed(seed: int):
    """`tests/test_cross_plane.py::_run_seed`'s schedule on the port's
    host plane: the same rng draws, the port's Network and tap.  Cached
    per seed (deterministic)."""
    if seed in _SEED_CACHE:
        return _SEED_CACHE[seed]
    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 4, 4, 7]))
    f_max = (n - 1) // 3
    behaviors = ["honest"] * n
    for i in rng.choice(n, size=int(rng.integers(0, f_max + 1)),
                        replace=False):
        behaviors[i] = str(rng.choice(["silent", "equivocator",
                                       "nil_flood"]))
    net = Network(n=n, specs=[NodeSpec(behavior=b) for b in behaviors])
    traces = R.trace_network(net)
    scenario = "plain"
    net.start()
    if rng.random() < 0.35:
        perm = rng.permutation(n)
        cut = int(rng.integers(1, n))
        g1, g2 = [int(x) for x in perm[:cut]], [int(x) for x in perm[cut:]]
        net.partition(g1, g2)
        scenario = f"partition{g1}|{g2}"
        try:
            net.run_until(lambda: net.decided(0), max_iters=25)
        except AssertionError as e:
            assert "predicate" in str(e), e   # stall, not a crash
        net.heal()
    net.run_until(lambda: net.decided(0))
    _SEED_CACHE[seed] = (net, traces, scenario)
    return _SEED_CACHE[seed]


def _fields(m):
    """A wire message as (kind, fields): both packages' enums are
    IntEnums, so equal codes compare equal."""
    return type(m).__name__, dataclasses.astuple(m)


def _same_traces(mine, theirs, ctx):
    assert len(mine) == len(theirs), ctx
    for j, (a, b) in enumerate(zip(mine, theirs)):
        assert [_fields(m) for m in a] == [_fields(m) for m in b], \
            f"{ctx} node={j}"


def _replay(trace, n, **kw):
    return R.replay_trace(trace, n_validators=n, device="cpu", **kw)


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
    _, twin_traces, twin_scenario = _twin_run_seed(seed)
    assert scenario == twin_scenario
    _same_traces(traces, twin_traces, f"seed={seed}")
    _agree(net, traces, f"seed={seed} {scenario}")


def test_port_replay_equals_jax_replay():
    net, traces, _ = _run_seed(SEEDS[0])
    _, twin_traces, _ = _twin_run_seed(SEEDS[0])
    _same_traces(traces, twin_traces, f"seed={SEEDS[0]}")
    for j in range(net.n):
        want = jax_replay(twin_traces[j], n_validators=net.n)
        got = _replay(traces[j], net.n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            f"node={j}"


@pytest.mark.parametrize("name", ["mc_n4_equivocator_evidence",
                                  "mc_epoch_set_change_decides"])
def test_corpus_schedules_agree_with_the_host(name):
    from agnes_tpu.analysis import modelcheck as mc

    entry = next(e for e in mc.load_corpus(CORPUS) if e["name"] == name)
    cfg = mc.MCConfig.from_json(entry["config"])
    # the checker's build_network, on the port's Network
    base = cfg.get_value_base
    net = Network(
        n=cfg.n,
        specs=[NodeSpec(behavior=b, power=p) for b, p in
               zip(cfg.behaviors, cfg.powers or (1,) * cfg.n)],
        get_value=lambda h: base + h, epochs=cfg.epochs_dict())
    net.enable_step_mode(partition_groups=cfg.partition,
                         max_height=cfg.max_height,
                         churn_budget=cfg.churn_budget,
                         churnable=cfg.churnable)
    twin = mc.build_network(cfg, sign=True, verify=True, start=False)
    powers = None
    if any(v.voting_power != 1 for v in net.vset):
        powers = net.vset.device_arrays()[1]
    epochs = ({h: list(pw) for h, pw in net.epochs.items()}
              if net.epochs else None)
    traces = R.trace_network(net)
    twin_traces = jax_trace_network(twin)
    assert net.run_schedule(entry["actions"]) == \
        twin.run_schedule(entry["actions"])
    _same_traces(traces, twin_traces, f"corpus={name}")
    reps = _agree(net, traces, f"corpus={name}", powers=powers,
                  epochs=epochs)
    assert any(r.decided for r in reps)
    if epochs:
        assert any(1 in r.decisions for r in reps)


def _executor(me=None, **kw):
    """A 4-validator host executor of the port (signatures off) and its
    trace."""
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
        ex.execute(Vote(typ=typ, round=round_, value=value,
                        validator=validator, height=0))

    ex.execute(WireTimeout(0, 0, TimeoutStep.PROPOSE))
    for r in (1, 2):                     # two round skips
        for v in others[:2]:
            vote(v, r, VoteType.PREVOTE, 77)
    assert ex.state.round == 2
    for v in others:
        vote(v, 0, VoteType.PRECOMMIT, 7)
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
        ex.execute(Vote(typ=typ, round=round_, value=value,
                        validator=validator, height=height))

    for v in peers:
        vote(v, 0, 0, VoteType.PRECOMMIT, 7)
    ex.execute(WireProposal(height=1, round=0, value=9, pol_round=-1,
                            proposer=p1))
    for v in peers:
        vote(v, 1, 0, VoteType.PREVOTE, 9)
    for v in lights:
        vote(v, 1, 0, VoteType.PRECOMMIT, 9)
    host = {h: [d.round, d.value] for h, d in ex.decided.items()}
    assert 0 in host and 1 not in host

    rep = _replay(trace, n, epochs={h: list(pw) for h, pw in epochs.items()})
    assert {h: [r, v] for h, (r, v) in rep.decisions.items()} == host
    blind = _replay(trace, n)           # table withheld
    assert 1 in blind.decisions
