"""The port's native C++ core (`agnes_tpu_torch.core.native`, its own
copy of the sources, built by `core/native_build.py`) against the
port's Python core and the JAX package's: `native_apply` against
`core.state_machine.apply` over every (state, round, event) of the twin
suite's alphabet (`tests/test_native_core.py`), `NativeRoundVotes` and
`NativeValidatorSet` against both packages' Python `RoundVotes` and
`ValidatorSet`, and the host signer (`crypto.host_sign` / `host_verify`)
byte for byte against the RFC 8032 oracle `crypto/ed25519_ref` and the
twin's C++ signer.  The executor's outboxes after the switch to the C++
signer are held against the twin's by `tests/test_torch_executor.py`.
"""

import random

import numpy as np
import pytest

from agnes_tpu.core import native as jnative
from agnes_tpu.core import round_votes as jrv
from agnes_tpu.core import validators as jval
from agnes_tpu.types import Vote as JVote
from agnes_tpu.types import VoteType as JVoteType
from agnes_tpu_torch import crypto
from agnes_tpu_torch.core import native as N
from agnes_tpu_torch.core import native_build
from agnes_tpu_torch.core import state_machine as sm
from agnes_tpu_torch.core.round_votes import RoundVotes, ThreshKind
from agnes_tpu_torch.core.validators import Validator, ValidatorSet
from agnes_tpu_torch.crypto import ed25519_ref as ed
from agnes_tpu_torch.types import Vote, VoteType
from tests.test_ed25519_ref import VECTORS


def _all_events():
    evs = []
    for tag in sm.EventTag:
        if tag in (sm.EventTag.NEW_ROUND_PROPOSER, sm.EventTag.POLKA_VALUE,
                   sm.EventTag.PRECOMMIT_VALUE):
            evs += [sm.Event(tag, value=v) for v in (1, 2)]
        elif tag == sm.EventTag.PROPOSAL:
            evs += [sm.Event(tag, value=v, pol_round=pr)
                    for v in (1, 2) for pr in (-2, -1, 0, 1, 2)]
        else:
            evs.append(sm.Event(tag))
    return evs


def _states(step):
    return [sm.State(height=5, round=round, step=step, locked=locked,
                     valid=valid)
            for round in (0, 1, 2)
            for locked in (None, sm.RoundValue(0, 1), sm.RoundValue(1, 2),
                           sm.RoundValue(2, 1))
            for valid in (None, sm.RoundValue(0, 1), sm.RoundValue(1, 2))]


@pytest.mark.parametrize("step", list(sm.Step), ids=lambda s: s.name)
def test_native_apply_matches_state_machine(step):
    """Every (state, round, event) of one step: C++ == Python, field
    for field, state and message."""
    events = _all_events()
    for s in _states(step):
        for round in (0, 1, 2, 3):
            for e in events:
                assert N.native_apply(s, round, e) == sm.apply(s, round, e), \
                    (s, round, e)


@pytest.mark.parametrize("trial", range(6))
def test_round_votes_match_both_python_tallies(trial):
    """Random identified / anonymous vote streams: thresholds, skip
    weight and equivocation evidence agree with the port's and the
    twin's RoundVotes at every step."""
    rng = random.Random(trial)
    total = rng.randrange(4, 30)
    cc = N.NativeRoundVotes(height=1, round=0, total=total)
    py = RoundVotes(height=1, round=0, total=total)
    jpy = jrv.RoundVotes(height=1, round=0, total=total)
    for _ in range(80):
        typ = rng.choice([0, 1])
        value = rng.choice([None, 1, 2, 3])
        validator = rng.choice([None] + list(range(8)))
        w = rng.randrange(1, 4)
        t_cc = cc.add_vote(Vote(typ=VoteType(typ), round=0, value=value,
                                validator=validator), w)
        t_py = py.add_vote(Vote(typ=VoteType(typ), round=0, value=value,
                                validator=validator), w)
        t_j = jpy.add_vote(JVote(typ=JVoteType(typ), round=0, value=value,
                                 validator=validator), w)
        assert t_cc == t_py
        assert (int(t_cc.kind), t_cc.value) == (int(t_j.kind), t_j.value)
        assert cc.skip_weight() == py.skip_weight() == jpy.skip_weight()

    def rows(eqs):
        return [(e.height, e.round, int(e.typ), e.validator, e.first_value,
                 e.second_value) for e in eqs]

    assert rows(cc.equivocations) == rows(py.equivocations) \
        == rows(jpy.equivocations)


def test_round_votes_threshold_ladder_and_no_truncation():
    """The reference's add_votes ladder (round_votes.rs:107-132), then
    1,500 equivocating validators: every record survives."""
    cc = N.NativeRoundVotes(height=1, round=0, total=4)
    nil = Vote(typ=VoteType.PREVOTE, round=0, value=None)
    seven = Vote(typ=VoteType.PREVOTE, round=0, value=7)
    kinds = [cc.add_vote(v, 1) for v in (nil, nil, seven, seven, seven)]
    assert [t.kind for t in kinds] == [ThreshKind.INIT, ThreshKind.INIT,
                                       ThreshKind.ANY, ThreshKind.ANY,
                                       ThreshKind.VALUE]
    assert kinds[-1].value == 7
    n = 1500
    cc = N.NativeRoundVotes(height=1, round=0, total=n)
    for v in range(n):
        for value in (1, 2):
            cc.add_vote(Vote(typ=VoteType.PREVOTE, round=0, value=value,
                             validator=v), 1)
    assert {e.validator for e in cc.equivocations} == set(range(n))


def test_validator_set_matches_both_python_sets():
    rng = random.Random(7)
    keys = [ed.keypair(bytes([i]) * 32)[1] for i in range(6)]
    entries = [(keys[i], i + 1) for i in range(6)]
    shuffled = entries[:]
    rng.shuffle(shuffled)
    cc = N.NativeValidatorSet(shuffled + [(shuffled[0][0], 9)])
    py = ValidatorSet([Validator(k, p) for k, p in
                       shuffled + [(shuffled[0][0], 9)]])
    jpy = jval.ValidatorSet([jval.Validator(k, p) for k, p in
                             shuffled + [(shuffled[0][0], 9)]])

    def table(s):
        return [(v.public_key, v.voting_power) for v in s]

    assert cc.validators() == table(py) == table(jpy)
    assert len(cc) == len(py) == 6
    assert cc.total_power == py.total_power == jpy.total_power
    for k in keys:
        assert cc.index_of(k) == py.index_of(k) == jpy.index_of(k)
    assert cc.index_of(b"\x00" * 32) == -1 and py.index_of(b"\x00" * 32) \
        is None
    assert cc.update(keys[0], 100)
    py.update(Validator(keys[0], 100))
    assert cc.remove(keys[1]) and not cc.remove(keys[1])
    py.remove(keys[1])
    cc.add(keys[1], 3)
    py.add(Validator(keys[1], 3))
    assert cc.validators() == table(py)
    assert N.NativeValidatorSet(cc.validators()).hash() == cc.hash() == \
        jnative.NativeValidatorSet(cc.validators()).hash()


@pytest.mark.parametrize("i", range(len(VECTORS)))
def test_host_signer_rfc_vectors(i):
    seed, pub, msg, sig = (bytes.fromhex(x) for x in VECTORS[i])
    assert N.pubkey(seed) == pub
    assert crypto.host_sign(seed, msg) == N.sign(seed, msg) == sig
    assert crypto.host_verify(pub, msg, sig)


def test_host_signer_equals_oracle_and_twin():
    """Byte for byte on random seeds and messages: the port's C++
    signer, the pure-Python oracle and the twin's C++ signer."""
    rng = np.random.default_rng(3)
    for n in (0, 1, 45, 109, 300):
        seed, msg = rng.bytes(32), rng.bytes(n)
        sig = crypto.host_sign(seed, msg)
        assert sig == ed.sign(seed, msg) == jnative.sign(seed, msg)
        assert N.pubkey(seed) == ed.keypair(seed)[1] == jnative.pubkey(seed)
        assert crypto.host_verify(N.pubkey(seed), msg, sig)
    with pytest.raises(ValueError):
        N.sign(b"short", b"m")


def test_verify_and_verify_batch_match_the_oracle():
    seeds = [bytes([i + 1]) * 32 for i in range(6)]
    msgs = [bytes([i]) * 45 for i in range(6)]
    pks = [N.pubkey(s) for s in seeds]
    sigs = [N.sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[2] = sigs[2][:3] + bytes([sigs[2][3] ^ 0x40]) + sigs[2][4:]
    pks[4] = N.pubkey(b"\x99" * 32)
    ok = N.verify_batch(pks, msgs, sigs)
    assert ok == [True, True, False, True, False, True]
    assert ok == [ed.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    s = int.from_bytes(sigs[0][32:], "little")
    assert not N.verify(pks[0], msgs[0],
                        sigs[0][:32] + (s + ed.L).to_bytes(32, "little"))
    assert not N.verify(pks[0][:31], msgs[0], sigs[0])
    assert N.verify_batch([pks[0], b"x"], msgs[:2], sigs[:2]) == [True,
                                                                   False]
    assert N.verify_batch([], [], []) == []


def test_host_plane_signs_through_the_native_signer():
    """The executor, the simulator and the fixtures sign with the C++
    host signer, one signer and no fallback."""
    from agnes_tpu_torch.core import executor
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness import simulator

    assert executor._sign is crypto.host_sign
    assert executor._verify is crypto.host_verify
    assert simulator._sign is crypto.host_sign
    seeds = fx.deterministic_seeds(3)
    sigs = fx.sign_class(seeds, 2, 1, 5, forge_validator=1)
    from agnes_tpu.harness import fixtures as jfx
    np.testing.assert_array_equal(
        sigs, jfx.sign_class(seeds, 2, 1, 5, forge_validator=1))
    np.testing.assert_array_equal(fx.validator_pubkeys(seeds),
                                  jfx.validator_pubkeys(seeds))


def test_build_compiles_the_ports_sources_only(tmp_path):
    """The g++ command names the port's own sources and generated
    constants, nothing of the JAX package's tree; the constants equal
    FIPS 180-4's published words."""
    cmd = native_build.command(str(tmp_path / "x.so"))
    srcs = [a for a in cmd if a.endswith(".cpp")]
    assert sorted(srcs) == sorted(
        f"{native_build.NATIVE_DIR}/{s}" for s in native_build.SOURCES)
    assert all("agnes_tpu_torch" in a for a in cmd if "/" in a
               and "tmp" not in a)
    inc = native_build.gen_sha512_inc()
    assert "0x428a2f98d728ae22ULL" in inc and "0x6a09e667f3bcc908ULL" in inc
    assert "0x428a2f98u" in inc and "0x5be0cd19u" in inc
    assert native_build.build().startswith(native_build.BUILD_DIR)
