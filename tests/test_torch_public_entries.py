"""Port differentials for the twin's remaining public entry points:
`VoteBatcher.add` / `extend` (the per-vote wire entry), the one-instance
`device.state_machine.apply_scalar`, `core.native.NativeProposerRotation`
and `native.sha512`, and `BlsClassTable.pending_shares`, each against
its JAX-package twin on the same inputs.

The bridge cases are those of tests/test_bridge.py: signed votes with a
forged and an unknown (99) validator, conflicting values, exact
duplicates, the wrong height, 10- and 65-byte signatures and nil votes,
each fed to both batchers one vote at a time; counters and built phases
must agree leaf for leaf.  The signed builds verify through the RFC 8032
oracle on both sides (`_verify` patched): what is under test is the
per-vote entry, not the verifier; the `slow` case runs the twin's fused
JAX verify and the port's plain one instead.
"""

import hashlib
import itertools

import numpy as np
import pytest
import torch

from agnes_tpu.bridge import ingest as jingest
from agnes_tpu.core import native as jnative
from agnes_tpu.device import state_machine as jsm
from agnes_tpu.serve import bls_lane as JL
from agnes_tpu.types import VoteType as JVoteType
from agnes_tpu_torch.analysis import admission_mc as tam
from agnes_tpu_torch.bridge import ingest
from agnes_tpu_torch.bridge.ingest import VoteBatcher, WireVote
from agnes_tpu_torch.core import native
from agnes_tpu_torch.core.state_machine import EventTag, Step
from agnes_tpu_torch.core.validators import (ProposerRotation, Validator,
                                             ValidatorSet)
from agnes_tpu_torch.crypto import ed25519_ref as oracle
from agnes_tpu_torch.crypto.encoding import vote_signing_bytes
from agnes_tpu_torch.device import (DeviceEvent, DeviceState, apply_batch,
                                    apply_scalar)
from agnes_tpu_torch.device.tally import VOTED_NIL
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.serve import bls_lane as TL
from agnes_tpu_torch.types import VoteType
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V = 2, 4
SEEDS = fx.deterministic_seeds(V)
PUBKEYS = fx.validator_pubkeys(SEEDS)
VALUE = 5


def _vote(inst, v, typ, value, height=0, rnd=0, sig=True, seed=None):
    """(instance, validator, height, round, typ, value, signature): one
    wire vote as a tuple both packages' WireVote take; `sig` True signs
    with the validator's key (or `seed`), bytes is used as given."""
    if sig is True:
        key = seed if seed is not None else SEEDS[v]
        sig = native.sign(key, vote_signing_bytes(height, rnd, int(typ),
                                                  value))
    return (inst, v, height, rnd, int(typ), value, sig or None)


def _signed_mesh(typ, value=VALUE):
    return [_vote(i, v, typ, value) for i in range(I) for v in range(V)]


#: the cases of tests/test_bridge.py: (name, votes, verify)
CASES = [
    ("signed_forged_unknown", _signed_mesh(VoteType.PREVOTE) + [
        _vote(0, 3, VoteType.PREVOTE, VALUE, seed=b"\xbb" * 32),
        _vote(0, 99, VoteType.PREVOTE, VALUE, sig=None)], True),
    ("conflicting_values",
     [_vote(0, v, VoteType.PREVOTE, 100 + v % 2, sig=None)
      for v in range(V)]
     + [_vote(0, 0, VoteType.PREVOTE, 999, sig=None)], False),
    ("duplicates", [_vote(0, 2, VoteType.PREVOTE, 7, sig=None)] * 10
     + [_vote(0, 1, VoteType.PREVOTE, 7, sig=None)], False),
    ("wrong_height", [_vote(0, 1, VoteType.PREVOTE, 1, height=5),
                      _vote(1, 1, VoteType.PREVOTE, 1, height=5)], True),
    ("wrong_length_signatures",
     [_vote(0, 0, VoteType.PREVOTE, 1, sig=b"\x01" * 10),
      _vote(0, 1, VoteType.PREVOTE, 1, sig=b"\x01" * 65)], True),
    ("nil", [_vote(i, v, VoteType.PRECOMMIT, None) for i in range(I)
             for v in range(V)] + [_vote(1, 2, VoteType.PREVOTE, VALUE)],
     True),
]

COUNTERS = ("rejected_signature", "rejected_malformed", "overflow_votes",
            "dropped_stale_height", "dropped_held_overflow")


def _by_oracle(self, b, pubkeys):
    """The RFC 8032 oracle's verdicts, lane for lane the verifiers'."""
    msgs = ingest.vote_messages_np(b.height, b.round, b.typ, b.value)
    sigs = (b.signature if b.signature is not None
            else np.zeros((len(b), 64), np.uint8))
    return np.asarray([oracle.verify(bytes(pubkeys[v]), m.tobytes(),
                                     bytes(s))
                       for v, m, s in zip(b.validator, msgs, sigs)])


def _same_phases(tp, jp):
    assert [n for _, n in tp] == [n for _, n in jp]
    for (t, _), (j, _) in zip(tp, jp):
        for name, a, b in zip(t._fields, t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


def _both(votes, heights=None):
    tb = VoteBatcher(I, V, n_slots=4, device="cpu")
    jb = jingest.VoteBatcher(I, V, n_slots=4)
    if heights is not None:
        tb.sync_device(np.zeros(I, np.int64), heights)
        jb.sync_device(np.zeros(I, np.int64), heights)
    tb.extend(WireVote(*v[:4], VoteType(v[4]), *v[5:]) for v in votes)
    for v in votes:
        jb.add(jingest.WireVote(*v[:4], JVoteType(v[4]), *v[5:]))
    return tb, jb


@pytest.mark.parametrize("name,votes,verify", CASES,
                         ids=[c[0] for c in CASES])
def test_add_extend_vs_twin(name, votes, verify, monkeypatch):
    monkeypatch.setattr(VoteBatcher, "_verify", _by_oracle)
    monkeypatch.setattr(jingest.VoteBatcher, "_verify", _by_oracle)
    heights = np.array([5, 6]) if name == "wrong_height" else None
    tb, jb = _both(votes, heights)
    assert tb.pending_votes == jb.pending_votes
    pk = PUBKEYS if verify else None
    tp, jp = tb.build_phases(pk), jb.build_phases(pk)
    _same_phases(tp, jp)
    for f in COUNTERS:
        assert getattr(tb, f) == getattr(jb, f), f
    want = {"signed_forged_unknown": (1, 1, 1),
            "conflicting_values": (0, 0, 2), "duplicates": (0, 0, 1),
            "wrong_height": (0, 0, 1), "wrong_length_signatures": (0, 2, 0),
            "nil": (0, 0, 2)}[name]
    assert (tb.rejected_signature, tb.rejected_malformed, len(tp)) == want
    if name == "wrong_height":
        assert tb.dropped_stale_height == 1
    if name == "nil":
        pc = next(p for p, _ in tp if int(p.typ[0]) == int(VoteType.PRECOMMIT))
        assert bool(pc.mask.all()) and bool((pc.slots == VOTED_NIL).all())


def test_per_vote_build_equals_add_arrays():
    """One vote at a time through `extend` builds what the same votes
    give through one `add_arrays`: phases and signed lanes, leaf for
    leaf (the device-verify build; no verify runs in it)."""
    cols = [fx.full_mesh_cols(I, V, SEEDS, 0, typ, VALUE, forge_validator=1)
            for typ in (0, 1)]
    bulk = VoteBatcher(I, V, n_slots=4, device="cpu")
    per = VoteBatcher(I, V, n_slots=4, device="cpu")
    for c in cols:
        bulk.add_arrays(*c)
        per.extend(WireVote(*(int(x[k]) for x in c[:4]),
                            VoteType(int(c[4][k])), int(c[5][k]),
                            c[6][k].tobytes())
                   for k in range(len(c[0])))
    per.add(WireVote(0, 0, 0, 0, VoteType.PREVOTE, VALUE, b"\x00" * 63))
    assert per.rejected_malformed == 1 and bulk.rejected_malformed == 0
    (bp, bl), (pp, pl) = (b.build_phases_device(PUBKEYS, phase_offset=1)
                          for b in (bulk, per))
    assert bl is not None and pl is not None
    _same_phases(pp, bp)
    for name, a, b in zip(bl._fields, bl, pl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


@pytest.mark.slow
def test_add_signed_vs_twin_real_verifiers():
    """The signed case with each package's own verifier: the twin's
    fused JAX verify, the port's plain verify on the CPU."""
    tb, jb = _both(CASES[0][1])
    _same_phases(tb.build_phases(PUBKEYS), jb.build_phases(PUBKEYS))
    for f in COUNTERS:
        assert getattr(tb, f) == getattr(jb, f), f
    assert (tb.rejected_signature, tb.rejected_malformed) == (1, 1)


def _scalar_cases():
    """Every (step, tag, round relation), under two guard states: fresh
    (no lock, no valid value) and locked + valid at round 1 on another
    value; the event carries value 7 and pol_round 1 where it takes
    them.  Rows of ints in DeviceState / DeviceEvent field order."""
    s_round = 2
    for step, tag, rel, locked in itertools.product(
            Step, EventTag, (-1, 0, 1), (False, True)):
        lr, lv = (1, 9) if locked else (-1, -1)
        state = (s_round, int(step), lr, lv, lr, lv, 3)
        takes_value = tag in (EventTag.PROPOSAL, EventTag.NEW_ROUND_PROPOSER,
                              EventTag.POLKA_VALUE, EventTag.PRECOMMIT_VALUE)
        event = (int(tag), s_round + rel, 7 if takes_value else -1,
                 1 if tag == EventTag.PROPOSAL else -1)
        yield state, event


def test_apply_scalar_vs_twin_and_apply_batch():
    import jax

    cases = list(_scalar_cases())
    assert len(cases) == 5 * 13 * 3 * 2
    twin = jax.jit(jsm.apply_scalar)
    rows = [tuple(torch.tensor(c, dtype=torch.int32) for c in zip(*col))
            for col in zip(*cases)]
    bs, bm = apply_batch(DeviceState(*rows[0]), DeviceEvent(*rows[1]))
    for k, (st, ev) in enumerate(cases):
        ts, tm = apply_scalar(
            DeviceState(*(torch.tensor(x, dtype=torch.int32) for x in st)),
            DeviceEvent(*(torch.tensor(x, dtype=torch.int32) for x in ev)))
        assert all(x.shape == () and x.dtype == torch.int32
                   for x in (*ts, *tm))
        js, jm = twin(jsm.DeviceState(*(np.int32(x) for x in st)),
                      jsm.DeviceEvent(*(np.int32(x) for x in ev)))
        got = [int(x) for x in (*ts, *tm)]
        assert got == [int(x) for x in (*js, *jm)], (st, ev)
        assert got == [int(x[k]) for x in (*bs, *bm)], (st, ev)


def test_native_proposer_rotation_vs_twin_and_python():
    keys = [oracle.keypair(bytes([i + 30]) * 32)[1] for i in range(5)]
    powers = [1, 2, 5, 1, 3]
    py = ProposerRotation(ValidatorSet(
        [Validator(pk, p) for pk, p in zip(keys, powers)]))
    cc = native.NativeProposerRotation(
        native.NativeValidatorSet(list(zip(keys, powers))))
    tw = jnative.NativeProposerRotation(
        jnative.NativeValidatorSet(list(zip(keys, powers))))
    seq = [cc.step() for _ in range(60)]
    assert seq == [tw.step() for _ in range(60)]
    assert seq == [py.step() for _ in range(60)]
    # the rotation keeps its validator set alive
    assert cc._vset is not None and len(cc._vset) == 5


def test_native_sha512_vs_hashlib_and_twin():
    rng = np.random.RandomState(7)
    for n in range(301):
        data = rng.bytes(n)
        got = native.sha512(data)
        assert got == hashlib.sha512(data).digest(), n
        assert got == jnative.sha512(data), n


def test_pending_shares_vs_twin_after_folds():
    """Both class tables over the same registry stub and opaque shares:
    pending_shares after each fold (new classes, a duplicate, an unknown
    validator, one without a proof of possession) and after a poll
    closes a full class."""
    tables = [cls(reg(4, no_pop=(3,)), 2) for cls, reg in (
        (TL.BlsClassTable, tam._McBlsRegistry),
        (JL.BlsClassTable, tam._McBlsRegistry))]

    def wire(rows):
        inst, val, typ = (list(x) for x in zip(*rows))
        n = len(rows)
        return TL.pack_bls_wire(inst, val, [0] * n, [0] * n, typ, [7] * n,
                                np.full((n, 192), 5, np.uint8))

    seen = []
    for rows in ([(0, 0, 0), (0, 1, 0), (1, 0, 1)],
                 [(0, 1, 0), (0, 2, 0), (1, 9, 1), (1, 3, 1)],
                 [(1, 1, 1), (1, 2, 1)]):
        w = wire(rows)
        res = [t.fold(w, decode=False) for t in tables]
        assert res[0] == res[1]
        seen.append([t.pending_shares for t in tables])
    closed = [t.poll(target_signers=3) for t in tables]
    assert [len(c) for c in closed] == [2, 2]
    seen.append([t.pending_shares for t in tables])
    assert seen == [[3, 3], [4, 4], [6, 6], [0, 0]]
