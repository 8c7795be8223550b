"""Port differential: the evidence join (`agnes_tpu_torch.bridge.evidence`)
against the JAX `collect_device_evidence` and the RFC 8032 oracle.

* On the same signed votes, verified by the oracle before they reach
  either bridge and densified by the unsigned build on both, the port's
  records equal the twin's, in order and field for field (double-signs
  with a value and with nil; a conflicting pair without signatures and
  a flag without a pair yield no record).  Each record passes
  `verify_evidence` and the oracle; a tampered record fails.
* On device-verify builds (votes logged before their verdicts exist),
  the join walks the log once, re-verifies each logged batch in one
  call, and returns, in order, exactly what `signed_evidence` returns
  flag by flag; the forger's flag yields no record.
"""

import dataclasses

import numpy as np
import pytest

from agnes_tpu.bridge import evidence as jev
from agnes_tpu.bridge.ingest import VoteBatcher as JBatcher
from agnes_tpu.crypto import ed25519_ref as oracle
from agnes_tpu_torch.bridge import evidence as tev
from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V, FORGED, VALUE = 4, 4, 1, 7
DOUBLE = {2: 8, 3: None}          # validator -> its second prevote value


@pytest.fixture(scope="module")
def keys():
    seeds = fx.deterministic_seeds(V)
    return seeds, fx.validator_pubkeys(seeds)


def _sign(seeds, v, value):
    msg = vote_messages_np(*(np.zeros(1, np.int64),) * 3,
                           np.full(1, -1 if value is None else value,
                                   np.int64))[0].tobytes()
    return np.frombuffer(oracle.sign(seeds[v], msg), np.uint8)


def _double_cols(seeds, instances):
    """The DOUBLE validators' second, validly signed prevotes."""
    rows = [(i, v, val) for i in instances for v, val in DOUBLE.items()]
    sig = {v: _sign(seeds, v, val) for v, val in DOUBLE.items()}
    return (np.asarray([r[0] for r in rows]), np.asarray([r[1] for r in rows]),
            np.zeros(len(rows), np.int64), np.zeros(len(rows), np.int64),
            np.zeros(len(rows), np.int64),
            np.asarray([-1 if r[2] is None else r[2] for r in rows]),
            np.stack([sig[r[1]] for r in rows]))


def _oracle_ok(pubkeys, w):
    msg = vote_messages_np(*(np.full(1, x, np.int64) for x in (
        w.height, w.round, int(w.typ),
        -1 if w.value is None else w.value)))[0].tobytes()
    return oracle.verify(bytes(pubkeys[w.validator]), msg, w.signature)


def _fields(rec):
    return (rec.instance, rec.validator) + tuple(
        (w.instance, w.validator, w.height, w.round, int(w.typ), w.value,
         w.signature) for w in (rec.first, rec.second))


def test_records_equal_the_twin_and_pass_the_oracle(keys):
    seeds, pubkeys = keys
    cls = fx.full_mesh_cols(I, V, seeds, 0, 0, VALUE)
    double = _double_cols(seeds, [0, 2, 3])
    # every signature checked by the oracle before ingestion
    for cols in (cls, double):
        for k in range(len(cols[0])):
            msg = vote_messages_np(*(np.asarray(c[k:k + 1]) for c in
                                     cols[2:6]))[0].tobytes()
            assert oracle.verify(bytes(pubkeys[cols[1][k]]), msg,
                                 bytes(cols[6][k]))
    # validator 0 in instance 1: a second, unsigned vote for another value
    unsigned = ([1, 1], [0, 0], [0, 0], [0, 0], [0, 0], [VALUE, 9])
    bats = (VoteBatcher(I, V, 4, device="cpu"), JBatcher(I, V, n_slots=4))
    drv = DeviceDriver(I, V, device="cpu")
    drv.step()
    for cols in (cls, double, unsigned):
        bats[1].add_arrays(*cols)
        bats[1].build_phases()
        bats[0].add_arrays(*cols)
        drv.step_seq([p for p, _ in bats[0].build_phases()])
    flags = drv.tally.equiv.clone()
    assert flags.sum() == 3 * len(DOUBLE) + 1 and flags[1, 0]
    flags[0, 1] = True                  # a flag with no conflicting pair
    port = tev.collect_device_evidence(flags, bats[0])
    twin = jev.collect_device_evidence(flags.numpy(), bats[1])
    assert [_fields(r) for r in port] == [_fields(r) for r in twin]
    assert [(r.instance, r.validator) for r in port] == [
        (i, v) for i in (0, 2, 3) for v in DOUBLE]
    for r in port:
        assert [w.value for w in (r.first, r.second)] == [VALUE,
                                                           DOUBLE[r.validator]]
        assert tev.verify_evidence(r, bytes(pubkeys[r.validator]))
        assert _oracle_ok(pubkeys, r.first) and _oracle_ok(pubkeys, r.second)

    r = port[0]
    pk = bytes(pubkeys[r.validator])
    bad_sig = bytes([r.second.signature[0] ^ 1]) + r.second.signature[1:]
    for tampered in (
            dataclasses.replace(r, second=dataclasses.replace(
                r.second, signature=bad_sig)),
            dataclasses.replace(r, second=dataclasses.replace(
                r.second, value=9)),
            dataclasses.replace(r, second=r.first),
            dataclasses.replace(r, second=dataclasses.replace(
                r.second, round=1))):
        assert not tev.verify_evidence(tampered, pk)
    assert not tev.verify_evidence(r, bytes(pubkeys[0]))   # wrong key


def test_join_equals_signed_evidence_flag_by_flag(keys, monkeypatch):
    """Device-verify builds log their votes before the verdicts: the
    join re-verifies each logged batch once (the plain verify here),
    and its records equal `signed_evidence` per flag, in order."""
    seeds, pubkeys = keys
    bat = VoteBatcher(I, V, 4, device="cpu")
    ticks = (fx.full_mesh_cols(I, V, seeds, 0, 0, VALUE,
                               forge_validator=FORGED),
             _double_cols(seeds, [1, 2]),
             fx.full_mesh_cols(I, V, seeds, 0, 1, VALUE,
                               forge_validator=FORGED))
    for cols in ticks:
        bat.add_arrays(*cols)
        _, lanes = bat.build_phases_device(pubkeys)
        assert lanes is not None
    assert all(pk is not None for pk in bat._log_pk)
    flags = np.zeros((I, V), bool)
    flags[:, [FORGED, 2, 3]] = True
    flags[0, 0] = True

    real = VoteBatcher._verify
    calls = []

    def counted(self, b, pk):
        calls.append(len(b))
        return real(self, b, pk)

    monkeypatch.setattr(VoteBatcher, "_verify", counted)
    joined = tev.collect_device_evidence(flags, bat)
    # one re-verify per logged batch, of the rows of the cells still
    # without a pair: 13 flagged cells, of which the second tick pairs 4
    assert calls == [3 * I + 1, 2 * 2, 3 * I + 1 - 4]

    def by_oracle(self, b, pk):
        """Verdicts of the RFC 8032 oracle, lane for lane the kernel's
        under the cofactored policy (the flag-by-flag walk below would
        cost one plain verify a batch a flag)."""
        msgs = vote_messages_np(b.height, b.round, b.typ, b.value)
        return np.asarray([oracle.verify(bytes(pk[v]), m.tobytes(),
                                         bytes(s))
                           for v, m, s in zip(b.validator, msgs,
                                              b.signature)])

    monkeypatch.setattr(VoteBatcher, "_verify", by_oracle)
    per_flag = []
    for i, v in zip(*np.nonzero(flags)):
        pair = bat.signed_evidence(int(i), int(v))
        if pair is not None:
            per_flag.append((int(i), int(v)) + tuple(
                (w.instance, w.validator, w.height, w.round, int(w.typ),
                 w.value, w.signature) for w in pair))
    assert [_fields(r) for r in joined] == per_flag
    assert [(r.instance, r.validator) for r in joined] == [
        (1, 2), (1, 3), (2, 2), (2, 3)]
    assert all(tev.verify_evidence(r, bytes(pubkeys[r.validator]))
               for r in joined)


def test_other_bridges_are_refused():
    with pytest.raises(TypeError):
        tev.collect_device_evidence(np.zeros((I, V), bool),
                                    JBatcher(I, V, n_slots=4))
