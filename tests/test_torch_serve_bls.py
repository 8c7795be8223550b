"""The BLS aggregate lane through the port's serve plane on the CPU
(V = 4 validators, one instance): `VoteService(..., bls_lane=...)` with
no Ed25519 keys, shares in through `submit_bls`, `pump` closes the
classes by size, the lane aggregates them (the real `bls_aggregate` on
the plain kernels) and pairing-checks them (the host oracle: no pairing
class rungs planned), and the cleared rows ride the unsigned sequence to
a decision.  The decisions equal those of the per-share oracle
(`bls_ref.verify_share` on every share of the class with the forgery,
one pairing of the honest class's aggregate, then the tally's 2/3
rule); a
forged precommit share is dropped and counted, and cannot suppress the
honest shares of its class.  Warmup arms the retrace tripwire, which
stays silent.
"""

import numpy as np

from agnes_tpu.crypto import bls_ref as ref
from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.crypto import bls as BLS
from agnes_tpu_torch.crypto.encoding import vote_signing_bytes
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.serve import BlsLane, ShapeLadder, VoteService
from agnes_tpu_torch.serve.bls_lane import BlsKeyRegistry, pack_bls_wire
from agnes_tpu_torch.utils.flightrec import FlightRecorder
from agnes_tpu_torch.utils.metrics import RETRACE_UNEXPECTED
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PV, PC = 0, 1
V, I, VALUE, FORGED = 4, 1, 7, 2
POWERS = np.ones(V, np.int64)


def _setup():
    pts, acc = [], None
    for _ in range(V):                       # sk_v = v + 1
        acc = ref.point_add(acc, ref.G1)
        pts.append(acc)
    # the registry from the known points (a decompress is ~0.2 s a key)
    reg = BlsKeyRegistry.from_state(
        [ref.g1_compress(p) for p in pts], pts, BLS.pack_g1_rows(pts),
        POWERS, np.zeros(V, bool), np.zeros(V, np.int64),
        np.zeros(V, bool), 0)
    reg.mark_trusted(np.arange(V))
    wire, shares = b"", {}
    for typ in (PV, PC):
        msg = ref.hash_to_g2(vote_signing_bytes(0, 0, typ, VALUE))
        sh, acc = [], None
        for _ in range(V):
            acc = ref.point_add(acc, msg)
            sh.append(acc)
        if typ == PC:
            sh[FORGED] = ref.point_mul(77, msg)
        shares[typ] = (msg, sh)
        wire += pack_bls_wire([0] * V, range(V), [0] * V, [0] * V,
                              [typ] * V, [VALUE] * V,
                              np.stack([np.frombuffer(ref.g2_to_bytes(s),
                                                      np.uint8)
                                        for s in sh]))
    return reg, pts, wire, shares


def test_bls_serve_decides_as_the_per_share_oracle():
    reg, pts, wire, shares = _setup()
    # the per-share oracle: which shares verify, and does each class
    # reach more than 2/3 of the power
    msg, sh = shares[PV]
    apk = asig = None
    for v in range(V):
        apk = ref.point_add(apk, pts[v])
        asig = ref.point_add(asig, sh[v])
    assert ref.pairing_product_is_one([(ref.point_neg(ref.G1), asig),
                                       (apk, msg)])
    msg, sh = shares[PC]
    good = {PV: [True] * V,
            PC: [ref.verify_share(pts[v], msg, sh[v]) for v in range(V)]}
    assert good[PC] == [v != FORGED for v in range(V)]
    quorum = all(3 * sum(POWERS[v] for v in range(V) if good[t][v])
                 > 2 * POWERS.sum() for t in (PV, PC))

    d = DeviceDriver(I, V, advance_height=True, defer_collect=True,
                     device="cpu", audit=True)
    d.set_validators(POWERS)
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    bat.set_validators(POWERS)
    lane = BlsLane(reg, I, target_signers=V, max_delay_s=1e9, device="cpu")
    flight = FlightRecorder()
    svc = VoteService(d, bat, None, bls_lane=lane, flightrec=flight,
                      ladder=ShapeLadder.plan(I, V, min_rung=8,
                                              hbm_bytes=1 << 30)
                      .with_bls(V, min_rung=V, class_rungs=()))
    assert not lane.uses_device_pairing and lane.driver is d
    assert svc.pipeline.warmup() == 3       # unsigned P = 2, 3; rung 4
    assert d.sentinel.armed

    res = svc.submit_bls(wire)
    assert res.accepted == 2 * V and res.rejected == 0
    svc.pump()                 # close both classes, clear, stage
    svc.pump()                 # dispatch
    dec = svc.poll_decisions()
    rep = svc.drain()

    assert quorum and len(dec) == I
    assert [(x.value_id, x.round) for x in dec] == [(VALUE, 0)]
    assert rep["bls"]["rejected_share_signature"] == 1
    assert rep["bls"]["agg_classes"] == 1
    assert rep["bls"]["fallback_classes"] == 1
    assert rep["bls_votes"] == rep["preverified_votes"] == 2 * V - 1
    assert rep["metrics"]["serve_bls_agg_classes"] == 1
    assert rep["metrics"]["serve_bls_fallback_votes"] == V - 1
    assert d.sentinel.metrics.counters.get(RETRACE_UNEXPECTED, 0) == 0
    assert d.sentinel.report()["entries_observed"]["bls_aggregate"] == 3
    assert flight.counts()["dispatch"] == 1
