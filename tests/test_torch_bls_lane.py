"""Port differential: the BLS aggregate lane of `agnes_tpu_torch` against
the JAX `serve.bls_lane`, fed the same wire bytes, then to a decision.

The JAX lane runs its host-pairing mode with the device aggregation
stubbed by a weighted `bls_ref` point sum (the pattern of
tests/test_bls.py, no XLA compile); the port's lane runs on the CPU in
its device-pairing mode: the real `bls_aggregate` MSMs and one
`bls_pairing_product` call, on the plain versions of the CUDA kernels.
Both see an honest prevote class, a precommit class with one forged
share, and a byte-identical replay of the forged class; their
`clear_classes` rows and counters (memo hits, fallback, rejected shares,
strikes, quarantine) must agree, and the port's host-pairing mode must
clear the same rows.  The port's cleared rows then go
through `VoteBatcher.add_class_votes` -> `build_phases` ->
`DeviceDriver.step_seq` to a decision.
"""

import functools

import numpy as np
import pytest
import torch

from agnes_tpu.crypto import bls_ref as ref
from agnes_tpu.serve import bls_lane as JL
from agnes_tpu_torch import convert
from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.crypto.encoding import vote_signing_bytes
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.serve import bls_lane as TL
from agnes_tpu_torch.serve.batcher import ShapeLadder
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PV, PC = 0, 1
V, I, VALUE = 2, 1, 7
POWERS = np.array([4, 1])             # quorum > 10/3: validator 1 can fail
FORGED = 1


def _keys():
    """sk_v = v + 1: pubkeys by cumulative G1 adds."""
    pts, acc = [], None
    for _ in range(V):
        acc = ref.point_add(acc, ref.G1)
        pts.append(acc)
    return np.stack([np.frombuffer(ref.g1_compress(p), np.uint8)
                     for p in pts])


@functools.lru_cache(maxsize=None)
def _class_wire(typ, forge=None):
    msg = ref.hash_to_g2(vote_signing_bytes(0, 0, typ, VALUE))
    shares, acc = [], None
    for _ in range(V):
        acc = ref.point_add(acc, msg)
        shares.append(np.frombuffer(ref.g2_to_bytes(acc), np.uint8))
    if forge is not None:
        shares[forge] = np.frombuffer(
            ref.g2_to_bytes(ref.point_mul(77, ref.G2)), np.uint8)
    return TL.pack_bls_wire([0] * V, list(range(V)), [0] * V, [0] * V,
                            [typ] * V, [VALUE] * V, np.stack(shares))


def _weighted_oracle_agg(reg):
    def agg(cls, signers):
        apk = asig = None
        for v in signers:
            w = int(reg.powers[v])
            apk = ref.point_add(apk, ref.point_mul(w, reg.pk_points[v]))
            asig = ref.point_add(asig, ref.point_mul(
                w, ref.g2_from_bytes(cls.shares[v])))
        return apk, asig
    return agg


def _rows_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(a[k], b[k]) for k in a if k != "t_first")


def test_lane_matches_jax_lane_then_decides():
    jreg = JL.BlsKeyRegistry(_keys(), POWERS)
    jreg.mark_trusted(np.arange(V))
    treg = convert.bls_registry_from_jax(jreg)
    hreg = convert.bls_registry_from_jax(jreg)
    assert treg.n_windows == jreg.n_windows == 1
    jlane = JL.BlsLane(jreg, I, target_signers=V, max_delay_s=1e9,
                       device_pairing=False, pallas_field=False)
    jlane._aggregate_device = _weighted_oracle_agg(jreg)
    tlane = TL.BlsLane(treg, I, target_signers=V, max_delay_s=1e9,
                       device="cpu")
    tlane.bind(None, ladder=ShapeLadder().with_bls(V, min_rung=4,
                                                   class_rungs=(1, 2)))
    assert tlane.uses_device_pairing

    wires = [_class_wire(PV) + _class_wire(PC, forge=FORGED),
             _class_wire(PC, forge=FORGED)]          # then the replay
    cleared = []
    for wire in wires:
        for lane in (jlane, tlane):
            assert lane.table.fold(wire)["folded"] == len(wire) // 224
        rows_j = jlane.clear_classes(jlane.poll())
        rows_t = tlane.clear_classes(tlane.poll())
        assert _rows_equal(rows_j, rows_t)
        cleared.append(rows_t)
    snap_j, snap_t = jlane.snapshot(), tlane.snapshot()
    assert snap_t.pop("bls_device_pairing_dispatches") == 1
    snap_j.pop("bls_device_pairing_dispatches")
    assert snap_t == snap_j
    assert snap_t["agg_classes"] == 1
    assert snap_t["fallback_classes"] == 2
    assert snap_t["rejected_share_signature"] == 2     # forged, then replay
    assert snap_t["pairing_memo_hits"] == 1
    np.testing.assert_array_equal(treg.forged_strikes, jreg.forged_strikes)
    np.testing.assert_array_equal(treg.quarantined, jreg.quarantined)
    assert treg.forged_strikes.tolist() == [0, 1]      # the replay: no strike

    # the port's host-pairing mode (no class rungs) clears the same rows
    hlane = TL.BlsLane(hreg, I, target_signers=V, max_delay_s=1e9,
                       device="cpu")
    assert not hlane.uses_device_pairing
    hlane.table.fold(wires[0])
    assert _rows_equal(hlane.clear_classes(hlane.poll()), cleared[0])
    assert hlane.snapshot()["rejected_share_signature"] == 1

    rows = cleared[0]
    assert len(rows["validator"]) == 2 * V - 1
    bat = VoteBatcher(I, V, n_slots=4, device="cpu")
    bat.set_validators(POWERS)
    bat.add_class_votes(*(rows[k] for k in ("instance", "validator",
                                            "height", "round_", "typ",
                                            "value")))
    phases = bat.build_phases()
    assert bat.rejected_signature == 0 and len(phases) == 2
    drv = DeviceDriver(I, V, advance_height=True, device="cpu")
    drv.set_validators(POWERS)
    drv.step_seq([drv.empty_phase()] + [p for p, _ in phases])
    assert bool(drv.stats.decided.all())
    assert int(drv.stats.decision_round[0]) == 0
    assert bat.decode_slot(0, int(drv.stats.decision_value[0])) == VALUE


def test_class_votes_skip_verification_beside_signed_votes():
    """Pre-verified class rows ride beside signed rows: with pubkeys the
    signed rows are verified (an unsigned one is rejected) and the class
    rows are not; their presence sends `build_phases_device` down the
    host-verified build (no lanes)."""
    from agnes_tpu_torch.harness import fixtures as fx

    pubkeys = fx.validator_pubkeys(fx.deterministic_seeds(V))
    bat = VoteBatcher(2, V, n_slots=4, device="cpu")
    bat.add_class_votes([0] * V, range(V), [0] * V, [0] * V, [PV] * V,
                        [VALUE] * V)
    bat.add_arrays([1], [0], [0], [0], [PV], [VALUE])   # no signature
    phases, lanes = bat.build_phases_device(pubkeys)
    assert lanes is None and bat.rejected_signature == 1
    assert sum(int(p.mask.sum()) for p, _ in phases) == V


def test_cuda_lane_pairs_on_the_device_unless_told_not_to():
    """Auto mode: a CUDA lane pairs on the device and raises without
    planned class rungs (it never moves the pairing to the host on its
    own); a CPU lane follows the bound ladder; False forces the host."""
    reg = convert.bls_registry_from_jax(JL.BlsKeyRegistry(_keys(), POWERS))
    lane = TL.BlsLane(reg, I, device="cpu")
    assert not lane.uses_device_pairing
    lane.device = torch.device("cuda")     # resolution only: no tensor made
    assert lane.uses_device_pairing
    with pytest.raises(ValueError, match="bls_class_rungs"):
        lane._device_pairing_sweep([])
    lane.device_pairing = False
    assert not lane.uses_device_pairing
