"""Card-only tests of the port (marker `cuda`): the CUDA verify kernel
against its plain PyTorch version and the RFC 8032 oracle, and one small
signed height through the default-device entry points.  They skip where
no GPU is present; on the card run

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports neither jax nor agnes_tpu, so it runs on a machine
that has only the port's dependencies.
"""

import numpy as np
import pytest
import torch

from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.crypto import ed25519
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import verify as V
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _grid_plus_random(n_random=64):
    pubs, msgs, sigs = fx.adversarial_grid()
    rng = np.random.RandomState(3)
    for k in range(n_random):
        sk, pk = ref.keypair(rng.bytes(32))
        m = rng.bytes(45)
        s = ref.sign(sk, m)
        if k % 2:
            s = bytes([s[0] ^ 1 << (k % 8)]) + s[1:]
        pubs.append(pk)
        msgs.append(m)
        sigs.append(s)
    return pubs, msgs, sigs


def test_kernel_matches_plain_and_oracle(cuda):
    pubs, msgs, sigs = _grid_plus_random()
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs, msgs, sigs,
                                                  device=cuda)
    args, ok_s = V.prologue(pub, sig, blocks)
    n0 = V.LAUNCHES
    got = V.verify_signed5(*args)
    assert V.LAUNCHES == n0 + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  V.verify_plain(*args).cpu().numpy())
    want = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert ((got > 0) & ok_s).cpu().tolist() == want


def test_signed_height_on_default_device(cuda):
    I, Vn = 8, 4
    seeds = fx.deterministic_seeds(Vn)
    bat = VoteBatcher(I, Vn, n_slots=4)
    for typ in (0, 1):
        bat.add_arrays(*fx.full_mesh_cols(I, Vn, seeds, 0, typ, 9,
                                          forge_validator=0))
    phases, lanes = bat.build_phases_device(fx.validator_pubkeys(seeds),
                                            phase_offset=1, lane_floor=80)
    drv = DeviceDriver(I, Vn, advance_height=True)
    assert drv.state.round.is_cuda and lanes.pub.is_cuda
    n0 = V.LAUNCHES
    drv.step_seq_signed([drv.empty_phase()] + [p for p, _ in phases], lanes)
    assert V.LAUNCHES > n0
    assert drv.all_decided() and drv.rejected_signature_device == 2 * I
    assert {bat.decode_slot(i, int(s))
            for i, s in enumerate(drv.stats.decision_value)} == {9}
