"""The six benchmark configs on the port (`agnes_tpu_torch.harness.
configs`) under `--small --device cpu`, against the JAX package's
`agnes_tpu.harness.configs`.

Configs 1 and 6 (host plane) must give the twin's `--small` result on
every key that is not a time or a rate.  Configs 3, 4 and 5 must give
the twin's counts and detections; the twin's side compiles JAX steps
(~28 s on one core), so that comparison is `slow`, and a tier-1 case
checks the port's counts against their closed forms.  Config 2 runs the
plain verify on its 16 lanes: its verdicts must be the RFC 8032
oracle's, and a forged lane at the same shape must be rejected.
"""

import json

import pytest
import torch

from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto.ed25519 import pack_verify_inputs, verify_batch
from agnes_tpu_torch.harness import configs as C
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TIMED = {"heights_per_sec", "host_applies_per_sec", "verifies_per_sec",
         "first_call_s", "votes_per_sec", "decisions_per_sec",
         "detect_votes_per_sec", "wall_s"}


def _untimed(d):
    return {k: v for k, v in d.items() if k not in TIMED}


@pytest.mark.parametrize("n", [1, 6])
def test_host_configs_equal_the_twin(n, capsys):
    from agnes_tpu.harness import configs as J

    C.main([str(n), "--small", "--device", "cpu"])
    mine = json.loads(capsys.readouterr().out)
    theirs = J.CONFIGS[n](small=True)
    assert mine.keys() == theirs.keys()
    assert _untimed(mine) == _untimed(theirs)
    assert all(mine[k] > 0 for k in mine.keys() & TIMED)


def test_device_configs_counts_in_closed_form():
    r3 = C.run(3, small=True, device="cpu")
    assert r3["votes_tallied"] == 2 * 2 * r3["instances"] * r3["validators"]
    r4 = C.run(4, small=True, device="cpu")
    assert (r4["instances"], r4["validators"]) == (16, 32)
    r5 = C.run(5, small=True, device="cpu")
    assert r5["detected_per_instance"] == r5["validators"] == 32
    assert r5["double_sign_votes"] == r5["instances"] * r5["validators"]
    assert r5["decided_despite_byzantine"]
    for r in (r3, r4, r5):
        assert all(r[k] > 0 for k in r.keys() & TIMED)


@pytest.mark.slow
def test_device_configs_equal_the_twin():
    """Twin side: three JAX step compiles."""
    from agnes_tpu.harness import configs as J

    for n in (3, 4, 5):
        mine = C.run(n, small=True, device="cpu")
        theirs = J.CONFIGS[n](small=True)
        assert mine.keys() == theirs.keys()
        assert _untimed(mine) == _untimed(theirs)


def test_config2_verdicts_and_a_forged_lane():
    result, lanes, ok = C.config2_verify_lanes(small=True, device="cpu")
    assert _untimed(result) == {"config": 2, "validators": 8,
                                "decided": True}
    pks, msgs, sigs, _ = C.config2_votes(8)
    assert ok.shape == (16,) and lanes[0].shape == (16, 32)
    assert ok.tolist() == [ref.verify(p, m, s)
                           for p, m, s in zip(pks, msgs, sigs)]
    # one forged lane (S + 1) at the same shape: rejected, the rest pass
    forged = list(sigs)
    s = int.from_bytes(sigs[11][32:], "little")
    forged[11] = sigs[11][:32] + ((s + 1) % ref.L).to_bytes(32, "little")
    got = verify_batch(*pack_verify_inputs(pks, msgs, forged,
                                           device="cpu")).tolist()
    assert got == [ref.verify(p, m, s) for p, m, s in zip(pks, msgs, forged)]
    assert got == [i != 11 for i in range(16)]


def test_configs_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card path runs")
    for n in C.CONFIGS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            C.run(n, small=True)
