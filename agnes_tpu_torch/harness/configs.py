"""The five BASELINE.json benchmark configs (+ a liveness drill) on the
port, runnable standalone (twin of `agnes_tpu.harness.configs`).

    python -m agnes_tpu_torch.harness.configs <1..6> [--small] [--device cpu]

Each config returns the twin's metrics dict, with the twin's keys (one
JSON line on stdout).  The device configs (2-5) run on the card unless
the caller passes `--device cpu`; without a GPU every config refuses to
start unless given it (`device/encoding.py::resolve_device`).  Configs 1
and 6 are host-only, as in the twin.  `--small` shrinks the shapes for
CPU and test runs, to the twin's small shapes.

  1. 4-validator happy path, 20 heights — host executor network with
     signed, verified messages (reference state_machine.rs:331-345
     trace), then raw `apply` throughput.
  2. 100-validator prevote/precommit with Ed25519 batch verify — 2 x V
     real signatures verified in one call of `crypto/ed25519.py::
     verify_batch` (one window-5 launch of `csrc/ed25519_verify.cu` on
     the card) and tallied through `VoteExecutor` to a decision.
  3. 1000-validator multi-round with timeouts + nil prevotes — the
     device tally.
  4. 10k parallel heights x 1000 validators — the north-star shape,
     honest path, one fused dispatch a height.
  5. Byzantine equivocation sweep — 1M double-sign votes, every one
     detected on the device.
  6. Partition/heal liveness drill — a quorum-less split stalls
     without deciding, a majority split decides alone, and heal
     converges everyone.

Config 2 signs with the port's host signer (`crypto.host_sign`, the
C++ core) and cross-checks the device verdicts with the C++ batch
verifier `core.native.verify_batch` on the host, as the twin does.
Departures from the twin: its `first_call_s` is the one verify call, the
kernel's load included (the kernel is built before the clock starts),
where the twin's is an XLA compile plus a run; `verifies_per_sec` is
2 x V over that same call (the twin times a second call).  The twin's
persistent-compile-cache switch has no counterpart: the port has no XLA
cache.
"""

from __future__ import annotations

import argparse
import json
import time

from agnes_tpu_torch.types import VoteType

HOST_ONLY = (1, 6)


def _check(ok: bool, what) -> None:
    """A config's own assertion (raises under `python -O` too)."""
    if not ok:
        raise AssertionError(what)


def config1_happy_path(small: bool = False) -> dict:
    """Host-plane parity: a 4-node network decides 20 heights; then raw
    state-machine apply throughput (the reference's only benchmarkable
    surface)."""
    from agnes_tpu_torch.core import state_machine as sm
    from agnes_tpu_torch.harness.simulator import Network

    heights = 3 if small else 20
    net = Network(n=4)
    net.start()
    t0 = time.perf_counter()
    net.run_until(lambda: net.decided(heights - 1))
    dt = time.perf_counter() - t0
    for h in range(heights):
        vals = set(net.decisions(h))
        _check(vals == {100 + h}, (h, vals))

    # raw apply throughput (pure python transition fn)
    s = sm.State.new(0)
    ev = sm.Event.new_round()
    n = 20_000 if small else 200_000
    t1 = time.perf_counter()
    for _ in range(n):
        sm.apply(s, 0, ev)
    apply_rate = n / (time.perf_counter() - t1)
    return {"config": 1, "heights": heights,
            "heights_per_sec": round(heights / dt, 2),
            "host_applies_per_sec": round(apply_rate)}


def config2_votes(V: int, value: int = 42):
    """Config 2's fixture: V validators' seeds and keys, and one signed
    prevote and precommit each for `value` at height 1, round 0.
    Returns (pubkeys, messages, signatures, votes), 2 x V of each,
    prevotes first."""
    from agnes_tpu_torch.core import native
    from agnes_tpu_torch.crypto import host_sign
    from agnes_tpu_torch.crypto.encoding import vote_signing_bytes
    from agnes_tpu_torch.types import Vote

    seeds = [bytes([i % 251 + 1, i // 251]) + bytes(30) for i in range(V)]
    pks = [native.pubkey(s) for s in seeds]
    msgs, sigs, votes = [], [], []
    for typ in (VoteType.PREVOTE, VoteType.PRECOMMIT):
        m = vote_signing_bytes(1, 0, int(typ), value)
        for i in range(V):
            msgs.append(m)
            sigs.append(host_sign(seeds[i], m))
            votes.append(Vote(typ=typ, round=0, value=value, validator=i,
                              height=1))
    return pks + pks, msgs, sigs, votes


def config2_verify_lanes(small: bool = False, device="cuda"):
    """Config 2 with what its verify call saw: (result dict, (pub, sig,
    blocks) on `device`, [2V] bool verdicts on `device`)."""
    import torch

    from agnes_tpu_torch import cuda_build
    from agnes_tpu_torch.core import native
    from agnes_tpu_torch.core.state_machine import Event, State, Step
    from agnes_tpu_torch.core.vote_executor import VoteExecutor
    from agnes_tpu_torch.crypto.ed25519 import (pack_verify_inputs,
                                                verify_batch)
    from agnes_tpu_torch.crypto.ed25519_verify import KERNEL
    from agnes_tpu_torch.device.encoding import resolve_device

    dev = resolve_device(device)
    V = 8 if small else 100
    value = 42
    pks, msgs, sigs, votes = config2_votes(V, value)
    lanes = pack_verify_inputs(pks, msgs, sigs, device=dev)
    if dev.type == "cuda":
        cuda_build.build_all([KERNEL])
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ok = verify_batch(*lanes)
    verdicts = ok.cpu().numpy().tolist()       # waits for the device
    dt = time.perf_counter() - t0
    _check(all(verdicts), f"honest lanes rejected: {verdicts}")
    # host cross-check: the C++ batch verifier, lane for lane
    host = native.verify_batch(pks, msgs, sigs)
    _check(host == verdicts, "device verdicts != native.verify_batch")

    # verified votes -> tally -> decision
    state = State.new(1)
    vx = VoteExecutor(height=1, total_weight=V)
    state, _ = state.apply(0, Event.new_round_proposer(value))
    state, _ = state.apply(0, Event.proposal(-1, value))
    for v, valid in zip(votes, verdicts):
        if valid:
            ev = vx.apply(v, 1)
            if ev is not None:
                state, _ = state.apply(0, ev)
    _check(state.step == Step.COMMIT, f"no decision: {state}")
    return ({"config": 2, "validators": V,
             "verifies_per_sec": round(2 * V / dt),
             "first_call_s": round(dt, 2),
             "decided": True}, lanes, ok)


def config2_verify_100(small: bool = False, device="cuda") -> dict:
    """100 validators, one height: every prevote+precommit is a real
    Ed25519 signature, batch-verified on the device in one call, checked
    against the host oracle, then tallied to decision."""
    return config2_verify_lanes(small, device)[0]


def config3_multiround(small: bool = False, device="cuda") -> dict:
    """1000-validator tally, multi-round: round 0 times out on nil
    votes, round 1 receives a proposal and decides."""
    from agnes_tpu_torch.harness.device_driver import DeviceDriver

    I, V = (8, 64) if small else (256, 1000)
    d = DeviceDriver(I, V, proposer_is_self=False, device=device)
    t0 = time.perf_counter()
    d.run_nil_round(0)
    d.run_proposed_round(1, slot=1)
    d.block_until_ready()
    dt = time.perf_counter() - t0
    _check(d.all_decided(), "config 3: not every instance decided")
    _check(bool((d.stats.decision_round == 1).all()),
           f"config 3: decision rounds {set(d.stats.decision_round)}")
    return {"config": 3, "instances": I, "validators": V,
            "rounds": 2, "votes_tallied": d.stats.votes_ingested,
            "votes_per_sec": round(d.stats.votes_ingested / dt)}


def config4_parallel_heights(small: bool = False, device="cuda") -> dict:
    """10k concurrent instances x 1000 validators — the north star
    shape, honest path."""
    from agnes_tpu_torch.harness.device_driver import DeviceDriver

    I, V = (16, 32) if small else (10_000, 1000)
    # a first height on a throwaway driver: the first launch of each
    # operator (the whole honest height is one fused dispatch,
    # device/step.py honest_heights)
    d = DeviceDriver(I, V, advance_height=True, device=device)
    d.run_heights_fused(1)
    d.block_until_ready()
    d2 = DeviceDriver(I, V, advance_height=True, device=device)
    t0 = time.perf_counter()
    d2.run_heights_fused(1)
    d2.block_until_ready()
    dt = time.perf_counter() - t0
    _check(d2.all_decided(), "config 4: not every instance decided")
    votes = d2.stats.votes_ingested
    return {"config": 4, "instances": I, "validators": V,
            "votes_per_sec": round(votes / dt),
            "decisions_per_sec": round(I / dt)}


def config5_byzantine_sweep(small: bool = False, device="cuda") -> dict:
    """Equivocation sweep: every validator double-signs in every
    instance — 1M conflicting votes at full shape — and every one is
    detected on the device (the per-validator seen-record, SURVEY §2.3
    fix 2), while the honest quorum still decides."""
    from agnes_tpu_torch.harness.device_driver import DeviceDriver

    I, V = (8, 32) if small else (1000, 1000)
    d = DeviceDriver(I, V, device=device)
    t0 = time.perf_counter()
    d.step()  # entry + self-proposal
    # first prevote: everyone votes slot 1; then everyone re-votes
    # conflicting slot 2 (double-sign)
    expected = d.run_equivocation_phase(0, VoteType.PREVOTE, 1, 2, 1.0)
    d.block_until_ready()
    dt = time.perf_counter() - t0
    det = d.equivocators_detected()
    _check(bool((det == expected).all()), (det[:4], expected))
    # first votes kept counting: the polka for slot 1 still stands
    d.step(phase=d.phase(0, VoteType.PRECOMMIT, 1))
    _check(d.all_decided(), "config 5: not every instance decided")
    double_signs = I * V
    return {"config": 5, "instances": I, "validators": V,
            "double_sign_votes": double_signs,
            "detected_per_instance": int(det[0]),
            "detect_votes_per_sec": round(2 * double_signs / dt),
            "decided_despite_byzantine": True}


def config6_partition_liveness(small: bool = False) -> dict:
    """Network-fault liveness drill on the host plane: (a) a 2-2 split
    of 4 nodes has no +2/3 side — nobody decides; (b) heal delivers
    the gossip-held traffic and the timeout chain drives a unanimous
    round>=1 decision; (c) a 5-2 split decides on the majority side
    alone and the minority catches up on heal (commit-from-any-round
    over held precommits)."""
    from agnes_tpu_torch.harness.simulator import Network

    t0 = time.perf_counter()
    net = Network(n=4)
    net.start()
    heal_round = net.partition_heal_drill([0, 1], [2, 3])

    # majority side must keep +2/3: 4-1 at small, 5-2 at full
    n2, n_min = (5, 1) if small else (7, 2)
    maj = list(range(n2 - n_min))
    minority = list(range(n2 - n_min, n2))
    net2 = Network(n=n2)
    net2.start()
    net2.partition(maj, minority)
    net2.run_until(lambda: all(0 in net2.nodes[i].decided for i in maj))
    _check(not any(0 in net2.nodes[i].decided for i in minority),
           "config 6: the minority decided while split")
    net2.heal()
    net2.run_until(lambda: net2.decided(0))
    _check(len(set(net2.decisions(0))) == 1,
           f"config 6: decisions {net2.decisions(0)}")
    dt = time.perf_counter() - t0
    return {"config": 6, "quorumless_split_stalled": True,
            "healed_decision_round": int(heal_round),
            "majority_decided_alone": True,
            "minority_caught_up_on_heal": True,
            "wall_s": round(dt, 2)}


CONFIGS = {1: config1_happy_path, 2: config2_verify_100,
           3: config3_multiround, 4: config4_parallel_heights,
           5: config5_byzantine_sweep, 6: config6_partition_liveness}


def run(n: int, small: bool = False, device="cuda") -> dict:
    """Config `n` on `device`.  The host-only configs refuse a missing
    card too: one placement rule for the whole CLI."""
    from agnes_tpu_torch.device.encoding import resolve_device

    resolve_device(device)
    if n in HOST_ONLY:
        return CONFIGS[n](small=small)
    return CONFIGS[n](small=small, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Run one benchmark config of the PyTorch port.")
    ap.add_argument("config", type=int, choices=sorted(CONFIGS))
    ap.add_argument("--small", action="store_true",
                    help="the twin's small shapes (CPU and test runs)")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default) or "cpu"')
    a = ap.parse_args(argv)
    print(json.dumps(run(a.config, small=a.small, device=a.device)))


if __name__ == "__main__":
    main()
