#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Drives `agnes_tpu_torch` (never the JAX package) on the card:

  1. prints the card and its power limit; builds every CUDA kernel from
     `agnes_tpu_torch/csrc/` with nvcc (one process per source, started
     together) and prints the build time and `ptxas` registers/spills;
  2. holds the Ed25519 verify kernel against its plain PyTorch version
     on the card, lane for lane: the adversarial grid and the torsioned
     case (both also against the RFC 8032 oracle `ed25519_ref.verify`)
     plus 4,096 random honest and forged lanes;
  3. one signed consensus height at full width — I = 1,024 instances x
     V = 1,000 validators, an entry phase plus a prevote and a precommit
     class, 2,048,000 signed lanes with validator 7 forged in both
     classes — through VoteBatcher.add_arrays -> build_phases_device ->
     DeviceDriver.step_seq_signed; every instance must decide value 7 in
     round 0 with exactly 2 x I rejected lanes, and the verify kernel's
     launch count over this run must be above zero.  The step is then
     repeated on a fresh driver (same decisions) to time it warm, the
     prologue is timed alone, and the kernel and its plain version are
     timed on this run's 2,048,000 lanes and compared on all of them;
  4. four unsigned honest heights at I = 10,000 x V = 1,000
     (run_heights_fused): every instance must decide four heights.

Prints a JSON line of kernel numbers, the `nvidia-smi` name/power line,
and last `{"ok": true, "device": {...}}`.  Any failed check raises:
the exit code is non-zero and no result line is printed.  Exits 1
without a CUDA device, 2 outside the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

DEVICE = "cuda"
SEED = 20261016
I_SIGNED, V_SIGNED = 1024, 1000
I_UNSIGNED, V_UNSIGNED, HEIGHTS = 10_000, 1_000, 4
FORGED = 7
VALUE = 7
N_RANDOM = 4096
KERNEL_REPS = 3


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn()` over `reps` runs, by CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_lanes(rng, pubkeys, msgs, sigs, n):
    """n lanes drawn from the signed fixture: honest, or forged by a
    flipped R bit, a flipped S bit, another message or another key."""
    V = len(pubkeys)
    pubs, ms, ss = [], [], []
    for k in range(n):
        v, c, kind = rng.randint(V), rng.randint(2), rng.randint(5)
        pub, msg = bytes(pubkeys[v]), bytes(msgs[c])
        sig = bytearray(sigs[c][v].tobytes())
        if kind == 1:
            sig[rng.randint(32)] ^= 1 << rng.randint(8)
        elif kind == 2:
            sig[32 + rng.randint(31)] ^= 1 << rng.randint(8)
        elif kind == 3:
            msg = bytes(msgs[1 - c])
        elif kind == 4:
            pub = bytes(pubkeys[(v + 1 + rng.randint(V - 1)) % V])
        pubs.append(pub)
        ms.append(msg)
        ss.append(bytes(sig))
    return pubs, ms, ss


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from agnes_tpu_torch import cuda_build
        from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
        from agnes_tpu_torch.crypto import ed25519
        from agnes_tpu_torch.crypto import ed25519_ref as ref
        from agnes_tpu_torch.crypto import verify as V
        from agnes_tpu_torch.harness import fixtures as fx
        from agnes_tpu_torch.harness.device_driver import DeviceDriver
        from agnes_tpu_torch.types import VoteType
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    dev = torch.device(DEVICE)
    card = smi("name,power.limit")
    log(f"[card] {card}")
    props = torch.cuda.get_device_properties(0)
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build_all([V.KERNEL])
    log(f"[build] {V.KERNEL}: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_build.build_seconds[V.KERNEL]:.1f} s)")
    for line in cuda_build.ptxas_report(V.KERNEL):
        log(f"[build] {line}")

    # -- fixture: one signature per validator per class -------------------
    t0 = time.perf_counter()
    seeds = fx.deterministic_seeds(V_SIGNED)
    pubkeys = fx.validator_pubkeys(seeds)
    classes = (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT))
    sigs = [fx.sign_class(seeds, 0, typ, VALUE, forge_validator=FORGED)
            for typ in classes]
    msgs = [vote_messages_np(*[np.full(1, x, np.int64)
                               for x in (0, 0, typ, VALUE)])[0].tobytes()
            for typ in classes]
    log(f"[fixture] {V_SIGNED} keys, {2 * V_SIGNED} signatures: "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 2: kernel vs plain on the card -----------------------------
    grid = fx.adversarial_grid()
    sk, pk = ref.keypair(bytes([1]) * 32)
    tmsg = b"\x05" * 45
    honest = ref.sign(sk, tmsg)
    tors = fx.torsioned_sig(bytes([7]) * 32, tmsg)
    pubs = grid[0] + [pk, tors[0], pk]
    mss = grid[1] + [tmsg, tmsg, tmsg]
    sgs = grid[2] + [honest, tors[2], bytes([honest[0] ^ 1]) + honest[1:]]
    want = np.array([ref.verify(p, m, s) for p, m, s in zip(pubs, mss, sgs)])
    if not (want[:4].all() and want[17] and not want[4:17].any()
            and want.tolist()[-3:] == [True, True, False]):
        raise AssertionError(f"oracle grid changed: {want.tolist()}")
    rng = np.random.RandomState(SEED)
    rp, rm, rs = random_lanes(rng, pubkeys, msgs, sigs, N_RANDOM)
    n_grid = len(pubs)
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs + rp, mss + rm,
                                                  sgs + rs, device=dev)
    args, ok_s = V.prologue(pub, sig, blocks)
    got_k = V.verify_signed5(*args)
    got_p = V.verify_plain(*args)
    torch.cuda.synchronize()
    mism_small = int((got_k != got_p).sum())
    full_k = ((got_k > 0) & ok_s).cpu().numpy()
    if mism_small or not (full_k[:n_grid] == want).all():
        raise AssertionError(
            f"verify kernel disagrees: {mism_small} lanes vs plain; grid "
            f"kernel {full_k[:n_grid].astype(int).tolist()} oracle "
            f"{want.astype(int).tolist()}")
    batch_ok = ed25519.verify_batch(pub[:n_grid], sig[:n_grid],
                                    blocks[:n_grid]).cpu().numpy()
    if not (batch_ok == want).all():
        raise AssertionError("verify_batch disagrees with the oracle")
    log(f"[verify] kernel == plain on {n_grid + N_RANDOM} lanes "
        f"({int(full_k[n_grid:].sum())} of {N_RANDOM} random lanes valid); "
        f"grid == ed25519_ref on {n_grid} lanes")

    # -- phase 3: one signed height at full width (the main path) ---------
    I, Vn = I_SIGNED, V_SIGNED
    torch.cuda.synchronize()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
    for c, typ in enumerate(classes):
        bat.add_arrays(*fx.full_mesh_cols(I, Vn, seeds, 0, typ, VALUE,
                                          sigs=sigs[c]))
    t_add = time.perf_counter() - t0
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
    if lanes is None or len(phases) != 2:
        raise AssertionError("signed height did not take the device path")
    t_build = time.perf_counter() - t0
    drv = DeviceDriver(I, Vn, advance_height=True, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    drv.step_seq_signed([drv.empty_phase()] + [p for p, _ in phases], lanes)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    launches = V.LAUNCHES
    n_lanes = int(lanes.pub.shape[0])
    values = {bat.decode_slot(i, int(s))
              for i, s in enumerate(drv.stats.decision_value)}
    checks = {
        "all decided": bool(drv.stats.decided.all()),
        "round 0": bool((drv.stats.decision_round == 0).all()),
        f"value {VALUE}": values == {VALUE},
        "rejected == 2I": drv.rejected_signature_device == 2 * I,
        "heights advanced": bool((drv.state.height == 1).all()),
        "kernel launched": launches > 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"signed height failed: {checks}")
    log(f"[signed] I={I} V={Vn} lanes={n_lanes} rejected="
        f"{drv.rejected_signature_device} launches={launches} wall="
        f"{wall:.3f} s (add_arrays {t_add:.3f} s, build_phases_device "
        f"{t_build - t_add:.3f} s, step {t_step:.3f} s) "
        f"verified votes/s={n_lanes / wall:.0f} (step only "
        f"{n_lanes / t_step:.0f})")

    # the same step again on a fresh driver: steady state, without the
    # first launch of each operator (its decisions must not change)
    warm = DeviceDriver(I, Vn, advance_height=True, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    warm.step_seq_signed([warm.empty_phase()] + [p for p, _ in phases], lanes)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t1
    if not ((warm.stats.decision_value == drv.stats.decision_value).all()
            and warm.rejected_signature_device == 2 * I):
        raise AssertionError("repeated signed height diverged")
    log(f"[signed] repeat step (warm) {t_warm:.3f} s, verified votes/s="
        f"{n_lanes / t_warm:.0f}")

    # where the step's time goes, then kernel vs plain at this lane count
    prologue_ms = cuda_ms(lambda: V.prologue(lanes.pub, lanes.sig,
                                             lanes.blocks), 1)
    args, _ = V.prologue(lanes.pub, lanes.sig, lanes.blocks)
    V.verify_signed5(*args)                      # warm
    ms = cuda_ms(lambda: V.verify_signed5(*args), KERNEL_REPS)
    out_k = V.verify_signed5(*args)
    plain = {}
    plain_ms = cuda_ms(lambda: plain.setdefault("ok", V.verify_plain(*args)),
                       1)
    mism = int((out_k != plain["ok"]).sum())
    max_err = int((out_k - plain["ok"]).abs().max())
    del plain
    if mism:
        raise AssertionError(f"kernel != plain on {mism} of {n_lanes} lanes")
    int32_rate = props.multi_processor_count * 64 * sm_clock_mhz * 1e6
    ops_ms = V.INT32_OPS_PER_LANE * n_lanes / int32_rate * 1e3
    bytes_ms = V.BYTES_PER_LANE * n_lanes / 3.35e12 * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"[verify] B={n_lanes}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms,"
        f" bound {bound_ms:.3f} ms ({V.INT32_OPS_PER_LANE} int32 ops/lane "
        f"at {props.multi_processor_count} SMs x 64 x {sm_clock_mhz:.0f} "
        f"MHz; bytes {bytes_ms:.3f} ms), kernel-only verifies/s="
        f"{n_lanes / ms * 1e3:.0f}; prologue {prologue_ms:.3f} ms, rest of "
        f"the warm step {t_warm * 1e3 - prologue_ms - ms:.3f} ms")
    del args, lanes, phases, bat, drv, warm
    torch.cuda.empty_cache()

    # -- phase 4: unsigned heights at the north-star state size -----------
    t0 = time.perf_counter()
    d4 = DeviceDriver(I_UNSIGNED, V_UNSIGNED, advance_height=True,
                      device=dev)
    d4.run_heights_fused(HEIGHTS)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    if not (bool((d4.state.height == HEIGHTS).all())
            and d4.stats.decisions_total == HEIGHTS * I_UNSIGNED):
        raise AssertionError("unsigned heights did not all decide")
    votes = 2 * HEIGHTS * I_UNSIGNED * V_UNSIGNED
    log(f"[unsigned] I={I_UNSIGNED} V={V_UNSIGNED} heights={HEIGHTS} "
        f"wall={wall4:.3f} s votes/s={votes / wall4:.0f} peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[total] {time.perf_counter() - t_all:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "ed25519_verify_signed5",
        "route": "cuda",
        "source": "agnes_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "agnes_tpu/crypto/pallas_verify.py:409",
        "launches": launches,
        "max_abs_err": max_err,
        "mismatches": mism + mism_small,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "lanes": n_lanes,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
