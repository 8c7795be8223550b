"""Measurements behind the verify kernel's design (PERF.md §6).

    python3 -m agnes_tpu_torch.scripts.verify_probe [--parent DIR]

On one NVIDIA GPU, from the repository root:

  1. issue rates of `IMAD`, `IMAD.HI`, `IMAD.WIDE` (u32, s32) and
     `IADD3`: eight independent chains a thread at full occupancy, in
     operations per clock per SM (the maximum SM clock);
  2. dependent chains of field multiplies, squarings and add + subtract
     pairs in the radix-2^25.5 field (`csrc/fe25519.cuh`) and the
     radix-2^32 one (`csrc/fe25519_r32.cuh`), in SM clocks per operation
     and lane;
  3. the SASS opcode counts of one window of the W = 5 verify loop in
     each field (`cuobjdump -sass` of a kernel that runs one window minus
     the same kernel without it; `verify_probe.cu`);
  4. the verify kernel `csrc/ed25519_verify.cu` built at CTAs of 64, 128,
     256 and 512 threads, with minimum-block launch bounds, and with the
     -A table in shared memory; with `--parent`, the `csrc/` directory of
     another checkout (e.g. the parent commit unpacked by `git archive`),
     that checkout's verify kernel too.  For each: `ptxas` registers,
     stack and spills, equality with `verify_plain` on the adversarial
     grid and 4,096 random lanes and with the first variant on every
     timed lane, and the time by CUDA events at 2,048,000 lanes (W = 5)
     and 128,000 (W = 4), the variants timed in turns, forward then back.

The builds (one `nvcc` each, all at once) go to `csrc/build/probe/`.
A measurement tool: no path of the port runs it.  Prints the card's
name and power limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from agnes_tpu_torch import cuda_build

HERE = Path(__file__).resolve().parent
OUT = cuda_build.BUILD / "probe"
N_SIGNED = 2_048_000            # the signed height's lanes (W = 5)
N_MSM = 128_000                 # the MSM height's lanes (W = 4)
CONFIGS = ((64, 0), (128, 0), (256, 0), (512, 0), (128, 4), (256, 2),
           (64, 8))             # (threads a CTA, minimum CTAs an SM)


def log(msg: str) -> None:
    print(msg, flush=True)


def _nvcc(src: Path, so: Path, inc: Path):
    cmd = [cuda_build._nvcc(), cuda_build.ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(inc),
           "-o", str(so), str(src)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}{p.stderr}")
    return cuda_build.parse_ptxas(p.stdout + p.stderr)


def _edit(src: str, edits) -> str:
    for a, b in edits:
        if a not in src:
            raise ValueError(f"verify source lacks {a!r}")
        src = src.replace(a, b)
    return src


def variants(parent: Path | None, out_dir: Path = OUT):
    """name -> directory (under out_dir) holding an edited copy of
    csrc/."""
    kt = "constexpr int kThreads = 256;"
    lb = "__launch_bounds__(kThreads)"
    out = {}

    def make(name, srcdir, edits):
        d = out_dir / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(srcdir, d, ignore=shutil.ignore_patterns("build"))
        f = d / "ed25519_verify.cu"
        f.write_text(_edit(f.read_text(), edits))
        out[name] = d

    for t, m in CONFIGS:
        edits = [(kt, f"constexpr int kThreads = {t};")]
        if m:
            edits.append((lb, f"__launch_bounds__(kThreads, {m})"))
        make(f"t{t}" + (f"_min{m}" if m else ""), cuda_build.CSRC, edits)
    # the -A table in dynamic shared memory, a 16-byte padded slot a thread
    make("t64_smem_table", cuda_build.CSRC, [
        (kt, "constexpr int kThreads = 64;"),
        ("  niels atab[kEnt];",
         "  extern __shared__ __align__(16) unsigned char ag_dyn[];\n"
         "  niels* atab = reinterpret_cast<niels*>(\n"
         "      ag_dyn + threadIdx.x * (kEnt * sizeof(niels) + 16));"),
        ("  const int64_t blocks = (B + kThreads - 1) / kThreads;",
         "  const int64_t blocks = (B + kThreads - 1) / kThreads;\n"
         "  const int smem = kThreads * (ag::Window<W>::kEnt *\n"
         "                               sizeof(ag::r32::niels) + 16);\n"
         "  cudaFuncSetAttribute(ed25519_verify_kernel<W>,\n"
         "      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);"),
        ("<<<(unsigned)blocks, kThreads, 0,",
         "<<<(unsigned)blocks, kThreads, smem,")])
    if parent is not None:
        make("parent", parent, [])
    return out


def build_chains(out_dir: Path = OUT) -> Path:
    """Build `verify_probe.cu` alone (the chain kernels of item 2); the
    path of its library."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "probe.so"
    _nvcc(HERE / "verify_probe.cu", so, cuda_build.CSRC)
    return so


def chain_latency_ns(so: Path, op: str = "r32_mul", n: int = 8192) -> float:
    """Dependent latency of one field operation in ns: item 2's chain
    kernel `p_<op>` on one warp (one CTA of 32 threads, n dependent
    operations a thread), so no other warp hides an operation's latency.
    The latency floor of a kernel whose lane is one dependent chain."""
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"p_{op}")
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    buf = torch.empty(32, dtype=torch.int32, device="cuda")
    if fn(buf.data_ptr(), 16, 1, 32):
        raise RuntimeError(f"p_{op}: launch failed")
    ms = cuda_ms(lambda: fn(buf.data_ptr(), n, 1, 32), 3)
    return ms * 1e6 / n


def sass_hist(so: Path):
    """Mangled kernel name -> {opcode: static count} (cuobjdump -sass)."""
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    p = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                       text=True, check=True)
    funcs, cur = {}, None
    for ln in p.stdout.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     ln)
        if m and cur is not None:
            cur[m.group(2)] += 1
    return funcs


def cuda_ms(fn, reps: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def signed_lanes(n_random: int, seed: int):
    """The adversarial grid plus n_random lanes from 256 signing keys:
    honest, or forged by a flipped R bit, S bit, message or key."""
    from agnes_tpu_torch.bridge.ingest import vote_messages_np
    from agnes_tpu_torch.harness import fixtures as fx

    seeds = fx.deterministic_seeds(256)
    pubkeys = fx.validator_pubkeys(seeds)
    msgs = [vote_messages_np(*[np.full(1, x, np.int64)
                               for x in (0, 0, typ, 7)])[0].tobytes()
            for typ in (0, 1)]
    sigs = [fx.sign_class(seeds, 0, typ, 7) for typ in (0, 1)]
    pubs, ms, ss = fx.adversarial_grid()
    rng = np.random.RandomState(seed)
    for _ in range(n_random):
        v, c, kind = rng.randint(256), rng.randint(2), rng.randint(5)
        sig = bytearray(sigs[c][v].tobytes())
        if kind == 1:
            sig[rng.randint(32)] ^= 1 << rng.randint(8)
        elif kind == 2:
            sig[32 + rng.randint(31)] ^= 1 << rng.randint(8)
        pubs.append(bytes(pubkeys[(v + (kind == 4)) % 256]))
        ms.append(msgs[1 - c if kind == 3 else c])
        ss.append(bytes(sig))
    return pubs, ms, ss


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc/ of another checkout whose verify kernel is "
                         "timed beside this one's")
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("verify_probe: needs an NVIDIA GPU")
    from agnes_tpu_torch.crypto import ed25519
    from agnes_tpu_torch.crypto import ed25519_ref as ref
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.crypto.field import P, limbs25

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    log(f"[card] {card}, {clock / 1e6:.0f} MHz")
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"card": card}

    # -- builds, one nvcc each, all at once --
    OUT.mkdir(parents=True, exist_ok=True)
    vs = variants(args.parent)
    jobs = {"probe": (HERE / "verify_probe.cu", OUT / "probe.so",
                      cuda_build.CSRC)}
    jobs.update({n: (d / "ed25519_verify.cu", d / "verify.so", d)
                 for n, d in vs.items()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {n: ex.submit(_nvcc, *j) for n, j in jobs.items()}
        usage = {n: f.result() for n, f in futs.items()}
    log(f"[build] {len(jobs)} sources in parallel: "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 1. issue rates, 2. chains --
    lib = ctypes.CDLL(str(jobs["probe"][1]))
    buf = torch.empty(n_sm * 2048 * 8, dtype=torch.int32, device=dev)

    def run(name, n, blocks, threads):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
        if fn(buf.data_ptr(), n, blocks, threads):
            raise RuntimeError(f"{name}: launch failed")

    res["ops_per_clock_per_sm"] = {}
    for op in ("imad", "imad_hi", "imad_wide_u32", "imad_wide_s32", "iadd3"):
        blocks, threads, n = n_sm * 8, 256, 4096
        run(f"p_{op}", 16, blocks, threads)
        ms = cuda_ms(lambda: run(f"p_{op}", n, blocks, threads), 3)
        rate = blocks * threads * n * 8 / (ms * 1e-3) / n_sm / clock
        res["ops_per_clock_per_sm"][op] = rate
        log(f"[rate] {op}: {ms:.3f} ms, {rate:.2f} a clock an SM")
    res["sm_clocks_per_op"] = {}
    lanes, n = n_sm * 2048, 256
    for field in ("r25", "r32"):
        for op in ("mul", "sq", "addsub"):
            name = f"p_{field}_{op}"
            run(name, 4, lanes // 256, 256)
            ms = cuda_ms(lambda: run(name, n, lanes // 256, 256), 3)
            clk = ms * 1e-3 * clock * n_sm / (lanes * n)
            res["sm_clocks_per_op"][f"{field}_{op}"] = clk
            log(f"[chain] {field} {op}: {ms:.3f} ms for {lanes} lanes x {n},"
                f" {clk:.3f} SM clocks an operation")

    # -- 3. one window's SASS --
    hist = sass_hist(jobs["probe"][1])
    res["window_sass"] = {}
    for field in ("r25", "r32"):
        on, off = (next(c for f, c in hist.items()
                        if f"window_{field}ILb{int(do)}E" in f)
                   for do in (True, False))
        d = {k: on[k] - off[k] for k in on.keys() | off.keys()
             if on[k] != off[k]}
        d = dict(sorted(d.items(), key=lambda kv: -kv[1]))
        res["window_sass"][field] = d
        log(f"[window] {field}: {sum(d.values())} instructions: " + ", ".join(
            f"{k} {v}" for k, v in d.items() if v > 2))

    # -- 4. the verify kernel's variants --
    pubs, ms_, sgs = signed_lanes(4096, args.seed)
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs, ms_, sgs, device=dev)
    old = limbs25(ref.D) + limbs25(2 * ref.D % P) + limbs25(ref.SQRT_M1)
    for ent in V._btable_ints():
        for c in ent:
            old += limbs25(c)
    consts = {n: torch.tensor(
        old if "30 + 17 * 30" in (d / "ed25519_verify.cu").read_text()
        else V.kernel_consts(), dtype=torch.int32, device=dev)
        for n, d in vs.items()}
    libs = {}
    for n in vs:
        libs[n] = ctypes.CDLL(str(jobs[n][1]))
        for fn in (libs[n].ag_ed25519_verify_signed5,
                   libs[n].ag_ed25519_verify_w4):
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64,
                                                   ctypes.c_void_p]

    def call(n, w, a):
        fn = (libs[n].ag_ed25519_verify_signed5 if w == 5
              else libs[n].ag_ed25519_verify_w4)
        B = a[0].shape[1]
        out = torch.empty(B, dtype=torch.int32, device=dev)
        err = fn(*(t.data_ptr() for t in a), consts[n].data_ptr(),
                 out.data_ptr(), B, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{n}: launch failed, CUDA error {err}")
        return out

    res["verify"] = {n: {"ptxas": {("w5" if "ILi5E" in f else "w4"): u
                                   for f, u in usage[n].items()}}
                     for n in vs}
    for w, big in ((5, N_SIGNED), (4, N_MSM)):
        a, _ = V.prologue(pub, sig, blocks, window=w)
        plain = V.verify_plain(*a, window=w)
        reps = -(-big // a[0].shape[1])
        ab = [t.repeat(1, reps)[:, :big].contiguous() if t.ndim == 2
              else t.repeat(reps)[:big].contiguous() for t in a]
        times = collections.defaultdict(list)
        for n in list(vs) + list(vs)[::-1]:
            call(n, w, ab)
            times[n].append(cuda_ms(lambda: call(n, w, ab), 3))
        first = call(next(iter(vs)), w, ab)
        for n in vs:
            r = res["verify"][n]
            r[f"w{w}_lanes_differing_from_plain"] = int(
                (call(n, w, a) != plain).sum())
            r[f"w{w}_lanes_differing_from_first"] = int(
                (call(n, w, ab) != first).sum())
            r[f"w{w}_ms"] = times[n]
            u = r["ptxas"].get(f"w{w}", {})
            log(f"[verify w{w}] {n}: {', '.join(f'{t:.3f}' for t in times[n])}"
                f" ms at {big} lanes; {u.get('registers')} registers, "
                f"{u.get('stack_bytes')} B stack, {u.get('spill_bytes')} B "
                f"spills; lanes differing: "
                f"{r[f'w{w}_lanes_differing_from_plain']} from plain, "
                f"{r[f'w{w}_lanes_differing_from_first']} from "
                f"{next(iter(vs))}")
        del ab
        torch.cuda.empty_cache()
    bad = {n: r for n, r in res["verify"].items()
           if any(v for k, v in r.items() if k.endswith(("plain", "first")))}
    if bad:
        raise AssertionError(f"verify variants disagree: {sorted(bad)}")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main() and 0)
