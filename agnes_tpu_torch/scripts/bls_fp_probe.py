"""Measurements behind the BLS12-381 field kernels' design (PERF.md §6).

    python3 -m agnes_tpu_torch.scripts.bls_fp_probe [--parent DIR]
                                                     [--rows R ...]

On one NVIDIA GPU, from the repository root: builds `csrc/bls_fp.cu` as
it is (CTAs of up to 128 threads), of up to 64 threads, without the
final chain over limb pairs (`nochain`: wrong limbs, timed only to bound
the chain's share), and with `--parent` the `bls_fp.cu` of another
checkout's `csrc/` (e.g. the parent commit unpacked by `git archive`;
its kernels take limbs-first [33, R] operands and one thread an
element), one `nvcc` each, all at once.  For
each build: the `nvcc` seconds, and per kernel function (one per group
size G) the `ptxas` registers, stack and spill bytes and the SASS
instruction count (`cuobjdump -sass`).  Then, at each row count (the
BLS lane's most-launched ones, a G2 add's stack at rung 1,024 and
1,048,576), the multiply and the reduce (1 pass) of every build at every
G are timed by CUDA events, in turns forward then back, with the card
held busy while the launches are queued (`device_ms`), so the times are
the device's and not the Python launch path's.  The parent is timed as
its wrapper ran it: the transposing copies into [33, R] and the launch.
Every output but `nochain`'s is held against the plain version on every
timed row; a difference raises.  With `--parent`, `lane_ab` then times
the lane's `bls_aggregate` with either tree's wrappers and kernels in
turns within one process.  Beside them, the host time a wrapper
call takes (`host_us`, this tree's `bls_field.mul_rows` / `reduce_rows`
and the parent's wrapper path) at 1 and 108 rows: the lane's launches
are that small, and its calls are bound by their host path.

The builds go to `csrc/build/bls_probe/`.  A measurement tool: no path
of the port runs it.  Prints the card's name and power limit first and
one JSON object last.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from agnes_tpu_torch import cuda_build
from agnes_tpu_torch.scripts.verify_probe import sass_hist

OUT = cuda_build.BUILD / "bls_probe"
#: the lane's most-launched row counts (chip_smoke.py phase 6: 1 and 3
#: per bls_aggregate, 4 and 108 per bls_pairing_product for the
#: multiply; 1 and 6, 48 and 144 for the reduce), the larger stacks of
#: its MSMs, a G2 add's fv_mul_pairs stack at rung 1,024 and the
#: throughput shape
ROWS = (1, 3, 4, 6, 48, 108, 144, 432, 1024, 2048, 4096, 6144, 12_288,
        18_432, 65_536, 262_144, 1 << 20)
THREADS = (128, 64)             # CTA sizes built; the first is the source's
BASE_ROWS = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def nvcc(src: Path, so: Path):
    """Build one source; (ptxas usage by function, seconds)."""
    cmd = [cuda_build._nvcc(), cuda_build.ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
           str(src.parent), "-o", str(so), str(src)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}{p.stderr}")
    return cuda_build.parse_ptxas(p.stdout + p.stderr), secs


def variants(parent: Path | None, out_dir: Path = OUT):
    """name -> bls_fp.cu path of each build (edited copies under
    out_dir)."""
    kt = "constexpr int kThreads = 128;"
    out = {}
    for t in THREADS:
        d = out_dir / f"t{t}"
        d.mkdir(parents=True, exist_ok=True)
        src = (cuda_build.CSRC / "bls_fp.cu").read_text()
        if kt not in src:
            raise ValueError(f"bls_fp.cu lacks {kt!r}")
        (d / "bls_fp.cu").write_text(
            src.replace(kt, f"constexpr int kThreads = {t};"))
        out[f"t{t}"] = d / "bls_fp.cu"
    # timing only: the chain over 17 limb pairs left out (wrong limbs),
    # to bound its share of a launch
    d = out_dir / "nochain"
    d.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / "bls_fp.cu").read_text()
    loop = "AG_BLS_UNROLL for (int k = 0; k < kLow / 2; ++k) {"
    if loop not in src:
        raise ValueError(f"bls_fp.cu lacks {loop!r}")
    (d / "bls_fp.cu").write_text(src.replace(
        loop, "AG_BLS_UNROLL for (int k = 0; k < 0; ++k) {"))
    out["nochain"] = d / "bls_fp.cu"
    if parent is not None:
        d = out_dir / "parent"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(parent) / "bls_fp.cu", d / "bls_fp.cu")
        out["parent"] = d / "bls_fp.cu"
    return out


def host_us(fn, reps: int = 2000) -> float:
    """Host time of one `fn()` call in microseconds (the best of three
    loops of `reps`, not synchronized: at the lane's small row counts the
    card finishes each launch before the next is issued)."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return best


def device_ms(fn, reps: int) -> float:
    """Device time of one `fn()`, by CUDA events around `reps` launches
    queued while the card sleeps, so they run back to back."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class ParentKernels:
    """The limbs-first kernels of an earlier `bls_fp.cu` (one thread an
    element), called through a copy of the parent's wrapper path
    (`bls_field.mul_rows` / `reduce_rows` at the parent commit)."""

    def __init__(self, so: Path):
        self.lib = ctypes.CDLL(str(so))
        self.lib.ag_bls_fp_mul.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_void_p]
        self.lib.ag_bls_fp_reduce.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]

    @staticmethod
    def _check(*ts):
        for t in ts:
            if t.dtype != torch.int32 or t.shape[-1] != 33:
                raise ValueError("[..., 33] int32 limbs")

    def _launch(self, fn, dev, *args):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*args, stream)
        if err:
            raise RuntimeError(f"parent bls_fp launch failed: {err}")

    def mul(self, xa, ya):
        self._check(xa, ya)
        xa, ya = torch.broadcast_tensors(xa, ya)
        lead = xa.shape[:-1]
        xt, yt = (a.reshape(-1, 33).t().contiguous() for a in (xa, ya))
        out = torch.empty_like(xt)
        self._launch(self.lib.ag_bls_fp_mul, xt.device, xt.data_ptr(),
                     yt.data_ptr(), out.data_ptr(), out.shape[1])
        return out.t().reshape(lead + (33,))

    def reduce(self, cols, passes):
        self._check(cols)
        lead = cols.shape[:-1]
        ct = cols.reshape(-1, 33).t().contiguous()
        out = torch.empty_like(ct)
        self._launch(self.lib.ag_bls_fp_reduce, ct.device, ct.data_ptr(),
                     out.data_ptr(), out.shape[1], passes)
        return out.t().reshape(lead + (33,))


class Kernels:
    """This design's kernels from one build, at a chosen group size."""

    def __init__(self, so: Path):
        self.lib = ctypes.CDLL(str(so))
        self.lib.ag_bls_fp_mul.argtypes = [ctypes.c_void_p, ctypes.c_int64
                                           ] * 2 + [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        self.lib.ag_bls_fp_reduce.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def mul(self, xa, ya, group):
        out = torch.empty_like(xa)
        err = self.lib.ag_bls_fp_mul(
            xa.data_ptr(), 33, ya.data_ptr(), 33, out.data_ptr(),
            out.shape[0], group, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bls_fp mul launch failed: {err}")
        return out

    def reduce(self, cols, passes, group):
        out = torch.empty_like(cols)
        err = self.lib.ag_bls_fp_reduce(
            cols.data_ptr(), 33, out.data_ptr(), out.shape[0], passes, group,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bls_fp reduce launch failed: {err}")
        return out


def operand_rows(rng, n: int, dev) -> torch.Tensor:
    """[n, 33]: the edges 0, 1, p-1, p, 4p-1, then loose rows a + b
    (a, b < 2p), the operand envelope of fv_mul_pairs."""
    from agnes_tpu_torch.crypto import bls_field as BF
    from agnes_tpu_torch.crypto.bls_ref import P

    def below(b):
        return int.from_bytes(rng.bytes(56), "little") % b

    rows = [BF.to_limbs(v) for v in (0, 1, P - 1, P, 4 * P - 1)]
    rows += [BF.to_limbs(below(2 * P)) + BF.to_limbs(below(2 * P))
             for _ in range(n - len(rows))]
    return torch.from_numpy(np.stack(rows).astype(np.int32)).to(dev)


def lane_ab(parent: "ParentKernels", dev, pairs: int, seed: int) -> dict:
    """`bls_aggregate` of one vote class at the lane's rung (1,000
    signers padded to 1,024, 24-bit heavy-tailed stake: 6 windows), its
    field kernels and wrappers swapped in one process between this
    tree's and the parent's (`bls_field.mul_rows` / `reduce_rows`, the
    only difference of the two `bls_field` modules), `pairs` pairs in
    alternating order, each call's wall by the host clock around a
    synchronize: the end-to-end effect of the kernels on the lane's
    aggregate without the noise between processes."""
    from agnes_tpu_torch.crypto import bls as BLS
    from agnes_tpu_torch.crypto import bls_field as BF
    from agnes_tpu_torch.crypto import bls_ref as bref

    n, rung = 1000, 1024
    r = np.random.RandomState(seed)
    w = np.minimum(np.floor(np.exp2(24 * r.random_sample(n) ** 2)),
                   (1 << 24) - 1).astype(np.int64)
    msg = bref.hash_to_g2(b"bls_fp_probe lane")
    pks, shares, a, b = [], [], None, None
    for _ in range(n):
        a, b = bref.point_add(a, bref.G1), bref.point_add(b, msg)
        pks.append(a)
        shares.append(b)
    pad = rung - n                                   # weight-0 lanes
    args = [torch.from_numpy(x).to(dev) for x in (
        BLS.pack_g1_rows(pks + pks[:pad]),
        BLS.pack_g2_rows(shares + shares[:pad]),
        BLS.pack_weights(np.concatenate([w, np.zeros(pad, np.int64)])))]
    paths = {"new": (BF.mul_rows, BF.reduce_rows),
             "parent": (parent.mul, parent.reduce)}
    walls = {"new": [], "parent": []}
    outs = {}
    try:
        for i in range(pairs + 1):
            order = ("new", "parent") if i % 2 else ("parent", "new")
            for which in order:
                BF.mul_rows, BF.reduce_rows = paths[which]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = BLS.bls_aggregate(*args, n_windows=6)
                torch.cuda.synchronize()
                if i:                                # the first pair warms
                    walls[which].append(time.perf_counter() - t0)
                outs[which] = (BLS.g1_from_device(out[0]),
                               BLS.g2_from_device(out[1]))
    finally:
        BF.mul_rows, BF.reduce_rows = paths["new"]
    if outs["new"] != outs["parent"]:
        raise AssertionError("lane A/B: the aggregates differ")
    wins = sum(x < y for x, y in zip(walls["new"], walls["parent"]))
    return {"walls_s": walls, "new_faster_pairs": wins, "pairs": pairs,
            "median_s": {k: float(np.median(v)) for k, v in walls.items()}}


def plain_chunked(fn, *xs, chunk: int = 1 << 17):
    return torch.cat([fn(*(x[i:i + chunk] for x in xs))
                      for i in range(0, xs[0].shape[0], chunk)])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc/ of another checkout whose bls_fp.cu is "
                         "timed beside this one's")
    ap.add_argument("--rows", type=int, nargs="*", default=list(ROWS))
    ap.add_argument("--seed", type=int, default=6)
    ap.add_argument("--lane-pairs", type=int, default=8,
                    help="with --parent: bls_aggregate calls A/B, pairs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bls_fp_probe: needs an NVIDIA GPU")
    from agnes_tpu_torch.crypto import bls_field as BF

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[card] {card}")
    dev = torch.device("cuda")
    res = {"card": card, "builds": {}, "times": {}}

    srcs = variants(args.parent)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(srcs)) as ex:
        futs = {n: ex.submit(nvcc, s, s.with_suffix(".so"))
                for n, s in srcs.items()}
        built = {n: f.result() for n, f in futs.items()}
    log(f"[build] {len(srcs)} sources in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for n, (usage, secs) in built.items():
        hist = sass_hist(srcs[n].with_suffix(".so"))
        fns = {}
        for f, u in usage.items():
            fns[f] = dict(u, sass=sum(hist.get(f, {}).values()))
        res["builds"][n] = {"nvcc_s": secs, "functions": fns}
        for f, u in sorted(fns.items()):
            log(f"[build] {n}: nvcc {secs:.1f} s; {f}: {u}")

    new = {n: Kernels(s.with_suffix(".so")) for n, s in srcs.items()
           if n != "parent"}
    parent = (ParentKernels(srcs["parent"].with_suffix(".so"))
              if "parent" in srcs else None)
    # the floor: one PyTorch kernel on one element, back to back
    one = torch.zeros(1, device=dev)
    res["floor_ms"] = min(device_ms(lambda: one.add_(1), 200)
                          for _ in range(3))
    log(f"[floor] a one-element torch add: {res['floor_ms']:.4f} ms")
    rng = np.random.RandomState(args.seed)
    base = operand_rows(rng, BASE_ROWS, dev)
    # the wrappers' host path, which bounds the lane's small launches:
    # this tree's (bls_field.mul_rows / reduce_rows) and the parent's
    res["host_us"] = {}
    for R in (1, 108):
        x = base[:R]
        y = x.flip(0).contiguous()
        calls = {"mul_rows": lambda: BF.mul_rows(x, y),
                 "reduce_rows": lambda: BF.reduce_rows(x, 1)}
        if parent:
            calls["parent_mul"] = lambda: parent.mul(x, y)
            calls["parent_reduce"] = lambda: parent.reduce(x, 1)
        res["host_us"][R] = {n: host_us(fn) for n, fn in calls.items()}
        log(f"[host] R={R}: " + ", ".join(
            f"{n} {v:.2f}" for n, v in res["host_us"][R].items())
            + " us a call")
    for R in args.rows:
        x = base.repeat(-(-R // BASE_ROWS), 1)[:R].contiguous()
        y = x.flip(0).contiguous()
        for kern in ("mul", "reduce"):
            if kern == "mul":
                want = plain_chunked(BF.mul_plain, x, y)
                calls = {f"{n}_g{g}": (lambda k=k, g=g: k.mul(x, y, g))
                         for n, k in new.items() for g in BF.GROUP_SIZES}
                if parent:
                    calls["parent"] = lambda: parent.mul(x, y)
            else:
                want = plain_chunked(lambda c: BF.reduce_plain(c, 1), x)
                calls = {f"{n}_g{g}": (lambda k=k, g=g: k.reduce(x, 1, g))
                         for n, k in new.items() for g in BF.GROUP_SIZES}
                if parent:
                    calls["parent"] = lambda: parent.reduce(x, 1)
            reps = max(3, min(200, (1 << 22) // R))
            times = collections.defaultdict(list)
            for n in list(calls) + list(calls)[::-1]:
                calls[n]()
                times[n].append(device_ms(calls[n], reps))
            for n, fn in calls.items():
                if n.startswith("nochain"):
                    continue                        # timing only
                bad = int((fn() != want).any(-1).sum())
                if bad:
                    raise AssertionError(f"{kern} {n} != plain on {bad} of "
                                         f"{R} rows")
            res["times"][f"{kern}_{R}"] = dict(times)
            best = min(times, key=lambda n: min(times[n]))
            log(f"[{kern}] R={R}: " + ", ".join(
                f"{n} {min(t):.4f}" for n, t in times.items())
                + f" ms; fastest {best}; every build == plain on all rows")
        del x, y
        torch.cuda.empty_cache()
    if parent and args.lane_pairs:
        res["lane_ab"] = lane_ab(parent, dev, args.lane_pairs, args.seed)
        ab = res["lane_ab"]
        log(f"[lane] bls_aggregate wall, median of {ab['pairs']} pairs: new "
            f"{ab['median_s']['new']:.4f} s, parent "
            f"{ab['median_s']['parent']:.4f} s; new faster in "
            f"{ab['new_faster_pairs']} of {ab['pairs']} pairs; equal "
            f"aggregates")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main() and 0)
