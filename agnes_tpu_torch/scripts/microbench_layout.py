"""Microbenchmark: the field-multiply chain on the card (twin of
`scripts/microbench_layout.py`).

    python -m agnes_tpu_torch.scripts.microbench_layout [--device cuda]
        [--seed S] [--iters N] [--lanes T] [--n-chain N]

Times a chain of `N_CHAIN` dependent rounds of `PAR` independent
radix-2^13 field multiplies (`_fe_mul`, the TPU kernel's own multiply)
over T lanes, through the hand-written CUDA kernel `csrc/fe13_chain.cu`
(replaces `scripts/microbench_layout.py::_chain_kernel`).  The rows are
the JAX script's six: layout A at blocks of 512 and 1,024 lanes, layout
B at 8 and 16 x 128, and the two rows at twice the chain.

On the TPU the two layouts were two placements of the lanes in vector
registers: A [20, T] puts the batch on lanes with the limbs on
sublanes, B [20, T/128, 128] tiles the batch (8, 128).  Row-major, both
are the same bytes, so on the card they are one tensor: a kernel thread
owns a lane either way.  What the rows still vary is the block, which
becomes the lanes of one CTA (`chain`'s `block`): 16,384 lanes in blocks
of 512 are 32 CTAs, in blocks of 2,048 are 8, on a card of 132 SMs.  So
here A at 1,024 and B at 8 x 128 are the same launch.

Each row prints the script's own line (dt, ns/mul/lane, G mul-lanes/s),
then the row's bound (the least time the card could take: one int32
multiply-add a product, `PRODUCTS_PER_FE_MUL` per multiply, at SMs x 64
lanes x the maximum SM clock) and the card's name and power limit.
Inputs are `randint(0, 8192)` limbs from `--seed`.  The kernel is timed
with CUDA events over `--iters` launches after one warm launch.  With
`--device cpu` the plain PyTorch version runs instead, timed by the
host clock, and no bound is printed: that is a CPU number.

`chain` launches the kernel for CUDA tensors (a failed build or launch
raises) and runs `chain_plain` for CPU tensors.  `LAUNCHES` counts
kernel launches.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import subprocess
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from agnes_tpu_torch import cuda_build
from agnes_tpu_torch.device.encoding import resolve_device

BITS = 13
LMASK = (1 << BITS) - 1      # 8191
NLIMBS = 20
FOLD = 608                   # 2^260 mod p = 32 * 19
N_CHAIN = 64                 # sequential rounds
PAR = 4                      # independent multiplies per round
HI_PASSES = 3                # _vpass0(hi, None) passes of _fe_mul
CARRY_PASSES = 4             # _carry0 passes
T_LANES = 16384              # the script's T
SEED = 20261017

#: IMADs one `_fe_mul` needs: the 20 x 20 schoolbook, 608 * hi on 20
#: limbs, and one fold a carry pass.  The kernel does exactly these.
PRODUCTS_PER_FE_MUL = NLIMBS * NLIMBS + NLIMBS + CARRY_PASSES   # 424

KERNEL = "fe13_chain"        # csrc/fe13_chain.cu
# kernel launches since import (reset by callers that count a run)
LAUNCHES = 0
I32 = torch.int32
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate


# --- the plain version: `_fe_mul` on int32 values held in int64 -------------
# JAX's int32 arithmetic wraps mod 2^32.  The plain version keeps every
# value as an int64 inside the int32 range and wraps after each add and
# multiply, so it equals JAX on any int32 input (`&` and the arithmetic
# `>>` then see the same bits).

def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it wraps to, still int64."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _vpass0(r: torch.Tensor, fold: Optional[int]) -> torch.Tensor:
    """One vectorized carry pass over the limb axis 0; without `fold`
    the top limb keeps its full value, with it the top carry folds
    into limb 0 times `fold`."""
    lo = r & LMASK
    hi = r >> BITS
    if fold is None:
        lo = torch.cat([lo[:-1], r[-1:]])
        shift = torch.cat([torch.zeros_like(hi[:1]), hi[:-1]])
        return _wrap(lo + shift)
    shift = torch.cat([_wrap(hi[-1:] * fold), hi[:-1]])
    return _wrap(lo + shift)


def _carry0(r: torch.Tensor, passes: int = CARRY_PASSES) -> torch.Tensor:
    for _ in range(passes):
        r = _vpass0(r, FOLD)
    return r


def _fe_mul64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_fe_mul` on [20, ...] int64 operands holding int32 values
    (trailing axes broadcast): the 40 schoolbook columns (row 39 is
    zero), 3 passes over the high half, lo + FOLD * hi, `_carry0`."""
    a, b = torch.broadcast_tensors(a, b)
    cols = torch.zeros((2 * NLIMBS,) + a.shape[1:], dtype=torch.int64,
                       device=a.device)
    for i in range(NLIMBS):
        cols[i:i + NLIMBS] += _wrap(a[i] * b)
    cols = _wrap(cols)
    lo, hi = cols[:NLIMBS], cols[NLIMBS:]
    for _ in range(HI_PASSES):
        hi = _vpass0(hi, None)
    return _carry0(_wrap(lo + _wrap(FOLD * hi)))


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_fe_mul` of the JAX script on [20, ...] int32 limbs, limb for
    limb (raw limbs, not a value mod p)."""
    return _fe_mul64(a.long(), b.long()).to(I32)


def chain_plain(x: torch.Tensor, y: torch.Tensor, n_chain: int
                ) -> torch.Tensor:
    """Plain version of the kernel: `_chain_kernel` on [20, ...] int32
    limbs.  The `PAR` chains x + i run side by side on a trailing axis."""
    xs = _wrap(torch.stack([x.long() + i for i in range(PAR)], dim=-1))
    yb = y.long().unsqueeze(-1)
    for _ in range(n_chain):
        xs = _fe_mul64(xs, yb)
    return _wrap(xs.sum(dim=-1)).to(I32)


# --- the CUDA kernel ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    lib.ag_fe13_chain.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.ag_fe13_chain.restype = ctypes.c_int
    return lib


def chain(x: torch.Tensor, y: torch.Tensor, n_chain: int = N_CHAIN,
          block: int = 512) -> torch.Tensor:
    """`_chain_kernel` over x, y: [20, ...] int32 limbs, limbs first,
    contiguous, same shape -> out of that shape.  `block` is the lanes
    of one CTA (the TPU block's lane count).  CUDA tensors launch the
    kernel, CPU tensors run `chain_plain`."""
    global LAUNCHES
    if (x.dtype != I32 or y.dtype != I32 or x.shape != y.shape
            or x.dim() < 2 or x.shape[0] != NLIMBS):
        raise ValueError(f"chain: [{NLIMBS}, ...] int32 x and y of one "
                         f"shape, got {x.dtype} {tuple(x.shape)} and "
                         f"{y.dtype} {tuple(y.shape)}")
    if x.device != y.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chain: operands on {x.device} and {y.device}")
    if int(n_chain) < 0 or int(block) <= 0:
        raise ValueError(f"chain: n_chain {n_chain}, block {block}")
    if x.device.type == "cpu":
        return chain_plain(x, y, int(n_chain))
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("chain: x and y must be contiguous")
    out = torch.empty_like(x)
    T = x.numel() // NLIMBS
    if T:
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.ag_fe13_chain(x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), T, int(block),
                                    int(n_chain), stream)
        if err != 0:
            raise RuntimeError(f"fe13_chain launch failed: CUDA error {err}")
        LAUNCHES += 1
    return out


def least_products(lanes: int, n_chain: int) -> int:
    """IMADs the chain needs at least over `lanes` lanes."""
    return lanes * n_chain * PAR * PRODUCTS_PER_FE_MUL


def least_bytes(lanes: int) -> int:
    """Bytes the chain must move: x and y read once, out written once."""
    return 3 * NLIMBS * 4 * lanes


# --- the benchmark ------------------------------------------------------------

def smi(query: str) -> str:
    """One `nvidia-smi --query-gpu` value line of card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class CardBound:
    """The least time the card could take: the larger of the products
    over SMs x 64 int32 lanes x the maximum SM clock, and the bytes over
    the memory rate.  `card` is nvidia-smi's name and power limit."""

    def __init__(self, device: torch.device):
        props = torch.cuda.get_device_properties(device)
        self.card = smi("name,power.limit")
        clock_mhz = float(smi("clocks.max.sm").split()[0])
        self.rate = props.multi_processor_count * 64 * clock_mhz * 1e6
        self.desc = (f"{props.multi_processor_count} SMs x 64 x "
                     f"{clock_mhz:.0f} MHz")

    def __call__(self, lanes: int, n_chain: int):
        ops_ms = least_products(lanes, n_chain) / self.rate * 1e3
        bytes_ms = least_bytes(lanes) / HBM_BYTES_PER_S * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")


def row_inputs(shape_full: Sequence[int], seed: int = SEED):
    """The script's inputs: x, y randint(0, 8192) int32 limbs."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 8192, tuple(shape_full)).astype(np.int32)
    y = rng.randint(0, 8192, tuple(shape_full)).astype(np.int32)
    return x, y


def wrap_inputs(shape_full: Sequence[int], seed: int = SEED):
    """Limbs just below 2^15, whose columns (20 products of ~2^30)
    wrap int32 in the first multiply."""
    rng = np.random.RandomState(seed)
    lo = (1 << 15) - 1024
    return tuple(rng.randint(lo, 1 << 15, tuple(shape_full))
                 .astype(np.int32) for _ in range(2))


def bench(shape_full, block, label, iters=60, *, n_chain=None,
          device="cuda", seed=SEED, bound: Optional[CardBound] = None
          ) -> dict:
    """Time `chain` on one row: shape_full / block are limbs leading,
    batch trailing, as in the JAX script; a block's lanes are one CTA's.
    Prints the script's line and returns the row's numbers."""
    dev = resolve_device(device)
    n_chain = N_CHAIN if n_chain is None else int(n_chain)
    lanes = int(np.prod(shape_full[1:]))
    block_lanes = int(np.prod(block[1:]))
    if block[0] != NLIMBS or shape_full[1] % block[1]:
        raise ValueError(f"block {block} does not tile {shape_full}")
    x, y = (torch.from_numpy(a).to(dev) for a in row_inputs(shape_full, seed))
    chain(x, y, n_chain, block_lanes)                      # warm
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            chain(x, y, n_chain, block_lanes)
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            chain(x, y, n_chain, block_lanes)
        dt = (time.perf_counter() - t0) / iters
    n_mul = n_chain * PAR
    ns = dt / (lanes * n_mul) * 1e9
    rate = lanes * n_mul / dt / 1e9
    row = dict(label=label, shape=list(shape_full), block_lanes=block_lanes,
               n_chain=n_chain, lanes=lanes, ms=dt * 1e3,
               ns_per_mul_lane=ns, g_mul_lanes_per_s=rate, device=str(dev))
    line = (f"{label:30s} dt={dt * 1e3:7.2f} ms  {ns:.3f} ns/mul/lane"
            f"  ({rate:.2f} G mul-lanes/s)")
    if bound is not None:
        b_ms, b_by = bound(lanes, n_chain)
        row.update(bound_ms=b_ms, bound_by=b_by, card=bound.card)
        line += (f"  bound {b_ms:.4f} ms ({b_by}; {PRODUCTS_PER_FE_MUL} "
                 f"IMADs a multiply at {bound.desc}, "
                 f"{100 * b_ms / (dt * 1e3):.3g}% of it)  [{bound.card}]")
    else:
        line += f"  [{dev.type}: host clock, no card bound]"
    print(line, flush=True)
    return row


def rows(T: int = T_LANES, n_chain: int = N_CHAIN):
    """The JAX script's six rows: (shape_full, block, label, n_chain)."""
    out = [((NLIMBS, T), (NLIMBS, b), f"A [20,{b}] sublane", n_chain)
           for b in (512, 1024)]
    out += [((NLIMBS, T // 128, 128), (NLIMBS, bh, 128),
             f"B [20,{bh},128] vreg-plane", n_chain) for bh in (8, 16)]
    # scaling sanity: double the chain, expect ~2x time
    out += [((NLIMBS, T), (NLIMBS, 512), "A [20,512] 2x chain", 2 * n_chain),
            ((NLIMBS, T // 128, 128), (NLIMBS, 8, 128),
             "B [20,8,128] 2x chain", 2 * n_chain)]
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--lanes", type=int, default=T_LANES)
    ap.add_argument("--n-chain", type=int, default=N_CHAIN)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bound = CardBound(dev) if dev.type == "cuda" else None
    return [bench(shape, block, label, args.iters, n_chain=n, device=dev,
                  seed=args.seed, bound=bound)
            for shape, block, label, n in rows(args.lanes, args.n_chain)]


if __name__ == "__main__":
    main()
