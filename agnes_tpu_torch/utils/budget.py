"""Device-memory planner for the fused signed verify (twin of the planner
half of `agnes_tpu.utils.budget`).

At the north-star shape (2 vote classes x 10,000 instances x 1,000
validators = 20,000,000 lanes) the packed lanes alone are 512 B a lane,
10.24 GB on the card, and the verify's per-lane temporaries come on top.
`plan_lane_verify` (packed lanes) and `plan_dense_verify` (the dense
[Ps, I, V] cells, tiled by instance rows) size verify microbatches so
the step (`device/step.py`, `verify_chunk`) streams tiles through the
same kernel with a bounded peak; every lane's verdict is independent
integer math, so chunked and unchunked runs agree lane for lane.
`mesh_local_shape` is the (instances, validators) block one rank of a
mesh holds, the shape a per-device plan bounds.

The budget is the card's whole memory (`device_hbm_bytes`), with the
lanes resident inside it.  A CPU device has no budget: callers there
pass `hbm_bytes`.  Pure arithmetic otherwise: nothing is allocated.

The wall-clock half: `Deadline` is an absolute budget, given or
discovered (`Deadline.discover`: an env override, else the tightest
enclosing coreutils `timeout N` found by walking the ancestors in
/proc, minus its elapsed time), so a bounded run such as the model
checker's CLI (analysis/modelcheck.py) reports a clean partial instead
of being killed.  `install_deadline_signals` arms SIGTERM and a last-resort
SIGALRM `deadline_margin_s` before a finite deadline, so a bounded run
emits its verdict even when it is about to be killed from outside.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import time
from typing import Callable, List, Optional, Tuple

import torch

from agnes_tpu_torch.device.encoding import resolve_device

GIB = 1 << 30

#: bytes per verify lane for each operand (the bridge packs bytes as
#: int32 lanes: `bridge/ingest.py::_pack_verify_inputs_np`)
SIG_LANE_BYTES = 64 * 4            # [.., 64] int32
PUB_LANE_BYTES = 32 * 4            # [.., 32] int32
BLOCK_LANE_BYTES = 32 * 4          # per SHA-512 block: [.., 32] int32

#: transient bytes a lane while the verify runs: the plain-torch
#: prologue (SHA-512 on int64 words, the Barrett reduction, the digit
#: planes) and the kernel's inputs and output.  `chip_smoke.py` phase 3
#: measures it on the step of an unchunked I = 1,024 x V = 1,000 height
#: as (peak - allocated before the step) / lanes: 1,428.0 B on an
#: "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md), and the north-star
#: height read the same 1,427 B a lane at 8,388,608-lane chunks; phase
#: 3 fails if the reading outgrows the constant.  The constant adds
#: what the lane plan leaves out and must fit beside the chunk, the
#: phases and the tally (41 B a lane at that height), and rounds up to
#: a multiple of 256 B: an overestimate only shrinks the tile, an
#: underestimate runs out of memory at full shape.  (The twin models
#: JAX's 20-limb temporaries at 10,240 B a lane.)
VERIFY_WORKSPACE_LANE_BYTES = 1536


class BudgetError(RuntimeError):
    """No verify tiling fits the given memory budget."""


@dataclasses.dataclass(frozen=True)
class VerifyPlan:
    """A chunked-execution plan for the fused signed verify.

    ``tile`` is the microbatch size in lanes; the last chunk may be
    ragged.  The fields are the twin's, whose dense plan tiles instance
    rows of n_phases * n_validators lanes; a lane plan is one lane a
    row."""

    n_phases: int
    n_instances: int
    n_validators: int
    n_blocks: int
    tile: int                  # lanes per chunk
    n_chunks: int
    lanes_per_chunk: int
    resident_bytes: int        # persistent operands (live for the whole step)
    chunk_bytes: int           # transient workspace of ONE microbatch
    hbm_bytes: int
    safety: float

    @property
    def peak_bytes(self) -> int:
        return self.resident_bytes + self.chunk_bytes

    def fits(self, hbm_bytes: Optional[int] = None) -> bool:
        budget = self.hbm_bytes if hbm_bytes is None else hbm_bytes
        return self.peak_bytes <= budget * self.safety

    @property
    def chunked(self) -> bool:
        return self.n_chunks > 1

    def describe(self) -> str:
        return (f"verify plan: {self.n_chunks} chunk(s) x {self.tile} "
                f"(lanes/chunk={self.lanes_per_chunk}); resident "
                f"{self.resident_bytes / GIB:.2f} GiB + chunk "
                f"{self.chunk_bytes / GIB:.2f} GiB = peak "
                f"{self.peak_bytes / GIB:.2f} GiB of "
                f"{self.hbm_bytes / GIB:.2f} GiB "
                f"(safety {self.safety:.2f})")


def _floor_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def device_hbm_bytes(device=None) -> int:
    """The card's total memory in bytes (`torch.cuda.mem_get_info`;
    `device` None: the current card).
    A CPU device has no memory budget: ValueError (RuntimeError, as
    everywhere in the port, when CUDA is asked for and absent)."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"no device memory budget on {dev}: pass "
                         f"hbm_bytes (hbm_budget_bytes on the driver)")
    return int(torch.cuda.mem_get_info(dev)[1])


def _budget(hbm_bytes: Optional[int]) -> int:
    return device_hbm_bytes() if hbm_bytes is None else int(hbm_bytes)


def dense_resident_bytes(n_phases: int, n_instances: int,
                         n_validators: int, n_blocks: int = 1,
                         n_seq_phases: Optional[int] = None) -> int:
    """Persistent memory of the dense fused signed step: the full sig
    and blocks tensors (they stay resident while tiles stream), the
    pubkey table, the dense phase tensors and verdict mask, and the
    tally's per-validator arrays (voted and equiv; a 4-round window of
    2 classes).  The twin's formula."""
    P = n_seq_phases if n_seq_phases is not None else n_phases + 1
    lanes = n_phases * n_instances * n_validators
    cells = n_instances * n_validators
    sig = lanes * SIG_LANE_BYTES
    blocks = lanes * n_blocks * BLOCK_LANE_BYTES
    pub_table = n_validators * PUB_LANE_BYTES
    # phases: slots int32 + mask bool per (seq phase, cell); vmask bool
    phases = P * cells * (4 + 1) + P * cells
    # tally: voted [I, W=4, 2, V] int32 + equiv [I, V] bool
    tally = cells * 4 * 2 * 4 + cells
    return sig + blocks + pub_table + phases + tally


def plan_dense_verify(n_phases: int, n_instances: int, n_validators: int,
                      n_blocks: int = 1,
                      hbm_bytes: Optional[int] = None,
                      safety: float = 0.9,
                      workspace_lane_bytes: Optional[int] = None,
                      ) -> VerifyPlan:
    """Size the instance-row tile of the dense fused signed step
    (`consensus_step_seq_signed_dense`): the largest power-of-two row
    count whose tile fits the memory left after the resident operands;
    a lane of a tile costs `workspace_lane_bytes` plus its pub
    broadcast.  `tile` counts instance rows (n_phases * n_validators
    lanes each).  The default workspace is VERIFY_WORKSPACE_LANE_BYTES
    plus the tile's contiguous copy of its sig and n_blocks blocks,
    which a tile of Ps > 1 classes cuts out of the [Ps, I, V] layout
    (`device/step._verify_dense`; the lane path's chunks are views): a
    departure from the twin, whose formula this is with the twin's
    workspace passed.  Raises BudgetError when even a one-row tile does
    not fit, ValueError on an empty shape."""
    if min(n_phases, n_instances, n_validators) <= 0:
        raise ValueError("n_phases/n_instances/n_validators must be >= 1")
    if workspace_lane_bytes is None:
        workspace_lane_bytes = (VERIFY_WORKSPACE_LANE_BYTES + SIG_LANE_BYTES
                                + n_blocks * BLOCK_LANE_BYTES)
    hbm = _budget(hbm_bytes)
    resident = dense_resident_bytes(n_phases, n_instances, n_validators,
                                    n_blocks)
    avail = hbm * safety - resident
    # a tile's lane: the verify workspace plus the [Ps, tile, V, 32]
    # int32 pub broadcast the tile materializes
    lane_cost = workspace_lane_bytes + PUB_LANE_BYTES
    row_lanes = n_phases * n_validators
    max_rows = int(avail // (row_lanes * lane_cost))
    if max_rows < 1:
        raise BudgetError(
            f"dense fused verify cannot fit {n_phases}x{n_instances}x"
            f"{n_validators} (nb={n_blocks}) in {hbm / GIB:.2f} GiB: "
            f"resident {resident / GIB:.2f} GiB leaves "
            f"{max(avail, 0) / GIB:.2f} GiB, one instance row needs "
            f"{row_lanes * lane_cost / GIB:.3f} GiB")
    tile = min(n_instances, _floor_pow2(max_rows))
    return VerifyPlan(
        n_phases=n_phases, n_instances=n_instances,
        n_validators=n_validators, n_blocks=n_blocks,
        tile=tile, n_chunks=-(-n_instances // tile),
        lanes_per_chunk=tile * row_lanes,
        resident_bytes=resident,
        chunk_bytes=tile * row_lanes * lane_cost,
        hbm_bytes=hbm, safety=safety)


def mesh_local_shape(mesh, n_instances: int, n_validators: int,
                     n_hosts: int = 1,
                     n_live: Optional[int] = None) -> Tuple[int, int]:
    """(instances, validators) as one rank of `mesh` (parallel/mesh.py,
    a DeviceMesh) holds them: instances split over its data axes
    (`slice` and `data`), validators over `val`.  `mesh` None is one
    device.  Shared by DeviceDriver's chunk planning and
    ShapeLadder.plan_dense.

    `n_hosts` and `n_live` are the pod's (ROADMAP §1 item 6), as in the
    twin: where `n_instances` is already one host's slice of a mesh
    spanning `n_hosts` hosts, the data extent one host owns is the
    mesh's over the live host count (`n_live`, default `n_hosts`); the
    caller passes the slice the live owner serves.  ValueError when
    the live count is outside [1, n_hosts] or does not split the data
    extent."""
    if mesh is None:
        return int(n_instances), int(n_validators)
    from agnes_tpu_torch.parallel.mesh import DATA_AXIS, SLICE_AXIS, VAL_AXIS

    live = int(n_live) if n_live is not None else int(n_hosts)
    if not 1 <= live <= max(1, int(n_hosts)):
        raise ValueError(
            f"live membership {live} outside [1, {n_hosts}]")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_data = shape.get(DATA_AXIS, 1) * shape.get(SLICE_AXIS, 1)
    if live > 1:
        if n_data % live:
            raise ValueError(
                f"mesh data extent {n_data} does not split over "
                f"{live} live host(s)")
        n_data //= live
    return (int(n_instances) // n_data,
            int(n_validators) // shape.get(VAL_AXIS, 1))


def plan_lane_verify(n_lanes: int, n_blocks: int = 1,
                     hbm_bytes: Optional[int] = None,
                     safety: float = 0.9,
                     workspace_lane_bytes: int = VERIFY_WORKSPACE_LANE_BYTES,
                     ) -> VerifyPlan:
    """Size the lane chunk for the packed-lane fused signed path
    (`consensus_step_seq_signed`): the largest power-of-two lane count
    whose workspace fits the memory left after the resident lanes.
    Raises BudgetError when even one lane does not fit."""
    if n_lanes <= 0:
        raise ValueError("n_lanes must be >= 1")
    hbm = _budget(hbm_bytes)
    resident = n_lanes * (SIG_LANE_BYTES + PUB_LANE_BYTES
                          + n_blocks * BLOCK_LANE_BYTES)
    avail = hbm * safety - resident
    max_lanes = int(avail // workspace_lane_bytes)
    if max_lanes < 1:
        raise BudgetError(
            f"lane fused verify cannot fit {n_lanes} lanes "
            f"(nb={n_blocks}) in {hbm / GIB:.2f} GiB")
    tile = min(n_lanes, _floor_pow2(max_lanes))
    return VerifyPlan(
        n_phases=1, n_instances=n_lanes, n_validators=1,
        n_blocks=n_blocks, tile=tile, n_chunks=-(-n_lanes // tile),
        lanes_per_chunk=tile, resident_bytes=resident,
        chunk_bytes=tile * workspace_lane_bytes,
        hbm_bytes=hbm, safety=safety)


# --- wall-clock deadline discovery ------------------------------------------

#: how far up the process tree to look for an enclosing `timeout`
_MAX_ANCESTOR_HOPS = 20

#: suffix multipliers accepted by coreutils timeout durations
_SUFFIX = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}

#: timeout(1) options that consume a following argument
_TIMEOUT_OPTS_WITH_ARG = ("-k", "--kill-after", "-s", "--signal")


def parse_timeout_duration(tok: str) -> Optional[float]:
    """'870' -> 870.0, '30m' -> 1800.0; None if not a duration."""
    mult = 1.0
    if tok and tok[-1] in _SUFFIX:
        mult, tok = _SUFFIX[tok[-1]], tok[:-1]
    try:
        v = float(tok)
    except ValueError:
        return None
    return v * mult if v >= 0 else None


def parse_timeout_argv(argv: List[str]) -> Optional[float]:
    """The duration of a coreutils `timeout` invocation's argv, or None
    when argv is not one (or is unparseable).  Handles `-k 10 870`,
    `--kill-after=10`, `-s TERM`, and s/m/h/d suffixes."""
    if not argv or os.path.basename(argv[0]) != "timeout":
        return None
    i = 1
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and a != "-":
            if a in _TIMEOUT_OPTS_WITH_ARG:
                i += 2
            else:
                i += 1  # flag (or --opt=value) without separate arg
            continue
        return parse_timeout_duration(a)
    return None


def _proc_stat_fields(pid: int) -> Optional[List[str]]:
    """Fields of /proc/<pid>/stat AFTER the (comm) — comm may contain
    spaces/parens, so split at the last ')'."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            raw = f.read().decode("ascii", "replace")
    except OSError:
        return None
    rp = raw.rfind(")")
    if rp < 0:
        return None
    return raw[rp + 1:].split()


def _proc_ppid(pid: int) -> Optional[int]:
    f = _proc_stat_fields(pid)
    try:
        return int(f[1]) if f else None      # field 4 overall
    except (ValueError, IndexError):
        return None


def _proc_elapsed_s(pid: int) -> Optional[float]:
    """Seconds since process start (start_time field vs /proc/uptime)."""
    f = _proc_stat_fields(pid)
    if not f or len(f) < 20:
        return None
    try:
        start_ticks = float(f[19])           # field 22 overall
        with open("/proc/uptime") as up:
            uptime = float(up.read().split()[0])
        tck = os.sysconf("SC_CLK_TCK")
    except (ValueError, OSError):
        return None
    return max(0.0, uptime - start_ticks / tck)


def _proc_cmdline(pid: int) -> Optional[List[str]]:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            raw = f.read()
    except OSError:
        return None
    return [a.decode("utf-8", "replace")
            for a in raw.split(b"\0") if a] or None


def enclosing_timeout_remaining() -> Optional[float]:
    """Walk the ancestor chain; for every `timeout N ...` wrapper found,
    compute N minus its elapsed runtime; return the tightest remaining
    seconds, or None when no ancestor is a timeout (or /proc is
    unavailable — non-Linux)."""
    best: Optional[float] = None
    pid, hops = os.getppid(), 0
    while pid and pid > 1 and hops < _MAX_ANCESTOR_HOPS:
        argv = _proc_cmdline(pid)
        if argv:
            dur = parse_timeout_argv(argv)
            if dur is not None:
                elapsed = _proc_elapsed_s(pid)
                if elapsed is not None:
                    rem = dur - elapsed
                    best = rem if best is None else min(best, rem)
        pid = _proc_ppid(pid)
        hops += 1
    return best


@dataclasses.dataclass(frozen=True)
class Deadline:
    """An absolute wall-clock budget: `at` is a time.monotonic()
    instant, or None for unbounded.  `source` records where it came
    from, so a partial report can state it."""

    at: Optional[float]
    source: str = "none"

    @classmethod
    def none(cls) -> "Deadline":
        return cls(at=None, source="none")

    @classmethod
    def after(cls, seconds: float, source: str = "explicit") -> "Deadline":
        return cls(at=time.monotonic() + seconds, source=source)

    @classmethod
    def discover(cls, env_var: str = "AGNES_BENCH_DEADLINE_S",
                 default_s: Optional[float] = None) -> "Deadline":
        """The enclosing wall-clock budget, in preference order: the
        seconds in `env_var`; an ancestor `timeout N` found via /proc
        (minus its elapsed time); `default_s`; unbounded."""
        env = os.environ.get(env_var)
        if env:
            try:
                return cls.after(float(env), source=f"env:{env_var}")
            except ValueError:
                pass
        rem = enclosing_timeout_remaining()
        if rem is not None:
            return cls.after(max(0.0, rem), source="proc:timeout")
        if default_s is not None:
            return cls.after(default_s, source="default")
        return cls.none()

    def remaining(self) -> float:
        return math.inf if self.at is None else self.at - time.monotonic()

    def expired(self) -> bool:
        return self.at is not None and self.remaining() <= 0

    def cap(self, want: float, margin: float = 0.0) -> float:
        """`want` seconds, clamped so it ends `margin` before the
        deadline (never below 0); `want` unchanged when unbounded."""
        if self.at is None:
            return want
        return max(0.0, min(want, self.remaining() - margin))


def deadline_margin_s(rem: float) -> float:
    """The alarm margin for a finite remaining budget of `rem` seconds:
    the gap between "every derived work cap has ended" and the
    last-resort SIGALRM.  A caller that caps its own work with
    `Deadline.cap(..., margin=deadline_margin_s(rem))` ends that work
    before `install_deadline_signals`' alarm fires, because both sides
    subtract this number."""
    return min(30.0, max(5.0, rem * 0.2))


def install_deadline_signals(callback: Callable[[int], None],
                             deadline: Deadline,
                             margin_s: Optional[float] = None) -> float:
    """Arm SIGTERM and SIGALRM with `callback(signum)` and, for a finite
    deadline, schedule an alarm `margin_s` (default `deadline_margin_s`)
    before it: the last-resort guarantee that a verdict is emitted even
    when the process is about to be killed from outside (coreutils
    `timeout` sends SIGTERM first; the alarm fires even if that TERM
    never reaches the process through an intermediate shell).  Returns
    the scheduled alarm delay in whole seconds (0.0: no alarm).  Call
    from the main thread."""
    signal.signal(signal.SIGTERM, lambda sn, fr: callback(sn))
    signal.signal(signal.SIGALRM, lambda sn, fr: callback(sn))
    rem = deadline.remaining()
    if not math.isfinite(rem):
        return 0.0
    if margin_s is None:
        margin_s = deadline_margin_s(rem)
    delay = max(1, int(rem - margin_s))
    signal.alarm(delay)
    return float(delay)
