"""The spawnable pod worker and the spawner (twin of
`agnes_tpu.distributed.smoke`).

    python -m agnes_tpu_torch.distributed.smoke --mode pod --pid 0 \\
        --n-processes 2 --init-method file:///tmp/pod/rendezvous \\
        --per-host 1 --n-val 1 --device cpu --out /tmp/pod/pod0.json

Three modes, each writing a result JSON (and, with `--state-npz`, its
state, tally and decision stats as an .npz) so that a parent compares
them leaf for leaf without touching a process group:

* ``pod``     one pod process: `initialize_pod` (a `file://` or
              `tcp://localhost` rendezvous), a DistributedDriver and a
              HostShard serving height by height, batches closed by size,
              the warmup between barriers and armed, a decision gather
              after each height, a heartbeat trail stamped with the host,
              the drain.  Dumps its host's block.
* ``elastic`` the same deployment through ElasticShard's negotiated
              ticks (distributed/elastic.py): heterogeneous traffic a
              host, padded to each tick's max, and one leave / rejoin
              cycle of the last host across epoch boundaries
              (`run_elastic_worker` has the choreography).  Dumps its
              host's block.
* ``single``  one host of `--n-processes` ranks serving the same
              deployment through a plain VoteService over a
              DistributedDriver with a coordinator attached (dense
              serving over a mesh of several ranks).  Dumps the global
              arrays.
* ``offline`` the one-device offline dense path: VoteBatcher
              `build_phases_device_dense` -> `step_seq_signed_dense`.
              Dumps the global arrays.

Each height's traffic is both vote classes of every (instance,
validator) for value `VALUE`, signed with the fixture keys
(`harness/fixtures.py`); `--forge F` signs validator F's votes with its
neighbour's key in both classes.  Workers load only torch and the port.
On "cuda" a pod or elastic worker also runs the verify kernel again on
its last dispatch's cells, at that launch's shape, and holds it against
the plain version on `SAMPLE_ROWS` instance rows (outside the counted
path).

`spawn_pod` (`start_pod(...).wait()` over `n_processes` hosts of
`devices_per_host` ranks) is the parent's side: it launches a world's
workers (and the `single` / `offline` comparison worlds, each
with its own rendezvous), bounds them all by one wall-clock deadline
and returns every worker's record.  The deadline is the workers' only
bound: on its breach, or as soon as any worker fails (its peers would
wait in a collective until then), every worker is SIGKILLed.  A worker
dies with its parent (PR_SET_PDEATHSIG), so a pod never outlives the
process that spawned it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

PV, PC = 0, 1                   # VoteType.{PREVOTE, PRECOMMIT}
#: the value every vote carries
VALUE = 7
#: instance rows of a pod worker's last dispatch held against plain
SAMPLE_ROWS = 16
#: a heartbeat trail's interval (the default of `--hb-interval`)
HB_INTERVAL_S = 1.0
#: the planner's budget on the CPU, which has no device memory to read
CPU_HBM_BYTES = 1 << 34


# -- traffic and state ---------------------------------------------------------

def signatures(seeds, heights: int, value: int,
               forge: Optional[int]) -> dict:
    """{(height, class): [V, 64] signatures} of heights 0..`heights`."""
    from agnes_tpu_torch.harness import fixtures as fx

    return {(h, typ): fx.sign_class(seeds, h, typ, value,
                                    forge_validator=forge)
            for h in range(heights + 1) for typ in (PV, PC)}


def wire_height(I: int, V: int, seeds, h: int, value: int,
                sigs: dict) -> bytes:
    """Both vote classes of one height, global instance ids."""
    from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
    from agnes_tpu_torch.harness.fixtures import full_mesh_cols

    return b"".join(
        pack_wire_votes(*full_mesh_cols(I, V, seeds, h, typ, value,
                                        sigs=sigs[h, typ]))
        for typ in (PV, PC))


def state_arrays(driver) -> dict:
    """{name: numpy}: state, tally and decision stats of a driver (on a
    pod host's mesh, the host's block, gathered over its ranks)."""
    state, tally = driver.state_copies()
    out = {}
    for name, leaf in zip(type(state)._fields, state):
        out[f"state_{name}"] = leaf.cpu().numpy()
    for name, leaf in zip(type(tally)._fields, tally):
        out[f"tally_{name}"] = leaf.cpu().numpy()
    out["decided"] = driver.stats.decided
    out["decision_value"] = driver.stats.decision_value
    out["decision_round"] = driver.stats.decision_round
    return out


def plain_sample(dense, rows: int, forged: Optional[int], rng) -> dict:
    """The verify kernel at a dense batch's launch shape (every cell)
    against its plain version on every cell of `rows` sampled instance
    rows (both classes, so the forged validator's cells too), and whether
    the verdicts are exactly "every forged cell rejected, every other
    accepted"."""
    import torch

    from agnes_tpu_torch.crypto import ed25519_verify as VF

    Ps, I, Vn = dense.sig.shape[:3]
    rows = min(rows, I)
    pick = torch.from_numpy(rng.choice(I, rows, replace=False)) \
        .to(dense.sig.device)
    full, _ = VF.prologue(
        dense.pub[None, None].expand(Ps, I, Vn, 32).reshape(-1, 32),
        dense.sig.reshape(-1, 64),
        dense.blocks.reshape((-1,) + dense.blocks.shape[3:]))
    got = VF.verify_signed5(*full).reshape(Ps, I, Vn)[:, pick].reshape(-1)
    del full
    sig = dense.sig[:, pick].reshape(-1, 64)
    blocks = dense.blocks[:, pick].reshape((-1,) + dense.blocks.shape[3:])
    pub = dense.pub[None, None].expand(Ps, rows, Vn, 32).reshape(-1, 32)
    args, ok_s = VF.prologue(pub, sig, blocks)
    plain = VF.verify_plain(*args)
    diff = (got.to(torch.int64) - plain.to(torch.int64)).abs()
    ok = ((got > 0) & ok_s).reshape(Ps, rows, Vn).cpu()
    is_forged = torch.zeros((Ps, rows, Vn), dtype=torch.bool)
    if forged is not None:
        is_forged[:, :, forged] = True
    return {"cells": int(sig.shape[0]), "launch_cells": Ps * I * Vn,
            "mismatches": int((diff != 0).sum()),
            "max_abs_err": int(diff.max()) if diff.numel() else 0,
            "forged_cells": int(is_forged.sum()),
            "verdicts_right": (not bool(ok[is_forged].any())
                               and bool(ok[~is_forged].all()))}


def _timed(fn, into: list, keep=lambda out: True):
    """`fn`, appending each call's wall in ms to `into` when
    `keep(result)`."""
    def call(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if keep(out):
            into.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


class _TickClock:
    """Per-dispatch host and device times of a driver, the verify
    kernel's device time a launch, and the walls of a coordinator's
    agree() and negotiate(), of a pipeline's stage (densify) and of the
    elastic frame's pack and unpack (one unpack a host row): the
    wrappers record, then call through.  Device times are CUDA events
    (None on the CPU)."""

    def __init__(self, driver, pipeline, coordinator, cuda: bool):
        import torch

        from agnes_tpu_torch.crypto import ed25519_verify as VF
        from agnes_tpu_torch.distributed import elastic as EL

        self.launch_ms: List[float] = []
        self.densify_ms: List[float] = []
        self.agree_ms: List[float] = []
        self.negotiate_ms: List[float] = []
        self.pack_ms: List[float] = []
        self.unpack_ms: List[float] = []
        self.steps: list = []
        self.kernels: list = []
        self.last_lanes = None
        self.cells: List[int] = []
        step, stage, agree = (driver.step_async, pipeline.stage,
                              coordinator.agree)

        def events(fn, into):
            def call(*a, **k):
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
                out = fn(*a, **k)
                ev[1].record()
                into.append(ev)
                return out
            return call

        if cuda:
            step = events(step, self.steps)
            VF.verify_signed5 = events(VF.verify_signed5, self.kernels)

        def step_async(phases, lanes=None, *a, **k):
            t0 = time.perf_counter()
            out = step(phases, lanes, *a, **k)
            self.launch_ms.append((time.perf_counter() - t0) * 1e3)
            if lanes is not None:
                self.last_lanes = lanes
                self.cells.append(int(lanes.sig.shape[0]) * driver.I
                                  * driver.V)
            return out

        driver.step_async = step_async
        # a stage that staged nothing (an empty tick) is no densify
        pipeline.stage = _timed(stage, self.densify_ms, keep=bool)
        coordinator.agree = _timed(agree, self.agree_ms)
        coordinator.negotiate = _timed(coordinator.negotiate,
                                       self.negotiate_ms)
        EL.pack_elastic_frame = _timed(EL.pack_elastic_frame, self.pack_ms)
        EL.unpack_elastic_frame = _timed(EL.unpack_elastic_frame,
                                         self.unpack_ms)

    @staticmethod
    def ms(events) -> List[float]:
        return [a.elapsed_time(b) for a, b in events]


def _no_sync(fn, calls: list):
    """`fn` run under `torch.cuda.set_sync_debug_mode("error")` (a call
    that would wait for the card raises), counted in calls[0]."""
    import torch

    def call(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            calls[0] += 1
    return call


def _rss_gib() -> float:
    """This process's resident set now (`VmRSS`).  Not `ru_maxrss`: a
    worker spawned by vfork + exec carries the spawning process's peak
    in it."""
    with open("/proc/self/status") as f:
        return next(int(ln.split()[1]) for ln in f
                    if ln.startswith("VmRSS:")) / 2**20


def _setup(args):
    """(torch, device, planner budget) of a worker."""
    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)     # workers share the host's cores
    return torch, torch.device(args.device)


# -- the modes -----------------------------------------------------------------

def _start_host(args, shard_cls, n_phases):
    """A pod or elastic worker's set-up, after initialize_pod: the
    DistributedDriver, the flight recorder and heartbeat, the shard
    (`shard_cls`) with batches closed by size and a window predictor on
    `box["h"]`, the signatures, the _TickClock, and the warmup of
    `n_phases` between barriers and armed.  Launch counters are zeroed
    and the device peak reset after the warmup."""
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.crypto import ed25519_verify as VF
    from agnes_tpu_torch.distributed.driver import DistributedDriver
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.serve import ShapeLadder
    from agnes_tpu_torch.utils import budget
    from agnes_tpu_torch.utils.flightrec import FlightRecorder, Heartbeat

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    I, V = args.instances, args.validators
    hbm = budget.device_hbm_bytes(dev) if cuda else CPU_HBM_BYTES
    d = DistributedDriver(I, V, advance_height=True, defer_collect=True,
                          audit=True, n_val=args.n_val,
                          per_host=args.per_host, hbm_budget_bytes=hbm,
                          device=dev)
    flightrec = FlightRecorder()
    hb = None
    if args.heartbeat:
        hb = Heartbeat(args.heartbeat, interval_s=args.hb_interval,
                       recorder=flightrec, host_id=d.host).start()
    n_local = d.I * V
    box = {"h": 0}
    seeds = fx.deterministic_seeds(V)
    shard = shard_cls(
        d, VoteBatcher(d.I, V, n_slots=4, device=dev),
        fx.validator_pubkeys(seeds),
        capacity=4 * 2 * n_local, target_votes=2 * n_local,
        max_delay_s=1e9,                     # batches close by size
        ladder=ShapeLadder.plan_dense(
            I, V, local_shape=d._local_shape(), n_hosts=d.n_hosts,
            min_rung=1 << (2 * n_local - 1).bit_length(), hbm_bytes=hbm),
        window_predictor=lambda: (np.zeros(d.I, np.int64),
                                  np.full(d.I, box["h"], np.int64)),
        flightrec=flightrec, native_admission=args.native_admission)
    if hb is not None:
        hb.sources.append(lambda: shard.metrics.snapshot(
            window=True, window_key="heartbeat"))
    sigs = signatures(seeds, args.heights, VALUE, args.forge)
    clock = _TickClock(d, shard.pipeline, shard.coordinator, cuda)
    VF.LAUNCHES = 0
    warmed = shard.warmup(n_phases=n_phases, arm=True)
    warm_launches = VF.LAUNCHES
    clock.kernels.clear()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    VF.LAUNCHES = 0
    return SimpleNamespace(d=d, shard=shard, box=box, seeds=seeds,
                           sigs=sigs, clock=clock, hb=hb, hbm=hbm,
                           cuda=cuda, n_local=n_local, warmed=warmed,
                           warm_launches=warm_launches)


def _finish_host(args, w, rep: dict, seed: int) -> dict:
    """The record fields a pod and an elastic worker share, read after
    the drain (`rep`): counts, launches, times, peak, RSS, the kernel's
    sample against plain (on "cuda") and the state dump."""
    import torch

    from agnes_tpu_torch.crypto import ed25519_verify as VF
    from agnes_tpu_torch.utils import budget
    from agnes_tpu_torch.utils.metrics import RETRACE_UNEXPECTED

    d, shard, clock = w.d, w.shard, w.clock
    rss = _rss_gib()                         # the serve's buffers still held
    launches = VF.LAUNCHES
    peak = torch.cuda.max_memory_allocated() if w.cuda else None
    # read before the sample, whose own launch the clock would record
    step_ms = clock.ms(clock.steps) if w.cuda else None
    kernel_ms = clock.ms(clock.kernels) if w.cuda else None
    if w.hb is not None:
        w.hb.stop()
    sample = None
    if w.cuda:
        sample = plain_sample(clock.last_lanes, SAMPLE_ROWS, args.forge,
                              np.random.RandomState(seed))
    if args.state_npz:
        np.savez(args.state_npz, **state_arrays(d))
    plan = budget.plan_dense_verify(2, *d._local_shape(), hbm_bytes=w.hbm)
    pod = rep["pod"]
    return {
        "process": args.pid, "host": d.host,
        "n_hosts": d.n_hosts, "per_host": d.per_host,
        "n_val": args.n_val, "device": str(d.device),
        "instances": args.instances, "validators": args.validators,
        "heights": args.heights, "local_instances": d.I,
        "decisions_total": d.stats.decisions_total,
        "pod_decisions": len(shard.pod_decisions),
        "pod_decision_rows": sorted(
            [pd.instance, pd.host, pd.height, pd.round,
             -1 if pd.value_id is None else pd.value_id]
            for pd in shard.pod_decisions),
        "foreign_rejects": shard.foreign_rejects,
        "rejected_signature_device": d.rejected_signature_device,
        "launches": launches,
        "cells_by_dispatch": clock.cells,
        "warm_launches": w.warm_launches,
        "retrace_unexpected": int(d.sentinel.metrics.counters.get(
            RETRACE_UNEXPECTED, 0)),
        "warmed_shapes": w.warmed,
        "offladder_builds": rep["offladder_builds"],
        "host_fallback_builds": rep["host_fallback_builds"],
        "dispatched_batches": rep["dispatched_batches"],
        "native_admission": bool(args.native_admission),
        "native_phase_builds": rep["native_phase_builds"],
        "agrees": pod["agrees"], "barriers": pod["barriers"],
        "gather_failed": pod["gather_failed"],
        "densify_ms": clock.densify_ms, "launch_ms": clock.launch_ms,
        "step_ms": step_ms, "kernel_ms": kernel_ms,
        "agree_ms": clock.agree_ms,
        "peak_bytes": peak, "plan_peak_bytes": plan.peak_bytes,
        "rss_gib": rss,
        "sample": sample,
        "heartbeat_path": args.heartbeat or None,
    }


def run_pod_worker(args) -> dict:
    """One pod process's serve loop (module docstring)."""
    _setup(args)
    from agnes_tpu_torch.distributed.pod import initialize_pod, shutdown_pod

    initialize_pod(args.init_method, args.n_processes, args.pid,
                   device_type=args.device)

    from agnes_tpu_torch.crypto import ed25519_verify as VF
    from agnes_tpu_torch.distributed.shard import HostShard

    try:
        I, V, H = args.instances, args.validators, args.heights
        # the one shape height-paced traffic dispatches: P = 3 (entry +
        # both classes); the sentinel then arms the no-retrace invariant
        w = _start_host(args, HostShard, (3,))
        d, shard, n_local = w.d, w.shard, w.n_local
        wire = [wire_height(I, V, w.seeds, h, VALUE, w.sigs)
                for h in range(H + 1)]
        gather_ms, rejected, launches = [], [], []
        t_all = time.perf_counter()
        t0 = t_all
        for h in range(H + 1):
            if h == 1:
                t0 = time.perf_counter()     # height 0 warms the path
            w.box["h"] = h
            res = shard.submit(wire[h])
            if res.accepted != 2 * n_local:
                raise RuntimeError(
                    f"process {args.pid} admitted {res.accepted} of the "
                    f"{2 * n_local} local records at height {h}: {res}")
            _progress(f"height {h}: admitted")
            want = 2 * n_local * (h + 1)
            before = VF.LAUNCHES
            while shard.pipeline.dispatched_votes < want:
                shard.pump()
            _progress(f"height {h}: dispatched")
            launches.append(VF.LAUNCHES - before)
            g0 = time.perf_counter()
            new = shard.poll_pod_decisions()
            gather_ms.append((time.perf_counter() - g0) * 1e3)
            if h == 0 and len(new) != I:
                raise RuntimeError(
                    f"process {args.pid}: the height-0 gather surfaced "
                    f"{len(new)} decisions, expected {I}")
            rejected.append(d.rejected_signature_device - sum(rejected))
        dt = time.perf_counter() - t0
        wall = time.perf_counter() - t_all
        rec = _finish_host(args, w, shard.drain(), 1000 + args.pid)
        rec.update({
            "mode": "pod",
            "votes_per_sec": 2 * I * V * H / dt if H else None,
            "wall_s": wall,
            "rejected_by_height": rejected,
            "launches_by_height": launches,
            "gather_ms": gather_ms,
        })
        return rec
    finally:
        shutdown_pod()


def _progress(msg: str) -> None:
    """A line in the worker's log: where a worker killed at the
    deadline stopped."""
    print(msg, flush=True)


def _serve_heights(svc, box, wire, n: int) -> None:
    """Submit and pump each height until its votes are dispatched."""
    for h, w in enumerate(wire):
        box["h"] = h
        res = svc.submit(w)
        if res.accepted != 2 * n:
            raise RuntimeError(f"height {h}: admitted {res.accepted} of "
                               f"{2 * n}")
        while svc.pipeline.dispatched_votes < 2 * n * (h + 1):
            svc.pump()
        _progress(f"height {h}: dispatched")


def wire_range(I: int, V: int, seeds, h: int, lo: int, hi: int, typs,
               sigs: dict) -> bytes:
    """One height's wire of the classes `typs` for instances [lo, hi)
    only, global instance ids: the traffic a host of the elastic smoke
    is given."""
    from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
    from agnes_tpu_torch.harness.fixtures import full_mesh_cols

    parts = []
    for typ in typs:
        cols = full_mesh_cols(I, V, seeds, h, typ, VALUE, sigs=sigs[h, typ])
        keep = (cols[0] >= lo) & (cols[0] < hi)
        parts.append(pack_wire_votes(*(c[keep] for c in cols)))
    return b"".join(parts)


def check_cycle(heights: int, leave_height: int,
                rejoin_height: int) -> bool:
    """Whether the elastic mode runs a leave / rejoin cycle: -1 for both
    heights means none; otherwise the cycle must lie within the served
    heights, 0 <= leave_height < rejoin_height <= heights."""
    if leave_height == rejoin_height == -1:
        return False
    if not 0 <= leave_height < rejoin_height <= heights:
        raise ValueError(
            f"elastic mode needs 0 <= leave_height < rejoin_height <= "
            f"heights, or -1 for both, got {leave_height}, "
            f"{rejoin_height}, {heights}")
    return True


def elastic_launches(heights: int, leave_height: int,
                     rejoin_height: int) -> List[int]:
    """The verify launches a process makes a height under
    `run_elastic_worker`'s tick schedule: one a dispatched dense slot.
    Every height dispatches two slots (its prevote tick and its
    precommit tick; a sleeper's are pure padding), and the readmission
    height of a cycle one more a catch-up tick."""
    churn = check_cycle(heights, leave_height, rejoin_height)
    return [2 + (rejoin_height - leave_height
                 if churn and h == rejoin_height else 0)
            for h in range(heights + 1)]


def run_elastic_worker(args) -> dict:
    """One elastic pod process: the deployment of ``pod`` mode served
    through ElasticShard's negotiated ticks, with heterogeneous traffic
    a host (host 0 splits each height's two vote classes across two
    ticks while the last host submits both at once, so the staged plans
    differ every tick and the per-tick max-merge and padding keep the
    pod in lockstep; the final height both hosts split, so the state is
    dumped from a quiesced pod) and one leave / rejoin cycle:

      height `leave_height - 1`, its last tick: the last host latches
          its leave;
      height `leave_height`'s boundary: repartition; the last host
          sleeps (its processes keep ticking, pure padding), host 0
          takes over its ranges and holds its gossip;
      height `rejoin_height - 1`, its last tick: the last host latches
          its rejoin (one tick early, so that host 0's prospective view
          holds it when the boundary tick packs the re-route);
      height `rejoin_height`'s boundary: readmission; host 0's held
          records re-route through that tick's frame, and catch-up ticks
          replay them in height order before live traffic resumes.

    The tick schedule is a function of the shared arguments, so every
    process runs the same collective sequence (the lockstep contract).
    With -1 for both heights there is no cycle (`check_cycle`); a cycle
    needs a pod of two hosts."""
    _setup(args)
    from agnes_tpu_torch.distributed.pod import initialize_pod, shutdown_pod

    initialize_pod(args.init_method, args.n_processes, args.pid,
                   device_type=args.device)

    from agnes_tpu_torch.crypto import ed25519_verify as VF
    from agnes_tpu_torch.distributed.elastic import ElasticShard

    try:
        I, V, H = args.instances, args.validators, args.heights
        leave_h, rejoin_h = args.leave_height, args.rejoin_height
        churn = check_cycle(H, leave_h, rejoin_h)
        # heterogeneous traffic dispatches P = 2 (entry + one class) and
        # P = 3 (entry + both): warm both, then arm; padding up to the
        # negotiated max must never make a new shape
        w = _start_host(args, ElasticShard, (2, 3))
        d, shard, box, sigs = w.d, w.shard, w.box, w.sigs
        if churn and d.n_hosts != 2:
            raise RuntimeError("the leave / rejoin cycle is choreographed "
                               "for a pod of two hosts")
        synced = [0]
        if w.cuda:
            # padding and the dispatch it feeds must not wait for the
            # card: each runs under sync debug mode "error"
            for name in ("pad_staged_to", "stage_padding",
                         "dispatch_staged"):
                setattr(shard.pipeline, name,
                        _no_sync(getattr(shard.pipeline, name), synced))

        me, sleeper = d.host, d.n_hosts - 1
        lo_s, hi_s = shard.plan.instance_range(sleeper)
        ticks: List[dict] = []

        def tick(boundary: bool = False) -> None:
            ticks.append(shard.tick(boundary=boundary))

        def mine(h, typs):
            return wire_range(I, V, w.seeds, h, shard.lo, shard.hi, typs,
                              sigs)

        launches = []
        t0 = time.perf_counter()
        for h in range(H + 1):
            before = VF.LAUNCHES
            tick(boundary=True)          # A: the height edge, a boundary
            if h == rejoin_h:
                # catch-up: the boundary tick re-routed the held wire to
                # the readmitted host, which replays it height by height
                # while host 0 ticks along with nothing staged
                for hh in range(leave_h, rejoin_h):
                    if me == sleeper:
                        box["h"] = hh
                    tick()
            asleep = me == sleeper and leave_h <= h < rejoin_h
            if not asleep:
                box["h"] = h
            hetero = h != H
            if asleep:
                tick()                   # B: pure padding
            elif me == sleeper and hetero:
                shard.submit(mine(h, (PV, PC)))
                tick()                   # B: P = 3 (both classes)
            else:
                shard.submit(mine(h, (PV,)))
                if me == 0 and leave_h <= h < rejoin_h:
                    # the sleeper's traffic, held for its readmission
                    shard.submit(wire_range(I, V, w.seeds, h, lo_s, hi_s,
                                            (PV, PC), sigs))
                tick()                   # B: P = 2 (prevotes)
            if me == sleeper:
                if h == leave_h - 1:
                    shard.announce_leave()
                if h == rejoin_h - 1:
                    shard.announce_join()
            if asleep or (me == sleeper and hetero):
                tick()                   # C: padding (nothing staged)
            else:
                shard.submit(mine(h, (PC,)))
                tick()                   # C: P = 2 (precommits)
            launches.append(VF.LAUNCHES - before)
            _progress(f"height {h}: epoch {shard.membership.view.epoch}, "
                      f"{launches[-1]} launches")
        for _ in range(3):               # settle, latch, gather
            tick()
        dt = time.perf_counter() - t0
        rep = shard.drain()
        rec = _finish_host(args, w, rep, 2000 + args.pid)
        ela = rep["pod"]["elastic"]
        rec.update({
            "mode": "elastic",
            "leave_height": leave_h,
            "rejoin_height": rejoin_h,
            "votes_per_sec": 2 * I * V * (H + 1) / dt,   # pod-wide
            "wall_s": dt,
            "launches_by_height": launches,
            "launches_implied": elastic_launches(H, leave_h, rejoin_h),
            "sync_checked_calls": synced[0],
            "negotiation_ticks": ela["negotiation_ticks"],
            "negotiations": ela["negotiations"],
            "negotiation_ms": [t["negotiation_wall_s"] * 1e3
                               for t in ticks],
            "negotiate_ms": w.clock.negotiate_ms,
            "pack_ms": w.clock.pack_ms,
            "unpack_ms": w.clock.unpack_ms,
            "ticks_dispatched": sum(t["dispatched"] for t in ticks),
            "ticks_padded": sum(t["padded"] for t in ticks),
            "padded_slots": ela["padded_slots"],
            "pad_builds": ela["pad_builds"],
            "padded_phases": ela["padded_phases"],
            "boundaries": ela["boundaries"],
            "membership_epoch": ela["epoch"],
            "alive": ela["alive"],
            "readmissions": ela["readmissions"],
            "departures": ela["departures"],
            "adopted_held": ela["adopted_held"],
            "held_dropped": ela["held_dropped"],
            "held_pending": ela["held_pending"],
            "reroute_sent": ela["reroute_sent"],
            "reroute_received": ela["reroute_received"],
            "reroute_reheld": ela["reroute_reheld"],
            "reroute_capacity": shard.reroute_capacity,
            "frame_bytes": shard.frame_bytes,
        })
        return rec
    finally:
        shutdown_pod()


def run_single_worker(args) -> dict:
    """One rank of a single host of `--n-processes` ranks serving the
    deployment (module docstring)."""
    torch, dev = _setup(args)
    from agnes_tpu_torch.distributed.pod import (
        PodCoordinator,
        initialize_pod,
        shutdown_pod,
    )

    initialize_pod(args.init_method, args.n_processes, args.pid,
                   device_type=args.device)

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.distributed.driver import DistributedDriver
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.serve import ShapeLadder, VoteService
    from agnes_tpu_torch.utils import budget

    try:
        I, V, H = args.instances, args.validators, args.heights
        hbm = (budget.device_hbm_bytes(dev) if dev.type == "cuda"
               else CPU_HBM_BYTES)
        d = DistributedDriver(I, V, advance_height=True,
                              defer_collect=True, audit=True,
                              n_val=args.n_val, per_host=args.n_processes,
                              coordinator=PodCoordinator(),
                              hbm_budget_bytes=hbm, device=dev)
        n = I * V
        box = {"h": 0}
        seeds = fx.deterministic_seeds(V)
        svc = VoteService(
            d, VoteBatcher(I, V, n_slots=4, device=dev),
            fx.validator_pubkeys(seeds), capacity=4 * 2 * n,
            target_votes=2 * n, max_delay_s=1e9,
            ladder=ShapeLadder.plan_dense(
                I, V, local_shape=d._local_shape(),
                min_rung=1 << (2 * n - 1).bit_length(), hbm_bytes=hbm),
            window_predictor=lambda: (np.zeros(I, np.int64),
                                      np.full(I, box["h"], np.int64)))
        svc.pipeline.warmup(n_phases=(3,), arm=True)
        sigs = signatures(seeds, H, VALUE, args.forge)
        _serve_heights(svc, box, [wire_height(I, V, seeds, h, VALUE, sigs)
                                  for h in range(H + 1)], n)
        rep = svc.drain()
        if args.state_npz:
            np.savez(args.state_npz, **state_arrays(d))
        return {"mode": "single", "process": args.pid,
                "decisions_total": d.stats.decisions_total,
                "rejected_signature_device": d.rejected_signature_device,
                "offladder_builds": rep["offladder_builds"],
                "agrees": d.coordinator.agrees}
    finally:
        shutdown_pod()


def run_offline_worker(args) -> dict:
    """The one-device offline dense path (module docstring)."""
    torch, dev = _setup(args)
    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver

    I, V, H = args.instances, args.validators, args.heights
    seeds = fx.deterministic_seeds(V)
    pubkeys = fx.validator_pubkeys(seeds)
    sigs = signatures(seeds, H, VALUE, args.forge)
    d = DeviceDriver(I, V, advance_height=True, defer_collect=True,
                     device=dev)
    bat = VoteBatcher(I, V, n_slots=4, device=dev)
    for h in range(H + 1):
        bat.sync_device(np.zeros(I, np.int64), np.full(I, h, np.int64))
        for typ in (PV, PC):
            bat.add_arrays(*fx.full_mesh_cols(I, V, seeds, h, typ,
                                              VALUE, sigs=sigs[h, typ]))
        phases, dense = bat.build_phases_device_dense(pubkeys)
        if dense is None:
            raise RuntimeError("the offline dense build left the device "
                               "path")
        d.step_seq_signed_dense([d.empty_phase()]
                                + [p for p, _ in phases], dense)
    d.block_until_ready()
    if args.state_npz:
        np.savez(args.state_npz, **state_arrays(d))
    return {"mode": "offline", "decisions_total": d.stats.decisions_total,
            "rejected_signature_device": d.rejected_signature_device}


def _die_with_parent() -> None:
    """SIGKILL this worker when its parent dies (PR_SET_PDEATHSIG), so
    a pod never outlives the process that spawned it.  Set after exec,
    in the worker's own interpreter; a parent that died before that has
    handed the worker to init, and the worker exits."""
    import ctypes
    import signal

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, signal.SIGKILL, 0, 0, 0):   # 1 = PR_SET_PDEATHSIG
        err = ctypes.get_errno()
        raise OSError(err, f"prctl(PR_SET_PDEATHSIG): {os.strerror(err)}")
    if os.getppid() == 1:
        sys.exit("the spawning process is gone")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m agnes_tpu_torch.distributed.smoke")
    ap.add_argument("--mode", choices=("pod", "elastic", "single",
                                       "offline"), required=True)
    ap.add_argument("--pid", type=int, default=0, help="this rank")
    ap.add_argument("--n-processes", type=int, default=2,
                    help="the world's ranks")
    ap.add_argument("--init-method", default=None,
                    help="file://<path> or tcp://localhost:<port>")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--per-host", type=int, default=1,
                    help="ranks a host (pod mode)")
    ap.add_argument("--n-val", type=int, default=1,
                    help="ranks a host's val axis")
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--validators", type=int, default=8)
    ap.add_argument("--heights", type=int, default=2,
                    help="heights after height 0")
    ap.add_argument("--forge", type=int, default=None,
                    help="validator whose votes are forged in both "
                         "classes")
    ap.add_argument("--native-admission", action="store_true")
    ap.add_argument("--leave-height", type=int, default=-1,
                    help="elastic mode: the boundary height at which the "
                         "last host departs (-1: no leave)")
    ap.add_argument("--rejoin-height", type=int, default=-1,
                    help="elastic mode: the readmission boundary height "
                         "(-1: no rejoin)")
    ap.add_argument("--out", required=True, help="result JSON path")
    ap.add_argument("--state-npz", default=None)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--hb-interval", type=float, default=HB_INTERVAL_S,
                    help="seconds between heartbeat lines")
    args = ap.parse_args(argv)
    _die_with_parent()
    if args.mode != "offline" and not args.init_method:
        ap.error(f"--mode {args.mode} needs --init-method")
    run = {"pod": run_pod_worker, "elastic": run_elastic_worker,
           "single": run_single_worker,
           "offline": run_offline_worker}[args.mode]
    try:
        rec = run(args)
    except BaseException as e:
        # the parent reads a record even when a worker dies
        _result(args.out, {"mode": args.mode, "process": args.pid,
                           "error": f"{type(e).__name__}: {e}"})
        raise
    _result(args.out, rec)
    return 0


def _result(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, sort_keys=True)
        f.write("\n")


# -- the parent's side ---------------------------------------------------------

def _repo_root() -> str:
    import agnes_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(agnes_tpu_torch.__file__)))


class PodRun:
    """Workers started by `start_pod`; `wait()` collects them."""

    def __init__(self, jobs, timeout_s: float):
        self.jobs = jobs
        self.deadline = time.monotonic() + timeout_s

    def wait(self) -> dict:
        """Poll every worker until all have exited, one has failed, or
        the deadline has passed; SIGKILL the rest in the last two cases.
        Returns {"pod": [record a rank, pod or elastic mode],
        "single": [record a rank]?,
        "offline": record?, "paths": {tag: {...}}, "killed": bool (the
        deadline passed), "failed_first": tag?}.  A worker that died,
        or was killed, has a record with an "error" key."""
        killed, failed = False, None
        while True:
            rcs = [job["proc"].poll() for job in self.jobs]
            failed = next((job["tag"] for job, rc in zip(self.jobs, rcs)
                           if rc not in (None, 0)), None)
            if failed is not None or None not in rcs:
                break
            if time.monotonic() > self.deadline:
                killed = True
                break
            time.sleep(0.05)
        for job in self.jobs:
            if job["proc"].poll() is None:
                job["proc"].kill()
        for job in self.jobs:
            try:
                job["proc"].wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        out: dict = {"pod": [], "paths": {}, "killed": killed,
                     "failed_first": failed}
        for job in self.jobs:
            job["log"].close()
            rc = job["proc"].returncode
            out["paths"][job["tag"]] = dict(job["paths"], rc=rc)
            try:
                with open(job["paths"]["json"]) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                why = (", killed at the deadline" if killed else
                       f", killed after {failed} failed" if failed else "")
                rec = {"mode": job["mode"],
                       "error": f"no result record (rc={rc}{why})"}
            if job["mode"] == "offline":
                out["offline"] = rec
            elif job["mode"] == "elastic":
                out["pod"].append(rec)
            else:
                out.setdefault(job["mode"], []).append(rec)
        return out


def start_pod(n_processes: int = 2, *, per_host: int = 1, n_val: int = 1,
              instances: int = 8, validators: int = 8, heights: int = 2,
              forge: Optional[int] = None, device: str = "cuda",
              out_dir: str, timeout_s: float = 1200.0,
              heartbeat: bool = False, hb_interval: float = HB_INTERVAL_S,
              dump_state: bool = False, native_admission: bool = False,
              elastic: bool = False, leave_height: int = -1,
              rejoin_height: int = -1,
              extra_modes: Optional[List[str]] = None,
              tag: str = "pod") -> PodRun:
    """Launch a pod of `n_processes` ranks (`per_host` a host) in
    `device` mode, each its own interpreter, rendezvous by `file://` in
    `out_dir`; `elastic=True` serves it through ElasticShard's
    negotiated ticks (mode ``elastic``), with a leave / rejoin cycle at
    the given boundary heights (-1 for both: none; `check_cycle`);
    heartbeat trails are stamped every `hb_interval` seconds;
    `extra_modes` adds "single" (one host
    of `n_processes` ranks, a world of its own) and "offline" (one
    process).  Returns at once; `PodRun.wait()` bounds everything by
    `timeout_s`."""
    if elastic:
        check_cycle(heights, leave_height, rejoin_height)
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ)
    root = _repo_root()
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")

    def launch(mode: str, pid: int, world: int, name: str,
               rendezvous: Optional[str]) -> dict:
        paths = {"json": os.path.join(out_dir, f"{name}.json"),
                 "log": os.path.join(out_dir, f"{name}.log"),
                 "npz": (os.path.join(out_dir, f"{name}.npz")
                         if dump_state else None),
                 "heartbeat": (os.path.join(out_dir,
                                            f"heartbeat.{name}.ndjson")
                               if heartbeat and mode in ("pod", "elastic")
                               else None)}
        cmd = [sys.executable, "-m", "agnes_tpu_torch.distributed.smoke",
               "--mode", mode, "--pid", str(pid),
               "--n-processes", str(world), "--device", device,
               "--per-host", str(per_host), "--n-val", str(n_val),
               "--instances", str(instances),
               "--validators", str(validators),
               "--heights", str(heights), "--out", paths["json"]]
        if rendezvous:
            cmd += ["--init-method", f"file://{rendezvous}"]
        if forge is not None:
            cmd += ["--forge", str(forge)]
        if paths["npz"]:
            cmd += ["--state-npz", paths["npz"]]
        if paths["heartbeat"]:
            cmd += ["--heartbeat", paths["heartbeat"],
                    "--hb-interval", str(hb_interval)]
        if native_admission and mode in ("pod", "elastic"):
            cmd.append("--native-admission")
        if mode == "elastic":
            cmd += ["--leave-height", str(leave_height),
                    "--rejoin-height", str(rejoin_height)]
        log = open(paths["log"], "w")
        proc = subprocess.Popen(cmd, stdout=log, stderr=log, env=env,
                                cwd=root)
        return {"tag": name, "mode": mode, "proc": proc, "log": log,
                "paths": paths}

    def rendezvous(name: str) -> str:
        path = os.path.join(out_dir, f"rendezvous.{name}")
        if os.path.exists(path):
            os.remove(path)
        return path

    jobs = []
    rdv = rendezvous(tag)
    jobs += [launch("elastic" if elastic else "pod", k, n_processes,
                    f"{tag}{k}", rdv) for k in range(n_processes)]
    for mode in (extra_modes or ()):
        if mode == "single":
            rdv = rendezvous(f"{tag}_single")
            jobs += [launch("single", k, n_processes, f"{tag}_single{k}",
                            rdv) for k in range(n_processes)]
        elif mode == "offline":
            jobs.append(launch("offline", 0, 1, f"{tag}_offline", None))
        else:
            raise ValueError(f"unknown mode {mode!r}")
    return PodRun(jobs, timeout_s)


def spawn_pod(n_processes: int = 2, *, instances: int = 8,
              validators: int = 8, heights: int = 2,
              devices_per_host: int = 2, n_val: int = 2,
              out_dir: str, timeout_s: float = 1200.0,
              heartbeat: bool = False, hb_interval: float = 1.0,
              dump_state: bool = False,
              native_admission: bool = False,
              elastic: bool = False, leave_height: int = -1,
              rejoin_height: int = -1,
              extra_modes: Optional[List[str]] = None,
              forge: Optional[int] = None, device: str = "cuda",
              tag: str = "pod") -> dict:
    """A pod of `n_processes` hosts with `devices_per_host` devices each,
    one rank a device (`start_pod(n_processes * devices_per_host,
    per_host=devices_per_host, ...)`), waited for: every worker's
    record, one a rank.  The other arguments are start_pod's."""
    return start_pod(
        n_processes * devices_per_host, per_host=devices_per_host,
        n_val=n_val, instances=instances, validators=validators,
        heights=heights, forge=forge, device=device, out_dir=out_dir,
        timeout_s=timeout_s, heartbeat=heartbeat, hb_interval=hb_interval,
        dump_state=dump_state, native_admission=native_admission,
        elastic=elastic, leave_height=leave_height,
        rejoin_height=rejoin_height, extra_modes=extra_modes,
        tag=tag).wait()


if __name__ == "__main__":
    sys.exit(main())
