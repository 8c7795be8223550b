"""HostShard: a pod process's serve front end (twin of
`agnes_tpu.distributed.shard`).

One HostShard a process, wrapping a real VoteService built over the
process's DistributedDriver at host-local shape (its own admission
queue, native or Python, its own batcher, flight recorder and metrics),
and adding the pod-facing parts a single-host service does not have:

* **Instance-range screening** (the front door): gossip carries global
  instance ids; `submit` drops the records outside this host's block
  (counted `pod_foreign_rejects`), rebases the survivors' instance field
  in the 96-byte wire layout (topology.shift_instances_inplace on the
  one survivor copy, no unpack / repack) and feeds the local service,
  whose queue then screens and caps the local range as a single-host
  deployment would.
* **Barrier-synchronized warmup**: every process warms the same
  (entry, rung) set, its plan digest-compared at a pod barrier before
  and after; each process's retrace sentinel then arms, so an
  off-ladder dispatch fails loudly on its process (RetraceError) and a
  mismatched plan fails every process (PodDivergenceError).
* **Decision gather**: newly latched local decisions ride the 96-byte
  wire records in fixed-size frames through one all_gather (topology
  codec + pod transport), so every process holds the pod-wide
  decisions.  Every rank of a host holds the same decisions (its
  driver's read-outs gather over the host), so only the frame of each
  host's first rank is unpacked; the other ranks' frames of that host
  must equal it byte for byte, or the gather raises PodDivergenceError.
* **Fail-closed liveness**: a StragglerMonitor fed by completed
  collectives gates every decision gather; a peer past the dead age
  raises DeadHostError before this process walks into an all_gather
  that can never complete, and `drain` then degrades to a local drain
  with the failure in its report.

Every rank of a host is given the same global gossip and serves the same
host-local traffic; batches must close by size (the twin's smoke:
`target_votes`, `max_delay_s=1e9`) so that every rank of a host builds
the same batches, which the dispatch agree() checks.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from agnes_tpu_torch.bridge.native_ingest import REC_SIZE
from agnes_tpu_torch.distributed.pod import (
    PodCoordinator,
    PodDivergenceError,
)
from agnes_tpu_torch.distributed.topology import (
    DeadHostError,
    PodDecision,
    StragglerMonitor,
    pack_decision_frame,
    shift_instances_inplace,
    unpack_decision_frames,
    wire_instance_ids,
)
from agnes_tpu_torch.serve.queue import AdmitResult
from agnes_tpu_torch.utils.metrics import POD_FOREIGN_REJECTS


class HostShard:
    """A pod process's serve front end (module docstring).  `driver` is
    a DistributedDriver, which gets this shard's coordinator
    (`coordinator`, default one over the pod's gloo group; it gets this
    shard's monitor when it has none).  `monitor` defaults to a
    StragglerMonitor that calls a peer a straggler / dead after
    `straggler_after_s` / `dead_after_s` seconds without a completed
    collective (a healthy gap spans a step, a densify and a warmup's
    rungs), read on `clock`, which the VoteService reads too.
    `service_kwargs` go to VoteService (ladder, window_predictor,
    target_votes, max_delay_s, native_admission, dedup_cache, metrics,
    flightrec, ...: the whole single-host surface)."""

    def __init__(self, driver, batcher, pubkeys=None, *,
                 coordinator: Optional[PodCoordinator] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 dead_after_s: float = 60.0,
                 straggler_after_s: float = 10.0,
                 clock=time.monotonic,
                 **service_kwargs):
        from agnes_tpu_torch.serve import VoteService

        self.driver = driver
        self.plan = driver.plan
        self.host = driver.host
        self.n_hosts = driver.n_hosts
        self.per_host = driver.per_host
        self.monitor = monitor if monitor is not None else \
            StragglerMonitor(self.n_hosts, self.host,
                             dead_after_s=dead_after_s,
                             straggler_after_s=straggler_after_s,
                             clock=clock)
        self.coordinator = coordinator if coordinator is not None else \
            PodCoordinator(monitor=self.monitor,
                           flightrec=service_kwargs.get("flightrec"))
        if self.coordinator.monitor is None:
            self.coordinator.monitor = self.monitor
        # the driver's per-dispatch agree() rides the same coordinator
        # (one collective order for the pod)
        driver.coordinator = self.coordinator
        self.service = VoteService(driver, batcher, pubkeys, clock=clock,
                                   **service_kwargs)
        self.lo, self.hi = self.plan.instance_range(self.host)
        self._frame_cap = self.plan.local_instances
        self.foreign_rejects = 0
        self.pod_decisions: List[PodDecision] = []
        self._gather_failed: Optional[str] = None

    # -- ingress: the pod front door -----------------------------------------

    def submit(self, wire_bytes) -> AdmitResult:
        """Admit pod-wide gossip: screen to this host's block, rebase the
        ids onto the local service, count the foreign remainder.  One
        parse, one survivor copy: the fancy-indexed `rec[mine]` is the
        kept copy, rebased in place before its one serialization."""
        buf = np.frombuffer(bytes(wire_bytes), np.uint8)
        n = len(buf) // REC_SIZE
        tail = buf[n * REC_SIZE:]
        if n:
            rec = buf[:n * REC_SIZE].reshape(n, REC_SIZE)
            inst = wire_instance_ids(rec)
            mine = (inst >= self.lo) & (inst < self.hi)
            foreign = int(n - mine.sum())
            kept = rec[mine]                 # fancy index: a new copy
            shift_instances_inplace(kept, -self.lo)
            local_wire = kept.tobytes() + tail.tobytes()
        else:
            foreign = 0
            local_wire = tail.tobytes()
        self.foreign_rejects += foreign
        if foreign:
            self.service.metrics.count(POD_FOREIGN_REJECTS, foreign)
        return self.service.submit(local_wire)

    def submit_local(self, wire_bytes) -> AdmitResult:
        """Admit traffic already in local instance ids (a router that
        shards by host skips the screen)."""
        return self.service.submit(wire_bytes)

    # -- lifecycle -----------------------------------------------------------

    def warmup(self, n_phases=(2, 3), arm: bool = True) -> int:
        """Barrier-synchronized warmup (module docstring)."""
        lad = self.service.pipeline.ladder
        plan = ("warmup", tuple(n_phases), self.driver.I, self.driver.V,
                self.driver.global_I, lad.rungs, lad.bls_rungs,
                lad.bls_class_rungs, self.service.pipeline.dense,
                bool(arm))
        self.coordinator.barrier("warmup_enter", plan)
        warmed = self.service.pipeline.warmup(n_phases, arm=arm)
        self.coordinator.barrier("warmup_exit", ("warmed", warmed))
        return warmed

    def pump(self, now: Optional[float] = None) -> dict:
        return self.service.pump(now)

    def poll_decisions(self):
        """Local decisions only (no pod collective)."""
        return self.service.poll_decisions()

    def poll_pod_decisions(self) -> List[PodDecision]:
        """Local poll + the pod-wide decision gather (one all_gather;
        every process calls it in lockstep).  Returns the new pod-wide
        decisions this gather surfaced; `pod_decisions` accumulates
        them.  Fails closed on a dead peer (module docstring)."""
        self.monitor.check()
        frames = self.coordinator.allgather_bytes(
            self._local_decision_frame())
        new = unpack_decision_frames(self._host_rows(frames, "decision"))
        self.pod_decisions.extend(new)
        return new

    def _local_decision_frame(self) -> np.ndarray:
        """Newly latched local decisions (a local poll, which settles the
        dispatches in flight) as one decision frame in global ids.  The
        height stamp is the instance's first-advance height (its first
        latched decision's height, kept by the pipeline); an instance
        polled before its window advanced is still on its decided height,
        so the live height is the fallback."""
        local = self.service.poll_decisions()
        inst = self.plan.to_global(
            self.host, np.asarray([d.instance for d in local], np.int64))  # lint: allow (host list -> array)
        fah = self.service.pipeline.first_advance_height
        hts = np.asarray(  # lint: allow (host list -> array)
            [fah.get(d.instance,
                     int(self.service.batcher.heights[d.instance]))
             for d in local], np.int64)
        return pack_decision_frame(
            self.host, inst,
            np.asarray([(d.value_id if d.value_id is not None else -1)  # lint: allow (host list -> array)
                        for d in local], np.int64),
            np.asarray([d.round for d in local], np.int64),  # lint: allow (host list -> array)
            hts, self._frame_cap)

    def _host_rows(self, frames: np.ndarray, what: str) -> np.ndarray:
        """[n_hosts, len]: each host's first rank's row of a gathered
        [n_processes, len] frame.  The other ranks of a host hold the
        same gossip and build the same batches, so their rows must equal
        it byte for byte; PodDivergenceError otherwise."""
        first = frames[::self.per_host]
        bad = [p for p, row in enumerate(frames) if p % self.per_host
               and not np.array_equal(row, first[p // self.per_host])]
        if bad:
            raise PodDivergenceError(
                f"{what} frames of process(es) {bad} differ from their "
                f"host's first rank: the ranks of one host diverged")
        return first

    def drain(self, gather: bool = True) -> dict:
        """Drain the local slice and (in lockstep) run one last decision
        gather; a dead peer degrades this to a local drain with the
        failure in the report, never a hang."""
        if gather:
            try:
                self.monitor.check()
            except DeadHostError as e:
                self._gather_failed = str(e)
                gather = False
        rep = self.service.drain()
        final: List[PodDecision] = []
        if gather:
            try:
                final = self.poll_pod_decisions()
            except DeadHostError as e:
                self._gather_failed = str(e)
        rep["pod"] = {
            "host_id": self.host,
            "n_hosts": self.n_hosts,
            "process_index": self.driver.process_index,
            "per_host": self.per_host,
            "instance_range": [self.lo, self.hi],
            "foreign_rejects": self.foreign_rejects,
            "final_gathered": len(final),
            "pod_decisions": len(self.pod_decisions),
            "stragglers": self.monitor.stragglers(),
            "dead_hosts": self.monitor.dead(),
            "gather_failed": self._gather_failed,
            "agrees": self.coordinator.agrees,
            "barriers": self.coordinator.barriers,
        }
        return rep

    # -- passthroughs --------------------------------------------------------

    @property
    def metrics(self):
        return self.service.metrics

    @property
    def pipeline(self):
        return self.service.pipeline

    @property
    def queue(self):
        return self.service.queue
