"""Pod coordination: lockstep agreement, barriers and the byte-frame
all_gather, over `torch.distributed` (twin of `agnes_tpu.distributed.pod`).

Serving a pod has one hard protocol rule: every process launches the
same pod computations in the same order.  A rank that sits a dispatch
out, or launches another shape, leaves its peers waiting in a
collective that never completes.  The per-host serve fronts make that
a property of the traffic, so this layer turns a violation into a loud
failure instead of a silent hang:

* **agree(tag)** — before every dispatch each process contributes a
  digest of its dispatch plan (entry, statics, argument signature) to a
  tiny fixed-size all_gather; any mismatch raises PodDivergenceError on
  every process, naming the processes that differ.  All processes run
  the same code path, so when plans diverge every side sits in the
  same agree call when it fails: the check cannot wedge the pod worse
  than the divergence it caught.
* **barrier(name, payload)** — agree() with rendezvous semantics: the
  warmup brackets itself in barriers whose payload is its plan, so
  "every process warms the same set" is checked, not hoped.
* **allgather_bytes(frame)** — the decision-gather transport: each
  process contributes one fixed-size uint8 frame and gets
  [n_processes, len] back, in rank order.
* **negotiate(frame)** — the elastic pod's per-tick exchange
  (distributed/elastic.py): the same gather, counted apart.

Departure from the twin, by design: the twin's gathers ride the device
fabric (`process_allgather`); the port's ride a `gloo` group of every
pod rank on CPU tensors (`initialize_pod` makes it).  Its frames never
touch the card, so an agree before every dispatch adds no device
synchronization, and two processes may share one card (NCCL refuses two
ranks of one communicator on one GPU).  The step's `val` all_reduces
stay on the mesh's own backend.  The twin counts one controller a host;
the port runs one process a device, so a coordinator counts processes
and a host is a block of `per_host` consecutive ranks
(distributed/driver.py).

A pod of one process degenerates to no-ops (agree and barrier pass,
allgather returns the caller's frame).
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from agnes_tpu_torch.distributed.topology import StragglerMonitor

#: digest frame bytes (blake2b-16: the check guards against honest
#: configuration and traffic drift, not an adversary)
DIGEST_BYTES = 16

#: the coordinator's gloo group of every pod rank (initialize_pod)
_GROUP = None


def initialize_pod(init_method: str, world_size: int, rank: int,
                   device_type: str = "cuda"):
    """Join the pod's process group and return (rank, world_size).

    `init_method` is a `file://` rendezvous or `tcp://localhost:<port>`;
    the caller gives the world size and this process's rank.  On
    "cuda" the rank's card (rank % cards on this machine) is made
    current before the process group starts, and the world's backend is
    "cpu:gloo,cuda:nccl": NCCL for the step's all_reduces on the card,
    gloo for CPU tensors.  On "cpu" it is gloo.  Either way a gloo group
    of every rank is made for the coordinator (module docstring).  A
    "cuda" pod without a card raises: a pod never drops to the CPU."""
    import torch
    import torch.distributed as dist

    global _GROUP
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda pod needs a CUDA device; pass "
                               "device_type='cpu' for a gloo pod")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "cpu:gloo,cuda:nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device type {device_type!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _GROUP = dist.new_group(backend="gloo")
    return dist.get_rank(), dist.get_world_size()


def pod_group():
    """The coordinator's gloo group (made by initialize_pod)."""
    if _GROUP is None:
        raise RuntimeError("no pod: call initialize_pod first")
    return _GROUP


def shutdown_pod() -> None:
    """Leave the pod: destroy the process group initialize_pod joined
    (the coordinator's group with it)."""
    import torch.distributed as dist

    global _GROUP
    _GROUP = None
    dist.destroy_process_group()


class PodDivergenceError(RuntimeError):
    """Processes disagreed on a pod-wide dispatch plan or barrier."""


def plan_digest(tag) -> bytes:
    """Stable digest of a (nested, repr-able) dispatch-plan tag."""
    return hashlib.blake2b(repr(tag).encode(),
                           digest_size=DIGEST_BYTES).digest()


class PodCoordinator:
    """Lockstep and gather primitives over the pod's gloo group (module
    docstring).  `n_processes` / `process` default to the group's size
    and this rank.  `monitor` (topology.StragglerMonitor) is beaten on
    every completed gather: an all_gather that returned proves every
    host live.  `flightrec` gets one `pod_divergence` event a
    divergence."""

    def __init__(self, n_processes: Optional[int] = None,
                 process: Optional[int] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 flightrec=None):
        if n_processes is None or process is None:
            import torch.distributed as dist

            if n_processes is None:
                n_processes = dist.get_world_size(pod_group())
            if process is None:
                process = dist.get_rank(pod_group())
        self.n_processes = int(n_processes)
        self.process = int(process)
        self.monitor = monitor
        self.flightrec = flightrec
        self.agrees = 0
        self.barriers = 0
        self.gathered_frames = 0
        self.negotiations = 0

    # -- transport -----------------------------------------------------------

    def allgather_bytes(self, frame: np.ndarray) -> np.ndarray:
        """One fixed-size uint8 frame a process -> [n_processes, len],
        in rank order.  Every process must call with the same frame
        length (the lockstep contract this class polices)."""
        frame = np.ascontiguousarray(frame, np.uint8)
        if self.n_processes == 1:
            out = frame[None]
        else:
            import torch
            import torch.distributed as dist

            got = torch.empty((self.n_processes * len(frame),),
                              dtype=torch.uint8)
            dist.all_gather_into_tensor(got, torch.tensor(frame),
                                        group=pod_group())
            out = got.numpy().reshape(self.n_processes, len(frame))
        self.gathered_frames += 1
        if self.monitor is not None:
            self.monitor.beat(None)     # completed: everybody live
        return out

    def negotiate(self, frame: np.ndarray) -> np.ndarray:
        """The elastic pod's per-tick exchange: the same fixed-size
        all_gather as `allgather_bytes`, counted in `negotiations`, so a
        post-mortem tells negotiated ticks (shape plans, decisions,
        membership intents and re-routed gossip in one frame,
        distributed/elastic.py) from plain decision gathers.  Padding to
        the merged plan is the caller's."""
        out = self.allgather_bytes(frame)
        self.negotiations += 1
        return out

    # -- lockstep ------------------------------------------------------------

    def agree(self, tag, kind: str = "dispatch") -> bytes:
        """Every process's digest of `tag` compared; PodDivergenceError
        on a mismatch (module docstring).  Returns the agreed digest."""
        mine = plan_digest(tag)
        if self.n_processes > 1:
            frames = self.allgather_bytes(np.frombuffer(mine, np.uint8))
            bad = [p for p, row in enumerate(frames)
                   if row.tobytes() != mine]
            if bad:
                if self.flightrec is not None:
                    self.flightrec.event("pod_divergence", plan=kind,
                                         process=self.process,
                                         differing=bad)
                raise PodDivergenceError(
                    f"{kind} plan diverged across the pod: process "
                    f"{self.process} disagrees with process(es) {bad} "
                    f"(local tag: {tag!r}); a dispatch with mismatched "
                    f"plans would wedge the pod, so it fails here")
        self.agrees += 1
        return mine

    def barrier(self, name: str, payload=()) -> None:
        """Rendezvous + payload-digest compare (module docstring)."""
        self.agree((name, payload), kind=f"barrier:{name}")
        self.barriers += 1
