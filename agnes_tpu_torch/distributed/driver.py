"""DistributedDriver: the dense fused signed step of one pod host, over
`torch.distributed` (twin of `agnes_tpu.distributed.driver`).

The pod's world is `n_hosts x per_host` ranks, one process a device,
laid out host-major by `parallel/mesh.py::make_pod_mesh`: host h is
ranks [h * per_host, (h + 1) * per_host), the slice coordinate h of a
(slice, data, val) mesh.  Hosts sit on the slice axis, which carries no
collective: the tally's quorum all_reduces stay on each host's `val`
group, so a pod step communicates across hosts exactly as much as a
single-host step does (nothing).

The driver is a DeviceDriver over the host's (data, val) sub-mesh
(`pod_mesh["data", "val"]`) with `I` the host's instance slice
(`HostPlan`): the host's serve plane (admission, batching, densify)
builds everything at host-local shape as a single-host deployment
would, every rank of the host is given the same host-local arguments
and cuts its own block out of them (the port's mesh contract), and the
read-outs (`collect` and the stats, `rejected_signature_device`,
`state_copies`, `window`) gather over the host's ranks only, as the
twin's `fetch_local_block` reads only its host's block: nothing
crosses hosts at read-out.

Lockstep: with a PodCoordinator attached, every dense and unsigned
dispatch (warmup's included) first `agree()`s on a digest of its plan
(entry, statics, the shapes and dtypes of its host-local arguments, the
same on every rank of a healthy pod); divergence fails loudly on every
process instead of wedging a collective (distributed/pod.py).

The single-process surfaces (`step`, `step_seq`, the signed sequences,
`run_heights_fused`) and `set_proposer_table` raise NotImplementedError,
as the twin's do: the pod driver serves through `step_async`, and the
offline comparison runs on one device.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from agnes_tpu_torch.distributed.pod import pod_group
from agnes_tpu_torch.distributed.topology import HostPlan
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.parallel.mesh import DATA_AXIS, VAL_AXIS, make_pod_mesh


def _leaves(tree) -> list:
    """The tensors of a nest of (named) tuples, in order."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if tree is not None else []


def plan_sig(args) -> tuple:
    """(shape, dtype) of every tensor of `args`: the same on every rank
    of a healthy pod (host-local shapes split evenly by the HostPlan; no
    device string, since two hosts' cards may differ)."""
    return tuple((tuple(x.shape), str(x.dtype)) for x in _leaves(args))


class _HostRejects:
    """One signed dispatch's rejected-lane counts over the host's block,
    filled when the driver collects (a rank's own count covers only its
    block).  The serve pipeline's dedup-cache gate reads `.sum()` after
    collect: a host's cache holds digests of that host's lanes, so the
    host block's count is the verdict that gates them."""

    def __init__(self):
        self.counts = None

    def sum(self):
        if self.counts is None:
            raise RuntimeError("rejected counts are read after collect()")
        return self.counts.sum()


class DistributedDriver(DeviceDriver):
    """DeviceDriver of one pod host (module docstring).  `n_instances`
    is the global deployment figure; the pod mesh is `mesh`, or
    `make_pod_mesh(n_val, per_host, pod_group())` over the world that
    distributed/pod.py::initialize_pod joined (a given mesh must have
    that shape: val = `n_val`, data x val = `per_host`); the host's
    instance block (`plan.instance_range(host)`) becomes `self.I`.  A
    coordinator (`coordinator=`, or the one HostShard attaches) agrees
    every dispatch unless `lockstep_check` is false."""

    def __init__(self, n_instances: int, n_validators: int,
                 n_rounds: int = 4, n_slots: int = 4,
                 proposer_is_self: bool = True,
                 advance_height: bool = False,
                 defer_collect: bool = False,
                 verify_chunk=None, hbm_budget_bytes: Optional[int] = None,
                 audit=False, n_val: int = 1, mesh=None,
                 coordinator=None, lockstep_check: bool = True,
                 per_host: int = 1, device="cuda"):
        from agnes_tpu_torch.device.encoding import resolve_device

        dev = resolve_device(device)
        if mesh is None:
            pod_mesh = make_pod_mesh(n_val, per_host, pod_group(),
                                     device_type=dev.type)
        else:
            pod_mesh = mesh
            shape = tuple(pod_mesh.shape)
            if (len(shape) != 3 or shape[2] != n_val
                    or shape[1] * shape[2] != per_host):
                raise ValueError(
                    f"mesh {shape} is not a pod mesh of val={n_val} and "
                    f"{per_host} ranks a host (parallel/mesh.py::"
                    f"make_pod_mesh)")
        n_hosts, n_data, n_v = pod_mesh.shape
        if n_validators % n_v:
            raise ValueError(f"V={n_validators} does not shard over "
                             f"val={n_v}")
        self.pod_mesh = pod_mesh
        self.n_hosts = int(n_hosts)
        self.per_host = int(n_data * n_v)
        self.process_index = dist.get_rank()
        self.host = int(pod_mesh.get_coordinate()[0])
        self.plan = HostPlan(self.n_hosts, n_instances)
        self.global_I = int(n_instances)
        self.coordinator = coordinator
        self.lockstep_check = bool(lockstep_check)
        self._reject_views: list = []
        super().__init__(self.plan.local_instances, n_validators,
                         n_rounds=n_rounds, n_slots=n_slots,
                         proposer_is_self=proposer_is_self,
                         advance_height=advance_height,
                         mesh=pod_mesh[DATA_AXIS, VAL_AXIS],
                         defer_collect=defer_collect,
                         verify_chunk=verify_chunk,
                         hbm_budget_bytes=hbm_budget_bytes, audit=audit,
                         device=dev)

    # -- lockstep ------------------------------------------------------------

    def _agree(self, entry: str, statics, args) -> None:
        """The pre-dispatch lockstep check (module docstring)."""
        if (self.coordinator is not None and self.lockstep_check
                and self.coordinator.n_processes > 1):
            self.coordinator.agree((entry, tuple(statics), plan_sig(args)))

    def _dense_dispatch_fn(self, n_dense_phases: int):
        fn = super()._dense_dispatch_fn(n_dense_phases)
        statics = (self.advance_height,
                   self._resolve_dense_chunk(n_dense_phases))

        def dispatch(st, ta, ex, ph, dn):
            self._agree("sharded_step_seq_signed", statics, (ex, ph, dn))
            return fn(st, ta, ex, ph, dn)

        return dispatch

    def _unsigned(self, phases_st, exts_st, state=None, tally=None):
        self._agree("sharded_step_seq", (self.advance_height,),
                    (exts_st, phases_st))
        return super()._unsigned(phases_st, exts_st, state, tally)

    # -- the host's read-outs ------------------------------------------------

    def step_async(self, phases, lanes=None, exts=None,
                   tick: Optional[int] = None):
        msgs = super().step_async(phases, lanes, exts, tick=tick)
        if self.last_step_rejects is not None:
            view = _HostRejects()
            self._reject_views.append(view)
            self.last_step_rejects = view
        return msgs

    def _gather_collect(self, msgs):
        msgs, rejects = super()._gather_collect(msgs)
        views, self._reject_views = self._reject_views, []
        for view, counts in zip(views, rejects):
            view.counts = counts
        return msgs, rejects

    def _local_shape(self, n_live=None):
        """(I, V) as this rank's block holds them: the host's slice over
        the data extent one host owns (`mesh_local_shape(n_hosts=)` on
        the pod mesh).  With a live membership of `n_live` hosts (the
        elastic pod) a surviving owner serves the bigger slice I *
        n_hosts / n_live over the data extent of n_hosts / n_live hosts,
        so the slice is scaled up here and mesh_local_shape's live
        divisor cancels it: the figure a rank holds does not change with
        the membership (the pod mesh never shrinks).  Passing the static
        slice with a live divisor would under-claim a rank's instances,
        and the memory bound would pass on a shape the full deployment
        does not fit."""
        from agnes_tpu_torch.utils.budget import mesh_local_shape

        live = self.n_hosts if n_live is None else int(n_live)
        if live < 1 or (self.I * self.n_hosts) % live:
            raise ValueError(
                f"{self.I * self.n_hosts} instances do not repartition "
                f"evenly over {live} live host(s)")
        return mesh_local_shape(self.pod_mesh, self.I * self.n_hosts // live,
                                self.V, n_hosts=self.n_hosts, n_live=live)

    def set_proposer_table(self, flags, rotation_period: int) -> None:
        raise NotImplementedError(
            "proposer tables on a pod driver: not wired (the serve plane "
            "uses the constant default)")

    # -- single-process surfaces ---------------------------------------------

    def _pod_only(self, what: str):
        raise NotImplementedError(
            f"{what} is a single-process surface; the pod driver serves "
            f"through step_async (module docstring)")

    def step(self, ext=None, phase=None):
        self._pod_only("step()")

    def step_seq(self, phases, exts=None):
        self._pod_only("step_seq()")

    def step_seq_signed(self, phases, lanes, exts=None):
        self._pod_only("step_seq_signed()")

    def step_seq_signed_dense(self, phases, dense, exts=None):
        self._pod_only("step_seq_signed_dense()")

    def run_heights_fused(self, n_heights: int, slot: int = 1,
                          frac: float = 1.0):
        self._pod_only("run_heights_fused()")
