"""Closed-loop driver for the fused device consensus step (twin of
`agnes_tpu.harness.device_driver.DeviceDriver`).

Runs I independent consensus instances on one device, or on a mesh of
devices (`mesh=`, parallel/), with the harness playing the network: it
fabricates the dense vote phases for the validators according to a
schedule, and collects decisions off the message stream.

Port notes: JAX donation becomes in-place state on the driver (each
step's outputs replace `self.state` / `self.tally`); JAX's async
dispatch becomes stream order.  The signed paths and `step_async` read
nothing back from the device: their vote and rejected-lane counts stay
device scalars until `collect()`, and message batches are read back
there (or at once by `_collect`, one `.cpu()` copy a batch, unless
collection is deferred).  The serve plane's pieces are the twin's: the
retrace tripwire (`audit=`, `_observe` on the signed and unsigned
sequence entries), the flight recorder (`flightrec`, a `dispatch` event
per `step_async`, stamped with the serve tick) and `step_async`'s
`tick`.  The twin's `donate` is left out: a torch step already returns
fresh tensors, and nothing is copied that donation would save.

On a mesh (one process per device, parallel/mesh.py) every rank is
called with the same global arguments, as the twin's single controller
is, and computes only its block: `self.state` / `self.tally` are the
rank's blocks, and each dispatch cuts the rank's block out of its
global phases, events and lanes (parallel/sharded.py's layout table).
The tally's all_reduces over the mesh's `val` group are the only
collectives inside a step.  The read-outs (`collect` and the stats,
`all_decided`, `rejected_signature_device`, `equivocators_detected`,
`state_copies`, `window`) give the global answer on every rank, through
one all_gather at each call, outside the step.  A phase's `height` is read
at the rank's own block only, so `empty_phase` and `phase` fill that
block from the rank's state.  The packed-lane signed layout is one
device's, as in the twin: on a mesh use the dense layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from agnes_tpu_torch.core.state_machine import EventTag, MsgTag
from agnes_tpu_torch.device.encoding import (
    I32,
    DeviceMessage,
    DeviceState,
    resolve_device,
    stack_tuples,
)
from agnes_tpu_torch.device.step import (
    NULL_EVENT,
    DenseSignedPhases,
    ExtEvent,
    SignedLanes,
    VotePhase,
    consensus_step,
    consensus_step_seq,
    consensus_step_seq_signed,
    consensus_step_seq_signed_dense,
    honest_heights,
)
from agnes_tpu_torch.device.tally import TallyConfig, TallyState
from agnes_tpu_torch.types import NIL_ID, VoteType
from agnes_tpu_torch.utils.budget import (
    device_hbm_bytes,
    mesh_local_shape,
    plan_dense_verify,
    plan_lane_verify,
)


@dataclass
class DriverStats:
    votes_ingested: int = 0
    steps: int = 0
    decisions_total: int = 0                  # across heights
    decided: Optional[np.ndarray] = None      # [I] bool
    decision_value: Optional[np.ndarray] = None
    decision_round: Optional[np.ndarray] = None


def _int32_total(powers: np.ndarray) -> int:
    """The total voting power of a table, refused (ValueError) unless
    every power and the total fit the device's int32 leaves."""
    pw = np.asarray(powers).astype(np.int64)
    total = int(pw.sum())
    if (pw < 0).any() or (pw >= 2**31).any() or total >= 2**31:
        raise ValueError(f"voting powers must be non-negative with a total "
                         f"below 2^31 (int32 tally); total {total}")
    return total


class DeviceDriver:
    """I instances x V validators on one device (default "cuda"), or on
    a mesh (module docstring)."""

    def __init__(self, n_instances: int, n_validators: int,
                 n_rounds: int = 4, n_slots: int = 4,
                 proposer_is_self: bool = True,
                 advance_height: bool = False,
                 mesh=None, defer_collect: bool = False,
                 verify_chunk=None, hbm_budget_bytes: Optional[int] = None,
                 audit=False, device="cuda"):
        """`mesh` (parallel/mesh.py, a flat data x val or hierarchical
        slice x data x val DeviceMesh over this process's world) runs
        the sharded steps, this rank holding its block (module
        docstring); `device` must be of the mesh's device type.

        `defer_collect`: steps return without reading anything back;
        `collect()` (or `block_until_ready`) folds the queued message
        batches and counts into the stats.

        `verify_chunk` bounds the fused signed verify's memory peak
        (`utils/budget.py`): None verifies every lane in one call; an
        int streams that many instance rows per microbatch (rows x V
        lanes on the packed-lane path; on the dense path rows of the
        rank's own block, Ps x V lanes each); "auto" sizes the tile
        from the card's memory (`hbm_budget_bytes` overrides it, and a
        CPU driver must give it), on a mesh for the rank's block.
        Chunked and unchunked runs agree lane for lane.

        `audit=True` (or a ready RetraceSentinel) installs the retrace
        tripwire (analysis/retrace.py) on the sequence entries: each
        dispatch's (entry, signature) is observed, and once
        `ServePipeline.warmup()` arms the sentinel an unwarmed one
        raises RetraceError."""
        self.device = resolve_device(device)
        if audit:
            from agnes_tpu_torch.analysis.retrace import RetraceSentinel

            self.sentinel = (audit if isinstance(audit, RetraceSentinel)
                             else RetraceSentinel())
        else:
            self.sentinel = None
        # optional utils/flightrec.FlightRecorder: every step_async
        # dispatch and retrace trip leaves an event in its ring
        self.flightrec = None
        self.I, self.V = n_instances, n_validators
        self.advance_height = advance_height
        self.defer_collect = defer_collect
        self.verify_chunk = verify_chunk
        self.hbm_budget_bytes = hbm_budget_bytes
        self._lane_plans: dict = {}            # lanes -> VerifyPlan
        self._dense_plans: dict = {}           # (Ps, local I, V) -> plan
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"a {mesh.device_type} mesh needs a driver on "
                    f"{mesh.device_type}, not {self.device}")
            from agnes_tpu_torch.parallel import sharded

            self._sh = sharded
            self._sharded: dict = {}           # (entry, statics) -> fn
        self._deferred_msgs: list = []
        # device scalars settled at collect: votes of the signed and
        # async dispatches, and their device-verify rejects
        self._pending_votes: list = []
        self._pending_rejects: list = []
        self.rejected_signature_device = 0
        # the last step_async dispatch's rejected-lane count (a device
        # scalar; None for an unsigned dispatch)
        self.last_step_rejects = None
        self.cfg = TallyConfig(n_validators=n_validators, n_rounds=n_rounds,
                               n_slots=n_slots)
        self.state = DeviceState.new((self.I,), device=self.device)
        self.tally = TallyState.new(self.I, self.cfg, device=self.device)
        if mesh is not None:
            self.state, self.tally = self._sh.place_step_state(
                mesh, self.state, self.tally)
        self.powers = torch.ones((self.V,), dtype=I32, device=self.device)
        self.total = torch.tensor(_int32_total(np.ones(self.V, np.int64)),
                                  dtype=I32, device=self.device)
        # every instance's node proposes every round by default
        self.proposer_flag = torch.full((self.I, n_rounds),
                                        bool(proposer_is_self),
                                        dtype=torch.bool, device=self.device)
        self.propose_value = torch.full((self.I,), 1, dtype=I32,
                                        device=self.device)
        self.stats = DriverStats(
            decided=np.zeros(self.I, bool),
            decision_value=np.full(self.I, NIL_ID, np.int32),
            decision_round=np.full(self.I, -1, np.int32))

    def set_validators(self, powers) -> None:
        """Validator-set epoch at a height boundary: re-upload the
        voting-power table the quorum math uses (shape [V] is fixed).
        A table whose total does not fit int32 raises ValueError."""
        pw = np.asarray(powers)
        if pw.shape != (self.V,):
            raise ValueError(f"powers must be [{self.V}], got {pw.shape}")
        total = _int32_total(pw)
        self.powers = torch.tensor(pw, dtype=I32, device=self.device)
        self.total = torch.tensor(total, dtype=I32, device=self.device)

    def set_proposer_table(self, flags, rotation_period: int) -> None:
        """Install a round-varying [I, R] proposer table.  The device
        indexes it round % R, which is exact only when R is a multiple
        of the rotation period (weighted round-robin repeats every
        total_power rounds); a table that varies over rounds and breaks
        that raises ValueError."""
        f = torch.as_tensor(flags, dtype=torch.bool)
        if not bool((f == f[:, :1]).all()) \
                and f.shape[1] % rotation_period != 0:
            raise ValueError(
                f"proposer table covers {f.shape[1]} rounds; must be a "
                f"multiple of the rotation period {rotation_period}")
        self.proposer_flag = f.to(self.device)

    # -- verify chunk planning -----------------------------------------------

    def _resolve_lane_chunk(self, n_lanes: int) -> Optional[int]:
        """Lanes per verify microbatch for the packed-lane signed path,
        or None for one call.  An int knob is instance rows (rows x V
        lanes); <= 0 rows, or a chunk covering the batch, is the
        unchunked call.  "auto" plans once per lane count."""
        if self.verify_chunk is None or n_lanes == 0:
            return None
        if self.verify_chunk != "auto":
            rows = int(self.verify_chunk)
            if rows <= 0:
                return None
            c = rows * self.V
            return None if c >= n_lanes else c
        if n_lanes not in self._lane_plans:
            hbm = (self.hbm_budget_bytes if self.hbm_budget_bytes is not None
                   else device_hbm_bytes(self.device))
            self._lane_plans[n_lanes] = plan_lane_verify(n_lanes,
                                                         hbm_bytes=hbm)
        plan = self._lane_plans[n_lanes]
        return plan.tile if plan.chunked else None

    def _local_shape(self):
        """(I, V) as this rank's block holds them (the whole shape on one
        device): the shape the dense chunk plan bounds."""
        return mesh_local_shape(self.mesh, self.I, self.V)

    def _resolve_dense_chunk(self, n_phases: int) -> Optional[int]:
        """Instance rows (of the rank's block) per verify launch for the
        dense signed path, or None for one call.  An int knob of <= 0
        rows, or one covering the block, is the unchunked call; "auto"
        plans once per (Ps, local shape) with `plan_dense_verify`."""
        if self.verify_chunk is None:
            return None
        local_i, local_v = self._local_shape()
        if self.verify_chunk != "auto":
            c = int(self.verify_chunk)
            return None if c <= 0 or c >= local_i else c
        key = (n_phases, local_i, local_v)
        if key not in self._dense_plans:
            hbm = (self.hbm_budget_bytes if self.hbm_budget_bytes is not None
                   else device_hbm_bytes(self.device))
            self._dense_plans[key] = plan_dense_verify(
                n_phases, local_i, local_v, hbm_bytes=hbm)
        plan = self._dense_plans[key]
        return plan.tile if plan.chunked else None

    # -- the mesh --------------------------------------------------------------

    def _block(self, tree, spec):
        """This rank's block of a global argument (a view)."""
        return self._sh.shard_tree(self.mesh, tree, spec)

    def _common_blocks(self):
        """This rank's blocks of (powers, total, proposer_flag,
        propose_value)."""
        args = (self.powers, self.total, self.proposer_flag,
                self.propose_value)
        return tuple(self._block(x, sp) for x, sp in
                     zip(args, self._sh.step_specs()[4:]))

    def _sharded_fn(self, make, **statics):
        """The sharded entry `make(mesh, **statics)`, made once."""
        key = (make.__name__,) + tuple(sorted(statics.items()))
        if key not in self._sharded:
            self._sharded[key] = make(self.mesh, **statics)
        return self._sharded[key]

    def _heights(self) -> torch.Tensor:
        """A phase's [I] height leaf: the state's; on a mesh a global
        tensor whose own block holds this rank's heights (the only block
        a rank reads)."""
        if self.mesh is None:
            return self.state.height
        h = torch.zeros((self.I,), dtype=I32, device=self.device)
        self._block(h, (self._sh.DATA,)).copy_(self.state.height)
        return h

    # -- retrace tripwire ----------------------------------------------------

    def _observe(self, entry: str, args, statics=()) -> None:
        """Feed one dispatch's (entry, signature) to the sentinel when
        auditing: unarmed it learns the expected set; armed, a signature
        outside it raises and counts `retrace_unexpected` (and leaves a
        flight-recorder event first)."""
        if self.sentinel is not None:
            from agnes_tpu_torch.analysis.retrace import signature

            try:
                self.sentinel.observe(entry, signature(args, statics))
            except Exception:
                if self.flightrec is not None:
                    self.flightrec.event("retrace_unexpected",
                                         entry=entry)
                raise

    # -- phase builders ------------------------------------------------------

    def _full(self, shape, value: int, dtype=I32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def empty_phase(self) -> VotePhase:
        return VotePhase(
            round=self._full((self.I,), 0),
            typ=self._full((self.I,), 0),
            slots=self._full((self.I, self.V), NIL_ID),
            mask=torch.zeros((self.I, self.V), dtype=torch.bool,
                             device=self.device),
            height=self._heights())

    def phase(self, round: int, typ: VoteType, slot: int,
              frac: float = 1.0, offset: int = 0) -> VotePhase:
        """Validators [offset, offset + frac*V) vote `slot` (NIL_ID for
        nil) in `round` for class `typ` — same for every instance."""
        k = round_half_up(frac * self.V)
        idx = torch.arange(self.V, dtype=I32, device=self.device)
        voters = (idx >= offset) & (idx < offset + k)
        slots = torch.where(voters, slot, NIL_ID).to(I32)
        return VotePhase(
            round=self._full((self.I,), round),
            typ=self._full((self.I,), int(typ)),
            slots=slots[None, :].expand(self.I, self.V).contiguous(),
            mask=voters[None, :].expand(self.I, self.V).contiguous(),
            height=self._heights())

    def ext(self, tag: int = NULL_EVENT, round: int = 0, value: int = NIL_ID,
            pol_round: int = -1) -> ExtEvent:
        return ExtEvent(
            tag=self._full((self.I,), tag),
            round=self._full((self.I,), round),
            value=self._full((self.I,), value),
            pol_round=self._full((self.I,), pol_round))

    # -- stepping ------------------------------------------------------------

    def step(self, ext: Optional[ExtEvent] = None,
             phase: Optional[VotePhase] = None) -> DeviceMessage:
        """One fused step; returns the stacked DeviceMessage batch."""
        ext = ext if ext is not None else self.ext()
        phase = phase if phase is not None else self.empty_phase()
        if self.mesh is not None:
            s = self._sh.step_specs()
            fn = self._sharded_fn(self._sh.make_sharded_step,
                                  advance_height=self.advance_height)
            out = fn(self.state, self.tally, self._block(ext, s[2]),
                     self._block(phase, s[3]), *self._common_blocks())
        else:
            out = consensus_step(self.state, self.tally, ext, phase,
                                 self.powers, self.total,
                                 self.proposer_flag, self.propose_value,
                                 advance_height=self.advance_height)
        return self._finish_step(out, 1, int(phase.mask.sum()))

    def _stack_seq(self, phases, exts):
        P = len(phases)
        exts = exts if exts is not None else [self.ext()] * P
        return stack_tuples(phases), stack_tuples(exts), P

    def step_seq(self, phases, exts=None) -> DeviceMessage:
        """P fused steps in one call (consensus_step_seq): `phases` is a
        list of VotePhase, `exts` an optional matching list."""
        phases_st, exts_st, P = self._stack_seq(phases, exts)
        out = self._unsigned(phases_st, exts_st)
        return self._finish_step(out, P, int(phases_st.mask.sum()))

    def _unsigned(self, phases_st, exts_st, state=None, tally=None):
        """The plain sequence entry on the live state, or on the given
        state copies (warmup)."""
        args = (self.state if state is None else state,
                self.tally if tally is None else tally, exts_st, phases_st,
                self.powers, self.total, self.proposer_flag,
                self.propose_value)
        if self.mesh is not None:
            self._observe("sharded_step_seq", args, (self.advance_height,))
            s = self._sh.seq_specs()
            fn = self._sharded_fn(self._sh.make_sharded_step_seq,
                                  advance_height=self.advance_height)
            return fn(args[0], args[1], self._block(exts_st, s[2]),
                      self._block(phases_st, s[3]), *self._common_blocks())
        self._observe("consensus_step_seq", args, (self.advance_height,))
        return consensus_step_seq(*args, advance_height=self.advance_height)

    def _signed(self, phases_st, exts_st, lanes: SignedLanes, state=None,
                tally=None):
        """The fused signed sequence entry (see `_unsigned`).  The
        tripwire keys the lanes on their ladder rung (analysis/
        retrace.py); the verify tile follows from the lane count."""
        n_lanes = int(lanes.pub.shape[0])
        chunk = self._resolve_lane_chunk(n_lanes)
        args = (self.state if state is None else state,
                self.tally if tally is None else tally, exts_st, phases_st,
                lanes, self.powers, self.total, self.proposer_flag,
                self.propose_value)
        if self.sentinel is not None:
            from agnes_tpu_torch.analysis.retrace import lane_signature

            self._observe("consensus_step_seq_signed",
                          args[:4] + args[5:],
                          (self.advance_height, lane_signature(
                              lanes, self.sentinel.lane_key(n_lanes))))
        return consensus_step_seq_signed(
            *args, advance_height=self.advance_height, verify_chunk=chunk)

    def step_seq_signed(self, phases, lanes, exts=None) -> DeviceMessage:
        """step_seq with signature verification fused in
        (consensus_step_seq_signed): `lanes` (SignedLanes, from
        VoteBatcher.build_phases_device) carries the packed Ed25519
        inputs whose verdicts mask the phases on the device, in
        microbatches as `verify_chunk` sets.  Votes count real lanes
        less the device's rejects, into `votes_ingested` and
        `rejected_signature_device` at collect (at once unless
        collection is deferred).  The packed-lane layout is one
        device's: a mesh driver raises NotImplementedError (use
        step_seq_signed_dense)."""
        self._refuse_lanes_on_mesh()
        phases_st, exts_st, P = self._stack_seq(phases, exts)
        out = self._signed(phases_st, exts_st, lanes)
        return self._finish_step(out, P, lanes.real.sum(), out.n_rejected)

    def _refuse_lanes_on_mesh(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "the packed-lane signed step is single-device; on a mesh "
                "use step_seq_signed_dense (+ VoteBatcher."
                "build_phases_device_dense), which shards the lanes with "
                "the phases")

    def _dense_dispatch_fn(self, n_dense_phases: int):
        """The dense fused signed entry for a Ps-class dense batch, as
        f(state, tally, exts_st, phases_st, dense): sharded on a mesh
        (state and tally the rank's blocks, the rest global), one device
        otherwise, at the verify tile `_resolve_dense_chunk` gives.  The
        serve pipeline's dense dispatch and warmup go through it too."""
        chunk = self._resolve_dense_chunk(n_dense_phases)
        statics = (self.advance_height, chunk)
        if self.mesh is not None:
            s = self._sh.seq_specs()
            fn = self._sharded_fn(self._sh.make_sharded_step_seq_signed,
                                  advance_height=self.advance_height,
                                  verify_chunk=chunk)

            def dispatch(st, ta, ex, ph, dn):
                self._observe("sharded_step_seq_signed",
                              (st, ta, ex, ph, dn, self.powers, self.total,
                               self.proposer_flag, self.propose_value),
                              statics)
                return fn(st, ta, self._block(ex, s[2]),
                          self._block(ph, s[3]),
                          self._block(dn, self._sh.dense_lane_specs()),
                          *self._common_blocks())

            return dispatch

        def dispatch(st, ta, ex, ph, dn):
            args = (st, ta, ex, ph, dn, self.powers, self.total,
                    self.proposer_flag, self.propose_value)
            self._observe("consensus_step_seq_signed_dense", args, statics)
            return consensus_step_seq_signed_dense(
                *args, advance_height=self.advance_height,
                verify_chunk=chunk)

        return dispatch

    def step_seq_signed_dense(self, phases, dense: DenseSignedPhases,
                              exts=None) -> DeviceMessage:
        """Fused verify + step with dense per-cell lanes
        (consensus_step_seq_signed_dense), on one device or a mesh (each
        rank verifying its own cells; the tile loop adds no
        collective).  `dense` aligns with the last len(dense.sig)
        phases of `phases` (leading phases, such as the entry phase,
        carry no lanes); build both with VoteBatcher.
        build_phases_device_dense.  Votes count the phases' masks less
        the device's rejects, settled at collect."""
        phases_st, exts_st, P = self._stack_seq(phases, exts)
        out = self._dense_dispatch_fn(int(dense.sig.shape[0]))(
            self.state, self.tally, exts_st, phases_st, dense)
        return self._finish_step(out, P, phases_st.mask.sum(),
                                 out.n_rejected)

    def step_async(self, phases, lanes=None, exts=None,
                   tick: Optional[int] = None) -> DeviceMessage:
        """The serve plane's dispatch entry: queue a fused step sequence
        and return without reading anything back, so the host densifies
        the next batch while the card runs this one.  Collection is
        always deferred, whatever `defer_collect` says: call collect()
        or block_until_ready() when the stats are needed.

        `lanes` selects the path: SignedLanes runs the packed-lane fused
        signed step (one device only: a mesh driver raises
        NotImplementedError, as the twin does); DenseSignedPhases runs
        the dense fused signed step, on one device or sharded on the
        mesh; None runs the plain sequence (host-verified or unsigned
        phases), sharded on a mesh.  `tick` is the serve plane's tick
        id: it stamps the flight recorder's `dispatch` event, which
        carries the step count and the lane count (the vote count is a
        device scalar until collect)."""
        phases_st, exts_st, P = self._stack_seq(phases, exts)
        if lanes is None:
            out = self._unsigned(phases_st, exts_st)
            n_votes, n_rejected, n_lanes = phases_st.mask.sum(), None, None
            entry = "consensus_step_seq"
        elif isinstance(lanes, DenseSignedPhases):
            out = self._dense_dispatch_fn(int(lanes.sig.shape[0]))(
                self.state, self.tally, exts_st, phases_st, lanes)
            n_votes, n_rejected = phases_st.mask.sum(), out.n_rejected
            n_lanes = int(lanes.sig.shape[0]) * self.I * self.V
            entry = "consensus_step_seq_signed_dense"
        elif isinstance(lanes, SignedLanes):
            self._refuse_lanes_on_mesh()
            out = self._signed(phases_st, exts_st, lanes)
            n_votes, n_rejected = lanes.real.sum(), out.n_rejected
            n_lanes = int(lanes.pub.shape[0])
            entry = "consensus_step_seq_signed"
        else:
            raise TypeError(f"step_async takes SignedLanes, "
                            f"DenseSignedPhases or None, not "
                            f"{type(lanes).__name__}")
        self.last_step_rejects = n_rejected
        if self.flightrec is not None:
            self.flightrec.event("dispatch", tick=tick, phases=P,
                                 lanes=n_lanes, entry=entry)
        return self._finish_step(out, P, n_votes, n_rejected,
                                 force_defer=True)

    def _finish_step(self, out, P: int, n_votes, n_rejected=None,
                     force_defer: bool = False) -> DeviceMessage:
        """The bookkeeping tail of every dispatch: state/tally swap,
        stats, message collection.  `n_votes` is an int or a device
        scalar; device scalars and `n_rejected` are settled at collect
        (`force_defer` is step_async's always-deferred contract)."""
        self.state, self.tally = out.state, out.tally
        self.stats.steps += P
        if isinstance(n_votes, torch.Tensor):
            self._pending_votes.append(n_votes)
        else:
            self.stats.votes_ingested += n_votes
        if n_rejected is not None:
            self._pending_rejects.append(n_rejected)
        self._deferred_msgs.append(out.msgs)
        if not (self.defer_collect or force_defer):
            self.collect()
        return out.msgs

    def _settle_counts(self, rejects=None) -> None:
        """Fold the pending device counts into the stats: votes in,
        device-verify rejects out (a scalar from the lane path, [I] from
        the dense path; one device read each).  `rejects` replaces the
        pending list (a mesh's gathered global counts)."""
        votes, self._pending_votes = self._pending_votes, []
        if rejects is None:
            rejects, self._pending_rejects = self._pending_rejects, []
        for v in votes:
            self.stats.votes_ingested += int(v)
        for r in rejects:
            n = int(r.sum())
            self.rejected_signature_device += n
            self.stats.votes_ingested -= n

    def run_heights_fused(self, n_heights: int, slot: int = 1,
                          frac: float = 1.0) -> None:
        """`n_heights` consecutive honest heights (honest_heights: every
        phase takes its round/height from the carried state)."""
        if not self.advance_height:
            raise ValueError("construct with advance_height=True")
        voters = (torch.arange(self.V, device=self.device)
                  < round_half_up(frac * self.V))
        slots = torch.where(voters, slot, -1).to(I32)[None, :] \
            .expand(self.I, self.V).contiguous()
        mask = voters[None, :].expand(self.I, self.V).contiguous()
        if self.mesh is not None:
            sp = self._sh.honest_specs()
            fn = self._sharded_fn(self._sh.make_sharded_honest_heights,
                                  heights=n_heights)
            out = fn(self.state, self.tally, self._block(slots, sp[2]),
                     self._block(mask, sp[3]), *self._common_blocks())
        else:
            out = honest_heights(self.state, self.tally, slots, mask,
                                 self.powers, self.total,
                                 self.proposer_flag, self.propose_value,
                                 heights=n_heights)
        self._finish_step(out, 3 * n_heights, 2 * n_heights * self.I * int(
            voters.sum()))

    def _collect(self, msgs: DeviceMessage) -> None:
        """Fold one message batch into the stats.  Leaves are
        [stages, I] from step(), or [P, ..., stages, I] from the
        sequences — leading axes flatten into the stage axis (step order
        is preserved, so first-decision latching is unchanged).  One
        device-to-host copy for the whole batch."""
        host = torch.stack([msgs.tag, msgs.round, msgs.value]).cpu().numpy()
        if host.shape[-1] != self.I:
            raise ValueError("a mesh rank's message block: gather first")
        n_stages = msgs.tag.shape[-2]
        tags = host[0].reshape(-1, self.I)
        dec = tags == int(MsgTag.DECISION)
        # an instance commits at most once per step
        if not (dec.reshape(-1, n_stages, self.I).sum(axis=1) <= 1).all():
            raise AssertionError(
                "multiple DECISION stages for one instance in one step")
        self.stats.decisions_total += int(dec.sum())
        if dec.any():
            decided_now = dec.any(axis=0)
            stage = dec.argmax(0)
            rows = np.arange(self.I)
            val = host[2].reshape(-1, self.I)[stage, rows]
            rnd = host[1].reshape(-1, self.I)[stage, rows]
            new = decided_now & ~self.stats.decided
            self.stats.decision_value[new] = val[new]
            self.stats.decision_round[new] = rnd[new]
            self.stats.decided |= decided_now

    def collect(self) -> None:
        """Drain deferred message batches into the stats (in step order:
        decision latching is order-sensitive), and settle the pending
        vote and rejected-lane counts."""
        msgs, self._deferred_msgs = self._deferred_msgs, []
        rejects = None
        if self.mesh is not None:
            msgs, rejects = self._gather_collect(msgs)
        for m in msgs:
            self._collect(m)
        self._settle_counts(rejects)

    def _gather_collect(self, msgs):
        """A mesh's collect: every queued message batch's (tag, round,
        value) and every pending rejected count, global, in one
        all_gather."""
        rejects, self._pending_rejects = self._pending_rejects, []
        leaves = [x for m in msgs for x in (m.tag, m.round, m.value)]
        specs = [self._sh.msgs_spec(x.ndim) for x in leaves]
        specs += [(self._sh.DATA,)] * len(rejects)
        if not specs:
            return [], []
        g = self._sh.gather_tree(self.mesh, leaves + rejects, specs)
        out = [DeviceMessage(*g[k:k + 3], aux=None)
               for k in range(0, len(leaves), 3)]
        return out, g[len(leaves):]

    def block_until_ready(self) -> "DeviceDriver":
        """collect(), then wait for the driver's device."""
        self.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def window(self):
        """(base_round, heights), [I] int64 numpy each: one read of the
        card (it waits for the step in flight); on a mesh gathered from
        every rank's block."""
        leaves = [self.tally.base_round, self.state.height]
        if self.mesh is not None:
            leaves = self._sh.gather_tree(self.mesh, leaves,
                                          [(self._sh.DATA,)] * 2)
        return tuple(x.cpu().numpy().astype(np.int64) for x in leaves)

    def equivocators_detected(self) -> np.ndarray:
        """[I] count of flagged validators per instance."""
        equiv = self.tally.equiv
        if self.mesh is not None:
            equiv = self._sh.gather_tree(self.mesh, [equiv],
                                         [self._sh.step_specs()[1].equiv])[0]
        return equiv.sum(dim=1).cpu().numpy()

    def state_copies(self):
        """Independent (state, tally) copies, e.g. for warmup dispatches
        that must not touch the live state: clones, or on a mesh the
        global state gathered from every rank's block."""
        if self.mesh is not None:
            return self._sh.gather_state(self.mesh, self.state, self.tally)
        return (DeviceState(*[t.clone() for t in self.state]),
                TallyState(*[t.clone() for t in self.tally]))

    def all_decided(self, value: Optional[int] = None) -> bool:
        self.collect()
        if not bool(self.stats.decided.all()):
            return False
        if value is not None:
            return bool((self.stats.decision_value == value).all())
        return True

    # -- canned scenarios ----------------------------------------------------

    def run_honest_round(self, round: int = 0, slot: int = 1) -> None:
        """Drive one honest round to decision (round entry + self
        proposal, then full prevote and precommit phases)."""
        self.step()
        self.step(phase=self.phase(round, VoteType.PREVOTE, slot))
        self.step(phase=self.phase(round, VoteType.PRECOMMIT, slot))

    def run_heights(self, n_heights: int, slot: int = 1) -> None:
        """Drive every instance through `n_heights` consecutive honest
        heights, one run_honest_round each (advance_height=True: the
        device installs the next height after each decision)."""
        if not self.advance_height:
            raise ValueError("construct with advance_height=True")
        for _ in range(n_heights):
            self.run_honest_round(0, slot)

    def run_nil_round(self, round: int = 0) -> None:
        """Round that times out (build with proposer_is_self=False)."""
        self.step()
        self.step(ext=self.ext(int(EventTag.TIMEOUT_PROPOSE), round))
        self.step(phase=self.phase(round, VoteType.PREVOTE, NIL_ID))
        self.step(phase=self.phase(round, VoteType.PRECOMMIT, NIL_ID))
        self.step(ext=self.ext(int(EventTag.TIMEOUT_PRECOMMIT), round))

    def run_proposed_round(self, round: int = 0, slot: int = 1,
                           pol_round: int = -1) -> None:
        """Non-proposer instances receive a complete proposal and the
        full honest vote phases for it."""
        self.step()
        self.step(ext=self.ext(int(EventTag.PROPOSAL), round, slot,
                               pol_round))
        self.step(phase=self.phase(round, VoteType.PREVOTE, slot))
        self.step(phase=self.phase(round, VoteType.PRECOMMIT, slot))

    def run_equivocation_phase(self, round: int, typ: VoteType,
                               slot_a: int, slot_b: int,
                               frac: float = 1.0) -> int:
        """A fraction of validators vote slot_a then conflictingly
        slot_b for the same (round, class); returns the expected number
        of newly flagged equivocators per instance."""
        self.step(phase=self.phase(round, typ, slot_a, frac))
        self.step(phase=self.phase(round, typ, slot_b, frac))
        return round_half_up(frac * self.V)


def round_half_up(x: float) -> int:
    return int(np.floor(x + 0.5))
