"""Closed-loop driver for the fused device consensus step (twin of
`agnes_tpu.harness.device_driver.DeviceDriver`, single device).

Runs I independent consensus instances on one device, with the harness
playing the network: it fabricates the dense vote phases for the
validators according to a schedule, and collects decisions off the
message stream.

Port notes: JAX donation becomes in-place state on the driver (each
step's outputs replace `self.state` / `self.tally`); JAX's async
dispatch becomes stream order — nothing here synchronizes the device
except `_collect`, which reads each message batch back with one
`.cpu()` copy.  Waiting for later slices: `step_async` and the serve
plane, meshes, the dense signed step, verify chunking (the JAX
driver's `verify_chunk`, with its "auto" HBM planner; the step function
already takes `verify_chunk`), the retrace tripwire and the flight
recorder.
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
    ExtEvent,
    VotePhase,
    consensus_step,
    consensus_step_seq,
    consensus_step_seq_signed,
    honest_heights,
)
from agnes_tpu_torch.device.tally import TallyConfig, TallyState
from agnes_tpu_torch.types import NIL_ID, VoteType


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
    """I instances x V validators on one device (default "cuda")."""

    def __init__(self, n_instances: int, n_validators: int,
                 n_rounds: int = 4, n_slots: int = 4,
                 proposer_is_self: bool = True,
                 advance_height: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.I, self.V = n_instances, n_validators
        self.advance_height = advance_height
        self.rejected_signature_device = 0
        self._pending_rejects: list = []       # device-verify rejects
        self.cfg = TallyConfig(n_validators=n_validators, n_rounds=n_rounds,
                               n_slots=n_slots)
        self.state = DeviceState.new((self.I,), device=self.device)
        self.tally = TallyState.new(self.I, self.cfg, device=self.device)
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
            height=self.state.height)

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
            height=self.state.height)

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
        out = consensus_step(self.state, self.tally, ext, phase, self.powers,
                             self.total, self.proposer_flag,
                             self.propose_value,
                             advance_height=self.advance_height)
        self.state, self.tally = out.state, out.tally
        self.stats.steps += 1
        self.stats.votes_ingested += int(phase.mask.sum())
        self._collect(out.msgs)
        return out.msgs

    def _stack_seq(self, phases, exts):
        P = len(phases)
        exts = exts if exts is not None else [self.ext()] * P
        return stack_tuples(phases), stack_tuples(exts), P

    def step_seq(self, phases, exts=None) -> DeviceMessage:
        """P fused steps in one call (consensus_step_seq): `phases` is a
        list of VotePhase, `exts` an optional matching list."""
        phases_st, exts_st, P = self._stack_seq(phases, exts)
        out = consensus_step_seq(self.state, self.tally, exts_st, phases_st,
                                 self.powers, self.total, self.proposer_flag,
                                 self.propose_value,
                                 advance_height=self.advance_height)
        self.state, self.tally = out.state, out.tally
        self.stats.steps += P
        self.stats.votes_ingested += int(phases_st.mask.sum())
        self._collect(out.msgs)
        return out.msgs

    def step_seq_signed(self, phases, lanes, exts=None) -> DeviceMessage:
        """step_seq with signature verification fused in
        (consensus_step_seq_signed): `lanes` (SignedLanes, from
        VoteBatcher.build_phases_device) carries the packed Ed25519
        inputs whose verdicts mask the phases on the device.  Rejected
        lanes are counted into `rejected_signature_device` at collect."""
        phases_st, exts_st, P = self._stack_seq(phases, exts)
        out = consensus_step_seq_signed(
            self.state, self.tally, exts_st, phases_st, lanes, self.powers,
            self.total, self.proposer_flag, self.propose_value,
            advance_height=self.advance_height)
        self.state, self.tally = out.state, out.tally
        self.stats.steps += P
        # real lanes only; device rejects are subtracted at settle time
        self.stats.votes_ingested += int(lanes.real.sum())
        self._pending_rejects.append(out.n_rejected)
        self._collect(out.msgs)
        self._settle_rejects()
        return out.msgs

    def _settle_rejects(self) -> None:
        rejects, self._pending_rejects = self._pending_rejects, []
        for r in rejects:
            n = int(r)
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
        out = honest_heights(self.state, self.tally, slots, mask,
                             self.powers, self.total, self.proposer_flag,
                             self.propose_value, heights=n_heights)
        self.state, self.tally = out.state, out.tally
        self.stats.steps += 3 * n_heights
        self.stats.votes_ingested += 2 * n_heights * self.I * int(
            voters.sum())
        self._collect(out.msgs)

    def _collect(self, msgs: DeviceMessage) -> None:
        """Fold one message batch into the stats.  Leaves are
        [stages, I] from step(), or [P, ..., stages, I] from the
        sequences — leading axes flatten into the stage axis (step order
        is preserved, so first-decision latching is unchanged).  One
        device-to-host copy for the whole batch."""
        host = torch.stack([msgs.tag, msgs.round, msgs.value]).cpu().numpy()
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
        """Settle any pending device-verify rejected-lane counts (message
        batches are collected as each step returns)."""
        self._settle_rejects()

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
