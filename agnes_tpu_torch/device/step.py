"""The fused per-instance consensus step (twin of `agnes_tpu.device.step`).

One `consensus_step` advances a batch of I independent consensus
instances through one delivery phase as a fixed pipeline of seven
branch-free stages, each an application of the batched state machine:

  0. external event   1. vote ingestion   2. round skip
  3./4. re-query prevote / precommit thresholds
  5. round entry      6. self-proposal    (7. window rotation,
  8. optional height advance)

See the JAX twin's module docstring for the reference anchors.  Port
notes: `lax.scan` over phases / heights is a Python loop (P <= 3 on the
main path); JAX's donation becomes fresh tensors the driver swaps in;
and the signed step's drop-mode scatter of verdicts is an explicit mask
of out-of-range (padding) lanes before `index_put_`, which has no drop
mode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from agnes_tpu_torch.core.state_machine import EventTag, MsgTag, Step
from agnes_tpu_torch.crypto import ed25519
from agnes_tpu_torch.device.encoding import (
    I32,
    DeviceEvent,
    DeviceMessage,
    DeviceState,
    stack_tuples,
)
from agnes_tpu_torch.device.state_machine import apply_batch
from agnes_tpu_torch.device.tally import (
    NO_EVENT,
    NOT_VOTED,
    TH_INIT,
    TallyState,
    add_votes,
    current_threshold,
    event_of,
    psum,
    rotate_window,
)
from agnes_tpu_torch.types import NIL_ID, VoteType

# "no event" tag: matches no transition arm -> guaranteed no-op
NULL_EVENT = NO_EVENT
N_STAGES = 7


class VotePhase(NamedTuple):
    """One dense delivery phase.  `height` fences ingestion: a replayed
    phase of height-h votes must not tally into h+1."""

    round: torch.Tensor   # [I] int32
    typ: torch.Tensor     # [I] int32
    slots: torch.Tensor   # [I, V] int32
    mask: torch.Tensor    # [I, V] bool
    height: torch.Tensor  # [I] int32


class ExtEvent(NamedTuple):
    """Harness-injected events (tag NULL_EVENT = none)."""

    tag: torch.Tensor        # [I]
    round: torch.Tensor      # [I]
    value: torch.Tensor      # [I]
    pol_round: torch.Tensor  # [I]

    @classmethod
    def none(cls, n: int, device="cuda") -> "ExtEvent":
        z = torch.zeros((n,), dtype=I32, device=device)
        return cls(torch.full_like(z, NULL_EVENT), z, z, z - 1)


class StepOutputs(NamedTuple):
    state: DeviceState
    tally: TallyState
    msgs: DeviceMessage  # [n_stages, I] leaves (seq: [P, n_stages, I])


def consensus_step(state: DeviceState,
                   tally: TallyState,
                   ext: ExtEvent,
                   phase: VotePhase,
                   powers: torch.Tensor,         # [V]
                   total_power: torch.Tensor,    # scalar
                   proposer_flag: torch.Tensor,  # [I, R] this node proposes (h,r)
                   propose_value: torch.Tensor,  # [I] fresh value to propose
                   advance_height: bool = False,  # stage 8 on/off
                   group=None,  # validator ProcessGroup (all_reduce)
                   ) -> StepOutputs:
    msgs = []

    def apply_ev(st, tag, round_, value, pol):
        ev = DeviceEvent(tag.to(I32), round_.to(I32), value.to(I32),
                         pol.to(I32))
        st, m = apply_batch(st, ev)
        msgs.append(m)
        return st

    def null_like(t):
        return torch.full_like(t, NULL_EVENT)

    # --- 0. external event
    state = apply_ev(state, ext.tag, ext.round, ext.value, ext.pol_round)

    # --- 1. vote ingestion (height-fenced: stale-height phases no-op)
    height_ok = phase.height == state.height
    tally, tev = add_votes(tally, powers, total_power, phase.round, phase.typ,
                           phase.slots, phase.mask & height_ok[:, None],
                           state.round, group=group)
    neg1 = torch.full_like(tev.tag, -1)
    # precommit-class events are consumed on first in-round delivery
    # (their arms are step-independent, state_machine.rs:208,:211)
    is_pc_ev = ((tev.tag == int(EventTag.PRECOMMIT_ANY))
                | (tev.tag == int(EventTag.PRECOMMIT_VALUE)))
    consumed = is_pc_ev & ((tev.round == state.round)
                           | (tev.tag == int(EventTag.PRECOMMIT_VALUE)))
    W_t = tally.pc_done.shape[1]
    w_range = torch.arange(W_t, dtype=I32, device=state.round.device)
    ev_widx = tev.round - tally.base_round        # window row of the event
    pc_hit = (w_range[None, :] == ev_widx[:, None]) & consumed[:, None]
    tally = tally._replace(pc_done=tally.pc_done | pc_hit)
    state = apply_ev(state, tev.tag, tev.round, tev.value_slot, neg1)

    # --- 2. round skip
    skip_tag = torch.where(tev.skip_round >= 0,
                           torch.full_like(neg1, int(EventTag.ROUND_SKIP)),
                           null_like(neg1))
    state = apply_ev(state, skip_tag, tev.skip_round,
                     torch.full_like(skip_tag, NIL_ID), neg1)

    # --- 3./4. re-query current-round thresholds (prevote then
    # precommit), at most once per state-machine (round, step)
    for typ_code in (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT)):
        typ_arr = torch.full_like(state.round, typ_code)
        code, vslot = current_threshold(tally, state.round, typ_arr,
                                        total_power)
        moved = (state.round != tally.q_round) | (state.step != tally.q_step)
        tag = torch.where(moved, event_of(typ_arr, code), null_like(code))
        # suppress re-delivery of the event stage 1 just delivered for
        # the same round (same-call duplicate, cursor not yet advanced)
        tag = torch.where((tag == tev.tag) & (state.round == tev.round),
                          null_like(tag), tag)
        if typ_code == int(VoteType.PRECOMMIT):
            cur_widx = state.round - tally.base_round
            round_c_t = torch.clamp(cur_widx, 0, W_t - 1).long()
            done = torch.gather(tally.pc_done, 1, round_c_t[:, None])[:, 0]
            tag = torch.where(done, null_like(tag), tag)
            fired = ((tag != NULL_EVENT) & (cur_widx >= 0)
                     & (cur_widx < W_t))
            pc_hit = ((w_range[None, :] == cur_widx[:, None])
                      & fired[:, None])
            tally = tally._replace(pc_done=tally.pc_done | pc_hit)
        state = apply_ev(state, tag, state.round, vslot, neg1)
    tally = tally._replace(q_round=state.round, q_step=state.step)

    # --- 5. round entry.  proposer_flag[i, r % R] = "this node proposes
    # round r of instance i" (exact for all rounds, see the JAX twin)
    R = proposer_flag.shape[1]
    round_c = torch.remainder(state.round, R).long()
    is_prop = torch.gather(proposer_flag, 1, round_c[:, None])[:, 0]
    at_new_round = state.step == int(Step.NEW_ROUND)
    entry_tag = torch.where(
        at_new_round,
        torch.where(is_prop,
                    torch.full_like(neg1, int(EventTag.NEW_ROUND_PROPOSER)),
                    torch.full_like(neg1, int(EventTag.NEW_ROUND))),
        null_like(neg1))
    state = apply_ev(state, entry_tag, state.round, propose_value, neg1)

    # --- 6. self-proposal: the proposer processes its own proposal
    prop_msg = msgs[-1]
    was_proposal = prop_msg.tag == int(MsgTag.PROPOSAL)
    self_tag = torch.where(was_proposal,
                           torch.full_like(neg1, int(EventTag.PROPOSAL)),
                           null_like(neg1))
    state = apply_ev(state, self_tag, prop_msg.round, prop_msg.value,
                     prop_msg.aux)

    # --- 7. window rotation around the current round
    new_base = torch.maximum(tally.base_round,
                             torch.clamp(state.round - 1, min=0))
    tally = rotate_window(tally, new_base)

    # --- 8. height advance (optional): a decided instance is reset to
    # State::new(height+1) semantics (README.md:43-44)
    if advance_height:
        decided = state.step == int(Step.COMMIT)

        def sel(new, old):
            mask = decided.reshape(decided.shape + (1,) * (old.ndim - 1))
            return torch.where(mask, new, old)

        zero = torch.zeros_like(state.round)
        state = DeviceState(
            round=sel(zero, state.round),
            step=sel(zero, state.step),                 # Step.NEW_ROUND
            locked_round=sel(zero - 1, state.locked_round),
            locked_value=sel(zero - 1, state.locked_value),
            valid_round=sel(zero - 1, state.valid_round),
            valid_value=sel(zero - 1, state.valid_value),
            height=sel(state.height + 1, state.height),
        )
        tally = tally._replace(
            weights=sel(torch.zeros_like(tally.weights), tally.weights),
            voted=sel(torch.full_like(tally.voted, NOT_VOTED), tally.voted),
            emitted=sel(torch.full_like(tally.emitted, TH_INIT),
                        tally.emitted),
            skipped=sel(torch.zeros_like(tally.skipped), tally.skipped),
            q_round=sel(zero - 1, tally.q_round),
            q_step=sel(zero - 1, tally.q_step),
            pc_done=sel(torch.zeros_like(tally.pc_done), tally.pc_done),
            skip_w=sel(torch.zeros_like(tally.skip_w), tally.skip_w),
            base_round=sel(zero, tally.base_round),
            # equiv is cumulative evidence about validators: it survives
        )

    return StepOutputs(state=state, tally=tally, msgs=stack_tuples(msgs))


def consensus_step_seq(state: DeviceState,
                       tally: TallyState,
                       exts: ExtEvent,      # [P, I] leaves
                       phases: VotePhase,   # [P, I(, V)] leaves
                       powers: torch.Tensor,
                       total_power: torch.Tensor,
                       proposer_flag: torch.Tensor,
                       propose_value: torch.Tensor,
                       advance_height: bool = False,
                       group=None,
                       ) -> StepOutputs:
    """P sequential fused steps (the JAX twin's `lax.scan` over the
    leading axis of `exts`/`phases`, here a Python loop).  msgs leaves
    come back stacked [P, n_stages, I]."""
    msgs = []
    for p in range(phases.mask.shape[0]):
        out = consensus_step(state, tally,
                             ExtEvent(*[x[p] for x in exts]),
                             VotePhase(*[x[p] for x in phases]),
                             powers, total_power, proposer_flag,
                             propose_value, advance_height=advance_height,
                             group=group)
        state, tally = out.state, out.tally
        msgs.append(out.msgs)
    return StepOutputs(state=state, tally=tally, msgs=stack_tuples(msgs))


class SignedLanes(NamedTuple):
    """Packed per-lane Ed25519 verify inputs: lane j is one wire vote
    destined for phase `phase_idx[j]` of a step sequence, cell
    (inst[j], val[j]).  pub/sig/blocks are `crypto.ed25519.verify_batch`
    inputs; blocks hold the uint32 SHA-512 words as int32 bit patterns."""

    pub: torch.Tensor        # [N, 32] int32
    sig: torch.Tensor        # [N, 64] int32
    blocks: torch.Tensor     # [N, nb, 32] int32 (uint32 bits)
    phase_idx: torch.Tensor  # [N] int32; out-of-range = padding lane
    inst: torch.Tensor       # [N] int32
    val: torch.Tensor        # [N] int32
    real: torch.Tensor       # [N] bool; False = padding


class SignedStepOutputs(NamedTuple):
    state: DeviceState
    tally: TallyState
    msgs: DeviceMessage      # [P, n_stages, I] leaves
    n_rejected: torch.Tensor  # int32: real lanes that failed, a scalar
    #                           (lane path) or [I] (dense path); the
    #                           driver sums it at collect


def _verify_lanes_chunked(pub: torch.Tensor, sig: torch.Tensor,
                          blocks: torch.Tensor,
                          verify_chunk: Optional[int]) -> torch.Tensor:
    """`verify_batch` over [N] lanes in bounded microbatches of
    `verify_chunk` lanes (None, 0 or a chunk >= N: one call).
    Bit-identical to the unchunked call by construction: every lane's
    verification is independent integer math."""
    N = pub.shape[0]
    if not verify_chunk or verify_chunk >= N:
        return ed25519.verify_batch(pub, sig, blocks)
    c = int(verify_chunk)
    return torch.cat([ed25519.verify_batch(pub[i:i + c], sig[i:i + c],
                                           blocks[i:i + c])
                      for i in range(0, N, c)])


def consensus_step_seq_signed(state: DeviceState,
                              tally: TallyState,
                              exts: ExtEvent,      # [P, I] leaves
                              phases: VotePhase,   # [P, I(, V)] leaves
                              lanes: SignedLanes,  # [N, ...] leaves
                              powers: torch.Tensor,
                              total_power: torch.Tensor,
                              proposer_flag: torch.Tensor,
                              propose_value: torch.Tensor,
                              advance_height: bool = False,
                              verify_chunk: Optional[int] = None,
                              ) -> SignedStepOutputs:
    """`consensus_step_seq` with one batched Ed25519 verify over every
    lane (the CUDA kernel on the card), its verdicts scattered to
    [P, I, V] and ANDed into the phase masks on the device before the
    step sequence runs.  Caller contract (as in the JAX twin): at most
    one lane per (phase, cell)."""
    ok = _verify_lanes_chunked(lanes.pub, lanes.sig, lanes.blocks,
                               verify_chunk)                     # [N]
    P, I, V = phases.mask.shape
    # padding lanes carry an out-of-range phase_idx: JAX drops their
    # scatter (mode="drop"); index_put_ has no drop mode, so mask them
    # here: they land in a spare row P that is cut off (a boolean
    # select would cost a device sync), and `real` keeps them out of
    # the count
    in_range = (lanes.phase_idx >= 0) & (lanes.phase_idx < P)
    pidx = torch.where(in_range, lanes.phase_idx,
                       torch.full_like(lanes.phase_idx, P))
    vmask = torch.zeros((P + 1, I, V), dtype=torch.bool, device=ok.device)
    vmask.index_put_((pidx.long(), lanes.inst.long(), lanes.val.long()), ok)
    phases = phases._replace(mask=phases.mask & vmask[:P])
    out = consensus_step_seq(state, tally, exts, phases, powers,
                             total_power, proposer_flag, propose_value,
                             advance_height=advance_height)
    n_rej = (lanes.real & ~ok).sum(dtype=I32)
    return SignedStepOutputs(state=out.state, tally=out.tally,
                             msgs=out.msgs, n_rejected=n_rej)


class DenseSignedPhases(NamedTuple):
    """Dense per-cell Ed25519 inputs: entry (p, i, v) holds the
    signature material of validator v's vote in instance i for phase
    `P - Ps + p` (the last Ps phases of the sequence are the signed vote
    classes; leading phases, such as the round-entry phase, carry no
    lanes).  The [.., I, V, ..] layout shards like the phase masks, so
    each rank of a mesh verifies only its own cells
    (parallel/sharded.py).  blocks hold the uint32 SHA-512 words as
    int32 bit patterns, as SignedLanes does."""

    pub: torch.Tensor     # [V, 32] int32 validator table
    sig: torch.Tensor     # [Ps, I, V, 64] int32
    blocks: torch.Tensor  # [Ps, I, V, nb, 32] int32 (uint32 bits)


def _verify_dense(dense: DenseSignedPhases,
                  verify_chunk: Optional[int]) -> torch.Tensor:
    """[Ps, I, V] verdicts of every dense cell: one `verify_batch`
    call (one kernel launch on the card) over all Ps*I*V cells, or with
    `verify_chunk` one a tile of that many instance rows
    (verify_chunk*Ps*V lanes), the last tile padded with zero rows whose
    verdicts are cut off, as the twin's `lax.map` tiles.  Each tile
    materializes its [Ps, t, V, 32] pub broadcast and, for Ps > 1, a
    contiguous copy of its sig and blocks (utils/budget.
    plan_dense_verify counts both).  Chunked and unchunked agree cell
    for cell: every lane is independent integer math."""
    Ps, I, V = dense.sig.shape[:3]
    tail = tuple(dense.blocks.shape[3:])

    def verify(sig, blocks):
        t = sig.shape[1]
        pub = dense.pub[None, None].expand(Ps, t, V, 32)
        return ed25519.verify_batch(
            pub.reshape(Ps * t * V, 32), sig.reshape(Ps * t * V, 64),
            blocks.reshape((Ps * t * V,) + tail)).reshape(Ps, t, V)

    if not verify_chunk or verify_chunk >= I:
        return verify(dense.sig, dense.blocks)
    t = int(verify_chunk)
    tiles = []
    for r0 in range(0, I, t):
        sig, blocks = dense.sig[:, r0:r0 + t], dense.blocks[:, r0:r0 + t]
        pad = t - sig.shape[1]
        if pad:
            sig = torch.cat([sig, sig.new_zeros((Ps, pad) + sig.shape[2:])],
                            dim=1)
            blocks = torch.cat(
                [blocks, blocks.new_zeros((Ps, pad) + blocks.shape[2:])],
                dim=1)
        tiles.append(verify(sig, blocks))
    return torch.cat(tiles, dim=1)[:, :I]


def consensus_step_seq_signed_dense(state: DeviceState,
                                    tally: TallyState,
                                    exts: ExtEvent,       # [P, I]
                                    phases: VotePhase,    # [P, I(, V)]
                                    dense: DenseSignedPhases,
                                    powers: torch.Tensor,
                                    total_power: torch.Tensor,
                                    proposer_flag: torch.Tensor,
                                    propose_value: torch.Tensor,
                                    advance_height: bool = False,
                                    verify_chunk: Optional[int] = None,
                                    group=None,
                                    ) -> SignedStepOutputs:
    """`consensus_step_seq_signed` with dense per-cell lanes, the
    layout that shards (parallel/sharded.make_sharded_step_seq_signed):
    verification is elementwise in (instance, validator), so each rank
    verifies only its own cells and the tally's all_reduces stay the
    only collectives.  Cells without a vote verify garbage that the
    mask AND discards.  `n_rejected` comes back per instance, [I]
    (all-reduced over `group` when sharded): masked cells whose
    signature failed.

    `verify_chunk` counts instance rows per verify launch (size it with
    utils/budget.plan_dense_verify); on a mesh it tiles the rank's own
    rows and the tile loop adds no collective."""
    Ps, I, V = dense.sig.shape[:3]
    P = phases.mask.shape[0]
    ok = _verify_dense(dense, verify_chunk)                       # [Ps, I, V]
    vmask = torch.cat([torch.ones((P - Ps, I, V), dtype=torch.bool,
                                  device=ok.device), ok], dim=0)
    n_rej = (phases.mask & ~vmask).sum(dim=(0, 2), dtype=I32)     # [I]
    psum(n_rej, group)
    phases = phases._replace(mask=phases.mask & vmask)
    out = consensus_step_seq(state, tally, exts, phases, powers,
                             total_power, proposer_flag, propose_value,
                             advance_height=advance_height, group=group)
    return SignedStepOutputs(state=out.state, tally=out.tally,
                             msgs=out.msgs, n_rejected=n_rej)


def honest_heights(state: DeviceState,
                   tally: TallyState,
                   slots: torch.Tensor,      # [I, V] value slot votes
                   mask: torch.Tensor,       # [I, V] voter mask
                   powers: torch.Tensor,
                   total_power: torch.Tensor,
                   proposer_flag: torch.Tensor,
                   propose_value: torch.Tensor,
                   heights: int,
                   group=None,
                   ) -> StepOutputs:
    """`heights` consecutive honest heights — entry step, full prevote
    phase, full precommit phase, decision, height advance — with every
    phase taking its round/height from the carried state (nothing
    round-trips the host).  msgs leaves come back [H, 3, n_stages, I]."""
    n = state.round.shape[0]
    dev = state.round.device
    none = ExtEvent.none(n, dev)
    empty_slots = torch.full_like(slots, -1)
    empty_mask = torch.zeros_like(mask)

    def one(st, ta, typ_code, sl, mk):
        phase = VotePhase(round=st.round,
                          typ=torch.full_like(st.round, typ_code),
                          slots=sl, mask=mk, height=st.height)
        return consensus_step(st, ta, none, phase, powers, total_power,
                              proposer_flag, propose_value,
                              advance_height=True, group=group)

    per_height = []
    for _ in range(heights):
        out0 = one(state, tally, 0, empty_slots, empty_mask)
        out1 = one(out0.state, out0.tally, int(VoteType.PREVOTE), slots, mask)
        out2 = one(out1.state, out1.tally, int(VoteType.PRECOMMIT), slots,
                   mask)
        state, tally = out2.state, out2.tally
        per_height.append(stack_tuples([out0.msgs, out1.msgs, out2.msgs]))
    return StepOutputs(state=state, tally=tally,
                       msgs=stack_tuples(per_height))
