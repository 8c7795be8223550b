"""Branch-free Tendermint state machine over a batch of instances.

Twin of `agnes_tpu.device.state_machine` (`apply_scalar`, vmapped as
`apply_batch`), written with the batch axis explicit: every leaf is an
int32 [n] tensor and one call applies one event per instance.
`apply_scalar`, the one-instance form, is `apply_batch` on a batch of
one, so the transition table is written once.

The match expression compiles to an *arm selector*: one predicate per
reference match arm (src/state_machine.rs:185-213) stacked into an
[16, n] int tensor, first-true-wins via `argmax` (first occurrence,
exactly Rust match priority; int, not bool, because CUDA's argmax
takes no bool).  `lax.select_n(arm, ...)` becomes a gather from the
stacked per-arm candidates.  Every candidate is computed
unconditionally, so the whole transition is a few dozen elementwise
ops with no data-dependent control flow.
"""

from __future__ import annotations

from typing import Tuple

import torch

from agnes_tpu_torch.core.state_machine import EventTag, MsgTag, Step, TimeoutStep
from agnes_tpu_torch.device.encoding import I32, DeviceEvent, DeviceMessage, DeviceState
from agnes_tpu_torch.types import MAX_ROUND, NIL_ID, VoteType

_S = Step
_E = EventTag
_M = MsgTag


def apply_batch(s: DeviceState, ev: DeviceEvent
                ) -> Tuple[DeviceState, DeviceMessage]:
    """One event per instance; all leaves [n] int32."""
    eqr = s.round == ev.round
    step, tag = s.step, ev.tag

    def c(v: int) -> torch.Tensor:
        return torch.full_like(s.round, v)

    def at(st: Step):
        return step == int(st)

    def on(t: EventTag):
        return tag == int(t)

    # valid_vr: -1 <= vr < round (state_machine.rs:170-172)
    vr_ok = (ev.pol_round >= -1) & (ev.pol_round < s.round)

    # --- arm predicates, in reference match order (state_machine.rs:185-213)
    arms = torch.stack([
        at(_S.NEW_ROUND) & on(_E.NEW_ROUND_PROPOSER) & eqr,          # 0 propose
        at(_S.NEW_ROUND) & on(_E.NEW_ROUND) & eqr,                   # 1 sched t.propose
        at(_S.PROPOSE) & on(_E.PROPOSAL) & eqr & vr_ok,              # 2 prevote
        at(_S.PROPOSE) & on(_E.PROPOSAL_INVALID) & eqr,              # 3 prevote nil
        at(_S.PROPOSE) & on(_E.TIMEOUT_PROPOSE) & eqr,               # 4 prevote nil
        at(_S.PREVOTE) & on(_E.POLKA_ANY) & eqr,                     # 5 sched t.prevote
        at(_S.PREVOTE) & on(_E.POLKA_NIL) & eqr,                     # 6 precommit nil
        at(_S.PREVOTE) & on(_E.POLKA_VALUE) & eqr,                   # 7 precommit
        at(_S.PREVOTE) & on(_E.TIMEOUT_PREVOTE) & eqr,               # 8 precommit nil
        at(_S.PRECOMMIT) & on(_E.POLKA_VALUE) & eqr,                 # 9 set valid
        at(_S.COMMIT),                                               # 10 absorb
        on(_E.PRECOMMIT_ANY) & eqr,                                  # 11 sched t.precommit
        on(_E.TIMEOUT_PRECOMMIT) & eqr,                              # 12 skip round+1
        on(_E.ROUND_SKIP) & (s.round < ev.round),                    # 13 skip ev.round
        on(_E.PRECOMMIT_VALUE),                                      # 14 commit (no eqr!)
        torch.ones_like(eqr),                                        # 15 no-op
    ]).to(I32)
    arm = torch.argmax(arms, dim=0)  # first true wins == Rust match priority

    # --- shared pieces
    # next_step saturates at Precommit; Commit unchanged (state_machine.rs:58-66)
    stepped = torch.where(step < int(_S.PRECOMMIT), step + 1, step)
    s_next = s._replace(step=stepped)
    has_valid = s.valid_round >= 0

    def msg(tag_: int, round_, value=NIL_ID, aux=0) -> DeviceMessage:
        def t(x):
            return x if isinstance(x, torch.Tensor) else c(x)
        return DeviceMessage(c(tag_), t(round_), t(value), t(aux))

    # --- candidates per arm
    # 0: propose (state_machine.rs:222-229)
    prop_val = torch.where(has_valid, s.valid_value, ev.value)
    prop_pol = torch.where(has_valid, s.valid_round, c(-1))
    c0 = (s_next, msg(_M.PROPOSAL, s.round, prop_val, prop_pol))

    # 1: schedule timeout propose (state_machine.rs:278-281)
    c1 = (s_next, msg(_M.TIMEOUT, s.round, NIL_ID, int(TimeoutStep.PROPOSE)))

    # 2: prevote with the lock rule (state_machine.rs:237-246)
    lock_ok = ((s.locked_round < 0)                 # not locked
               | (s.locked_round <= ev.pol_round)   # unlock
               | (s.locked_value == ev.value))      # same value
    pv_val = torch.where(lock_ok, ev.value, c(NIL_ID))
    c2 = (s_next, msg(_M.VOTE, s.round, pv_val, int(VoteType.PREVOTE)))

    # 3/4: prevote nil (state_machine.rs:250-253)
    c3 = (s_next, msg(_M.VOTE, s.round, NIL_ID, int(VoteType.PREVOTE)))

    # 5: schedule timeout prevote — NO step change (state_machine.rs:287-289)
    c5 = (s, msg(_M.TIMEOUT, s.round, NIL_ID, int(TimeoutStep.PREVOTE)))

    # 6/8: precommit nil (state_machine.rs:268-271)
    c6 = (s_next, msg(_M.VOTE, s.round, NIL_ID, int(VoteType.PRECOMMIT)))

    # 7: precommit value: lock + valid at current round (state_machine.rs:261-264)
    s7 = s._replace(step=stepped,
                    locked_round=s.round, locked_value=ev.value,
                    valid_round=s.round, valid_value=ev.value)
    c7 = (s7, msg(_M.VOTE, s.round, ev.value, int(VoteType.PRECOMMIT)))

    # 9: set valid value only, no message (state_machine.rs:304-306)
    s9 = s._replace(valid_round=s.round, valid_value=ev.value)
    c9 = (s9, msg(_M.NONE, 0))

    # 10/15: absorb / no-op
    c10 = (s, msg(_M.NONE, 0))

    # 11: schedule timeout precommit — no step change (state_machine.rs:293-295)
    c11 = (s, msg(_M.TIMEOUT, s.round, NIL_ID, int(TimeoutStep.PRECOMMIT)))

    # 12/13: round skip → NewRound at target round (state_machine.rs:314-316)
    def skip(r):
        return (s._replace(round=r, step=c(int(_S.NEW_ROUND))),
                msg(_M.NEW_ROUND, r))

    # clamp BEFORE the +1: at ev.round == MAX_ROUND a bare int32 +1
    # would wrap negative while the int64 oracle saturates
    c12 = skip(torch.clamp(ev.round, max=MAX_ROUND - 1) + 1)
    c13 = skip(ev.round)

    # 14: commit: step only; Decision carries the EVENT round
    #     (state_machine.rs:320-322)
    s14 = s._replace(step=c(int(_S.COMMIT)))
    c14 = (s14, msg(_M.DECISION, ev.round, ev.value))

    cands = [c0, c1, c2, c3, c3, c5, c6, c7, c6, c9, c10, c11, c12, c13,
             c14, c10]
    idx = arm.unsqueeze(0)

    def sel(leaves):
        return torch.gather(torch.stack(leaves), 0, idx)[0]

    state_out = DeviceState(*[sel([cd[0][k] for cd in cands])
                              for k in range(len(DeviceState._fields))])
    msg_out = DeviceMessage(*[sel([cd[1][k] for cd in cands])
                              for k in range(len(DeviceMessage._fields))])
    return state_out, msg_out


def apply_scalar(s: DeviceState, ev: DeviceEvent
                 ) -> Tuple[DeviceState, DeviceMessage]:
    """One instance, one event: 0-d int32 leaves in, 0-d int32 leaves
    out (`apply_batch` on a batch of one)."""
    def one(x):
        return torch.as_tensor(x, dtype=I32).reshape(1)

    s1, m1 = apply_batch(DeviceState(*map(one, s)),
                         DeviceEvent(*map(one, ev)))
    return (DeviceState(*(x[0] for x in s1)),
            DeviceMessage(*(x[0] for x in m1)))
