"""Vote tally + threshold detection on device (twin of
`agnes_tpu.device.tally`).

Semantics are `core.round_votes`'s: per-value weight buckets,
per-validator dedup, equivocation evidence, quorum predicate
`3*v > 2*total` (round_votes.rs:31-33), threshold priority
Value > Nil > Any > Init (round_votes.rs:58-66).  Votes arrive as dense
per-phase [I, V] matrices; events are edge-triggered (`emitted` records
the highest code already fired per (instance, round, class)).  See the
JAX twin's docstring for the full design.

Port notes:

* The JAX twin's one-hot segment sum is an int32 einsum (`tally.py:244`);
  CUDA has no integer matmul, so the weight delta is a `scatter_add_`
  over the slot axis — the same exact integer sum.
* `argmax` keeps first-occurrence ties (torch documents it); the
  round-skip argmax runs over an int32 cast because CUDA's argmax takes
  no bool.
* Every reduction pins `dtype=torch.int32` (torch sums ints to int64).
* The two quorum products (`3 * w > 2 * total`, `3 * w_skip > total`)
  are compared in int64, so a power table whose total is near 2^31
  decides as the host oracle does (`core.round_votes`, Python ints);
  every stored leaf stays int32.  The JAX twin compares in int32 and
  wraps there (a single validator of power 715,827,883 never reaches
  quorum): a deliberate departure, pinned by tests/test_torch_quorum.py.
* Sharded over a validator process group (`parallel/sharded.py`, one
  process per device), the twin's two `psum`s become
  `torch.distributed.all_reduce(SUM)` over that group (`psum` below),
  each counted in `COLLECTIVES` per group: the port's stand-in for the
  twin's collective census.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from agnes_tpu_torch.core.state_machine import EventTag
from agnes_tpu_torch.device.encoding import I32, full, resolve_device

# threshold codes, ordered by priority (round_votes.rs:58-66)
TH_INIT, TH_ANY, TH_NIL, TH_VALUE = 0, 1, 2, 3
# voted-record sentinels
NOT_VOTED = -2
VOTED_NIL = -1
# "no event" tag
NO_EVENT = -1

#: all_reduces issued by `psum`, by process group, over the process's
#: life.  The sharded factories read it around each dispatch
#: (`parallel/sharded.py`: their `census`); only tests and the smoke
#: reset it.
COLLECTIVES: collections.Counter = collections.Counter()


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The twin's `lax.psum` over a mesh axis: an in-place
    `all_reduce(SUM)` of `t` over `group` (a ProcessGroup), counted in
    COLLECTIVES; `group` None is the single-device identity."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        COLLECTIVES[group] += 1
    return t


class TallyConfig(NamedTuple):
    """Static shapes: V validators, W rounds in the tracked window,
    S value slots per instance."""

    n_validators: int
    n_rounds: int = 4
    n_slots: int = 4


class TallyState(NamedTuple):
    """Per-instance tally tensors (I = batch of instances); field
    meanings as in the JAX twin's TallyState docstring.

    weights [I, W, 2, S+1] int32, voted [I, W, 2, V] int32,
    emitted [I, W, 2] int32, skipped [I, W] bool, equiv [I, V] bool,
    q_round [I] int32, q_step [I] int32, pc_done [I, W] bool,
    skip_w [I, W] int32, base_round [I] int32."""

    weights: torch.Tensor
    voted: torch.Tensor
    emitted: torch.Tensor
    skipped: torch.Tensor
    equiv: torch.Tensor
    q_round: torch.Tensor
    q_step: torch.Tensor
    pc_done: torch.Tensor
    skip_w: torch.Tensor
    base_round: torch.Tensor

    @classmethod
    def new(cls, n_instances: int, cfg: TallyConfig,
            device="cuda") -> "TallyState":
        dev = resolve_device(device)
        I_, W, S, V = n_instances, cfg.n_rounds, cfg.n_slots, cfg.n_validators
        return cls(
            weights=full((I_, W, 2, S + 1), 0, dev),
            voted=full((I_, W, 2, V), NOT_VOTED, dev),
            emitted=full((I_, W, 2), 0, dev),
            skipped=torch.zeros((I_, W), dtype=torch.bool, device=dev),
            equiv=torch.zeros((I_, V), dtype=torch.bool, device=dev),
            q_round=full((I_,), -1, dev),
            q_step=full((I_,), -1, dev),
            pc_done=torch.zeros((I_, W), dtype=torch.bool, device=dev),
            skip_w=full((I_, W), 0, dev),
            base_round=full((I_,), 0, dev),
        )


class TallyEvents(NamedTuple):
    """Per-instance outputs of one ingestion phase ([I] int32 each):
    tag (EventTag code or NO_EVENT), value_slot (slot for *_VALUE
    events, else -1), round, skip_round (lowest round whose +1/3 skip
    threshold newly fired, or -1)."""

    tag: torch.Tensor
    value_slot: torch.Tensor
    round: torch.Tensor
    skip_round: torch.Tensor


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _thresh_code(weights_row: torch.Tensor, total: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """weights_row [..., S+1] -> (code, value_slot), both int32.

    Priority Value > Nil > Any (round_votes.rs:58-66); `Any` is quorum of
    all weight seen in the class (round_votes.rs:62)."""
    nil_w = weights_row[..., 0]
    val_w = weights_row[..., 1:]

    def q(w):                         # round_votes.rs:31-33, in int64
        return 3 * w.long() > 2 * total.long()

    val_q = q(val_w)
    has_val = val_q.any(dim=-1)
    # first-occurrence argmax of the masked weights, as jnp.argmax
    vslot = torch.argmax(torch.where(val_q, val_w, torch.full_like(val_w, -1)),
                         dim=-1).to(I32)
    seen = weights_row.sum(dim=-1, dtype=I32)
    code = torch.where(
        has_val, TH_VALUE,
        torch.where(q(nil_w), TH_NIL,
                    torch.where(q(seen), TH_ANY, TH_INIT))).to(I32)
    return code, torch.where(has_val, vslot, torch.full_like(vslot, -1))


# (class, code) -> EventTag, the vote_executor.rs:26-36 table.  There is
# no PrecommitNil event; a pure-nil precommit quorum maps to
# PRECOMMIT_ANY so spec line 47's timeout actually triggers.
_EVENT_ROWS = (
    # INIT       ANY                        NIL                      VALUE
    (NO_EVENT, int(EventTag.POLKA_ANY), int(EventTag.POLKA_NIL),
     int(EventTag.POLKA_VALUE)),
    (NO_EVENT, int(EventTag.PRECOMMIT_ANY), int(EventTag.PRECOMMIT_ANY),
     int(EventTag.PRECOMMIT_VALUE)),
)


@functools.lru_cache(maxsize=None)
def event_table(device: torch.device) -> torch.Tensor:
    """[2, 4] int32 (class, code) -> EventTag lookup on `device`, made
    once per device (read-only; callers index it, never write it)."""
    return torch.tensor(_EVENT_ROWS, dtype=I32, device=device)


def event_of(typ: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """_EVENT_TABLE[typ, code] elementwise (int32)."""
    return event_table(typ.device)[typ.long(), code.long()]


def _sel_wt(W: int, round_idx: torch.Tensor, typ: torch.Tensor
            ) -> torch.Tensor:
    """[I, W, 2] one-hot selector of each instance's (round, class) row.
    All-false when round_idx is outside the tracked window [0, W)."""
    onehot_w = _arange(W, round_idx)[None, :] == round_idx[:, None]
    onehot_t = _arange(2, typ)[None, :] == typ[:, None]
    return onehot_w[:, :, None] & onehot_t[:, None, :]


def _gather_row(arr: torch.Tensor, sel_wt: torch.Tensor,
                fill: int = 0) -> torch.Tensor:
    """One-hot gather of the selected [I, ...] row of an [I, W, 2, ...]
    (or [I, W, 2]) tensor; rows outside the window read as `fill`."""
    sel = sel_wt.reshape(sel_wt.shape + (1,) * (arr.ndim - 3))
    picked = torch.where(sel, arr - fill, torch.zeros_like(arr))
    return picked.sum(dim=(1, 2), dtype=I32) + fill


def add_votes(tally: TallyState,
              powers: torch.Tensor,        # [V] voting power
              total_power: torch.Tensor,   # scalar
              round_idx: torch.Tensor,     # [I] round being ingested
              typ: torch.Tensor,           # [I] VoteType code
              slots: torch.Tensor,         # [I, V] value slot or VOTED_NIL
              mask: torch.Tensor,          # [I, V] vote present
              cur_round: torch.Tensor,     # [I] instance's current round
              group=None,
              ) -> Tuple[TallyState, TallyEvents]:
    """Ingest one dense vote phase; returns the updated tally and the
    newly crossed threshold events (twin of the JAX `add_votes`).

    Sharded over a validator process group (`group`, the twin's
    `axis_name`), pass this rank's V-blocks of `powers`, `slots`,
    `mask`, `tally.voted` and `tally.equiv`: the two validator-axis
    reductions (the weight delta and the round-skip weight) become
    `all_reduce`s over `group` (`psum`), and everything else stays
    local.  `group` None: one device, the reductions local."""
    I_, W, _, S1 = tally.weights.shape

    # --- absolute rounds -> window rows; out-of-window votes dropped
    widx = round_idx - tally.base_round                              # [I]
    in_window = (widx >= 0) & (widx < W)                             # [I]
    # invalid slots (outside [VOTED_NIL, S)) are dropped too
    valid_slot = (slots >= VOTED_NIL) & (slots < S1 - 1)             # [I, V]
    mask = mask & in_window[:, None] & valid_slot
    sel_wt = _sel_wt(W, widx, typ)                                   # [I, W, 2]
    voted_row = _gather_row(tally.voted, sel_wt, fill=NOT_VOTED)     # [I, V]

    # --- dedup + equivocation
    fresh = mask & (voted_row == NOT_VOTED)
    conflict = mask & (voted_row != NOT_VOTED) & (voted_row != slots)
    voted_row_new = torch.where(fresh, slots, voted_row)

    # --- segment sum over the validator axis: column 0 = nil (slot -1),
    # column s+1 = slot s.  scatter_add_ replaces the int32 einsum.
    col = torch.clamp(slots + 1, 0, S1 - 1).long()                   # [I, V]
    contrib = torch.where(fresh, powers[None, :],
                          torch.zeros_like(slots))                   # [I, V]
    delta = torch.zeros((I_, S1), dtype=I32, device=slots.device)
    delta.scatter_add_(1, col, contrib)                              # [I, S1]
    psum(delta, group)

    weights_row = _gather_row(tally.weights, sel_wt)
    weights_row_new = weights_row + delta

    # --- threshold detection + edge-triggered event
    code, vslot = _thresh_code(weights_row_new, total_power)
    emitted_row = _gather_row(tally.emitted, sel_wt)
    # fire only when the code rises AND maps to a different event
    ev_new = event_of(typ, code)
    rising = (in_window & (code > emitted_row)
              & (ev_new != event_of(typ, emitted_row)))
    tag = torch.where(rising, ev_new, torch.full_like(ev_new, NO_EVENT))
    value_slot = torch.where(tag >= 0, vslot, torch.full_like(vslot, -1))

    # --- scatter rows back
    weights = torch.where(sel_wt[:, :, :, None],
                          weights_row_new[:, None, None, :], tally.weights)
    voted = torch.where(sel_wt[:, :, :, None],
                        voted_row_new[:, None, None, :], tally.voted)
    emitted = torch.where(sel_wt,
                          torch.maximum(emitted_row, code)[:, None, None],
                          tally.emitted)
    equiv = tally.equiv | conflict

    # --- RoundSkip: +1/3 of distinct-voter weight on a round above the
    # instance's current one (state_machine.rs:106)
    sel_other = _sel_wt(W, widx, 1 - typ)
    other_row = _gather_row(tally.voted, sel_other, fill=NOT_VOTED)  # [I, V]
    new_voter = fresh & (other_row == NOT_VOTED)
    dskip = torch.where(new_voter, powers[None, :],
                        torch.zeros_like(slots)).sum(dim=1, dtype=I32)
    psum(dskip, group)
    onehot_r = _arange(W, widx)[None, :] == widx[:, None]            # [I, W]
    w_skip = tally.skip_w + torch.where(onehot_r, dskip[:, None],
                                        torch.zeros_like(tally.skip_w))
    abs_round = tally.base_round[:, None] + _arange(W, widx)[None, :]
    eligible = ((3 * w_skip.long() > total_power.long())
                & (abs_round > cur_round[:, None])
                & ~tally.skipped)                                    # [I, W]
    any_skip = eligible.any(dim=1)
    # lowest eligible row; int32 cast — CUDA argmax takes no bool
    skip_widx = torch.argmax(eligible.to(I32), dim=1).to(I32)
    skip_round = torch.where(any_skip, tally.base_round + skip_widx,
                             torch.full_like(skip_widx, -1))
    skipped = tally.skipped | (
        any_skip[:, None] & (_arange(W, widx)[None, :] == skip_widx[:, None]))

    new_tally = tally._replace(weights=weights, voted=voted, emitted=emitted,
                               skipped=skipped, equiv=equiv, skip_w=w_skip)
    events = TallyEvents(tag=tag, value_slot=value_slot,
                         round=round_idx.to(I32), skip_round=skip_round)
    return new_tally, events


def current_threshold(tally: TallyState, round_idx: torch.Tensor,
                      typ: torch.Tensor, total_power: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(code, value_slot) currently reached at [I] (round, class) — the
    re-query path; out-of-window rounds read as empty (TH_INIT)."""
    W = tally.weights.shape[1]
    sel_wt = _sel_wt(W, round_idx - tally.base_round, typ)
    return _thresh_code(_gather_row(tally.weights, sel_wt), total_power)


def rotate_window(tally: TallyState, new_base: torch.Tensor) -> TallyState:
    """Roll each instance's W-row window forward so row 0 becomes
    absolute round `new_base` (>= the current base; per-instance).
    Rows that stay are shifted down; rows entering are fresh-empty."""
    W = tally.weights.shape[1]
    shift = torch.clamp(new_base - tally.base_round, min=0)          # [I]
    src = _arange(W, shift)[None, :] + shift[:, None]                # [I, W]
    keep = src < W
    srcc = torch.clamp(src, max=W - 1).long()

    def roll(arr, fill):
        extra = (1,) * (arr.ndim - 2)
        idx = srcc.reshape(srcc.shape + extra).expand(arr.shape)
        out = torch.gather(arr, 1, idx)
        k = keep.reshape(keep.shape + extra)
        return torch.where(k, out, torch.full_like(out, fill))

    return tally._replace(
        weights=roll(tally.weights, 0),
        voted=roll(tally.voted, NOT_VOTED),
        emitted=roll(tally.emitted, TH_INIT),
        skipped=roll(tally.skipped, False),
        pc_done=roll(tally.pc_done, False),
        skip_w=roll(tally.skip_w, 0),
        base_round=tally.base_round + shift,
    )
