"""The wire alphabet of the consensus executor and its epoch rule (the
part of `agnes_tpu.core.executor` that the cross-plane replay reads).

The executor itself (proposer rotation, signing, the timer wheel,
re-entrant execution, multi-height bookkeeping) waits for the host-plane
slice, ROADMAP §1 item 7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from agnes_tpu_torch.core.state_machine import TimeoutStep


def epoch_boundary_at(epochs, height: int) -> Optional[int]:
    """Largest epoch boundary <= `height`, or None when the genesis set
    applies: the boundary rule every plane shares.  `epochs` is any
    height-keyed mapping (or None/empty)."""
    best = None
    for boundary in epochs or ():
        if boundary <= height and (best is None or boundary > best):
            best = boundary
    return best


@dataclass(frozen=True, slots=True)
class WireProposal:
    height: int
    round: int
    value: int
    pol_round: int
    proposer: int                      # validator index
    signature: Optional[bytes] = None


@dataclass(frozen=True, slots=True)
class WireTimeout:
    height: int
    round: int
    step: TimeoutStep
