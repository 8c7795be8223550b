"""Cross-plane differential replay: host-plane traffic into the device
plane (twin of `agnes_tpu.harness.replay`).

The framework has two consensus planes over one state machine: the host
plane (a network of consensus executors, each re-entrant, with a timer
wheel) and the device plane (`VoteBatcher` densifying wire votes into
phases for the fused device step, its host fallback covering rounds
past the window).  They do not share tally and event ordering, which is
where a divergence would hide.  `replay_trace` pushes one host node's
complete processing stream (peer deliveries, self-deliveries, timeouts,
in order) through the port's `VoteBatcher` and `DeviceDriver` and
reports what the device plane decided, per height.

`trace_network` taps every node of a `harness.simulator.Network`:
because the executor is re-entrant (self-produced proposals and votes
and fired timeouts all loop back through `execute`), the tap captures
each node's complete processing stream in exact order.  The stream's
messages are the port's own wire types: `types.Vote`,
`core.executor.WireProposal` and `WireTimeout`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from agnes_tpu_torch.core.executor import (WireProposal, WireTimeout,
                                           epoch_boundary_at)
from agnes_tpu_torch.core.state_machine import EventTag, TimeoutStep
from agnes_tpu_torch.types import Vote

_TIMEOUT_TAG = {
    TimeoutStep.PROPOSE: int(EventTag.TIMEOUT_PROPOSE),
    TimeoutStep.PREVOTE: int(EventTag.TIMEOUT_PREVOTE),
    TimeoutStep.PRECOMMIT: int(EventTag.TIMEOUT_PRECOMMIT),
}


def trace_network(net) -> List[List[object]]:
    """Install a processing-order tap on every node of a
    harness.Network (before `net.start()`).  Returns one list per node;
    each fills with the wire messages that node processes, in exact
    order (including re-entrant self-deliveries and timeout firings)."""
    traces: List[List[object]] = [[] for _ in net.nodes]

    def _wrap(node, rec):
        orig = node.execute

        def tapped(msg):
            rec.append(msg)
            orig(msg)

        node.execute = tapped

    for node, rec in zip(net.nodes, traces):
        _wrap(node, rec)
    return traces


@dataclass
class ReplayResult:
    """Device-plane outcome of replaying one node's stream.  The scalar
    `decided`/`value`/`round` view is height 0; `decisions` carries
    every height the device decided: height -> (round, value)."""

    decided: bool = False
    value: Optional[int] = None          # decoded value id
    round: Optional[int] = None
    decisions: Dict[int, tuple] = field(default_factory=dict)
    equivocators: Set[int] = field(default_factory=set)
    steps: int = 0
    host_fallback_decisions: int = 0     # decided via PRECOMMIT_VALUE ext


def replay_trace(trace: List[object], n_validators: int,
                 powers: Optional[np.ndarray] = None,
                 n_rounds: int = 4, n_slots: int = 4,
                 epochs: Optional[Dict[int, object]] = None,
                 device="cuda") -> ReplayResult:
    """Replay one node's processed-message stream through the bridge
    and the fused device step on `device`, and return the per-height
    outcomes.

    The device instance is a non-proposer: the node's own proposal
    arrives in the trace as a re-entrant WireProposal and is injected as
    a PROPOSAL event, its own votes ride the dense phases like peer
    votes, and timeouts fire exactly where the host timer wheel fired
    them.

    `epochs` is a validator-set schedule {boundary_height: [V] powers}:
    at every height the table with the largest boundary <= height
    applies, `powers` (or all ones) below the first boundary.  Each
    boundary is installed through the real entry points:
    `DeviceDriver.set_validators` between heights (after the deciding
    step, before the next dispatch) and `VoteBatcher.set_validators`
    right after the `sync_device` that advanced the height."""
    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.harness.device_driver import DeviceDriver

    d = DeviceDriver(1, n_validators, n_rounds=n_rounds, n_slots=n_slots,
                     proposer_is_self=False, advance_height=True,
                     device=device)
    genesis = np.asarray(powers) if powers is not None \
        else np.ones(n_validators, np.int64)
    bat = VoteBatcher(1, n_validators, n_slots, n_rounds=n_rounds,
                      powers=powers, device=device)
    if powers is not None:
        d.set_validators(powers)
    res = ReplayResult()

    def height() -> int:
        return int(d.state.height[0])

    def epoch_powers_at(h: int) -> np.ndarray:
        best = epoch_boundary_at(epochs, h)
        return genesis if best is None \
            else np.asarray(epochs[best], np.int64)

    installed = {"driver": None, "batcher": None}

    def install_epoch(which: str, setter) -> None:
        """Idempotently adopt the epoch live at the device's current
        height through the real `set_validators` boundary call."""
        if not epochs:
            return
        pw = epoch_powers_at(height())
        if installed[which] is None or \
                not np.array_equal(installed[which], pw):
            setter(pw)
            installed[which] = pw

    def after_step() -> None:
        res.steps += 1
        if bool(d.stats.decided[0]):
            # with advance_height the post-step height is already +1,
            # so the decision belongs to height() - 1.  Decode now: the
            # next sync_device resets the slot maps.  Host-fallback
            # decisions carry the raw value id (>= n_slots), slot-space
            # ones a slot (< n_slots).
            dec_h = height() - 1
            dv = int(d.stats.decision_value[0])
            rnd = int(d.stats.decision_round[0])
            val = bat.decode_slot(0, dv) if 0 <= dv < n_slots else dv
            res.decisions.setdefault(dec_h, (rnd, val))
            if dec_h == 0:
                res.decided, res.round, res.value = True, rnd, val
            # unlatch so the next height's decision records too
            d.stats.decided[0] = False
            d.stats.decision_round[0] = -1
            # the decision advanced the height: adopt the new epoch
            # before the next dispatch
            install_epoch("driver", d.set_validators)

    def step(ext=None, phase=None) -> None:
        d.step(ext=ext, phase=phase)
        after_step()

    def sync() -> None:
        bat.sync_device(d.tally.base_round.cpu().numpy(),
                        d.state.height.cpu().numpy())
        # right after the sync that (may have) advanced heights: the
        # batcher's host-fallback tallies quorum against the live epoch
        install_epoch("batcher", bat.set_validators)

    def drain() -> None:
        for inst, hgt, rnd, vid in bat.drain_host_events():
            if hgt == height():   # commit-from-any-round, still live
                # after_step tells slots from value ids by range
                if vid < n_slots:
                    raise ValueError(
                        f"value id {vid} collides with the slot range "
                        f"[0, {n_slots}); use larger value ids")
                before = len(res.decisions)
                step(ext=d.ext(int(EventTag.PRECOMMIT_VALUE), rnd, vid))
                if len(res.decisions) > before:
                    res.host_fallback_decisions += 1

    def pump() -> None:
        """Sync the batcher to the device window and feed until quiet:
        feeding a phase can advance the device round, and the next sync
        may release votes held back as future-window."""
        while True:
            sync()
            phases = bat.build_phases()
            if not phases:
                drain()
                return
            for phase, _ in phases:
                step(phase=phase)
            drain()

    def flush(chunk: List[Vote]) -> None:
        if not chunk:
            return
        bat.add_arrays(
            np.zeros(len(chunk), np.int64),
            np.asarray([v.validator for v in chunk], np.int64),
            np.asarray([v.height for v in chunk], np.int64),
            np.asarray([v.round for v in chunk], np.int64),
            np.asarray([int(v.typ) for v in chunk], np.int64),
            np.asarray([-1 if v.value is None else v.value for v in chunk],
                       np.int64))
        pump()

    # genesis may itself sit past an epoch boundary: adopt it before
    # the entry dispatch
    install_epoch("driver", d.set_validators)
    install_epoch("batcher", bat.set_validators)
    step()                       # round-0 entry, like the host start()
    chunk: List[Vote] = []
    for msg in trace:
        if isinstance(msg, Vote):
            if chunk and (msg.round != chunk[-1].round
                          or msg.typ != chunk[-1].typ
                          or msg.height != chunk[-1].height):
                flush(chunk)
                chunk = []
            chunk.append(msg)
            continue
        flush(chunk)
        chunk = []
        if isinstance(msg, WireProposal):
            if msg.height != height():
                continue          # the executor's proposal screen
            sync()
            slot = bat.slots.slot_for(0, msg.value)
            if slot is None:      # slot overflow: host-fallback territory
                continue
            step(ext=d.ext(int(EventTag.PROPOSAL), msg.round, slot,
                           msg.pol_round))
        elif isinstance(msg, WireTimeout):
            if msg.height != height():
                continue          # the executor's timeout screen
            step(ext=d.ext(_TIMEOUT_TAG[msg.step], msg.round))
            pump()                # timeouts move the window: release holds
    flush(chunk)
    pump()                        # end of trace: release remaining holds

    res.equivocators = {int(v) for v in
                        np.nonzero(d.tally.equiv[0].cpu().numpy())[0]}
    return res
