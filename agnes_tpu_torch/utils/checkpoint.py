"""Checkpoint / resume for the device consensus plane (twin of
`agnes_tpu.utils.checkpoint`).

A snapshot is a flat `.npz` of named leaves with the twin's names and
dtypes, so a snapshot written by either package loads in the other:
the driver's state and tally leaves (`state.*`, `tally.*`, int32 and
bool), its decided log (`stats.*`), its configuration (`cfg.*`) and an
int64 `meta` row; the batcher's slot maps, synced window, counters and
retained evidence log (`log.*`, with the pubkey tables of device-verify
builds).  Saving pulls every tensor to the host (one copy each);
loading re-uploads onto `device` (default "cuda").  Writes go to a
temporary file renamed over the target, so a crash mid-save never
clobbers the previous snapshot.

Host executors snapshot separately (`save_executor` /
`load_executor_into`): their state is a handful of Python scalars plus
the decided log and the evidence, one JSON document equal to the
twin's for the same executor.  The native ingest loop snapshots through
`save_native_loop` / `load_native_loop`: the twin's leaves (`meta`,
`powers`, `slots`, `log`, `counters`, `heights`, `base_round`), so a
snapshot of either package's loop loads in the other's.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from agnes_tpu_torch.device.encoding import (DeviceState, decode_state,
                                             encode_state, resolve_device)
from agnes_tpu_torch.device.tally import TallyState

_STATE_PREFIX = "state."
_TALLY_PREFIX = "tally."
_STATS_PREFIX = "stats."
_LOG_FIELDS = ("instance", "validator", "height", "round", "typ", "value")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _atomic_savez(path: str, leaves: dict) -> None:
    """Write-then-rename so a crash mid-save never clobbers the
    previous snapshot (shared by every .npz saver here)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **leaves)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_driver(driver, path: str) -> None:
    """Snapshot a harness.DeviceDriver (device tensors + stats) to
    `path` (.npz).  Pending vote and device-verify reject counts are
    settled first, so `stats` and `meta` are the twin's at the same
    point.  A driver on a mesh holds only its rank's block: refused
    (NotImplementedError)."""
    if getattr(driver, "mesh", None) is not None:
        raise NotImplementedError("save_driver takes a one-device driver; "
                                  "a mesh driver holds its rank's block")
    driver._settle_counts()
    leaves = {}
    for name, t in zip(DeviceState._fields, driver.state):
        leaves[_STATE_PREFIX + name] = _host(t)
    for name, t in zip(TallyState._fields, driver.tally):
        leaves[_TALLY_PREFIX + name] = _host(t)
    leaves[_STATS_PREFIX + "decided"] = driver.stats.decided
    leaves[_STATS_PREFIX + "decision_value"] = driver.stats.decision_value
    leaves[_STATS_PREFIX + "decision_round"] = driver.stats.decision_round
    # full driver configuration: a resumed driver must behave
    # identically (proposer schedule, powers, propose values)
    leaves["cfg.proposer_flag"] = _host(driver.proposer_flag)
    leaves["cfg.powers"] = _host(driver.powers)
    leaves["cfg.total"] = _host(driver.total)
    leaves["cfg.propose_value"] = _host(driver.propose_value)
    leaves["meta"] = np.asarray([driver.I, driver.V, driver.cfg.n_rounds,
                                 driver.cfg.n_slots,
                                 driver.stats.votes_ingested,
                                 driver.stats.steps,
                                 int(driver.advance_height),
                                 driver.stats.decisions_total], np.int64)
    _atomic_savez(path, leaves)


def load_driver(path: str, device="cuda"):
    """Rebuild a DeviceDriver on `device` from a snapshot."""
    from agnes_tpu_torch.harness.device_driver import DeviceDriver

    dev = resolve_device(device)
    with np.load(path) as z:
        meta = z["meta"]
        d = DeviceDriver(int(meta[0]), int(meta[1]),
                         n_rounds=int(meta[2]), n_slots=int(meta[3]),
                         advance_height=bool(meta[6]) if len(meta) > 6
                         else False, device=dev)

        def up(key):
            # copy: np.load's arrays are read-only
            return torch.from_numpy(np.array(z[key])).to(dev)

        def leaf(prefix, n, default):
            """Pre-rotation snapshots lack the newer leaves (height,
            base_round); they resume with the fresh-constructed zeros."""
            key = prefix + n
            return up(key) if key in z.files else default

        d.state = DeviceState(*[leaf(_STATE_PREFIX, n, getattr(d.state, n))
                                for n in DeviceState._fields])
        d.tally = TallyState(*[leaf(_TALLY_PREFIX, n, getattr(d.tally, n))
                               for n in TallyState._fields])
        d.proposer_flag = up("cfg.proposer_flag")
        d.powers = up("cfg.powers")
        d.total = up("cfg.total")
        d.propose_value = up("cfg.propose_value")
        d.stats.decided = z[_STATS_PREFIX + "decided"].copy()
        d.stats.decision_value = z[_STATS_PREFIX + "decision_value"].copy()
        d.stats.decision_round = z[_STATS_PREFIX + "decision_round"].copy()
        d.stats.votes_ingested = int(meta[4])
        d.stats.steps = int(meta[5])
        d.stats.decisions_total = int(meta[7]) if len(meta) > 7 else 0
    return d


# --- ingestion bridge snapshots ---------------------------------------------


def save_batcher(bat, path: str) -> None:
    """Persist a bridge.VoteBatcher's durable state: the slot<->value
    maps (without which device decision slots cannot be decoded after
    a crash), the synced window, counters, and the retained vote log —
    the slashing evidence.  In-flight votes (pending/held) and host
    fallback tallies are not persisted: a restarted node re-receives
    them from peers."""
    from agnes_tpu_torch.bridge.ingest import _concat

    leaves = {
        "meta": np.asarray(
            [bat.I, bat.V, bat.W, bat.slots.n_slots, bat.held_cap,
             bat.msm_leaf, bat.rejected_signature, bat.rejected_malformed,
             bat.overflow_votes, bat.dropped_stale_height,
             bat.dropped_held_overflow, bat.slots.overflowed], np.int64),
        "verify_mode": np.asarray(bat.verify_mode),
        "heights": bat.heights,
        "base_round": bat.base_round,
        "powers": bat.powers,
    }
    # slot maps as a dense [I, S] value-id array in slot order
    smap = np.full((bat.I, bat.slots.n_slots), -1, np.int64)
    for i, m in enumerate(bat.slots._maps):
        for vid, s in m.items():
            smap[i, s] = vid
    leaves["slot_values"] = smap
    if bat._log:
        log = _concat(bat._log)    # zero-fills sig-less batches (>1)
        for f in _LOG_FIELDS:
            leaves["log." + f] = getattr(log, f)
        if log.signature is not None:
            leaves["log.signature"] = log.signature
            # per-row mask keeps zero-filled rows None after restore
            # (all-zero bytes must never surface as 'signed' evidence)
            leaves["log.has_sig"] = np.concatenate(
                [np.full(len(b), b.signature is not None)
                 for b in bat._log])
        # device-verify evidence epochs: per-row index into a stacked
        # table set, -1 = logged post-screen (trusted), so a restore
        # re-verifies pre-verdict rows against the same pubkey epoch
        tables: list = []
        row_ep = []
        for b, pk in zip(bat._log, bat._log_pk):
            if pk is None:
                row_ep.append(np.full(len(b), -1, np.int64))
                continue
            pk = np.asarray(pk)
            for j, t in enumerate(tables):
                if np.array_equal(t, pk):
                    idx = j
                    break
            else:
                tables.append(pk)
                idx = len(tables) - 1
            row_ep.append(np.full(len(b), idx, np.int64))
        if tables:
            leaves["log.pk_epoch"] = np.concatenate(row_ep)
            leaves["log.pk_tables"] = np.stack(tables)
    _atomic_savez(path, leaves)


def load_batcher(path: str, device="cuda"):
    """Rebuild a VoteBatcher on `device` from a snapshot (decoding and
    evidence extraction work at once; in-flight votes re-arrive from
    peers)."""
    from agnes_tpu_torch.bridge.ingest import VoteBatcher, _Batch

    with np.load(path) as z:
        m = z["meta"]
        bat = VoteBatcher(int(m[0]), int(m[1]), int(m[3]),
                          heights=z["heights"], n_rounds=int(m[2]),
                          powers=z["powers"], held_cap=int(m[4]),
                          verify_mode=str(z["verify_mode"]),
                          msm_leaf=int(m[5]), device=device)
        bat.base_round = z["base_round"].astype(np.int64)
        (bat.rejected_signature, bat.rejected_malformed,
         bat.overflow_votes, bat.dropped_stale_height,
         bat.dropped_held_overflow) = (int(x) for x in m[6:11])
        bat.slots.overflowed = int(m[11])
        smap = z["slot_values"]
        for i, s in zip(*np.nonzero(smap >= 0)):
            bat.slots._maps[int(i)][int(smap[i, s])] = int(s)
        if "log.instance" in z.files:
            cols = tuple(z["log." + f] for f in _LOG_FIELDS)
            n_rows = len(cols[0])
            ep = (z["log.pk_epoch"] if "log.pk_epoch" in z.files
                  else np.full(n_rows, -1, np.int64))
            tables = (z["log.pk_tables"] if "log.pk_tables" in z.files
                      else None)
            has = (z["log.has_sig"] if "log.signature" in z.files
                   else np.zeros(n_rows, bool))
            sig = z["log.signature"] if "log.signature" in z.files else None
            # Rebuild preserving the arrival interleaving: split the
            # rows into maximal runs of constant (signedness, evidence
            # epoch) — the original batch boundaries are gone, but run
            # order is arrival order — so signed_evidence scans rows in
            # the same order and re-verifies pre-verdict rows against
            # the same pubkey epoch before and after a restore.
            key = has.astype(np.int64) * (int(ep.max()) + 2) + ep
            cuts = np.flatnonzero(np.diff(key))
            bounds = np.concatenate(([0], cuts + 1, [n_rows]))
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                bat._log.append(_Batch(
                    *(c[lo:hi] for c in cols),
                    sig[lo:hi] if has[lo] else None))
                bat._log_pk.append(tables[ep[lo]] if ep[lo] >= 0 else None)
    return bat


def save_native_loop(loop, path: str) -> None:
    """Persist a `bridge.NativeIngestLoop`'s durable state (the policy
    of `save_batcher`: slot decode, evidence log, counters, window;
    in-flight votes re-arrive from peers)."""
    st = loop.export_state()
    leaves = {"meta": np.asarray(
        [loop.I, loop.V, loop._n_rounds, loop._n_slots,
         int(loop.signed), loop.held_cap], np.int64)}
    if loop._powers is not None:
        leaves["powers"] = loop._powers
    leaves.update(st)
    _atomic_savez(path, leaves)


def load_native_loop(path: str, pubkeys=None, powers=None, device="cuda"):
    """Rebuild a NativeIngestLoop on `device` from a snapshot.  A loop
    saved with signature verification on must be given the pubkey table
    again (it is the validator set, not snapshot-private state); voting
    powers and the held cap restore from the snapshot unless
    overridden."""
    from agnes_tpu_torch.bridge.native_ingest import NativeIngestLoop

    with np.load(path) as z:
        m = z["meta"]
        if bool(m[4]) and pubkeys is None:
            raise ValueError(
                "snapshot was taken with signature verification on; "
                "pass the validator pubkey table")
        if powers is None and "powers" in z.files:
            powers = z["powers"]
        loop = NativeIngestLoop(int(m[0]), int(m[1]), n_slots=int(m[3]),
                                n_rounds=int(m[2]), pubkeys=pubkeys,
                                powers=powers, held_cap=int(m[5]),
                                device=device)
        loop.import_state({k: z[k] for k in
                           ("slots", "log", "counters", "heights",
                            "base_round")})
    return loop


# --- host executor snapshots ------------------------------------------------


def save_executor(ex, path: str) -> None:
    """Persist a ConsensusExecutor's progress: height, state fields, the
    decided log, the clock and the evidence (votes in flight are not
    persisted: on resume the node rejoins at its height and catches up
    from peers, the same crash-recovery story as any BFT node)."""
    s = encode_state(ex.state)
    doc = {
        "height": ex.height,
        "state": {f: int(getattr(s, f)) for f in s._fields},
        "decided": {h: [d.height, d.round, d.value]
                    for h, d in ex.decided.items()},
        "now": ex.wheel.now,
        # slashing evidence survives restarts: archived records plus the
        # live height's (the live VoteExecutor is not persisted, so its
        # equivocations would otherwise vanish with it)
        "evidence": [[e.height, e.round, int(e.typ), e.validator,
                      e.first_value, e.second_value]
                     for e in ex.all_equivocations()],
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_executor_into(ex, path: str) -> Tuple[int, dict]:
    """Restore height/state/decisions/evidence into a freshly built
    executor (same validator set and seed).  Returns (height, decided)."""
    from agnes_tpu_torch.core.executor import Decision
    from agnes_tpu_torch.core.round_votes import Equivocation
    from agnes_tpu_torch.core.vote_executor import VoteExecutor
    from agnes_tpu_torch.types import VoteType

    with open(path) as f:
        doc = json.load(f)
    ex.height = doc["height"]
    ex.evidence = [Equivocation(h, r, VoteType(t), v, fv, sv)
                   for h, r, t, v, fv, sv in doc["evidence"]]
    ds = DeviceState(*[np.int32(doc["state"][f])
                       for f in DeviceState._fields])
    ex.state = decode_state(ds, height=ex.height)
    ex.decided = {int(h): Decision(*v) for h, v in doc["decided"].items()}
    ex.decisions = sorted(ex.decided.values(), key=lambda d: d.height)
    ex.votes = VoteExecutor(height=ex.height,
                            total_weight=ex.vset.total_power,
                            edge_triggered=True)
    ex.wheel.now = doc["now"]
    return ex.height, ex.decided
