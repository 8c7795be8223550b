"""Scenarios of the port's sharded step, and the ranks that run them.

`tests/test_torch_sharded.py` spawns a `gloo` world of four CPU ranks
(`run_world`: a `file://` rendezvous, no network) over a flat 2 x 2 or a
hierarchical 2 x 1 x 2 mesh; every rank runs every scenario (`SCRIPTS`,
`DRIVES`, the dense height at each chunk) on the mesh, and rank 0
writes the gathered global results to an .npz.  The test runs the same scenario functions with `mesh=None`
(one device) and holds the two leaf for leaf.  This module imports
neither JAX nor the JAX package, so the spawned ranks load only torch
and the port.
"""

from __future__ import annotations

import numpy as np
import torch

from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.core.state_machine import EventTag
from agnes_tpu_torch.device.encoding import DeviceState
from agnes_tpu_torch.device.step import ExtEvent, VotePhase, consensus_step
from agnes_tpu_torch.device.tally import TallyConfig, TallyState
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.parallel import (
    gather_step_outputs,
    make_hierarchical_mesh,
    make_mesh,
    make_sharded_step,
    shard_step_args,
)
from agnes_tpu_torch.types import NIL_ID, VoteType

I, V = 8, 4                 # the scripted scenarios (tests/test_sharded.py)
CFG = TallyConfig(n_validators=V, n_rounds=4, n_slots=4)
VAL = 2
PV, PC = int(VoteType.PREVOTE), int(VoteType.PRECOMMIT)
I_DENSE, V_DENSE, FORGED = 6, 4, 1   # 3 rows a data block: chunk 2 is ragged
DENSE_CHUNKS = (None, 1, 2)
JAX_PHASES = ((0, PV, 1), (0, PV, 2), (0, PC, 1))   # the JAX-held step_seq


def _i32(*shape, fill=0):
    return torch.full(shape, fill, dtype=torch.int32)


def _phase(round_, typ, votes):
    slots, mask = _i32(I, V, fill=-1), torch.zeros((I, V), dtype=torch.bool)
    for v, s in votes.items():
        slots[:, v] = s
        mask[:, v] = True
    return VotePhase(_i32(I, fill=round_), _i32(I, fill=int(typ)), slots,
                     mask, _i32(I))


def _empty():
    return _phase(0, 0, {})


def _ext(tag=None, round_=0):
    if tag is None:
        return ExtEvent.none(I, "cpu")
    return ExtEvent(_i32(I, fill=tag), _i32(I, fill=round_),
                    _i32(I, fill=NIL_ID), _i32(I, fill=-1))


def _np(tree, prefix):
    return {f"{prefix}.{f}": x.numpy().copy()
            for f, x in zip(tree._fields, tree)}


def run_script(mesh, script, advance=False):
    """(ext, phase, proposer) steps through `make_sharded_step` on
    `shard_step_args` of the global arguments (the global state
    gathered back after every step), or `consensus_step` without a
    mesh.  Returns every step's global state, tally and messages, and
    the census of the sharded steps."""
    state = DeviceState.new((I,), device="cpu")
    tally = TallyState.new(I, CFG, device="cpu")
    powers = torch.ones(V, dtype=torch.int32)
    total = torch.tensor(V, dtype=torch.int32)
    out, census = {}, {}
    if mesh is not None:
        step = make_sharded_step(mesh, advance_height=advance)
    for k, (ext, ph, proposer) in enumerate(script):
        ph = ph._replace(height=state.height.clone())
        args = (state, tally, ext, ph, powers, total,
                torch.full((I, CFG.n_rounds), proposer, dtype=torch.bool),
                _i32(I, fill=VAL))
        if mesh is None:
            o = consensus_step(*args, advance_height=advance)
        else:
            o = gather_step_outputs(mesh, step(*shard_step_args(mesh,
                                                                *args)))
            census = dict(step.census)
        state, tally = o.state, o.tally
        for part in ("state", "tally", "msgs"):
            out.update(_np(getattr(o, part), f"{k}.{part}"))
    return out, census


ALLV = {v: VAL for v in range(V)}
NILV = {v: -1 for v in range(V)}

SCRIPTS = {
    "happy_path": ([
        (_ext(), _empty(), True),
        (_ext(), _phase(0, PV, {0: VAL, 1: VAL, 2: VAL}), True),
        (_ext(), _phase(0, PC, {0: VAL, 1: VAL, 2: VAL}), True)], False),
    "round_skip": ([(_ext(), _phase(2, PV, {1: VAL, 3: VAL}), True)],
                   False),
    "nil_timeout_round": ([
        (_ext(), _empty(), False),
        (_ext(int(EventTag.TIMEOUT_PROPOSE), 0), _empty(), False),
        (_ext(), _phase(0, PV, NILV), False),
        (_ext(), _phase(0, PC, NILV), False),
        (_ext(int(EventTag.TIMEOUT_PRECOMMIT), 0), _empty(), False),
        (_ext(), _empty(), True),
        (_ext(), _phase(1, PV, ALLV), True),
        (_ext(), _phase(1, PC, ALLV), True)], False),
    "equivocation": ([
        (_ext(), _phase(0, PV, {0: VAL, 3: VAL}), True),
        (_ext(), _phase(0, PV, {0: VAL + 1, 3: VAL + 1}), True),
        (_ext(), _phase(2, PV, {1: VAL, 2: VAL}), True)], False),
    "window_rotation": ([
        (_ext(), _phase(2, PV, {1: VAL, 3: VAL}), False),
        (_ext(int(EventTag.TIMEOUT_PRECOMMIT), 2), _empty(), False),
        (_ext(int(EventTag.TIMEOUT_PRECOMMIT), 3), _empty(), False),
        (_ext(int(EventTag.TIMEOUT_PRECOMMIT), 4), _empty(), False),
        (_ext(), _phase(5, PV, ALLV), False)], False),
    "multi_height": ([
        (_ext(), _empty(), True),
        (_ext(), _phase(0, PV, ALLV), True),
        (_ext(), _phase(0, PC, ALLV), True)] * 2, True),
}


def _driver_result(d):
    """A driver's global state, tally and stats, as numpy."""
    state, tally = d.state_copies()
    out = {**_np(state, "state"), **_np(tally, "tally")}
    d.collect()
    st = d.stats
    out.update({"stats.decided": st.decided.copy(),
                "stats.decision_value": st.decision_value.copy(),
                "stats.decision_round": st.decision_round.copy(),
                "stats.counts": np.array([st.votes_ingested, st.steps,
                                          st.decisions_total,
                                          d.rejected_signature_device]),
                "equivocators": d.equivocators_detected()})
    return out


def _census(d):
    """{entry: census} of a mesh driver's sharded entries."""
    return {key[0]: dict(fn.census) for key, fn in
            getattr(d, "_sharded", {}).items()}


def drive_step_seq(mesh):
    d = DeviceDriver(8, 8, mesh=mesh, device="cpu")
    d.step_seq([d.phase(r, t, s) for r, t, s in JAX_PHASES])
    return _driver_result(d), _census(d)


def drive_heights(mesh):
    d = DeviceDriver(8, 8, advance_height=True, mesh=mesh, device="cpu")
    d.run_heights_fused(3)
    return _driver_result(d), _census(d)


def drive_closed_loop(mesh):
    """Config 3's small shape (8 x 64): a nil round with timeouts, then a
    proposed round to decision, through the driver's step()."""
    d = DeviceDriver(8, 64, proposer_is_self=False, mesh=mesh, device="cpu")
    d.run_nil_round(0)
    d.run_proposed_round(1, slot=1)
    return _driver_result(d), _census(d)


def drive_dense(mesh, chunk):
    """One dense signed height at 6 x 4, validator FORGED forged in both
    classes: the entry step, then build_phases_device_dense ->
    step_seq_signed_dense at `chunk` rows a verify launch; with the
    census of the dense dispatch."""
    seeds = fx.deterministic_seeds(V_DENSE)
    pubkeys = fx.validator_pubkeys(seeds)
    d = DeviceDriver(I_DENSE, V_DENSE, mesh=mesh, verify_chunk=chunk,
                     device="cpu")
    b = VoteBatcher(I_DENSE, V_DENSE, n_slots=4, device="cpu")
    d.step()
    state, tally = d.state_copies()
    b.sync_device(tally.base_round.numpy(), state.height.numpy())
    for typ in (PV, PC):
        b.add_arrays(*fx.full_mesh_cols(I_DENSE, V_DENSE, seeds, 0, typ, 7,
                                        forge_validator=FORGED))
    phases, dense = b.build_phases_device_dense(pubkeys)
    if dense is None:
        raise AssertionError("the dense build fell back to the host")
    d.step_seq_signed_dense([p for p, _ in phases], dense)
    return _driver_result(d), _census(d)


DRIVES = {
    "step_seq": drive_step_seq,
    "run_heights_fused": drive_heights,
    "closed_loop": drive_closed_loop,
}


def run_all(mesh, chunks=DENSE_CHUNKS):
    """Every scenario on `mesh` (or one device), the dense height at each
    of `chunks`: {"name/leaf": array}, the census entries under
    "census/<name>/<entry>/<axis>"."""
    drives = dict(DRIVES)
    drives.update({f"dense_chunk_{c}": (lambda m, c=c: drive_dense(m, c))
                   for c in chunks})
    out = {}
    for name, (script, advance) in SCRIPTS.items():
        res, census = run_script(mesh, script, advance)
        out.update({f"{name}/{k}": v for k, v in res.items()})
        out.update({f"census/{name}/step/{a}": np.array(n)
                    for a, n in census.items()})
    for name, drive in drives.items():
        res, census = drive(mesh)
        out.update({f"{name}/{k}": v for k, v in res.items()})
        for entry, c in census.items():
            out.update({f"census/{name}/{entry}/{a}": np.array(n)
                        for a, n in c.items()})
    return out


def run_world(rank: int, world: int, init_file: str, out_path: str,
              kind: str) -> None:
    """One rank of a gloo world: the mesh (`kind` "flat": 2 x 2,
    "hier": 2 x 1 x 2), every scenario, rank 0 writes the results."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = (make_mesh(2, 2, device_type="cpu") if kind == "flat"
                else make_hierarchical_mesh(2, 1, 2, device_type="cpu"))
        out = run_all(mesh)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
