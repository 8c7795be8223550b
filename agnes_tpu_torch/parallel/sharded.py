"""The consensus step sharded over a mesh: instances over the data axes,
validators over `val` (twin of `agnes_tpu.parallel.sharded`).

Layout (I = instances, V = validators, W = rounds, S = slots; ``data*``
is the instance axis set, ("data",) on a flat mesh and ("slice",
"data") on a hierarchical one, slice-major):

  =================  ==================  =========================
  array              shape               block (spec)
  =================  ==================  =========================
  DeviceState.*      [I]                 (data*,)
  tally.weights      [I, W, 2, S+1]      (data*,)       replicated over val
  tally.voted        [I, W, 2, V]        (data*,,,val)  the per-validator record
  tally.emitted      [I, W, 2]           (data*,)
  tally.skipped      [I, W]              (data*,)
  tally.equiv        [I, V]              (data*, val)
  ExtEvent.*         [I]                 (data*,)
  phase.round/typ    [I]                 (data*,)
  phase.slots/mask   [I, V]              (data*, val)
  powers             [V]                 (val,)
  total_power        []                  ()
  proposer_flag      [I, R]              (data*,)
  propose_value      [I]                 (data*,)
  dense pub          [V, 32]             (val,)
  dense sig/blocks   [Ps, I, V, ...]     (, data*, val)
  msgs out           [..., n_stages, I]  (..., data*)
  n_rejected out     [I]                 (data*,)
  =================  ==================  =========================

The one table (`_TALLY` and its neighbours below) serves both ways:
`shard_step_args` / `place_step_state` / `shard_tree` cut a rank's block
out of global arguments on the rank's device, and
`gather_step_outputs` / `gather_tree` rebuild global values from every
rank's blocks (one `all_gather` over the default group when the mesh is
the world; over the mesh's own axis groups when it is a pod host's
sub-mesh, where "global" is the host's block), for read-outs and tests.
A rank finds its block by its position in the mesh, whose entries are
world ranks, so a sub-mesh places its ranks as a mesh of its own.

Only the tally's two validator reductions communicate, plus the dense
step's rejected count: `all_reduce`s over the mesh's `val` group
(`device/tally.psum`).  The state machine replicates over val; nothing
reduces over `slice` or `data`, and the dense step's tile loop adds no
collective.  Each factory's callable keeps the census of the collectives
its dispatches issued, by mesh axis (`ShardedStep.last_census`,
`.census`): the port's stand-in for the twin's
`jaxpr_audit.collective_census`.

Departures from the twin: one process per device (parallel/mesh.py), so
a factory returns a callable on a rank's local blocks (the twin's
`shard_map` takes global arrays), and `shard_step_args` slices where the
twin's places.  The twin's `donate` and its memo of jitted factories
have no meaning here: a torch step returns fresh tensors and compiles
nothing.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from agnes_tpu_torch.device import tally as _tally
from agnes_tpu_torch.device.encoding import I32, DeviceMessage, DeviceState
from agnes_tpu_torch.device.step import (
    DenseSignedPhases,
    ExtEvent,
    SignedStepOutputs,
    StepOutputs,
    VotePhase,
    consensus_step,
    consensus_step_seq,
    consensus_step_seq_signed_dense,
    honest_heights,
)
from agnes_tpu_torch.device.tally import TallyState
from agnes_tpu_torch.parallel.mesh import DATA_AXIS, SLICE_AXIS, VAL_AXIS

#: the instance axis set of the layout table: data, or slice x data
DATA = "data*"

_I = (DATA,)
_IV = (DATA, VAL_AXIS)
_STATE = DeviceState(*[_I] * len(DeviceState._fields))
_TALLY = TallyState(
    weights=_I,
    voted=(DATA, None, None, VAL_AXIS),
    emitted=_I,
    skipped=_I,
    equiv=_IV,
    q_round=_I,
    q_step=_I,
    pc_done=_I,
    skip_w=_I,
    base_round=_I,
)
_EXT = ExtEvent(*[_I] * len(ExtEvent._fields))
_PHASE = VotePhase(round=_I, typ=_I, slots=_IV, mask=_IV, height=_I)
_POWERS = (VAL_AXIS,)
_TOTAL = ()
_DENSE = DenseSignedPhases(pub=(VAL_AXIS,), sig=(None, DATA, VAL_AXIS),
                           blocks=(None, DATA, VAL_AXIS))


def _seq(spec_tree):
    """Widen every spec of a tuple tree with a leading whole axis (the
    sequence axis of stacked exts / phases, [P, ...] leaves)."""
    return type(spec_tree)(*[(None,) + s for s in spec_tree])


def step_specs():
    """(state, tally, ext, phase, powers, total, proposer_flag,
    propose_value) block specs of `consensus_step`."""
    return (_STATE, _TALLY, _EXT, _PHASE, _POWERS, _TOTAL, _I, _I)


def seq_specs():
    """The step-sequence specs: exts and phases carry a leading [P]."""
    s = step_specs()
    return (s[0], s[1], _seq(s[2]), _seq(s[3])) + s[4:]


def dense_lane_specs() -> DenseSignedPhases:
    """Block specs of the dense signed lanes (DenseSignedPhases)."""
    return _DENSE


def msgs_spec(ndim: int) -> tuple:
    """A message leaf's spec: instances last, every leading axis whole."""
    return (None,) * (ndim - 1) + (DATA,)


# -- a rank's block ------------------------------------------------------------


def _extents(mesh) -> Dict[str, int]:
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {DATA: size.get(SLICE_AXIS, 1) * size[DATA_AXIS],
            VAL_AXIS: size[VAL_AXIS]}


def _coords_of(mesh, rank: int) -> Dict[str, int]:
    """{axis set: block index} of `rank` (data* slice-major)."""
    at = (mesh.mesh == rank).nonzero()
    if at.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    c = dict(zip(mesh.mesh_dim_names, at[0].tolist()))
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {DATA: c.get(SLICE_AXIS, 0) * size[DATA_AXIS] + c[DATA_AXIS],
            VAL_AXIS: c[VAL_AXIS]}


def _take(x: torch.Tensor, spec, at: Dict[str, int], n: Dict[str, int]):
    """The block of `x` at block coordinates `at` (a view)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = x.shape[dim]
        if size % n[axis]:
            raise ValueError(f"dim {dim} of size {size} does not split "
                             f"over {n[axis]} {axis} blocks")
        c = size // n[axis]
        x = x.narrow(dim, at[axis] * c, c)
    return x


def shard_tree(mesh, tree, spec_tree):
    """This rank's blocks (views) of a (named) tuple of global tensors,
    per a matching tuple of specs.  The global tensors live on the
    rank's device, so its blocks do too."""
    at, n = _coords_of(mesh, dist.get_rank()), _extents(mesh)

    def one(x, spec):
        if isinstance(x, tuple):              # a NamedTuple of leaves
            return type(x)(*[one(a, s) for a, s in zip(x, spec)])
        return _take(x, spec, at, n)

    return one(tree, spec_tree)


def shard_step_args(mesh, state, tally, ext, phase, powers, total_power,
                    proposer_flag, propose_value):
    """This rank's blocks of `consensus_step`'s global arguments, per the
    layout table."""
    args = (state, tally, ext, phase, powers, total_power, proposer_flag,
            propose_value)
    return tuple(shard_tree(mesh, a, s) for a, s in zip(args, step_specs()))


def place_step_state(mesh, state, tally):
    """This rank's blocks of a global (state, tally), copied (they own
    their memory, so the global copies can go)."""
    st, ta = (shard_tree(mesh, t, s)
              for t, s in ((state, _STATE), (tally, _TALLY)))
    return (DeviceState(*[x.clone() for x in st]),
            TallyState(*[x.clone() for x in ta]))


# -- global values from every rank's blocks ------------------------------------


def _all_blocks(mesh, flat: torch.Tensor):
    """(ranks, buffers): every rank of `mesh` and its `flat` buffer.  A
    mesh that is the world gathers in one `all_gather` over the default
    group; a sub-mesh (a pod host's, distributed/driver.py) in
    one over each of its axes' groups, innermost first, which hold only
    its ranks, so ranks outside it take no part.  Axes of one rank
    gather nothing.  Buffers come in row-major mesh order."""
    world = dist.get_world_size()
    if world == mesh.mesh.numel():
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat)
        return list(range(world)), parts
    parts = [flat]
    for dim in reversed(range(mesh.ndim)):
        k = mesh.shape[dim]
        if k == 1:
            continue
        buf = torch.cat(parts)
        got = [torch.empty_like(buf) for _ in range(k)]
        dist.all_gather(got, buf, group=mesh.get_group(dim))
        parts = [p for g in got for p in g.split(flat.numel())]
    return mesh.mesh.reshape(-1).tolist(), parts


def gather_tree(mesh, leaves: Sequence[torch.Tensor],
                specs: Sequence[tuple]) -> List[torch.Tensor]:
    """The global tensors (of the mesh: a pod host's block on a host's
    sub-mesh) whose blocks (per `specs`) the mesh's ranks hold in
    `leaves`: every leaf packed into one int32 buffer and all-gathered
    over the mesh's ranks (`_all_blocks`).  Replicated blocks are read
    from the first rank that holds them.  Int32 and bool leaves."""
    n = _extents(mesh)
    flat = torch.cat([x.reshape(-1).to(I32) for x in leaves]) if leaves \
        else torch.zeros((0,), dtype=I32)
    ranks, parts = _all_blocks(mesh, flat.contiguous())
    out = []
    for x, spec in zip(leaves, specs):
        shape = list(x.shape)
        for dim, axis in enumerate(spec):
            if axis is not None:
                shape[dim] *= n[axis]
        out.append(torch.empty(shape, dtype=x.dtype, device=x.device))
    filled = [set() for _ in leaves]
    for r, part in zip(ranks, parts):
        at = _coords_of(mesh, r)
        off = 0
        for k, (x, spec) in enumerate(zip(leaves, specs)):
            m = x.numel()
            key = tuple(at[a] for a in spec if a is not None)
            if key not in filled[k]:
                filled[k].add(key)
                _take(out[k], spec, at, n).copy_(
                    part[off:off + m].reshape(x.shape).to(x.dtype))
            off += m
    return out


def gather_state(mesh, state, tally):
    """The global (state, tally) of every rank's blocks, on every rank."""
    g = gather_tree(mesh, list(state) + list(tally),
                    list(_STATE) + list(_TALLY))
    return DeviceState(*g[:len(state)]), TallyState(*g[len(state):])


def gather_step_outputs(mesh, out):
    """The global StepOutputs / SignedStepOutputs of a sharded dispatch
    (every rank gets all of it): state, tally, messages and, for a
    signed step, the per-instance rejected counts."""
    leaves = list(out.state) + list(out.tally) + list(out.msgs)
    specs = (list(_STATE) + list(_TALLY)
             + [msgs_spec(m.ndim) for m in out.msgs])
    signed = isinstance(out, SignedStepOutputs)
    if signed:
        leaves.append(out.n_rejected)
        specs.append(_I)
    g = gather_tree(mesh, leaves, specs)
    ns, nt, nm = len(out.state), len(out.tally), len(out.msgs)
    state = DeviceState(*g[:ns])
    tally = TallyState(*g[ns:ns + nt])
    msgs = DeviceMessage(*g[ns + nt:ns + nt + nm])
    if signed:
        return SignedStepOutputs(state=state, tally=tally, msgs=msgs,
                                 n_rejected=g[-1])
    return StepOutputs(state=state, tally=tally, msgs=msgs)


# -- the sharded factories -----------------------------------------------------


class ShardedStep:
    """One step entry on a rank's local blocks, its validator reductions
    all-reduced over the mesh's `val` group.  Counts the collectives
    each call issued by mesh axis: `last_census` (the last dispatch)
    and `census` (every dispatch); "other" counts any on a group that
    is no axis of the mesh (none, by design).  A process group that
    several axes share (an axis of one rank, or one spanning the whole
    world, can be the world's group) is counted under the first of
    val, data, slice that has it."""

    def __init__(self, mesh, fn, **statics):
        self.mesh = mesh
        self._fn = fn
        self._statics = statics
        names = [VAL_AXIS] + [n for n in (DATA_AXIS, SLICE_AXIS)
                              if n in mesh.mesh_dim_names]
        self._groups = [(n, mesh.get_group(n)) for n in names]
        self._val = self._groups[0][1]
        self.census: collections.Counter = collections.Counter()
        self.last_census: Dict[str, int] = {}

    def __call__(self, *local_args):
        before = dict(_tally.COLLECTIVES)
        out = self._fn(*local_args, group=self._val, **self._statics)
        delta = {g: n - before.get(g, 0)
                 for g, n in _tally.COLLECTIVES.items()}
        last = {}
        for name, g in self._groups:
            last[name] = delta.pop(g, 0)
        last["other"] = sum(delta.values())
        self.last_census = last
        self.census.update(last)
        return out


def make_sharded_step(mesh, advance_height: bool = False) -> ShardedStep:
    """`consensus_step` on a rank's blocks (`shard_step_args`)."""
    return ShardedStep(mesh, consensus_step, advance_height=advance_height)


def make_sharded_step_seq(mesh, advance_height: bool = False) -> ShardedStep:
    """`consensus_step_seq` on a rank's blocks: P phases in one call,
    exts and phases with their leading [P] whole (`seq_specs`); msgs
    come back [P, n_stages, I_local]."""
    return ShardedStep(mesh, consensus_step_seq,
                       advance_height=advance_height)


def make_sharded_step_seq_signed(mesh, advance_height: bool = False,
                                 verify_chunk: Optional[int] = None
                                 ) -> ShardedStep:
    """`consensus_step_seq_signed_dense` on a rank's blocks: the dense
    lanes shard like the phase masks and the pub table like powers
    (`dense_lane_specs`), so each rank verifies its own cells; called
    as f(state, tally, exts, phases, dense, powers, total,
    proposer_flag, propose_value).  `verify_chunk` counts the rank's
    own instance rows (plan on `utils/budget.mesh_local_shape`).
    n_rejected comes back [I_local], all-reduced over val."""
    return ShardedStep(mesh, consensus_step_seq_signed_dense,
                       advance_height=advance_height,
                       verify_chunk=verify_chunk)


def make_sharded_honest_heights(mesh, heights: int) -> ShardedStep:
    """`honest_heights` on a rank's blocks: f(state, tally, slots,
    mask, powers, total, proposer_flag, propose_value), slots and mask
    (data*, val)."""
    return ShardedStep(mesh, honest_heights, heights=heights)


def honest_specs() -> Tuple[tuple, ...]:
    """Block specs of `honest_heights`' arguments."""
    s = step_specs()
    return (s[0], s[1], _IV, _IV) + s[4:]
