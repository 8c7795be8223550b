"""Port differential: the elastic pod's membership math and frame codec
against the JAX twin, in process, on inputs made with numpy from a seed.

`agnes_tpu_torch.distributed.membership` and the elastic frame codec of
`agnes_tpu_torch.distributed.elastic` held against
`agnes_tpu.distributed.membership` / `.elastic`, integers and bytes
exact: the range repartition and its errors over seeded host sets; the
spec-tree re-lift leaf for leaf over blocks whose instance axes come
from the port's `seq_specs()` / `dense_lane_specs()` (the axis lists
equal to the twin's over its PartitionSpecs); the tick-plan merge and
its kind-divergence error; seeded intent / tick / boundary schedules
driving both MembershipEpochs, compared after every step; the elastic
frame byte for byte, each package's unpack reading the other's frames.
Then the twin's own jax-free cases of `tests/test_elastic.py` for these
modules, each run on both packages.
"""

import dataclasses

import numpy as np
import pytest

from agnes_tpu.distributed import elastic as je
from agnes_tpu.distributed import membership as jm
from agnes_tpu.distributed import topology as jt
from agnes_tpu_torch.distributed import elastic as te
from agnes_tpu_torch.distributed import membership as tm
from agnes_tpu_torch.distributed import topology as tt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEED = 20261018
PKGS = {"port": (tm, te, tt), "twin": (jm, je, jt)}


def _outcome(fn):
    """("ok", value) or ("raise", the error's class name)."""
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raise", type(e).__name__)


def _view(v):
    return (v.epoch, v.n_hosts, v.n_instances, v.alive,
            tuple(sorted(v.ranges.items())))


def _rep(r):
    if r is None:
        return None
    return (_view(r.old), _view(r.new), r.transfers, r.joined, r.left)


# -- range repartition --------------------------------------------------------

@pytest.mark.parametrize("k", range(6))
def test_partition_and_relift_ranges_equal_twin(k):
    rng = np.random.RandomState(SEED + k)
    n_hosts = int(rng.randint(1, 9))
    n = int(rng.choice([0, 7, 12, 24, 60, 840]))
    for _ in range(12):
        hosts = [int(h) for h in rng.choice(n_hosts, rng.randint(0, 5))]
        got = _outcome(lambda: tm.partition_ranges(n, hosts))
        assert got == _outcome(lambda: jm.partition_ranges(n, hosts))
        if got[0] == "raise":
            assert got[1] == "MembershipError"
            continue
        tm.validate_partition(got[1], n)
        other = [int(h) for h in rng.choice(n_hosts, rng.randint(1, 5))]
        new = _outcome(lambda: tm.partition_ranges(n, other))
        if new[0] == "ok":
            assert tm.relift_ranges(got[1], new[1]) == \
                jm.relift_ranges(got[1], new[1])


@pytest.mark.parametrize("k", range(4))
def test_validate_partition_verdicts_equal_twin(k):
    """Seeded, often broken partitions: both packages accept the same
    ones and refuse the others with the same message."""
    rng = np.random.RandomState(SEED + 100 + k)
    n = 16
    for _ in range(24):
        cuts = np.sort(rng.randint(-1, n + 2, size=2 * rng.randint(1, 4)))
        ranges = {h: (int(cuts[2 * h]), int(cuts[2 * h + 1]))
                  for h in range(len(cuts) // 2)}
        msgs = []
        for mod in (tm, jm):
            try:
                mod.validate_partition(ranges, n)
                msgs.append(None)
            except mod.MembershipError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1]


# -- spec-tree re-lift --------------------------------------------------------

def _flat_specs(tree):
    """The spec leaves of a (state, tally, ..., scalar, ...) spec tree:
    named tuples are opened one level, a spec itself is a leaf (the
    twin's PartitionSpec is a tuple subclass, so no deeper)."""
    out = []
    for x in tree:
        if hasattr(x, "_fields"):
            out.extend(x)
        else:
            out.append(x)
    return out


@pytest.fixture(scope="module")
def spec_axes():
    """{layout: (port axes, twin axes, port specs)} for the step
    sequence's specs and the dense lanes' on a flat and a hierarchical
    mesh (the twin's instance axes widen with the slice axis)."""
    import jax
    from jax.sharding import Mesh

    from agnes_tpu.parallel import sharded as js
    from agnes_tpu_torch.parallel import sharded as ts

    dev = np.array(jax.devices()[:1])
    meshes = {"flat": Mesh(dev.reshape(1, 1), ("data", "val")),
              "hier": Mesh(dev.reshape(1, 1, 1), ("slice", "data", "val"))}
    out = {}
    for name, mesh in meshes.items():
        da = js._data_axes(mesh)
        for what, port, twin in (
                ("seq", ts.seq_specs(), js.seq_in_specs(mesh)),
                ("dense", ts.dense_lane_specs(),
                 js.dense_lane_specs(mesh))):
            pt = (_flat_specs([port]) if what == "dense"
                  else _flat_specs(port))
            jt_ = (_flat_specs([twin]) if what == "dense"
                   else _flat_specs(twin))
            out[f"{what}-{name}"] = (
                [tm.instance_axis_of(s) for s in pt],
                [jm.instance_axis_of(s, da) for s in jt_], pt)
    assert ts.DATA == tm.INSTANCE_AXIS
    return out


@pytest.mark.parametrize("layout", ["seq-flat", "seq-hier", "dense-flat",
                                    "dense-hier"])
def test_instance_axes_of_the_port_specs_equal_twin(spec_axes, layout):
    port, twin, specs = spec_axes[layout]
    assert port == twin
    assert len(port) == len(specs)
    assert any(a is None for a in port) or layout.startswith("dense")
    assert any(a is not None and a > 0 for a in port)   # [P, I, ...] leaves


@pytest.mark.parametrize("layout,moves", [
    ("seq-flat", "leave"), ("seq-hier", "rejoin"),
    ("dense-flat", "leave"), ("dense-hier", "three-to-two")])
def test_relift_tree_equals_twin_leaf_for_leaf(spec_axes, layout, moves):
    rng = np.random.RandomState(SEED + len(layout) + len(moves))
    axes = spec_axes[layout][0]
    n = 12
    old, new = {
        "leave": ({0: (0, 6), 1: (6, 12)}, {0: (0, 12)}),
        "rejoin": ({1: (0, 12)}, {0: (0, 6), 1: (6, 12)}),
        "three-to-two": ({0: (0, 4), 1: (4, 8), 2: (8, 12)},
                         {0: (0, 6), 2: (6, 12)}),
    }[moves]
    shapes = []
    for ax in axes:
        nd = int(rng.randint(max(1, (ax or 0) + 1), 5))
        shapes.append([int(x) for x in rng.randint(1, 4, size=nd)])
    glob = [rng.randint(-2**31, 2**31, size=[n if a == ax else s for a, s
                                             in enumerate(shp)],
                        dtype=np.int64).astype(np.int32)
            if ax is not None else
            rng.randint(0, 100, size=shp).astype(np.int32)
            for ax, shp in zip(axes, shapes)]

    def block(g, ax, lo, hi):
        if ax is None:
            return g
        sel = [slice(None)] * g.ndim
        sel[ax] = slice(lo, hi)
        return g[tuple(sel)]

    blocks = {h: [block(g, ax, lo, hi) for g, ax in zip(glob, axes)]
              for h, (lo, hi) in old.items()}
    got = tm.relift_tree(blocks, old, new, axes)
    want = jm.relift_tree(blocks, old, new, axes)
    assert sorted(got) == sorted(want) == sorted(new)
    for h, (lo, hi) in new.items():
        for k, (a, b) in enumerate(zip(got[h], want[h])):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"host {h} {k}")
            np.testing.assert_array_equal(a, block(glob[k], axes[k], lo,
                                                   hi))


# -- per-tick plan negotiation ------------------------------------------------

@pytest.mark.parametrize("k", range(6))
def test_merge_tick_plans_equals_twin(k):
    rng = np.random.RandomState(SEED + 200 + k)
    kinds = [tm.KIND_DENSE_SIGNED, tm.KIND_SIGNED, tm.KIND_UNSIGNED]
    assert tm.KIND_NAMES == jm.KIND_NAMES
    for _ in range(20):
        n_slots = int(rng.randint(0, 4))
        slot_kinds = [int(rng.choice(kinds)) for _ in range(n_slots)]
        plans = []
        for _h in range(int(rng.randint(0, 5))):
            mine = []
            for s in range(int(rng.randint(0, n_slots + 1))):
                kind = slot_kinds[s]
                if rng.rand() < 0.08:        # a statics divergence
                    kind = int(rng.choice(kinds))
                mine.append((kind, int(rng.randint(1, 5)),
                             int(rng.choice([0, 256, 512])),
                             int(rng.choice([0, 1, 4]))))
            plans.append(mine)
        got = _outcome(lambda: tm.merge_tick_plans(
            [[tm.TickSlot(*s) for s in p] for p in plans]))
        want = _outcome(lambda: jm.merge_tick_plans(
            [[jm.TickSlot(*s) for s in p] for p in plans]))
        assert got[0] == want[0]
        if got[0] == "ok":
            assert [tuple(s) for s in got[1]] == [tuple(s) for s in want[1]]
        else:
            assert got[1] == "MembershipError"


# -- the membership protocol --------------------------------------------------

def _state(ep):
    return (_view(ep.view), ep.pending(), ep.readmissions, ep.departures,
            ep.deferred_joins, ep.tick, ep.mc_canonical())


@pytest.mark.parametrize("n_hosts,n,holddown,k", [
    (2, 8, 0, 0), (3, 12, 0, 1), (4, 12, 2, 2), (4, 24, 3, 3),
    (5, 60, 1, 4), (3, 6, 0, 5)])
def test_membership_epoch_schedules_equal_twin(n_hosts, n, holddown, k):
    """One seeded schedule of ticks, leave / join intents, merged peer
    masks, boundaries and clones on both packages' MembershipEpoch: the
    same view, intents, counters and canonical key after every step,
    the same Repartition at every boundary."""
    rng = np.random.RandomState(SEED + 300 + k)
    t = tm.MembershipEpoch(n_hosts, n, rejoin_holddown_ticks=holddown)
    j = jm.MembershipEpoch(n_hosts, n, rejoin_holddown_ticks=holddown)
    assert _state(t) == _state(j)
    for _ in range(120):
        op = int(rng.randint(0, 6))
        h = int(rng.randint(0, n_hosts))
        if op == 0:
            assert t.note_tick() == j.note_tick()
        elif op == 1:
            assert t.note_leave(h) == j.note_leave(h)
        elif op == 2:
            assert t.note_join(h) == j.note_join(h)
        elif op == 3:
            masks = (int(rng.randint(0, 1 << n_hosts)),
                     int(rng.randint(0, 1 << n_hosts)))
            t.merge_intents(*masks)
            j.merge_intents(*masks)
        elif op == 4:
            pt, pj = t.prospective(), j.prospective()
            assert (pt is None) == (pj is None)
            if pt is not None:
                assert _view(pt) == _view(pj)
            got = _outcome(lambda: _rep(t.boundary()))
            assert got == _outcome(lambda: _rep(j.boundary()))
        else:
            t, j = t.mc_clone(), j.mc_clone()
        assert _state(t) == _state(j)
    assert t.departures + t.readmissions > 0


# -- the elastic frame codec --------------------------------------------------

def _frame_args(rng, pkg):
    mod, _el, top = PKGS[pkg]
    max_slots, max_dec = int(rng.randint(1, 6)), int(rng.randint(0, 9))
    cap = 96 * int(rng.randint(0, 6))
    n_dec = int(rng.randint(0, max_dec + 1))
    dec_cols = [rng.randint(0, 1 << 20, n_dec),
                rng.randint(-1, 40, n_dec), rng.randint(0, 9, n_dec),
                rng.randint(0, 1000, n_dec)]
    host = int(rng.randint(0, 32))
    dec = top.pack_decision_frame(host, *dec_cols, max_decisions=max_dec)
    slots = tuple(mod.TickSlot(*(int(x) for x in rng.randint(0, 1 << 16,
                                                             4)))
                  for _ in range(int(rng.randint(0, max_slots + 1))))
    reroute = rng.randint(0, 256, 96 * int(rng.randint(0, cap // 96 + 1)),
                          dtype=np.int64).astype(np.uint8).tobytes()
    masks = [int(x) for x in rng.randint(0, 1 << 31, 3, dtype=np.int64)]
    return ((host, int(rng.randint(0, 1 << 31)), *masks, slots, dec,
             reroute), dict(max_slots=max_slots, reroute_cap=cap),
            (max_slots, max_dec, cap))


def _decisions(f):
    return [dataclasses.astuple(d) for d in f.decisions]


@pytest.mark.parametrize("k", range(6))
def test_elastic_frame_byte_for_byte_and_cross_unpack(k):
    for pkg in PKGS:
        rng = np.random.RandomState(SEED + 400 + k)
        ta, tkw, caps = _frame_args(rng, "port")
        rng = np.random.RandomState(SEED + 400 + k)
        ja, jkw, _ = _frame_args(rng, "twin")
        ft = te.pack_elastic_frame(*ta, **tkw)
        fj = je.pack_elastic_frame(*ja, **jkw)
        assert ft.dtype == fj.dtype == np.uint8
        assert ft.tobytes() == fj.tobytes()
        assert len(ft) == te.elastic_frame_capacity(*caps) == \
            je.elastic_frame_capacity(*caps)
        for frame in (ft, fj):
            a = te.unpack_elastic_frame(frame, *caps)
            b = je.unpack_elastic_frame(frame, *caps)
            assert (a.host, a.epoch, a.alive_mask, a.leave_mask,
                    a.join_mask, a.reroute) == \
                (b.host, b.epoch, b.alive_mask, b.leave_mask, b.join_mask,
                 b.reroute)
            assert [tuple(s) for s in a.slots] == [tuple(s) for s in b.slots]
            assert _decisions(a) == _decisions(b)
            assert a.reroute == ta[7]
    assert (te.ELASTIC_MAGIC, te.EHDR, te.SLOT_BYTES, te.MAX_POD_HOSTS) == \
        (je.ELASTIC_MAGIC, je.EHDR, je.SLOT_BYTES, je.MAX_POD_HOSTS)


@pytest.mark.parametrize("case", ["slots", "reroute", "whole", "magic",
                                  "capacities", "claims"])
def test_elastic_frame_errors_equal_twin(case):
    """Each of the codec's refusals, on both packages, with the same
    message."""
    def run(mod, top):
        dec = top.pack_decision_frame(0, [], [], [], [], max_decisions=1)
        ok = mod.pack_elastic_frame(0, 0, 1, 0, 0, (), dec, b"",
                                    max_slots=4, reroute_cap=96)
        slot = mod.TickSlot(tm.KIND_DENSE_SIGNED, 3)
        calls = {
            "slots": lambda: mod.pack_elastic_frame(
                0, 0, 1, 0, 0, (slot,) * 5, dec, b"", max_slots=4,
                reroute_cap=96),
            "reroute": lambda: mod.pack_elastic_frame(
                0, 0, 1, 0, 0, (), dec, bytes(192), max_slots=4,
                reroute_cap=96),
            "whole": lambda: mod.pack_elastic_frame(
                0, 0, 1, 0, 0, (), dec, bytes(95), max_slots=4,
                reroute_cap=96),
            "magic": lambda: mod.unpack_elastic_frame(
                np.zeros_like(ok), 4, 1, 96),
            "capacities": lambda: mod.unpack_elastic_frame(ok[:-1], 4, 1,
                                                           96),
            "claims": lambda: mod.unpack_elastic_frame(
                np.concatenate([ok[:28], np.asarray([9], np.uint32)
                                .view(np.uint8), ok[32:]]), 4, 1, 96),
        }
        try:
            calls[case]()
        except mod.MembershipError as e:
            return str(e)
        return None

    got, want = run(te, tt), run(je, jt)
    assert got is not None and got == want


# -- the twin's jax-free cases (tests/test_elastic.py), on both packages -----

@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_partition_even_and_sorted(pkg):
    m = pkg[0]
    assert m.partition_ranges(8, [1, 0]) == {0: (0, 4), 1: (4, 8)}
    assert m.partition_ranges(8, [1]) == {1: (0, 8)}
    assert m.partition_ranges(12, [0, 2, 3]) == {
        0: (0, 4), 2: (4, 8), 3: (8, 12)}
    for args in ((7, [0, 1]), (8, []), (0, [0])):
        with pytest.raises(m.MembershipError):
            m.partition_ranges(*args)


def test_relift_ranges_transfer_plan(pkg):
    m = pkg[0]
    old = {0: (0, 4), 1: (4, 8)}
    assert m.relift_ranges(old, {0: (0, 8)}) == [(1, 0, 4, 8)]
    assert m.relift_ranges({0: (0, 8)}, old) == [(0, 1, 4, 8)]
    assert m.relift_ranges(old, old) == []
    assert m.relift_ranges({0: (0, 2), 1: (2, 4), 2: (4, 6)},
                           {0: (0, 3), 2: (3, 6)}) == [
        (1, 0, 2, 3), (1, 2, 3, 4)]


def test_instance_axis_of_spec_leaves(pkg):
    m = pkg[0]
    assert m.instance_axis_of(("slice", "val"), ["slice", "data"]) == 0
    assert m.instance_axis_of((None, ("slice", "data")),
                              ["slice", "data"]) == 1
    assert m.instance_axis_of((None, "val"), ["slice", "data"]) is None
    assert m.instance_axis_of((), ["slice"]) is None


def test_relift_tree_round_trips_and_refuses(pkg):
    m = pkg[0]
    old, new = {0: (0, 2), 1: (2, 4)}, {0: (0, 4)}
    rng = np.random.default_rng(17)
    a = rng.integers(0, 100, (4, 3))
    b = rng.integers(0, 100, (2, 4, 5))
    r = rng.integers(0, 100, (7,))
    blocks = {h: [a[lo:hi], b[:, lo:hi], r] for h, (lo, hi) in old.items()}
    out = m.relift_tree(blocks, old, new, axes=[0, 1, None])
    for got, want in zip(out[0], (a, b, r)):
        np.testing.assert_array_equal(got, want)
    back = m.relift_tree(out, new, old, axes=[0, 1, None])
    for h, (lo, hi) in old.items():
        np.testing.assert_array_equal(back[h][0], a[lo:hi])
        np.testing.assert_array_equal(back[h][1], b[:, lo:hi])
        np.testing.assert_array_equal(back[h][2], r)
    bad = {0: [np.zeros((2, 1))], 1: [np.zeros((2, 1))]}
    for o, n in (({0: (0, 2), 1: (2, 4)}, {0: (0, 3), 1: (2, 4)}),
                 ({0: (0, 2), 1: (1, 4)}, {0: (0, 4)})):
        with pytest.raises(m.MembershipError):
            m.relift_tree(bad, o, n, axes=[0])


def test_merge_max_pads_and_refuses(pkg):
    m = pkg[0]
    D, U = m.KIND_DENSE_SIGNED, m.KIND_UNSIGNED
    full, closed = (m.TickSlot(D, 3),), (m.TickSlot(D, 2),)
    assert m.merge_tick_plans([full, closed]) == full
    assert m.merge_tick_plans(
        [(m.TickSlot(D, 2, rung=256, bls_class_rung=1),),
         (m.TickSlot(D, 3, rung=512, bls_class_rung=4),)]) == (
        m.TickSlot(D, 3, rung=512, bls_class_rung=4),)
    two = (m.TickSlot(D, 3), m.TickSlot(U, 2))
    assert m.merge_tick_plans([two, two[:1]]) == two
    assert m.merge_tick_plans([(), two]) == two
    assert m.merge_tick_plans([(), ()]) == m.merge_tick_plans([]) == ()
    with pytest.raises(m.MembershipError, match="statics divergence"):
        m.merge_tick_plans([(m.TickSlot(D, 3),), (m.TickSlot(U, 3),)])


def test_leave_applies_at_boundary_and_rejoin_readmits(pkg):
    m = pkg[0]
    ep = m.MembershipEpoch(2, 8)
    assert ep.note_leave(1) is True and ep.note_leave(1) is False
    assert ep.view.ranges == {0: (0, 4), 1: (4, 8)}
    assert ep.pending() == (0b10, 0)
    rep = ep.boundary()
    assert rep.left == (1,) and rep.transfers == ((1, 0, 4, 8),)
    assert (ep.view.epoch, ep.view.alive) == (1, (0,))
    assert ep.boundary() is None and ep.view.epoch == 1
    assert ep.note_join(1) is True
    rep = ep.boundary()
    assert rep.joined == (1,) and rep.transfers == ((0, 1, 4, 8),)
    assert ep.view.ranges == {0: (0, 4), 1: (4, 8)}
    assert (ep.readmissions, ep.departures, ep.view.epoch) == (1, 1, 2)


def test_rejoin_holddown_counts_logical_ticks(pkg):
    m = pkg[0]
    ep = m.MembershipEpoch(2, 8, rejoin_holddown_ticks=3)
    ep.note_tick()
    ep.note_leave(1)
    ep.boundary()                             # stamped at tick 1
    ep.note_tick()
    assert ep.note_join(1) is False and ep.deferred_joins == 1
    assert ep.boundary() is None
    ep.note_tick()
    ep.note_tick()
    assert ep.note_join(1) is True
    assert ep.boundary().joined == (1,) and ep.readmissions == 1
    # a leave cancelled before any boundary owes no holddown
    ep = m.MembershipEpoch(2, 8, rejoin_holddown_ticks=5)
    ep.note_tick()
    ep.note_leave(1)
    assert ep.note_join(1) is True and ep.deferred_joins == 0
    assert ep.boundary() is None and ep.view.epoch == 0


def test_holddown_verdict_and_merged_intents_agree_across_hosts(pkg):
    m = pkg[0]
    a, b = (m.MembershipEpoch(2, 8, rejoin_holddown_ticks=2)
            for _ in range(2))
    for ep in (a, b):
        ep.note_tick()
        ep.note_leave(1)
        ep.boundary()
        ep.note_tick()
        ep.note_tick()
    assert a.note_join(1) is True
    for ep in (a, b):
        ep.note_tick()
    b.merge_intents(*a.pending())
    assert b.pending() == a.pending() and b.deferred_joins == 0
    assert a.boundary().new.ranges == b.boundary().new.ranges
    c, d = m.MembershipEpoch(2, 8), m.MembershipEpoch(2, 8)
    c.note_leave(1)
    d.merge_intents(*c.pending())
    assert c.boundary().new.ranges == d.boundary().new.ranges == \
        {0: (0, 8)}


def test_uneven_live_set_fails_loudly_at_boundary(pkg):
    m = pkg[0]
    ep = m.MembershipEpoch(3, 9)
    ep.note_leave(2)
    with pytest.raises(m.MembershipError, match="evenly"):
        ep.boundary()


def test_elastic_frame_round_trip(pkg):
    m, el, top = pkg
    slots = (m.TickSlot(m.KIND_DENSE_SIGNED, 3),
             m.TickSlot(m.KIND_UNSIGNED, 2, rung=0, bls_class_rung=4))
    dec = top.pack_decision_frame(
        1, np.asarray([5, 6]), np.asarray([2, -1]), np.asarray([7, 7]),
        np.asarray([0, 1]), max_decisions=4)
    reroute = bytes(range(96)) * 2
    frame = el.pack_elastic_frame(1, 3, 0b11, 0b10, 0b01, slots, dec,
                                  reroute, max_slots=4, reroute_cap=96 * 4)
    assert len(frame) == el.elastic_frame_capacity(4, 4, 96 * 4)
    f = el.unpack_elastic_frame(frame, 4, 4, 96 * 4)
    assert (f.host, f.epoch) == (1, 3)
    assert (f.alive_mask, f.leave_mask, f.join_mask) == (3, 2, 1)
    assert f.slots == slots
    assert [(d.instance, d.host, d.round, d.value_id)
            for d in f.decisions] == [(5, 1, 7, 2), (6, 1, 7, None)]
    assert f.reroute == reroute
