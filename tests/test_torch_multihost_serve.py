"""Port differential: the static pod served over gloo worlds on the CPU.

At the twin's test size (tests/test_multihost_serve.py: I = 4, V = 4,
heights 0-2, 2 hosts, n_val = 2) `agnes_tpu_torch.distributed.smoke`
spawns, all at once and each join bounded:

  A  the pod, 2 hosts x (1 x 2): four ranks, `file://` rendezvous;
  B  one host of four ranks (1 x (2 x 2)) serving the same deployment
     through a VoteService over a DistributedDriver with a coordinator;
  C  a native-admission pod, 2 hosts x (1 x 1);
  O  the one-device offline dense path (`build_phases_device_dense` ->
     `step_seq_signed_dense`), itself held against JAX by
     tests/test_torch_dense_step.py;
  E  the twin's tests/test_elastic_serve.py deployment: an elastic pod,
     2 hosts x (1 x 1), at I = 4, V = 4, heights 0-4, served through
     ElasticShard's negotiated ticks with heterogeneous traffic a host,
     host 1 leaving at height 2's boundary and rejoining at height 3's,
     beside its own offline path of the same heights.

A's host blocks, concatenated host-major, must equal B's global arrays,
C's and O's leaf for leaf; every rank of a host must hold the same block.
The twin's per-host invariants carry over: no unexpected retrace, no
off-ladder build, the foreign records screened, the decisions, the same
gathered decision rows on every process, one host-stamped heartbeat a
process.  E meets the twin's elastic invariants number for number (the
held gossip, the boundaries, the readmission, the padding) and its host
blocks equal its offline path's leaf for leaf.
"""

import numpy as np
import pytest

from agnes_tpu_torch.distributed.smoke import start_pod
from agnes_tpu_torch.utils.flightrec import (
    read_heartbeat,
    render_pod_postmortem,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I, V, HEIGHTS = 4, 4, 2
N_HOSTS, N_VAL = 2, 2
JOIN_S = 240
WORLDS = {"A": dict(n_processes=4, per_host=2, n_val=N_VAL,
                    heartbeat=True, extra_modes=["single", "offline"]),
          "C": dict(n_processes=2, per_host=1, n_val=1,
                    native_admission=True)}
E_HEIGHTS, LEAVE, REJOIN = 4, 2, 3      # host 1 away for height 2
ELASTIC = dict(n_processes=2, per_host=1, n_val=1, heights=E_HEIGHTS,
               elastic=True, leave_height=LEAVE, rejoin_height=REJOIN,
               heartbeat=True, extra_modes=["offline"])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: spawn_pod's result}: every world started at once, all
    bounded by one deadline of JOIN_S."""
    kws = {name: dict(kw, heights=HEIGHTS) for name, kw in WORLDS.items()}
    kws["E"] = ELASTIC
    runs = {name: start_pod(instances=I, validators=V, device="cpu",
                            timeout_s=JOIN_S, dump_state=True,
                            out_dir=str(tmp_path_factory.mktemp(name)), **kw)
            for name, kw in kws.items()}
    out = {name: run.wait() for name, run in runs.items()}
    for name, res in out.items():
        assert not res["killed"], (name, res["paths"])
        recs = res["pod"] + res.get("single", []) + (
            [res["offline"]] if "offline" in res else [])
        for rec in recs:
            assert "error" not in rec, (name, rec, res["paths"])
    return out


def _npz(res, tag):
    return dict(np.load(res["paths"][tag]["npz"]))


def _host_blocks(res, per_host):
    """The host blocks of a pod, host-major; every rank of a host must
    hold its host's block leaf for leaf."""
    blocks = []
    for h in range(N_HOSTS):
        first = _npz(res, f"pod{h * per_host}")
        for k in range(1, per_host):
            other = _npz(res, f"pod{h * per_host + k}")
            for key in first:
                np.testing.assert_array_equal(
                    other[key], first[key],
                    err_msg=f"host {h} rank {k}: {key}")
        blocks.append(first)
    return {key: np.concatenate([b[key] for b in blocks], axis=0)
            for key in blocks[0]}


def _same(a, b, what):
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key],
                                      err_msg=f"{key}: {what}")


def test_pod_equals_one_host_of_four_ranks(worlds):
    pod = _host_blocks(worlds["A"], 2)
    assert len(pod["state_height"]) == I
    for k in range(4):
        _same(pod, _npz(worlds["A"], f"pod_single{k}"),
              f"pod vs rank {k} of the one-host world")


def test_pod_equals_offline_dense_path(worlds):
    _same(_host_blocks(worlds["A"], 2), _npz(worlds["A"], "pod_offline"),
          "pod vs one-device offline")
    assert (worlds["A"]["offline"]["decisions_total"]
            == I * (HEIGHTS + 1))


def test_native_admission_pod_equals_pod(worlds):
    _same(_host_blocks(worlds["C"], 1), _host_blocks(worlds["A"], 2),
          "native-admission 2 x (1 x 1) pod vs the 2 x (1 x 2) pod")
    for rec in worlds["C"]["pod"]:
        assert rec["native_admission"] is True


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_per_host_invariants(worlds, world):
    recs = worlds[world]["pod"]
    assert len(recs) == WORLDS[world]["n_processes"]
    for rec in recs:
        assert rec["retrace_unexpected"] == 0, rec
        assert rec["offladder_builds"] == 0, rec
        assert rec["host_fallback_builds"] == 0, rec
        assert rec["rejected_signature_device"] == 0, rec
        assert rec["warmed_shapes"] == 1, rec
        assert rec["dispatched_batches"] == HEIGHTS + 1, rec
        # the front door screened the other host's share of every height
        assert rec["foreign_rejects"] == \
            (HEIGHTS + 1) * 2 * (I // N_HOSTS) * V
        assert rec["decisions_total"] == (I // N_HOSTS) * (HEIGHTS + 1)
        assert rec["pod_decisions"] == I
        assert rec["gather_failed"] is None
        assert rec["host"] == rec["process"] // rec["per_host"]
        assert rec["cells_by_dispatch"] == [2 * (I // N_HOSTS) * V] * 3
        # every dispatch agreed: warmup's and one a height, plus the
        # two warmup barriers
        assert rec["agrees"] == 1 + (HEIGHTS + 1) + 2
        assert rec["barriers"] == 2


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_gathered_decision_rows_identical(worlds, world):
    rows = [rec["pod_decision_rows"] for rec in worlds[world]["pod"]]
    assert all(r == rows[0] for r in rows)
    # every global instance, decided by its owner at height 0, value 7
    assert [r[0] for r in rows[0]] == list(range(I))
    assert [r[1] for r in rows[0]] == [i // (I // N_HOSTS) for i in range(I)]
    assert all(r[2:] == [0, 0, 7] for r in rows[0])


def test_one_world_serves_a_multi_rank_mesh(worlds):
    """B: a VoteService over a four-rank mesh, the coordinator agreeing
    each dispatch (warmup and three heights)."""
    for rec in worlds["A"]["single"]:
        assert rec["decisions_total"] == I * (HEIGHTS + 1)
        assert rec["offladder_builds"] == 0
        assert rec["agrees"] == 1 + (HEIGHTS + 1)


def test_one_host_stamped_heartbeat_a_process(worlds):
    res = worlds["A"]
    paths = [res["paths"][f"pod{k}"]["heartbeat"] for k in range(4)]
    for k, path in enumerate(paths):
        lines, bad = read_heartbeat(path)
        assert lines and not bad, path
        assert all(ln["host_id"] == k // 2 for ln in lines), path
    head = render_pod_postmortem(paths).split("\n\n")[0].splitlines()
    assert len(head) == 5
    assert sorted(ln.split(":")[0].strip() for ln in head[1:]) == \
        ["host 0", "host 0", "host 1", "host 1"]


# -- E: the elastic pod -------------------------------------------------------

def test_elastic_pod_completes_the_membership_cycle(worlds):
    """The twin's per-host invariants of tests/test_elastic_serve.py,
    number for number."""
    recs = worlds["E"]["pod"]
    assert [r["mode"] for r in recs] == ["elastic"] * N_HOSTS
    for rec in recs:
        assert rec["retrace_unexpected"] == 0, rec
        assert rec["rejected_signature_device"] == 0, rec
        assert rec["offladder_builds"] == 0, rec
        assert rec["host_fallback_builds"] == 0, rec
        # P = 2 and P = 3 warmed, the pad lands on nothing else
        assert rec["warmed_shapes"] == 2, rec
        assert rec["padded_slots"] > 0, rec
        # the survivor holds the sleeper's ranges, it rejects nothing
        assert rec["foreign_rejects"] == 0, rec
        assert rec["held_dropped"] == 0 and rec["held_pending"] == 0, rec
        assert rec["boundaries"] == 2, rec
        assert rec["membership_epoch"] == 2, rec
        assert rec["readmissions"] == 1, rec
        assert rec["departures"] == 1, rec
        assert rec["alive"] == [0, 1], rec
        assert rec["decisions_total"] == (I // N_HOSTS) * (E_HEIGHTS + 1)
        assert rec["pod_decisions"] == I, rec
        assert rec["gather_failed"] is None, rec
        # one negotiation a tick: three a height, one a catch-up tick,
        # three to settle; one dispatch a slot the schedule implies
        ticks = 3 * (E_HEIGHTS + 1) + (REJOIN - LEAVE) + 3
        assert rec["negotiation_ticks"] == rec["negotiations"] == ticks
        assert len(rec["negotiation_ms"]) == ticks
        assert rec["launches_implied"] == [2, 2, 2, 3, 2]
        assert len(rec["cells_by_dispatch"]) == \
            sum(rec["launches_implied"]) == rec["dispatched_batches"]


def test_elastic_held_gossip_flows_to_the_readmitted_host(worlds):
    held = 2 * (I // N_HOSTS) * V * (REJOIN - LEAVE)    # both classes
    surv, sleeper = worlds["E"]["pod"]
    assert surv["adopted_held"] == surv["reroute_sent"] == held, surv
    assert sleeper["reroute_received"] == held, sleeper
    assert sleeper["adopted_held"] == sleeper["reroute_sent"] == 0
    assert surv["reroute_reheld"] == sleeper["reroute_reheld"] == 0


def test_elastic_decision_rows_identical(worlds):
    rows = [rec["pod_decision_rows"] for rec in worlds["E"]["pod"]]
    assert rows[0] == rows[1]
    assert [r[0] for r in rows[0]] == list(range(I))
    assert all(r[2:] == [0, 0, 7] for r in rows[0])


def test_elastic_pod_equals_offline_dense_path(worlds):
    res = worlds["E"]
    _same(_host_blocks(res, 1), _npz(res, "pod_offline"),
          "elastic pod vs one-device offline")
    assert res["offline"]["decisions_total"] == I * (E_HEIGHTS + 1)


def test_elastic_postmortem_shows_the_membership_trail(worlds):
    res = worlds["E"]
    paths = [res["paths"][f"pod{k}"]["heartbeat"] for k in range(N_HOSTS)]
    for k, path in enumerate(paths):
        lines, bad = read_heartbeat(path)
        assert lines and not bad and all(ln["host_id"] == k
                                         for ln in lines), path
    post = render_pod_postmortem(paths)
    head = post.split("\n\n")[0]
    assert head.count("epoch 2)") == N_HOSTS
    assert "elastic membership:" in post and "epoch 2" in post
    assert "membership_boundary=2" in post and "membership_relift" in post
    assert "HELD GOSSIP DROPPED" not in post
