"""The port stands alone: a fresh interpreter imports `agnes_tpu_torch`
(the MSM slice's, the BLS lane's, the tooling's and the serve plane's
modules included), runs the CPU slice (fused honest heights, one signed
height through the bridge with the verify planner, the evidence join, one
cross-plane replay, one BLS field product and reduce, the
microbenchmark's chain, a traced checkpoint round trip of the driver and
the batcher, an unsigned height served through VoteService with its
metrics, flight recorder and heartbeat, and the host plane: benchmark
config 1 under --small, a tapped network and an executor snapshot, and
one unsigned tick of the C++ ingest loop with its checkpoint, the
library built from the port's own `core/native/` sources only, and the
native admission queue and its shards, the runtime lock checker and an
unsigned height served by the threaded host over native admission, the
mesh and sharding layer `agnes_tpu_torch.parallel`, and the static pod
`agnes_tpu_torch.distributed` with its worker module, and the elastic
pod's `distributed.membership` and `distributed.elastic` with an elastic
frame round trip), and every name the twin's packages export (the
package-level `types`, `crypto`, `device`, `bridge`, `harness`,
`analysis` and `utils` names, the lazy ones resolved), and never loads
`jax` or any `agnes_tpu` module.  Without a GPU its entry points refuse to run unless given
device="cpu".  The bounded model checkers import neither either, and the
consensus checker alone imports no torch, nor do the package names
it reaches through `harness` (the replay's), `crypto` (the oracle's and
the signing bytes') and `analysis` (the finding and retrace records).
Nor do the analyzers (the schedule checker, the lint and lock passes and
their CLI), and the metrics CLI, `agnes_tpu_torch.utils.Metrics` and the
package-level types import no torch at all.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import os
import sys
import tempfile

import numpy as np
import torch

import agnes_tpu_torch
import agnes_tpu_torch.convert
import agnes_tpu_torch.parallel
from agnes_tpu_torch.parallel import make_mesh, make_sharded_step_seq_signed
from agnes_tpu_torch.bridge.evidence import collect_device_evidence
from agnes_tpu_torch.bridge.ingest import VoteBatcher
from agnes_tpu_torch.core.executor import WireTimeout, epoch_boundary_at
from agnes_tpu_torch.crypto import ed25519_point  # noqa: F401
from agnes_tpu_torch.crypto import bls_field as BF
from agnes_tpu_torch.crypto import bls_pairing  # noqa: F401
from agnes_tpu_torch.crypto import bls_ref
from agnes_tpu_torch.crypto import msm as M
from agnes_tpu_torch.harness import fixtures as fx
from agnes_tpu_torch.harness.device_driver import DeviceDriver
from agnes_tpu_torch.harness.replay import replay_trace
from agnes_tpu_torch.serve.batcher import ShapeLadder
from agnes_tpu_torch.types import Vote, VoteType
from agnes_tpu_torch.scripts import microbench_layout as MB
from agnes_tpu_torch.scripts import bls_fp_probe  # noqa: F401
from agnes_tpu_torch.scripts import verify_probe  # noqa: F401
from agnes_tpu_torch.serve.bls_lane import BlsKeyRegistry, BlsLane
from agnes_tpu_torch.utils import (Tracer, load_batcher, load_driver,
                                   save_batcher, save_driver, span)
from agnes_tpu_torch.utils import budget
from agnes_tpu_torch.analysis import retrace
from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
from agnes_tpu_torch.serve import cache, pipeline, queue  # noqa: F401
from agnes_tpu_torch.serve.service import VoteService
from agnes_tpu_torch.utils import flightrec, metrics, metrics_http
from agnes_tpu_torch.core import state_machine as sm
from agnes_tpu_torch.core.executor import ConsensusExecutor
from agnes_tpu_torch.device.encoding import decode_state, encode_state
from agnes_tpu_torch.harness import Network, configs
from agnes_tpu_torch.harness.replay import trace_network
from agnes_tpu_torch.utils import load_executor_into, save_executor

d = DeviceDriver(4, 4, advance_height=True, device="cpu")
d.run_heights_fused(2)
assert (d.state.height == 2).all() and d.stats.decisions_total == 8

I, V = 2, 4
seeds = fx.deterministic_seeds(V)
bat = VoteBatcher(I, V, n_slots=4, device="cpu")
for typ in (0, 1):
    bat.add_arrays(*fx.full_mesh_cols(I, V, seeds, 0, typ, 5,
                                      forge_validator=2))
phases, lanes = bat.build_phases_device(fx.validator_pubkeys(seeds),
                                        phase_offset=1)
s = DeviceDriver(I, V, advance_height=True, device="cpu",
                 verify_chunk="auto", hbm_budget_bytes=1 << 30)
s.step_seq_signed([s.empty_phase()] + [p for p, _ in phases], lanes)
assert s.all_decided() and s.rejected_signature_device == 2 * I
assert collect_device_evidence(s.tally.equiv, bat) == []
assert budget.plan_lane_verify(16, hbm_bytes=1 << 30).n_chunks == 1

rep = replay_trace([Vote(VoteType.PRECOMMIT, 0, 7, validator=v, height=0)
                    for v in range(4)], 4, device="cpu")
assert rep.decisions == {0: (0, 7)}
assert epoch_boundary_at({1: None, 3: None}, 2) == 1
assert WireTimeout(0, 0, 0).height == 0

tr = Tracer()
with tempfile.TemporaryDirectory() as tmp:
    with span("save", tr):
        save_driver(s, os.path.join(tmp, "d.npz"))
        save_batcher(bat, os.path.join(tmp, "b.npz"))
    with span("load", tr):
        s2 = load_driver(os.path.join(tmp, "d.npz"), device="cpu")
        bat2 = load_batcher(os.path.join(tmp, "b.npz"), device="cpu")
    tr.write(os.path.join(tmp, "trace.json"))
assert (s2.stats.decision_value == s.stats.decision_value).all()
assert bat2.decode_slot(0, int(s2.stats.decision_value[0])) == 5
assert len(bat2._log) == 1 and bat2._log_pk[0] is not None
assert tr.total_us("save") > 0 and tr.total_us("load") > 0

xy = torch.from_numpy(np.arange(40, dtype=np.int32).reshape(20, 2))
assert MB.chain(xy, xy, 1).shape == (20, 2) and MB.LAUNCHES == 0

assert M.make_z(3, seed=1, device="cpu").shape == (3, M.Z_LIMBS)

x = torch.from_numpy(BF.ints_to_limbs([3, bls_ref.P - 1]))
assert [BF.from_limbs(r) % bls_ref.P
        for r in BF.mul_rows(x, x)] == [9, 1]
assert BF.from_limbs(BF.reduce_rows(x * 5, 1)[0]) % bls_ref.P == 15
assert ShapeLadder().with_bls(1000).bls_rung_for(1000) == 1024
reg = BlsKeyRegistry([list(bls_ref.g1_compress(bls_ref.G1))])

sd = DeviceDriver(2, 4, advance_height=True, device="cpu", audit=True)
rec = flightrec.FlightRecorder()
svc = VoteService(sd, VoteBatcher(2, 4, n_slots=4, device="cpu"), None,
                  max_delay_s=0.0, flightrec=rec,
                  ladder=ShapeLadder.plan(2, 4, min_rung=16,
                                          hbm_bytes=1 << 30))
for typ in (0, 1):
    c = fx.full_mesh_cols(2, 4, fx.deterministic_seeds(4), 0, typ, 5)
    assert svc.submit(pack_wire_votes(*c[:6])).accepted == 8
svc.pump()
svc.pump()
assert [(x.value_id, x.round) for x in svc.poll_decisions()] == [(5, 0)] * 2
assert svc.drain()["decisions_total"] == 2 and rec.counts()["dispatch"] == 1
assert metrics_http.render_prometheus(svc.metrics).count("serve_") > 10
with tempfile.TemporaryDirectory() as tmp:
    hb = flightrec.Heartbeat(os.path.join(tmp, "hb"), recorder=rec,
                             sources=[svc.metrics.snapshot])
    hb.beat()
    assert flightrec.read_heartbeat(hb.path)[1] == []
assert retrace.warmup_covers(svc.ladder)
assert isinstance(sd.sentinel, retrace.RetraceSentinel)
try:
    VoteService(DeviceDriver(2, 4, device="cpu"),
                VoteBatcher(2, 4, n_slots=4, device="cpu"))
except ValueError:
    pass
else:
    raise SystemExit("a CPU service planned a ladder without a budget")
assert metrics.SERVE_ADMITTED == "serve_admitted"

assert configs.run(1, small=True, device="cpu")["heights"] == 3
net = Network(n=4)
taps = trace_network(net)
net.start()
net.run_until(lambda: net.decided(0))
assert set(net.decisions(0)) == {100} and all(taps)
with tempfile.TemporaryDirectory() as tmp:
    save_executor(net.nodes[1], os.path.join(tmp, "n1.json"))
    fresh = ConsensusExecutor(net.vset, 1, net.seeds[1], net.get_value)
    assert load_executor_into(fresh, os.path.join(tmp, "n1.json"))[1] \
        == net.nodes[1].decided
st = sm.State(3, 1, sm.Step.PREVOTE, sm.RoundValue(0, 9))
assert decode_state(encode_state(st)) == st

from agnes_tpu_torch.bridge import NativeIngestLoop
from agnes_tpu_torch.core import native_build
from agnes_tpu_torch.utils import load_native_loop, save_native_loop

nl = NativeIngestLoop(2, 4, n_slots=4, device="cpu")
nl.sync_device(np.zeros(2, np.int64), np.zeros(2, np.int64))
c = fx.full_mesh_cols(2, 4, fx.deterministic_seeds(4), 0, 0, 5)
assert nl.push(pack_wire_votes(*c)) == 8
nph = nl.build_phases()
assert len(nph) == 1 and nph[0][1] == 8 and nph[0][0].mask.all()
with tempfile.TemporaryDirectory() as tmp:
    save_native_loop(nl, os.path.join(tmp, "nl.npz"))
    nl2 = load_native_loop(os.path.join(tmp, "nl.npz"), device="cpu")
assert nl2.decode_slot(0, int(nph[0][0].slots[0, 0])) == 5
so = native_build.build()
cpp = [a for a in native_build.command(so) if a.endswith(".cpp")]
native_dir = os.path.join(os.path.dirname(agnes_tpu_torch.__file__), "core",
                          "native")
assert cpp and all(os.path.dirname(a) == native_dir for a in cpp), cpp
with open("/proc/self/maps") as f:
    maps = f.read()
assert so in maps, so
libs = {ln.split()[-1] for ln in maps.splitlines()
        if ln.split()[-1].endswith(".so") and "agnes" in ln.split()[-1]}
assert libs == {so}, libs
assert any(a.endswith("admission_phases.cpp") for a in cpp), cpp

from agnes_tpu_torch.analysis import lockcheck
from agnes_tpu_torch.serve import (NativeAdmissionQueue,
                                   NativeAdmissionShards, threaded_service)

for nq in (NativeAdmissionQueue(2, 16), NativeAdmissionShards(2, 16,
                                                              n_shards=2)):
    assert nq.submit(pack_wire_votes(*c)).accepted == 8
    assert len(nq.drain()) == 8 and nq.counters["drained"] == 8
td = DeviceDriver(2, 4, advance_height=True, defer_collect=True,
                  device="cpu")
tsvc = threaded_service(td, VoteBatcher(2, 4, n_slots=4, device="cpu"),
                        None, native_admission=True, max_delay_s=0.0,
                        ladder=ShapeLadder.plan(2, 4, min_rung=16,
                                                hbm_bytes=1 << 30))
for typ in (0, 1):
    c = fx.full_mesh_cols(2, 4, fx.deterministic_seeds(4), 0, typ, 5)
    assert tsvc.submit(pack_wire_votes(*c[:6]))
trep = tsvc.drain(timeout_s=60)
assert trep["decisions_total"] == 2 and trep["thread_failure"] is None
assert isinstance(lockcheck.LockOrderState(), lockcheck.LockOrderState)

import agnes_tpu_torch.distributed
from agnes_tpu_torch.distributed import (DistributedDriver, HostPlan,  # noqa: F401
                                         HostShard, initialize_pod,
                                         pack_decision_frame, spawn_pod,
                                         unpack_decision_frames)
from agnes_tpu_torch.distributed import smoke as pod_smoke  # noqa: F401
assert HostPlan(2, 8).instance_range(1) == (4, 8)
assert [(x.instance, x.value_id) for x in unpack_decision_frames(
    pack_decision_frame(1, [5], [-1], [0], [2], 2)[None])] == [(5, None)]

import agnes_tpu_torch.distributed.elastic as ela
import agnes_tpu_torch.distributed.membership as memb
from agnes_tpu_torch.distributed import ElasticShard  # noqa: F401

ep = memb.MembershipEpoch(2, 8)
ep.note_leave(1)
assert ep.boundary().transfers == ((1, 0, 4, 8),)
slots = (memb.TickSlot(memb.KIND_DENSE_SIGNED, 3),)
frame = ela.pack_elastic_frame(
    1, ep.view.epoch, ep.view.alive_mask(), *ep.pending(), slots,
    pack_decision_frame(1, [5], [7], [0], [2], 2), bytes(96),
    max_slots=2, reroute_cap=192)
back = ela.unpack_elastic_frame(frame, 2, 2, 192)
assert (back.host, back.epoch, back.alive_mask, back.slots) == \
    (1, 1, 1, slots)
assert [(x.instance, x.value_id) for x in back.decisions] == [(5, 7)]
assert back.reroute == bytes(96)

from agnes_tpu_torch import NIL, Proposal  # noqa: F401
from agnes_tpu_torch import Vote as PkgVote, VoteType as PkgVoteType
from agnes_tpu_torch.analysis import (Finding, RetraceError,  # noqa: F401
                                      RetraceSentinel, signature)
from agnes_tpu_torch.bridge import (DeviceEvidence, SlotMap,  # noqa: F401
                                    ValueTable, WireVote, verify_evidence)
from agnes_tpu_torch.bridge import VoteBatcher as PkgBatcher
from agnes_tpu_torch.bridge import collect_device_evidence as pkg_cde
from agnes_tpu_torch.crypto import (VOTE_MSG_LEN, keypair,  # noqa: F401
                                    proposal_signing_bytes, sign, verify,
                                    vote_signing_bytes)
from agnes_tpu_torch.device import (DeviceEvent, DeviceMessage,  # noqa: F401
                                    DeviceState, apply_batch, apply_scalar)
from agnes_tpu_torch.harness import DeviceDriver as PkgDriver
from agnes_tpu_torch.harness import (ReplayResult,  # noqa: F401
                                     replay_trace as pkg_replay,
                                     trace_network as pkg_tap)
from agnes_tpu_torch.utils import Metrics

assert (PkgVote, PkgVoteType, PkgBatcher, pkg_cde, PkgDriver, pkg_replay,
        pkg_tap) == (Vote, VoteType, VoteBatcher, collect_device_evidence,
                     DeviceDriver, replay_trace, trace_network)
assert isinstance(rep, ReplayResult) and isinstance(Metrics(), Metrics)
assert VOTE_MSG_LEN == len(vote_signing_bytes(0, 0, 0, None))
ev = apply_scalar(DeviceState.new((), device="cpu"),
                  DeviceEvent(*(torch.tensor(x, dtype=torch.int32)
                                for x in (1, 0, 5, -1))))
assert int(ev[1].tag) == int(sm.MsgTag.PROPOSAL)

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "agnes_tpu"))
assert not bad, bad

if not torch.cuda.is_available():
    for make in (lambda: DeviceDriver(4, 4),
                 lambda: VoteBatcher(4, 4, n_slots=4),
                 lambda: VoteBatcher(4, 4, n_slots=4, verify_mode="msm"),
                 lambda: M.make_z(4),
                 lambda: BlsLane(reg, 1),
                 lambda: load_driver(os.devnull),
                 lambda: budget.device_hbm_bytes(),
                 lambda: replay_trace([], 4),
                 lambda: configs.run(3, small=True),
                 lambda: configs.run(1, small=True),
                 lambda: MB.main(["--lanes", "2048"]),
                 lambda: NativeIngestLoop(2, 4, n_slots=4),
                 lambda: initialize_pod("file:///nonexistent", 1, 0)):
        try:
            make()
        except RuntimeError:
            pass
        else:
            raise SystemExit("an entry point ran without a GPU")
print("PORT-OK")
"""


def test_port_imports_no_jax_and_runs_cpu_slice():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PORT-OK" in r.stdout


_CHECKERS = r"""
import sys

from agnes_tpu_torch.analysis import modelcheck as mc

rep = mc.explore(mc.MCConfig(name="t", depth=4, max_round=1))
assert rep.states > 10 and rep.complete and not rep.violations
from agnes_tpu_torch.analysis import (Finding, RetraceError,  # noqa: F401
                                      RetraceSentinel, signature)
from agnes_tpu_torch.crypto import (VOTE_MSG_LEN, keypair,  # noqa: F401
                                    proposal_signing_bytes, sign, verify,
                                    vote_signing_bytes)
from agnes_tpu_torch.harness import (ReplayResult, replay_trace,  # noqa: F401
                                     trace_network)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "agnes_tpu", "torch"))
assert not bad, bad

from agnes_tpu_torch.analysis import admission_mc as am
from agnes_tpu_torch.analysis import membership_mc as mm
from agnes_tpu_torch.utils.budget import Deadline

rep = am.explore_admission(am.ADMISSION_TINY[0], max_states=200)
assert rep.states >= 200 and not rep.violations
assert mm.explore_membership(mm.MEMBERSHIP_TINY[0]).complete
d = Deadline.discover(env_var="AGNES_MC_TEST_UNSET")
assert d.source == "proc:timeout" and 0 < d.remaining() <= 60, d
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "agnes_tpu"))
assert not bad, bad
print("CHECKERS-OK")
"""


def test_model_checkers_import_no_jax_and_consensus_no_torch():
    """The consensus checker alone imports no torch (nor jax, nor the
    twin); the admission and membership models and the deadline import
    no jax and nothing of the twin; and under `timeout 60` the deadline
    is discovered from /proc."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "AGNES_MC_TEST_UNSET")}
    r = subprocess.run(["timeout", "60", sys.executable, "-c", _CHECKERS],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CHECKERS-OK" in r.stdout


_ANALYZERS = r"""
import json
import os
import sys
import tempfile

from agnes_tpu_torch import NIL, Proposal, Vote, VoteType  # noqa: F401
from agnes_tpu_torch.utils import Metrics, flightrec, metrics_cli

assert Metrics().snapshot() is not None
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "agnes_tpu", "torch"))
assert not bad, bad
with tempfile.TemporaryDirectory() as tmp:
    hb = flightrec.Heartbeat(os.path.join(tmp, "hb.ndjson"))
    hb.beat()
    assert metrics_cli.main(["--check", hb.path]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "agnes_tpu", "torch"))
assert not bad, bad

import torch

from agnes_tpu_torch.analysis import lint, lint_cli, lockcheck, schedcheck

r = schedcheck.run_once(schedcheck.SCOPES["tiny"][0])
assert r.completed and not r.violations, r.violations
assert lint.check_threads(os.getcwd()) == []
assert lockcheck.check_source("with self._admission:\n    pass\n") == []
assert not torch.cuda.is_initialized()
assert lint_cli.PASSES == ("retrace", "locks", "lint")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "agnes_tpu"))
assert not bad, bad
print("ANALYZERS-OK")
"""


def test_analyzers_import_no_jax_and_metrics_cli_no_torch():
    """The metrics CLI, the flight recorder, `utils.Metrics` and the
    package-level types load no torch (they run on a box whose CUDA
    stack failed); the schedule checker, the lint and
    lock passes and the lint CLI load no jax and nothing of the twin,
    and a schedule-checker run leaves CUDA uninitialized."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _ANALYZERS], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ANALYZERS-OK" in r.stdout
