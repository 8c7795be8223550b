"""Port differential: the schedule checker against the JAX twin, on the
CPU.

`agnes_tpu_torch.analysis.schedcheck` held against
`agnes_tpu.analysis.schedcheck`.  Both drive their own package's real
threaded serve host (`ThreadedVoteService`, `Inbox`, `AdmissionQueue`,
`MicroBatcher`) under the cooperative scheduler, so an equal trace
means the port's host announces the same yield points in the same
order.  Every tree is bounded: one run of the tiny scope (the default
schedule and one forced sibling), its first 150 schedules, the tiny
scope at preemption bound 1 with and without sleep sets (236 and 188
schedules, a few seconds), the three cheap mutants to their first
violation, and the busy-fraction mutant (849 schedules) in the port
only, its schedule replayed by the twin.  Also: the atomic-span
registry against the source markers, the host's default seams, the
CLI's report, and the ThreadSanitizer stress harness built plainly
against the port's native admission sources.
"""

import dataclasses
import io
import json
import os
import shutil
import subprocess
import threading
import time
from contextlib import redirect_stdout

import pytest
import torch

from agnes_tpu.analysis import schedcheck as jsc
from agnes_tpu_torch.analysis import schedcheck as tsc
from agnes_tpu_torch.analysis.modelcheck import _ddmin
from agnes_tpu_torch.core import native_build
from agnes_tpu_torch.serve.threaded import ThreadedVoteService
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_T = tsc.SCOPES["tiny"][0]
TINY_J = jsc.SCOPES["tiny"][0]

#: the first violation's schedule count per mutant at preemption bound 1
#: (bounds 0 and 1 together, as self_test counts them): the twin's
#: figures, which the port must reproduce schedule for schedule
MUTANT_SCHEDULES = {"inbox_close_toctou": 17, "native_drain_shrink": 35,
                    "shard_route_lost": 77}


def _same_run(a, b) -> None:
    assert a.choices == b.choices
    assert len(a.decisions) == len(b.decisions)
    assert a.trace == b.trace
    assert a.digest == b.digest
    assert [v.kind for v in a.violations] == [v.kind for v in b.violations]


def test_run_once_tiny_matches_twin():
    """The default schedule and one forced sibling (the first decision's
    other thread) give the same choices, decisions, trace and digest,
    and touch no device."""
    cuda_before = torch.cuda.is_initialized()
    t, j = tsc.run_once(TINY_T), jsc.run_once(TINY_J)
    assert t.completed and not t.violations
    _same_run(t, j)
    first = next(i for i, d in enumerate(t.decisions) if len(d.enabled) > 1)
    d = t.decisions[first]
    alt = next(x for x in d.enabled if x != d.chosen)
    forced = t.choices[:first] + [alt]
    ft, fj = tsc.run_once(TINY_T, forced=forced), \
        jsc.run_once(TINY_J, forced=forced)
    assert ft.choices[:first + 1] == forced and ft.choices != t.choices
    _same_run(ft, fj)
    assert torch.cuda.is_initialized() == cuda_before


def test_explore_tiny_prefix_matches_twin():
    t = tsc.explore(TINY_T, max_schedules=150)
    j = jsc.explore(TINY_J, max_schedules=150)
    assert (t.schedules, t.max_decisions) == (j.schedules, j.max_decisions)
    assert t.schedules == 150 and not t.complete
    assert t.digests == j.digests
    assert not t.violations and not j.violations


@pytest.mark.parametrize("pkg", ["port", "twin"])
def test_sleep_sets_keep_terminal_states(pkg):
    """Sleep-set soundness, by brute force: the tiny scope at preemption
    bound 1 exhausts with and without pruning to the same digest set, in
    each package (236 schedules full, 188 pruned)."""
    sc = tsc if pkg == "port" else jsc
    cfg = dataclasses.replace(sc.SCOPES["tiny"][0], name="tiny_b1",
                              preemption_bound=1)
    full = sc.explore(cfg, sleep_sets=False)
    pruned = sc.explore(cfg, sleep_sets=True)
    assert full.complete and pruned.complete
    assert (full.schedules, pruned.schedules) == (236, 188)
    assert pruned.digests == full.digests and len(full.digests) == 2
    assert not full.violations and not pruned.violations


def _first_violation(sc, name):
    """self_test's search: exhaust bound b before b + 1, stop at the
    first violating schedule.  (schedules, bound, first run)."""
    cfg = sc.MUTANTS[name][0]
    total = 0
    for b in range(cfg.preemption_bound + 1):
        r = sc.explore(dataclasses.replace(cfg, preemption_bound=b),
                       mutant=name, stop_on_violation=True,
                       max_schedules=5000)
        total += r.schedules
        if r.first_violating is not None:
            return total, b, r.first_violating
    raise AssertionError(f"{name} not caught")


@pytest.mark.parametrize("name", sorted(MUTANT_SCHEDULES))
def test_mutant_caught_as_twin(name):
    """The same schedule count to the first violation at bound 1, the
    same violating schedule and kinds; the port's ddmin-minimized
    schedule still reproduces it and replays clean on the honest
    build."""
    cfg, kinds, desc = tsc.MUTANTS[name]
    assert desc and kinds == jsc.MUTANTS[name][1]
    nt, bt, rt = _first_violation(tsc, name)
    nj, bj, rj = _first_violation(jsc, name)
    assert (nt, bt) == (nj, bj) == (MUTANT_SCHEDULES[name], 1)
    assert rt.choices == rj.choices
    got = sorted({v.kind for v in rt.violations})
    assert got == sorted({v.kind for v in rj.violations})
    assert set(got) & set(kinds)

    def pred(acts):
        r = tsc.run_once(cfg, name, forced=acts)
        return any(v.kind in kinds for v in r.violations)

    minimized = _ddmin(list(rt.choices), pred)
    assert len(minimized) <= len(rt.choices) and pred(minimized)
    assert not tsc.run_once(cfg, None, forced=minimized).violations


def test_busy_frac_mutant_found_in_port_replayed_by_twin():
    """The busy-fraction mutant's 849-schedule search runs in the port
    only; its first violating schedule, replayed by the twin, shows the
    same gauge violation."""
    n, b, res = _first_violation(tsc, "busy_frac_inflight")
    assert b == 1 and "busy_frac" in {v.kind for v in res.violations}
    cfg = jsc.MUTANTS["busy_frac_inflight"][0]
    rj = jsc.run_once(cfg, "busy_frac_inflight", forced=res.choices)
    assert "busy_frac" in {v.kind for v in rj.violations}
    assert rj.choices == res.choices
    assert not tsc.run_once(tsc.MUTANTS["busy_frac_inflight"][0], None,
                            forced=res.choices).violations


def test_atomic_spans_are_the_twins_and_match_markers():
    assert tsc.check_atomic_annotations(ROOT) == []
    assert tsc.ATOMIC_SPANS == {
        (rel.replace("agnes_tpu/", "agnes_tpu_torch/", 1), fn): res
        for (rel, fn), res in jsc.ATOMIC_SPANS.items()}
    assert tsc.ATOMIC_MARKER == jsc.ATOMIC_MARKER


class _StubService:
    """The duck surface the threaded host touches, doing nothing."""

    def __init__(self):
        from agnes_tpu_torch.utils.metrics import Metrics

        self.metrics = Metrics()
        self.queue = object()
        self.tracer = self.flightrec = self.bls = None
        self.pipeline = type("P", (), {"_staged": []})()
        self.submitted = 0

    def submit(self, blob):
        self.submitted += 1

    def _close_batch(self):
        return None

    def _pump_batch(self, batch):
        pass

    def poll_decisions(self):
        return []

    def drain(self):
        return {"metrics": self.metrics.snapshot()}


def test_default_seams_and_spy_thread_factory():
    """The defaults are threading.Thread and time.sleep; with a spy
    factory both service loops start through it, and the host still
    serves and drains."""
    plain = ThreadedVoteService(_StubService())
    assert plain._sleep is time.sleep
    assert type(plain._submit_t) is threading.Thread
    assert type(plain._dispatch_t) is threading.Thread

    made, naps = [], []

    def spy(**kw):
        t = threading.Thread(**kw)
        made.append(t)
        return t

    svc = _StubService()
    host = ThreadedVoteService(svc, thread_factory=spy,
                               sleep=lambda s: naps.append(s) or
                               time.sleep(s), idle_wait_s=0.001).start()
    assert host.submit(b"x" * 96)
    deadline = time.monotonic() + 30
    while not naps and time.monotonic() < deadline:   # an idle nap taken
        time.sleep(0.001)
    rep = host.drain(timeout_s=30)
    assert [t.name for t in made] == ["agnes-serve-submit",
                                      "agnes-serve-dispatch"]
    assert all(not t.is_alive() for t in made)
    assert svc.submitted == 1 and rep["thread_failure"] is None
    assert naps and set(naps) == {0.001}


def test_cli_report_keys():
    """The CLI's report on a bounded tiny scope: no violation, the
    metric names, a partial (max-schedules) run marked incomplete."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tsc.main(["--scope", "tiny", "--max-schedules", "40",
                       "--json"])
    rep = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0 and rep["ok"] and rep["violations"] == 0
    assert rep["schedules_explored"] == 40 and rep["complete"] is False
    assert rep["metrics"] == {"schedcheck_schedules_explored": 40,
                              "schedcheck_violations": 0}
    assert set(rep) >= {"scope", "configs", "seconds", "deadline"}


def test_tsan_admission_harness_plain_build(tmp_path):
    """The twin's admission stress harness (read, not edited), built
    without -fsanitize=thread against the port's admission sources and
    generated SHA-512 constants: the admission taxonomy balances under
    real producer / drainer / reader concurrency."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (tmp_path / "sha512_k.inc").write_text(native_build.gen_sha512_inc())
    nat = os.path.join(ROOT, "agnes_tpu_torch", "core", "native")
    binary = tmp_path / "tsan_admission_stress"
    build = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-pthread", "-I", str(tmp_path),
         "-o", str(binary),
         os.path.join(ROOT, "tests", "native", "tsan_admission_stress.cpp")]
        + [os.path.join(nat, f) for f in (
            "admission.cpp", "admission_phases.cpp", "admission_shards.cpp",
            "sha512.cpp")],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr
    run = subprocess.run([str(binary)], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, (run.stdout, run.stderr)
    assert "tsan_admission_stress ok" in run.stdout, run.stdout
