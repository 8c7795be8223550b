"""The static analyzer's CLI (twin of `agnes_tpu.analysis.lint_cli`).

Runs the port's analysis passes over the repo, all on the CPU, without
building or launching anything, and exits non-zero on any finding:

  retrace  static warmup-coverage proof: every signed shape the serve
           plane can dispatch is covered by the warmup plan, on the
           packed-lane ladder with the pre-verified stream and on the
           dense ladder (the runtime half is DeviceDriver(audit=True))
  locks    the threaded host's two-lock discipline and no bare
           .acquire() / .release() anywhere in the package
           (lockcheck.py, LOCK001-005)
  lint     hot-path host syncs, raw native C calls outside the audited
           wrappers, bare threads outside the wrapper modules (lint.py,
           LINT001 / 004 / 005)

The twin's other passes have no subject here: `jaxpr` and `census`
trace and count jit entries the port does not have, `pallas` audits
Pallas lowering per backend, and the port's collective census is
`parallel/sharded.py::ShardedStep`'s own.  The twin's backend set-up
(CPU platform, virtual devices) is a JAX concern and does not carry
over.

Run it as `python -m agnes_tpu_torch.analysis.lint_cli [--pass
retrace|locks|lint|all] [--json]`.  The last stdout line is the JSON
report (`passes`, `findings`, `seconds`, `metrics`, `ok`); the exit
code is 0 when clean and 1 on any finding.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PASSES = ("retrace", "locks", "lint")

#: the retrace pass's planning budget: one H100's 80 GiB
PLAN_HBM = 80 << 30

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_retrace(quick: bool, metrics):
    # static proof only, no tensors: the serve build policy's
    # dispatchable (P, rung) set against the warmup plan, at a
    # representative deployment shape.  The budget is an H100's memory,
    # given explicitly: a CPU has no default budget to plan from
    from agnes_tpu_torch.analysis import retrace
    from agnes_tpu_torch.serve.batcher import ShapeLadder

    ladder = ShapeLadder.plan(64, 32, min_rung=256, hbm_bytes=PLAN_HBM)
    findings = []
    # the dedup=True shape set holds the dedup=False one (the
    # pre-verified stream's unsigned entries join the signed rungs), so
    # one call covers both
    findings += retrace.coverage_findings(ladder, n_phases=(2, 3),
                                          dedup=True)
    findings += retrace.coverage_findings(ladder, n_phases=(2, 3),
                                          dense=True)
    detail = {"ladder_rungs": list(ladder.rungs),
              "covered": not findings}
    return findings, detail


def run_locks(quick: bool, metrics):
    from agnes_tpu_torch.analysis import lockcheck

    paths = lockcheck.default_paths(_REPO)
    return lockcheck.check_paths(paths), {"paths": paths}


def run_lint(quick: bool, metrics):
    from agnes_tpu_torch.analysis import lint

    return lint.check_repo(_REPO), {}


RUNNERS = {"retrace": run_retrace, "locks": run_locks, "lint": run_lint}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pass", dest="passes", default="all",
                    choices=PASSES + ("all",),
                    help="which analysis pass to run (default: all)")
    ap.add_argument("--quick", action="store_true",
                    help="accepted for the twin's command line; every "
                         "pass here is already quick")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON report on stdout")
    args = ap.parse_args(argv)
    selected = PASSES if args.passes == "all" else (args.passes,)

    from agnes_tpu_torch.utils.metrics import (
        ANALYSIS_ENTRIES_AUDITED,
        RETRACE_UNEXPECTED,
        Metrics,
    )

    metrics = Metrics()
    report = {"passes": {}, "findings": []}
    t_all = time.perf_counter()
    for name in selected:
        t0 = time.perf_counter()
        findings, detail = RUNNERS[name](args.quick, metrics)
        dt = time.perf_counter() - t0
        report["passes"][name] = {
            "findings": len(findings), "seconds": round(dt, 1),
            **detail,
        }
        report["findings"].extend(
            {"pass": f.pass_name, "code": f.code, "where": f.where,
             "message": f.message} for f in findings)
        if not args.json:
            status = "CLEAN" if not findings else \
                f"{len(findings)} finding(s)"
            print(f"[agnes_lint] {name}: {status} ({dt:.1f}s)",
                  file=sys.stderr, flush=True)
            for f in findings:
                print(f"  {f}", file=sys.stderr, flush=True)
    report["seconds"] = round(time.perf_counter() - t_all, 1)
    report["metrics"] = {
        ANALYSIS_ENTRIES_AUDITED:
            metrics.counters.get(ANALYSIS_ENTRIES_AUDITED, 0),
        RETRACE_UNEXPECTED:
            metrics.counters.get(RETRACE_UNEXPECTED, 0),
    }
    report["ok"] = not report["findings"]
    print(json.dumps(report, sort_keys=True), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
