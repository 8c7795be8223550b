"""Heartbeat post-mortem CLI: render flight-recorder NDJSON trails into
a human summary, or schema-check them (twin of
`agnes_tpu.utils.metrics_cli`).

After a wedged run, point it at the run's heartbeat trail(s) and read
where the run was when it died:

  python -m agnes_tpu_torch.utils.metrics_cli hb.ndjson          # summary
  python -m agnes_tpu_torch.utils.metrics_cli --check hb.ndjson  # schema gate
  python -m agnes_tpu_torch.utils.metrics_cli --json hb.ndjson   # machine summary
  python -m agnes_tpu_torch.utils.metrics_cli hb.0 hb.1          # pod merge

`--check` exits 1 when any file holds zero valid lines or any line
fails the schema (utils/flightrec.REQUIRED_KEYS and the optional host
stamp), and 2 when a file is missing; one bad line that is the file's
last is tolerated as the cut of a process that died mid-write.  With
several paths every file must pass on its own (a pod run leaves one
trail per process).

Several paths without --check render the merged pod post-mortem
(utils/flightrec.render_pod_postmortem): hosts ranked by last-beat age,
the first host to go quiet first.

It imports only the standard library and utils/flightrec (itself
stdlib-only), neither torch nor anything else of the port's device
plane, so it runs on a box whose CUDA stack is the thing being
post-mortemed.
"""
from __future__ import annotations

import argparse
import json
import sys

from agnes_tpu_torch.utils.flightrec import (
    read_heartbeat,
    render_pod_postmortem,
    render_postmortem,
)


def _check_one(path: str) -> int:
    """Schema-gate one trail (the historical --check semantics)."""
    try:
        lines, bad = read_heartbeat(path)
    except OSError as e:
        print(f"agnes-metrics: cannot read {path}: {e}",
              file=sys.stderr)
        return 2
    # ONE bad line that is the FILE'S LAST is the expected artifact
    # of abrupt death mid-write (SIGKILL / os._exit while the
    # heartbeat thread writes) — the exact scenario the recorder
    # exists to survive.  Tolerate precisely that; any interior bad
    # line, or a trail with no valid line, fails.
    with open(path) as f:
        n_raw = sum(1 for raw in f if raw.strip())
    trailing = (len(bad) == 1 and bool(lines) and bad[0][0] == n_raw)
    for i, why in bad:
        print(f"BAD line {i}: {why}"
              + (" (trailing — tolerated as a death-cut line)"
                 if trailing else ""), file=sys.stderr)
    if (bad and not trailing) or not lines:
        print(f"heartbeat check FAILED: {len(lines)} valid, "
              f"{len(bad)} bad line(s) in {path}", file=sys.stderr)
        return 1
    print(f"heartbeat check OK: {path}: {len(lines)} valid line(s), "
          f"schema v{lines[-1]['v']}, last seq {lines[-1]['seq']}"
          + (", 1 trailing death-cut line tolerated" if trailing
             else "")
          + (f", host_id {lines[-1]['host_id']}"
             if "host_id" in lines[-1] else ""))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="agnes-metrics",
        description="render / schema-check flight-recorder heartbeat "
                    "NDJSON trails (several paths = pod merge)")
    ap.add_argument("paths", nargs="+", metavar="path",
                    help="heartbeat NDJSON file(s) — one per pod "
                         "process")
    ap.add_argument("--check", action="store_true",
                    help="schema gate: exit nonzero unless every "
                         "file's every line parses and validates and "
                         "each file holds at least one valid line")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable summary instead of prose")
    args = ap.parse_args(argv)

    if args.check:
        rcs = [_check_one(p) for p in args.paths]
        return max(rcs)

    if args.as_json:
        files = []
        ok = True
        for path in args.paths:
            try:
                lines, bad = read_heartbeat(path)
            except OSError:
                files.append({"path": path, "valid_lines": 0,
                              "bad_lines": 0, "unreadable": True,
                              "first": None, "last": None})
                ok = False
                continue
            files.append({
                "path": path,
                "valid_lines": len(lines),
                "bad_lines": len(bad),
                "first": lines[0] if lines else None,
                "last": lines[-1] if lines else None,
            })
            ok = ok and bool(lines)
        summary = files[0] if len(files) == 1 else {"files": files}
        print(json.dumps(summary, sort_keys=True))
        return 0 if ok else 1

    if len(args.paths) == 1:
        path = args.paths[0]
        try:
            lines, bad = read_heartbeat(path)
        except OSError as e:
            print(f"agnes-metrics: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        print(render_postmortem(path))
        return 0 if lines and not bad else 1

    print(render_pod_postmortem(args.paths))
    # rc mirrors the single-path render PER TRAIL: any unreadable
    # file -> 2, any file with bad lines or zero valid lines -> 1 — a
    # gating script keying on the render's rc must see a pod with one
    # corrupt/missing trail as unhealthy, exactly like the merge's
    # prose does
    worst = 0
    for path in args.paths:
        try:
            lines, bad = read_heartbeat(path)
        except OSError:
            worst = max(worst, 2)
            continue
        if bad or not lines:
            worst = max(worst, 1)
    return worst


if __name__ == "__main__":
    sys.exit(main())
