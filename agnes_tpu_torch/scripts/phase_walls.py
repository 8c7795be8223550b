"""Where a `chip_smoke.py` run spends its wall, read off its log.

    python3 -m agnes_tpu_torch.scripts.phase_walls CHECKOUT LOG

runs `python3 chip_smoke.py` from the root of CHECKOUT (a checkout of
this repo, of any commit), stamps every line of its standard output with
the seconds since the start, writes the stamped lines to LOG, and then
prints one JSON line: the smoke's exit code, its wall, and the log cut
into runs of consecutive lines under one tag ("[verify]", "[pod d]",
...), each with the seconds from the last line before the run to its own
last line.  The smoke logs a phase's results as the phase ends, so a
run's seconds are, to within a log line, the wall of the work whose
results it reports.  The smoke's standard error passes through; the
exit code is the smoke's.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

TAG = re.compile(r"^\[([^\]]+)\]")


def segments(stamped):
    """[(t, line)] -> [{"tag", "lines", "s"}], one a run of one tag."""
    out = []
    for t, line in stamped:
        m = TAG.match(line)
        tag = m.group(1) if m else None
        if out and out[-1]["tag"] == tag:
            out[-1]["lines"] += 1
        else:
            out.append({"tag": tag, "lines": 1,
                        "start": out[-1]["end"] if out else 0.0})
        out[-1]["end"] = t
    return [{"tag": s["tag"], "lines": s["lines"],
             "s": s["end"] - s["start"]} for s in out]


def main(argv=None) -> int:
    checkout, log_path = (argv or sys.argv[1:])[:2]
    t0 = time.perf_counter()
    stamped = []
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"],
                                cwd=checkout, stdout=subprocess.PIPE,
                                text=True, bufsize=1)
        for line in proc.stdout:
            t = time.perf_counter() - t0
            stamped.append((t, line.rstrip("\n")))
            log.write(f"{t:9.1f} {line}")
            log.flush()
        rc = proc.wait()
    for _, line in stamped[-3:]:
        print(line)
    print(json.dumps({"checkout": checkout, "rc": rc,
                      "wall_s": time.perf_counter() - t0,
                      "segments": segments(stamped)}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
