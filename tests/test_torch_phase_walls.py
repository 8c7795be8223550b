"""`agnes_tpu_torch.scripts.phase_walls`: the smoke's log cut into runs
of one tag, on a stand-in `chip_smoke.py` that logs at known times."""

import json
import subprocess
import sys
import textwrap

import pytest

from agnes_tpu_torch.scripts.phase_walls import segments


@pytest.mark.parametrize("stamped, want", [
    ([], []),
    ([(1.0, "[build] a"), (2.5, "[build] b"), (4.0, "[verify] c"),
      (4.5, "{\"kernels\": []}"), (7.0, "[pod d] e"), (8.0, "[pod d] f")],
     [("build", 2, 2.5), ("verify", 1, 1.5), (None, 1, 0.5),
      ("pod d", 2, 3.5)]),
    ([(0.5, "untagged"), (1.0, "[pod] a"), (1.5, "[pod c] b"),
      (3.0, "[pod] c")],
     [(None, 1, 0.5), ("pod", 1, 0.5), ("pod c", 1, 0.5), ("pod", 1, 1.5)]),
])
def test_segments_cut_the_log_at_tag_changes(stamped, want):
    got = segments(stamped)
    assert [(s["tag"], s["lines"]) for s in got] == \
        [(t, n) for t, n, _ in want]
    assert [s["s"] for s in got] == pytest.approx([s for *_, s in want])


def test_runs_the_smoke_of_a_checkout_and_keeps_its_exit_code(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(textwrap.dedent("""
        import sys, time
        for tag in ("build", "build", "pod"):
            time.sleep(0.05)
            print(f"[{tag}] x", flush=True)
        print('{"ok": true}')
        sys.exit(3)
    """))
    log = tmp_path / "walls.log"
    out = subprocess.run(
        [sys.executable, "-m", "agnes_tpu_torch.scripts.phase_walls",
         str(tmp_path), str(log)], capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 3, out.stderr
    *tail, last = out.stdout.strip().splitlines()
    assert tail == ["[build] x", "[pod] x", '{"ok": true}']
    rec = json.loads(last)
    assert rec["rc"] == 3
    assert [(s["tag"], s["lines"]) for s in rec["segments"]] == \
        [("build", 2), ("pod", 1), (None, 1)]
    assert all(s["s"] >= 0 for s in rec["segments"])
    lines = log.read_text().splitlines()
    assert [ln.split(None, 1)[1] for ln in lines] == \
        ["[build] x", "[build] x", "[pod] x", '{"ok": true}']
