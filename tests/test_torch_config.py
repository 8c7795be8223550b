"""Port differential: the run configuration (`agnes_tpu_torch.utils.config
.RunConfig`) and the deadline half of `agnes_tpu_torch.utils.budget`
against their JAX twins.

`RunConfig`: `as_dict` field for field (the timeouts as a dict),
`validate` raising on the same bad inputs, `from_args` over the same argv
lists, the batcher `make_batcher` builds (its shape and policy, and a
small unsigned build leaf for leaf), and `make_native_loop` refusing the
MSM mode.  The deadline: `deadline_margin_s` over a grid,
`Deadline.discover` under its env var and under `default_s`, and
`install_deadline_signals` in a child interpreter under `timeout` (the
callback runs on the TERM `timeout` passes on and on the alarm, and the
alarm delay is the twin's for the same deadline).  No JAX verify is compiled.
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from agnes_tpu.utils import budget as jb
from agnes_tpu.utils.config import RunConfig as JConfig
from agnes_tpu_torch.utils import RunConfig
from agnes_tpu_torch.utils import budget as tb
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- RunConfig -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    dict(n_validators=5, n_instances=6, n_rounds=3, n_slots=2,
         mesh=(2, 5), float_dtype="float32", verify_mode="msm",
         held_cap=100, checkpoint_dir="/ckpt", checkpoint_every_steps=7),
])
def test_as_dict_equals_twin(kw):
    t, j = RunConfig(**kw).validate(), JConfig(**kw).validate()
    assert t.as_dict() == j.as_dict()
    assert isinstance(t.as_dict()["timeouts"], dict)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]


@pytest.mark.parametrize("kw", [
    dict(n_validators=0), dict(n_instances=0), dict(n_rounds=0),
    dict(n_slots=0), dict(n_instances=10, mesh=(3, 1)),
    dict(n_validators=10, mesh=(1, 3)), dict(float_dtype="float16"),
    dict(verify_mode="batch"), dict(held_cap=0),
])
def test_validate_raises_where_the_twin_does(kw):
    with pytest.raises(AssertionError):
        JConfig(**kw).validate()
    with pytest.raises(AssertionError):
        RunConfig(**kw).validate()


@pytest.mark.parametrize("argv", [
    [],
    ["--validators", "7", "--instances", "16", "--mesh", "4x1"],
    ["--mesh", "4x2", "--rounds", "3", "--slots", "2",
     "--float-dtype", "float32", "--verify-mode", "msm",
     "--held-cap", "4096", "--checkpoint-dir", "ck",
     "--checkpoint-every", "5"],
])
def test_from_args_equals_twin(argv):
    assert RunConfig.from_args(argv).as_dict() == \
        JConfig.from_args(argv).as_dict()


I, V, S = 6, 5, 2


def _traffic(rng, n=60):
    return (rng.randint(0, I, n), rng.randint(0, V, n),
            np.zeros(n, np.int64), rng.randint(0, 3, n),
            rng.choice([0, 1], n), rng.choice([-1, 3, 3, 9], n))


@pytest.mark.parametrize("kw", [
    dict(n_slots=S),
    dict(n_slots=S, n_rounds=3, held_cap=17, verify_mode="msm"),
])
def test_make_batcher_equals_twin(kw):
    cfg = dict(n_instances=I, n_validators=V, **kw)
    t = RunConfig(**cfg).validate().make_batcher(device="cpu")
    j = JConfig(**cfg).validate().make_batcher()
    for f in ("I", "V", "W", "held_cap", "verify_mode", "msm_leaf"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.slots.n_slots == j.slots.n_slots == S
    rng = np.random.RandomState(len(kw))
    for _ in range(2):
        cols = _traffic(rng)
        t.add_arrays(*cols)
        j.add_arrays(*cols)
        tp, jp = t.build_phases(), j.build_phases()
        assert [n for _, n in tp] == [n for _, n in jp]
        for (a, _), (b, _) in zip(tp, jp):
            for name, x, y in zip(a._fields, a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=name)
        assert t._held_n == j.held_votes
        assert t.dropped_held_overflow == j.dropped_held_overflow


def test_make_batcher_builds_on_the_card_by_default():
    import inspect

    from agnes_tpu_torch.bridge.ingest import VoteBatcher

    assert inspect.signature(VoteBatcher).parameters["device"].default \
        == "cuda"
    t = RunConfig(n_instances=2, n_validators=3).make_batcher(
        device="cpu", n_slots=3)
    assert (t.device.type, t.slots.n_slots) == ("cpu", 3)


def test_make_native_loop_refuses_msm_in_both():
    for cls in (RunConfig, JConfig):
        with pytest.raises(ValueError, match="make_batcher"):
            cls(n_instances=2, n_validators=3,
                verify_mode="msm").validate().make_native_loop()


def test_make_native_loop_takes_the_config():
    loop = RunConfig(n_instances=2, n_validators=3, n_slots=3, n_rounds=2,
                     held_cap=77).make_native_loop(
        powers=np.array([1, 2, 3]), device="cpu")
    assert (loop.I, loop.V, loop._n_slots, loop._n_rounds,
            loop.held_cap) == (2, 3, 3, 2, 77)
    assert loop.device.type == "cpu" and not loop.signed


# -- the deadline half ----------------------------------------------------------

def test_deadline_margin_equals_twin():
    for rem in [0.0, 1.0, 4.9, 25.0, 25.1, 100.0, 149.9, 150.0, 151.0,
                1e4, math.inf]:
        assert tb.deadline_margin_s(rem) == jb.deadline_margin_s(rem)


@pytest.mark.parametrize("mod", [tb, jb], ids=["port", "twin"])
def test_discover_env_var_then_default(mod, monkeypatch):
    monkeypatch.setattr(mod, "enclosing_timeout_remaining", lambda: None)
    monkeypatch.setenv("AGNES_BENCH_DEADLINE_S", "40")
    d = mod.Deadline.discover()
    assert d.source == "env:AGNES_BENCH_DEADLINE_S"
    assert 39.0 < d.remaining() <= 40.0
    monkeypatch.setenv("AGNES_BENCH_DEADLINE_S", "not a number")
    assert mod.Deadline.discover().source == "none"
    d = mod.Deadline.discover(default_s=12.5)
    assert d.source == "default" and 12.0 < d.remaining() <= 12.5
    monkeypatch.delenv("AGNES_BENCH_DEADLINE_S")
    monkeypatch.setenv("MY_DEADLINE", "3")
    d = mod.Deadline.discover("MY_DEADLINE", default_s=99.0)
    assert d.source == "env:MY_DEADLINE" and d.remaining() <= 3.0
    monkeypatch.setattr(mod, "enclosing_timeout_remaining", lambda: 8.0)
    d = mod.Deadline.discover(default_s=99.0)
    assert d.source == "proc:timeout" and d.remaining() <= 8.0


_CHILD = """
import os, sys, time
sys.path.insert(0, {repo!r})
from agnes_tpu.utils import budget as jb
from agnes_tpu_torch.utils import budget as tb

def done(signum):
    print("signal", signum, flush=True)
    os._exit(0)

at = time.monotonic() + 100.0
jd = jb.install_deadline_signals(done, jb.Deadline(at=at))
td = tb.install_deadline_signals(done, tb.Deadline(at=at))
print("delays", jd, td, flush=True)
print("source", tb.Deadline.discover("AGNES_TEST_UNSET_DEADLINE").source,
      flush=True)
if {alarm}:
    tb.install_deadline_signals(done, tb.Deadline.after(30.0), margin_s=29.5)
else:
    tb.install_deadline_signals(done, tb.Deadline.none())
print("ready", flush=True)
time.sleep(60)
print("no signal", flush=True)
"""


@pytest.mark.parametrize("alarm,signum", [(False, 15), (True, 14)],
                         ids=["TERM", "ALRM"])
def test_install_deadline_signals_in_a_child(alarm, signum):
    """A child under `timeout 60`: the port's alarm delay for a deadline
    100 s out is the twin's, discovery reads the enclosing `timeout`,
    and the callback runs on the TERM that `timeout` passes on (no alarm
    armed) or on the alarm (armed 1 s out)."""
    import signal

    src = _CHILD.format(repo=REPO, alarm=alarm)
    proc = subprocess.Popen(["timeout", "60", sys.executable, "-c", src],
                            stdout=subprocess.PIPE, text=True)
    try:
        lines = []
        while not lines or lines[-1] != "ready":
            line = proc.stdout.readline()
            assert line, lines
            lines.append(line.strip())
        if not alarm:
            proc.send_signal(signal.SIGTERM)    # timeout passes it on
        lines += [x.strip() for x in proc.stdout]
        proc.wait(timeout=30)
    finally:
        proc.kill()
    _, jd, td = lines[0].split()
    assert jd == td and float(td) in (79.0, 80.0), lines
    assert lines[1] == "source proc:timeout", lines
    assert lines[3:] == [f"signal {signum}"], lines
