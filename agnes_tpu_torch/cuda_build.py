"""Build and load the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` exposes a plain C entry point and is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library that
`ctypes` loads — no PyTorch headers, so a build takes seconds.  The
library lands in `csrc/build/<name>-<source hash>.so` at first use (the
directory is generated, never committed); the hash covers the source and
every shared header `csrc/*.cuh`, so an edited header rebuilds.  The
`ptxas -v` report (registers, spill bytes) is kept beside it in
`<name>-<hash>.log`.

Nothing is built while a module is imported: `load` runs inside the
first launch.  `build_all` starts one `nvcc` per source at once, so a
run that needs every kernel pays for the slowest build, not the sum.
A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = CSRC / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> seconds the nvcc build took in this process (0.0 when cached)
build_seconds: Dict[str, float] = {}
# callables (name, seconds) told of every nvcc build that ran
_observers: List[Callable[[str, float], None]] = []


def on_build(fn: Callable[[str, float], None]) -> None:
    """Call `fn(name, seconds)` after each nvcc build this process runs
    (the serve plane's flight recorder dates them)."""
    _observers.append(fn)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def build_key(src: Path) -> str:
    """Hash of a source and every header beside it (sorted by name)."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    return h.hexdigest()[:16]


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    stem = BUILD / f"{name}-{build_key(src)}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def _start(name: str):
    """Start the nvcc build of one source; None when already built."""
    src, lib, log = _paths(name)
    if lib.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp, lib, log, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, cmd, tmp, lib, log, t0 = job
    out, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    log.write_text(" ".join(cmd) + "\n" + out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):"
                           f"\n{out}")
    os.replace(tmp, lib)
    for fn in list(_observers):
        fn(name, build_seconds[name])


def build_all(names: List[str]) -> None:
    """Build every named kernel, one nvcc process each, all at once."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is None:
                build_seconds.setdefault(n, 0.0)
            else:
                _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _loaded[name]


def ptxas_report(name: str) -> List[str]:
    """The `ptxas -v` lines (registers, spills) of the built kernel."""
    log = _paths(name)[2]
    if not log.exists():
        return []
    keys = ("registers", "spill", "stack")
    return [ln.strip() for ln in log.read_text().splitlines()
            if any(k in ln for k in keys)]


def ptxas_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel function of the built source: `parse_ptxas` of its
    report ({} before the first build)."""
    log = _paths(name)[2]
    return parse_ptxas(log.read_text()) if log.exists() else {}


def parse_ptxas(report: str) -> Dict[str, Dict[str, int]]:
    """Mangled function name -> its `registers`, `stack_bytes` (stack
    frame) and `spill_bytes` (spill stores plus spill loads), from a
    `ptxas -v` report."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for ln in report.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and fn:
            out[fn].update(stack_bytes=int(m.group(1)),
                           spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out
