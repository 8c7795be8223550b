"""On-demand g++ build of the port's native C++ core (twin of
`agnes_tpu.core.native_build`).

`lib()` compiles `agnes_tpu_torch/core/native/*.cpp` (the port's own
copy: the state machine, tally, validator set, SHA-512, Ed25519, the
flat C ABI, the ingest loop, and the serve plane's admission queue, its
shards and its phase drain) into one shared library with g++ at first
use, and loads it with ctypes.  The library is host code: it runs
on the host CPU and never touches the card.  The SHA-512
and SHA-256 round and IV constants are generated into `sha512_k.inc`
from their FIPS 180-4 definitions, by the integer roots that
`crypto/sha512.py` uses.  The `.inc` and the `.so` go to
`core/native/build/` (gitignored), the `.so` named by a hash of the
sources and the generated constants, so an edit rebuilds it.  A build
writes a per-process temporary file and renames it into place, so
concurrent first builds (parallel test workers) never race.  A failed
build raises RuntimeError with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from typing import List

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
SOURCES = ["core.cpp", "sha512.cpp", "ed25519.cpp", "capi.cpp",
           "ingest.cpp", "admission.cpp", "admission_phases.cpp",
           "admission_shards.cpp"]
HEADERS = ["core.hpp", "sha512.hpp", "ed25519.hpp", "admission.hpp"]
_M64 = (1 << 64) - 1


def _sha256_constants():
    """SHA-256 K and IV (FIPS 180-4 §4.2.2, §5.3.3): the fractional
    parts of the cube and square roots of the first 64 and 8 primes,
    exactly, as floor(cbrt(p * 2^96)) mod 2^32 and floor(sqrt(p * 2^64))
    mod 2^32, checked against the published first and last words."""
    from agnes_tpu_torch.crypto.sha512 import _icbrt, _primes

    primes = _primes(64)
    k256 = [_icbrt(p << 96) & 0xFFFFFFFF for p in primes]
    h256 = [math.isqrt(p << 64) & 0xFFFFFFFF for p in primes[:8]]
    if not (k256[0] == 0x428a2f98 and k256[63] == 0xc67178f2
            and h256[0] == 0x6a09e667 and h256[7] == 0x5be0cd19):
        raise RuntimeError("SHA-256 constants do not match FIPS 180-4")
    return k256, h256


def gen_sha512_inc() -> str:
    """The text of `sha512_k.inc`.  `crypto/sha512.py` holds the SHA-512
    words as the int64 values with the same bits; they are written back
    here as their unsigned 64-bit patterns."""
    from agnes_tpu_torch.crypto.sha512 import _H0, _K

    k512 = [k & _M64 for k in _K]
    h512 = [h & _M64 for h in _H0]
    lines = ["// generated by agnes_tpu_torch/core/native_build.py from",
             "// the FIPS 180-4 definitions (frac parts of prime roots)",
             "static const uint64_t kK[80] = {"]
    for i in range(0, 80, 4):
        lines.append("  " + " ".join(f"0x{k:016x}ULL," for k in k512[i:i + 4]))
    lines.append("};")
    lines.append("static const uint64_t kH0[8] = {")
    for i in range(0, 8, 4):
        lines.append("  " + " ".join(f"0x{h:016x}ULL," for h in h512[i:i + 4]))
    lines.append("};")
    k256, h256 = _sha256_constants()
    lines.append("static const uint32_t kK256[64] = {")
    for i in range(0, 64, 6):
        lines.append("  " + " ".join(f"0x{k:08x}u," for k in k256[i:i + 6]))
    lines.append("};")
    lines.append("static const uint32_t kH256[8] = {")
    lines.append("  " + " ".join(f"0x{h:08x}u," for h in h256))
    lines.append("};")
    return "\n".join(lines) + "\n"


def _source_hash(inc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(inc.encode())
    return h.hexdigest()[:16]


def command(out_path: str) -> List[str]:
    """The g++ command line that builds the library into `out_path`:
    the port's sources only, the generated constants from BUILD_DIR."""
    return (["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
             "-pthread",   # ingest.cpp's worker, admission's mutexes
             "-I", BUILD_DIR, "-o", out_path]
            + [os.path.join(NATIVE_DIR, s) for s in SOURCES])


def _atomic_write(path: str, data: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)


def build() -> str:
    """Compile the library if its sources changed; return its path."""
    inc = gen_sha512_inc()
    so_path = os.path.join(BUILD_DIR, f"libagnes_torch_{_source_hash(inc)}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    _atomic_write(os.path.join(BUILD_DIR, "sha512_k.inc"), inc)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    r = subprocess.run(command(tmp), capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ build of the native core failed "
                           f"(exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, so_path)
    return so_path


_lib = None


def lib() -> ctypes.CDLL:
    """The loaded native library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    return _lib
