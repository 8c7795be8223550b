"""Pure-Python Ed25519 (RFC 8032) — the signing/verification oracle.

Written from the RFC 8032 specification (curve equations, encodings and
check equation as specified in §5.1; constants from §5.1 "edwards25519").
The PyTorch port keeps its own copy of `agnes_tpu.crypto.ed25519_ref`
(the port imports nothing of the JAX package): it is the verdict oracle
the port's batched verifier is tested against and the signer
`harness/fixtures.py` uses to fabricate signed vote fixtures.  The
reference engine itself has no signature code anywhere (SURVEY.md §2.1:
`Vote` carries no signature; consensus_executor.rs:35-41 stubs "sign the
vote").

Not constant-time; host-side fixture/oracle use only.  The hot
verification path is the batched verifier (`crypto/ed25519.py`).
"""

from __future__ import annotations

import hashlib
from typing import Tuple

# --- curve constants (RFC 8032 §5.1) ---------------------------------------
P = 2**255 - 19                      # field prime
L = 2**252 + 27742317777372353535851937790883648493   # group order
D = (-121665 * pow(121666, P - 2, P)) % P             # edwards d
SQRT_M1 = pow(2, (P - 1) // 4, P)                     # sqrt(-1)

# base point B (x from sign bit 0 with y = 4/5)
_BY = (4 * pow(5, P - 2, P)) % P


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


def _sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def _sha512_int(data: bytes) -> int:
    return int.from_bytes(_sha512(data), "little")


# --- point arithmetic in extended homogeneous coordinates -------------------
# A point is (X, Y, Z, T) with x = X/Z, y = Y/Z, x*y = T/Z.

Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)


def _add(p: Point, q: Point) -> Point:
    """Unified addition on edwards25519 (complete formulas)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _double(p: Point) -> Point:
    return _add(p, p)


def _mul(s: int, p: Point) -> Point:
    """Scalar multiplication by double-and-add (MSB first)."""
    q = IDENTITY
    for bit in reversed(range(s.bit_length())):
        q = _double(q)
        if (s >> bit) & 1:
            q = _add(q, p)
    return q


def _recover_x(y: int, sign: int) -> int | None:
    """x with x^2 = (y^2-1)/(d*y^2+1), choosing the given sign bit."""
    if y >= P:
        return None
    x2 = (y * y - 1) * _inv(D * y * y + 1) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


BASE: Point = (_recover_x(_BY, 0), _BY, 1, (_recover_x(_BY, 0) * _BY) % P)


def _compress(p: Point) -> bytes:
    x, y, z, _ = p
    zi = _inv(z)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(data: bytes) -> Point | None:
    if len(data) != 32:
        return None
    enc = int.from_bytes(data, "little")
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, enc >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def point_equal(p: Point, q: Point) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


# --- key generation, signing, verification (RFC 8032 §5.1.5-5.1.7) ---------

def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def keypair(seed: bytes) -> Tuple[bytes, bytes]:
    """(secret, public) from a 32-byte seed; secret is the seed itself."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    a = _clamp(_sha512(seed))
    return seed, _compress(_mul(a, BASE))


def sign(secret: bytes, msg: bytes) -> bytes:
    """64-byte signature R || S."""
    h = _sha512(secret)
    a = _clamp(h)
    prefix = h[32:]
    pub = _compress(_mul(a, BASE))
    r = _sha512_int(prefix + msg) % L
    R = _compress(_mul(r, BASE))
    k = _sha512_int(R + pub + msg) % L
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify(public: bytes, msg: bytes, sig: bytes) -> bool:
    """COFACTORED check: [8]([S]B) == [8](R + [k]A), k = SHA-512(
    R || A || M) mod L, plus canonical encodings and S < L.

    The multiply-by-8 (vs RFC 8032's either-form allowance) is the
    framework's consensus-grade verification policy: it makes single,
    batched (msm_jax), and per-lane-kernel verification provably agree
    on every input — a signature's validity is a pure function of its
    bytes under every verification strategy, so nodes can never
    diverge on vote validity (the ZIP-215 agreement property).  All
    verifiers in this package (this oracle, the C++ host verifier,
    the jnp and Pallas batch verifiers, the MSM batch check) apply
    the same rule and are differential-tested for agreement."""
    if len(sig) != 64 or len(public) != 32:
        return False
    A = _decompress(public)
    if A is None:
        return False
    R = _decompress(sig[:32])
    if R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = _sha512_int(sig[:32] + public + msg) % L
    return point_equal(_mul(8, _mul(s, BASE)),
                       _mul(8, _add(R, _mul(k, A))))
