"""Pure-Python BLS12-381 — the aggregate-signature oracle (copy of
`agnes_tpu.crypto.bls_ref`, which imports nothing of JAX; the port keeps
its own copy so that it imports nothing of `agnes_tpu`).

The BLS lane's reference implementation, in the `ed25519_ref` oracle
style: plain Python ints, written from the curve's defining equations
(draft-irtf-cfrg-pairing-friendly-curves §4.2.1 parameterization), not
from any library.  Every derived constant (p, r, the cofactors) is
COMPUTED from the BLS parameter x at import and asserted against the
published hex values, so a transcription slip cannot silently ship.

Roles, mirroring PAPERS.md 2302.00418 (EdDSA vs BLS in committee-based
consensus):

* the **signer** the harness uses to fabricate BLS precommit shares
  (min-pubkey-size variant: pubkeys in G1 — 48-byte compressed —
  signatures in G2);
* the **pairing oracle** the serve plane's aggregate lane calls for
  its two O(1) pairings per vote class (`pairing_product_is_one`
  multiplies the Miller loops and pays ONE final exponentiation) —
  the O(N) aggregation work runs on device (`crypto/bls.py`),
  only the O(1)-per-class check runs here;
* the **differential oracle** tests/test_torch_bls*.py pin the port's
  limb field, MSM and pairing against.

Hash-to-G2 is deterministic try-and-increment over SHA-256 with
cofactor clearing — internally consistent across every verifier in
this repo (the property consensus needs), NOT the IETF
hash_to_curve suite; this repo never interoperates with external BLS
stacks.  Rogue-key defense is proof-of-possession (`pop_prove` /
`pop_verify`, domain-separated hash): an aggregate is only sound over
keys whose holder proved knowledge of the secret — the serve lane's
key registry enforces it at admission (README "BLS aggregate lane"
has the threat model).

Not constant-time; host-side fixture/oracle use only.  The hot
aggregation path is the batched device code (`crypto/bls.py`).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

# --- parameters, derived from the BLS parameter x and asserted --------------

X_PARAM = -0xD201000000010000                 # the BLS12-381 parameter
R = X_PARAM**4 - X_PARAM**2 + 1               # subgroup order (scalars)
P = (X_PARAM - 1) ** 2 * R // 3 + X_PARAM     # base field prime
H1 = (X_PARAM - 1) ** 2 // 3                  # G1 cofactor
H2 = (X_PARAM**8 - 4 * X_PARAM**7 + 5 * X_PARAM**6 - 4 * X_PARAM**4
      + 6 * X_PARAM**3 - 4 * X_PARAM**2 - 4 * X_PARAM + 13) // 9  # G2

assert P == int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16)
assert R == int(
    "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001",
    16)
assert P % 4 == 3          # sqrt via a^((p+1)/4)

B_G1 = 4                   # E:  y^2 = x^3 + 4       over Fp
B_G2 = (4, 4)              # E': y^2 = x^3 + 4(u+1)  over Fp2, u^2 = -1


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


def _sqrt_fp(x: int) -> Optional[int]:
    x %= P
    y = pow(x, (P + 1) // 4, P)
    return y if y * y % P == x else None


# --- Fp2 / Fp12 tower (py-polynomial fields, plain ints) --------------------
# Fp2 = Fp[u]/(u^2+1); Fp12 = Fp[w]/(w^12 - 2w^6 + 2), where w^6 = u+1.

class FQP:
    """Polynomial extension field element; subclasses fix degree and
    modulus coefficients (p(t) = t^deg + sum(mc[i] t^i))."""

    degree: int = 0
    mc: Tuple[int, ...] = ()

    __slots__ = ("c",)

    def __init__(self, coeffs: Sequence[int]):
        assert len(coeffs) == self.degree
        self.c = tuple(int(x) % P for x in coeffs)

    @classmethod
    def one(cls) -> "FQP":
        return cls((1,) + (0,) * (cls.degree - 1))

    @classmethod
    def zero(cls) -> "FQP":
        return cls((0,) * cls.degree)

    def __add__(self, o):
        return type(self)([a + b for a, b in zip(self.c, o.c)])

    def __sub__(self, o):
        return type(self)([a - b for a, b in zip(self.c, o.c)])

    def __neg__(self):
        return type(self)([-a for a in self.c])

    def __eq__(self, o):
        return type(self) is type(o) and self.c == o.c

    def __hash__(self):
        return hash((type(self).__name__, self.c))

    def scale(self, k: int) -> "FQP":
        return type(self)([a * k for a in self.c])

    def __mul__(self, o):
        d = self.degree
        buf = [0] * (2 * d - 1)
        for i, a in enumerate(self.c):
            if a:
                for j, b in enumerate(o.c):
                    buf[i + j] += a * b
        # reduce degree by the modulus polynomial, top down
        for k in range(2 * d - 2, d - 1, -1):
            top = buf[k]
            if top:
                buf[k] = 0
                for i, m in enumerate(self.mc):
                    if m:
                        buf[k - d + i] -= top * m
        return type(self)(buf[:d])

    def inv(self) -> "FQP":
        """Extended Euclid over Fp[t] against the modulus polynomial."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.c) + [0]
        high = [m % P for m in self.mc] + [1]
        while _deg(low):
            r = _poly_div(high, low)
            r += [0] * (d + 1 - len(r))
            nm, new = list(hm), list(high)
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        k = _inv(low[0])
        return type(self)([x * k for x in lm[:d]])

    def __truediv__(self, o):
        return self * o.inv()

    def __pow__(self, e: int):
        out = type(self).one()
        b = self
        while e:
            if e & 1:
                out = out * b
            b = b * b
            e >>= 1
        return out

    def is_zero(self) -> bool:
        return all(a == 0 for a in self.c)

    def __repr__(self):
        return f"{type(self).__name__}{self.c}"


def _deg(poly: List[int]) -> int:
    for i in range(len(poly) - 1, -1, -1):
        if poly[i]:
            return i
    return 0


def _poly_div(a: List[int], b: List[int]) -> List[int]:
    """Quotient of a/b over Fp[t] (b nonzero)."""
    da, db = _deg(a), _deg(b)
    out = [0] * (da - db + 1)
    rem = list(a)
    binv = _inv(b[db])
    for i in range(da - db, -1, -1):
        q = rem[db + i] * binv % P
        out[i] = q
        for j in range(db + 1):
            rem[i + j] -= q * b[j]
            rem[i + j] %= P
    return out


class FQ2(FQP):
    degree = 2
    mc = (1, 0)                       # u^2 = -1


class FQ12(FQP):
    degree = 12
    mc = (2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0)   # w^12 = 2w^6 - 2


def fq2(a: int, b: int) -> FQ2:
    return FQ2((a, b))


def _sqrt_fq2(a: FQ2) -> Optional[FQ2]:
    """Square root in Fp2 (u^2 = -1) via the norm trick; None when `a`
    is a non-residue.  Verified by squaring before returning."""
    x, y = a.c
    if y == 0:
        s = _sqrt_fp(x)
        if s is not None:
            cand = fq2(s, 0)
        else:
            s = _sqrt_fp(-x % P)
            if s is None:
                return None
            cand = fq2(0, s)
        return cand if cand * cand == a else None
    n = (x * x + y * y) % P
    s = _sqrt_fp(n)
    if s is None:
        return None
    inv2 = _inv(2)
    lam = (x + s) * inv2 % P
    c = _sqrt_fp(lam)
    if c is None:
        lam = (x - s) * inv2 % P
        c = _sqrt_fp(lam)
        if c is None:
            return None
    d = y * _inv(2 * c % P) % P
    cand = fq2(c, d)
    return cand if cand * cand == a else None


# --- curve arithmetic (affine, field-generic) -------------------------------
# A point is (x, y) with field elements, or None for the identity.

def _is_fq(v) -> bool:
    return isinstance(v, int)


def _fadd(a, b):
    return (a + b) % P if _is_fq(a) else a + b


def _fsub(a, b):
    return (a - b) % P if _is_fq(a) else a - b


def _fmul(a, b):
    return a * b % P if _is_fq(a) else a * b


def _fdiv(a, b):
    return a * _inv(b) % P if _is_fq(a) else a / b


def _fsq(a):
    return _fmul(a, a)


def point_add(p1, p2):
    """Affine chord-tangent addition (field-generic; None = identity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            if (y1 == 0 if _is_fq(y1) else y1.is_zero()):
                return None
            m = _fdiv(_fmul(3 if _is_fq(x1) else 3, _fsq(x1))
                      if _is_fq(x1) else _fsq(x1).scale(3),
                      _fmul(2, y1) if _is_fq(y1) else y1.scale(2))
        else:
            return None                     # P + (-P)
    else:
        m = _fdiv(_fsub(y2, y1), _fsub(x2, x1))
    x3 = _fsub(_fsub(_fsq(m), x1), x2)
    y3 = _fsub(_fmul(m, _fsub(x1, x3)), y1)
    return (x3, y3)


def point_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P if _is_fq(y) else -y)


def point_mul(k: int, pt):
    """Double-and-add scalar multiplication (MSB first)."""
    if k < 0:
        return point_mul(-k, point_neg(pt))
    q = None
    for bit in reversed(range(k.bit_length())):
        q = point_add(q, q)
        if (k >> bit) & 1:
            q = point_add(q, pt)
    return q


def on_curve_g1(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y % P == (x * x * x + B_G1) % P


def on_curve_g2(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y == x * x * x + FQ2(B_G2)


# generators (standard BLS12-381 generators, published coordinates)
G1 = (
    int("17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
        "6c55e83ff97a1aeffb3af00adb22c6bb", 16),
    int("08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
        "d03cc744a2888ae40caa232946c5e7e1", 16),
)
G2 = (
    fq2(int("024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647a"
            "e3d1770bac0326a805bbefd48056c8c121bdb8", 16),
        int("13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc"
            "7f5049334cf11213945d57e5ac7d055d042b7e", 16)),
    fq2(int("0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a6951"
            "60d12c923ac9cc3baca289e193548608b82801", 16),
        int("0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab57"
            "2e99ab3f370d275cec1da1aaa9075ff05f79be", 16)),
)
assert on_curve_g1(G1) and on_curve_g2(G2)


# --- pairing (optimal ate, py-generic Miller loop) --------------------------

_ATE = -X_PARAM                       # positive Miller-loop count
_LOG_ATE = _ATE.bit_length() - 2      # loop from the bit below the MSB
W2_INV = FQ12((0,) * 2 + (1,) + (0,) * 9).inv()      # w^-2
W3_INV = FQ12((0,) * 3 + (1,) + (0,) * 8).inv()      # w^-3


def _cast_g1(pt):
    """G1 point -> E(Fp12) coordinates."""
    x, y = pt
    return (FQ12((x,) + (0,) * 11), FQ12((y,) + (0,) * 11))


def _twist(pt):
    """G2 (on the twist, Fp2 coords) -> E(Fp12): with v = w^6 the
    tower relation gives (v - 1)^2 = -1, so a + b*u embeds as
    (a - b) + b*w^6 and the twist constant 4(1 + u) embeds as 4*w^6;
    untwisting divides x by w^2 and y by w^3, landing on
    y^2 = x^3 + 4 over Fp12 (checked below)."""
    x, y = pt
    nx = FQ12((x.c[0] - x.c[1],) + (0,) * 5 + (x.c[1],) + (0,) * 5)
    ny = FQ12((y.c[0] - y.c[1],) + (0,) * 5 + (y.c[1],) + (0,) * 5)
    return (nx * W2_INV, ny * W3_INV)


# the twisted generator must land on E(Fp12): y^2 = x^3 + 4
_tx, _ty = _twist(G2)
assert _ty * _ty == _tx * _tx * _tx + FQ12((4,) + (0,) * 11)
del _tx, _ty


def _linefunc(p1, p2, t):
    """l_{p1,p2} evaluated at t (all in E(Fp12), affine, non-identity)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1).scale(3) / y1.scale(2)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q, p) -> FQ12:
    """Miller loop over the ate count (no final exponentiation); q, p
    in E(Fp12) affine coordinates."""
    if q is None or p is None:
        return FQ12.one()
    r = q
    f = FQ12.one()
    for i in range(_LOG_ATE, -1, -1):
        f = f * f * _linefunc(r, r, p)
        r = point_add(r, r)
        if _ATE & (1 << i):
            f = f * _linefunc(r, q, p)
            r = point_add(r, q)
    return f


_FE_EXP = (P**12 - 1) // R


def final_exponentiate(f: FQ12) -> FQ12:
    return f ** _FE_EXP


def pairing(q, p) -> FQ12:
    """e(p, q) for p in G1, q in G2 (bilinear, non-degenerate; the
    x < 0 conjugation is skipped — consistent across this repo, which
    never interoperates with external pairing stacks)."""
    return final_exponentiate(miller_loop(_twist(q), _cast_g1(p)))


def pairing_product_is_one(pairs) -> bool:
    """prod e(p_i, q_i) == 1 for [(G1 point, G2 point)] — ONE final
    exponentiation however many pairs, the O(1)-per-class check the
    serve lane's aggregate verify calls (two Miller loops + one final
    exp instead of two full pairings)."""
    f = FQ12.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f * miller_loop(_twist(q), _cast_g1(p))
    return final_exponentiate(f) == FQ12.one()


# --- encodings --------------------------------------------------------------
# G1 pubkeys: 48-byte compressed big-endian x, ZCash-style flag bits in
# the top byte (compressed | infinity | y-sign).  G2 signatures travel
# UNCOMPRESSED on the wire (4 x 48-byte big-endian: x0 x1 y0 y1) so
# admission never pays an Fp2 square root per share.

_FLAG_C = 0x80
_FLAG_INF = 0x40
_FLAG_SIGN = 0x20


def _y_is_larger(y: int) -> bool:
    return y > P - y


def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([_FLAG_C | _FLAG_INF]) + bytes(47)
    x, y = pt
    flags = _FLAG_C | (_FLAG_SIGN if _y_is_larger(y) else 0)
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= flags
    return bytes(raw)


def g1_decompress(data: bytes):
    """48 bytes -> G1 point; raises ValueError on malformed input
    (wrong length, flags, x >= p, non-residue, off-subgroup)."""
    if len(data) != 48 or not data[0] & _FLAG_C:
        raise ValueError("bad G1 encoding")
    if data[0] & _FLAG_INF:
        if any(data[1:]) or data[0] & ~(_FLAG_C | _FLAG_INF):
            raise ValueError("bad G1 infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y = _sqrt_fp((x * x * x + B_G1) % P)
    if y is None:
        raise ValueError("G1 x not on curve")
    if _y_is_larger(y) != bool(data[0] & _FLAG_SIGN):
        y = P - y
    pt = (x, y)
    if point_mul(R, pt) is not None:
        raise ValueError("G1 point outside the r-torsion subgroup")
    return pt


SIG_BYTES = 192


def g2_to_bytes(pt) -> bytes:
    """G2 point -> 192 bytes (x0 x1 y0 y1, 48-byte big-endian each);
    the identity encodes as all-zero (not on the curve, so it is
    unambiguous)."""
    if pt is None:
        return bytes(SIG_BYTES)
    x, y = pt
    return (x.c[0].to_bytes(48, "big") + x.c[1].to_bytes(48, "big")
            + y.c[0].to_bytes(48, "big") + y.c[1].to_bytes(48, "big"))


def g2_from_bytes(data: bytes):
    """192 bytes -> G2 point (on-curve checked; subgroup NOT checked —
    the aggregate pairing check and the per-share fallback both fail a
    wrong-subgroup share, and a per-share r-torsion scalar mult at
    admission would cost more than the verify it guards; README
    documents the trade)."""
    if len(data) != SIG_BYTES:
        raise ValueError("bad G2 encoding length")
    if not any(data):
        return None
    vals = [int.from_bytes(data[i * 48:(i + 1) * 48], "big")
            for i in range(4)]
    if any(v >= P for v in vals):
        raise ValueError("G2 coordinate out of range")
    pt = (fq2(vals[0], vals[1]), fq2(vals[2], vals[3]))
    if not on_curve_g2(pt):
        raise ValueError("G2 point not on the twist curve")
    return pt


# --- hash to G2 -------------------------------------------------------------

_DST_MSG = b"AGNES-TPU-BLS12381G2-TAI-V1"
_DST_POP = b"AGNES-TPU-BLS12381G2-POP-V1"


def _fp_from_hash(dst: bytes, msg: bytes, tag: bytes, ctr: int) -> int:
    h = hashlib.sha512(dst + tag + ctr.to_bytes(4, "little") + msg)
    return int.from_bytes(h.digest(), "big") % P


def hash_to_g2(msg: bytes, dst: bytes = _DST_MSG):
    """Deterministic try-and-increment onto the twist, then cofactor-
    cleared into G2 (module docstring: internally consistent, not the
    IETF suite).  Never returns the identity for practical inputs (a
    counter whose candidate clears to infinity is skipped)."""
    ctr = 0
    while True:
        x = fq2(_fp_from_hash(dst, msg, b"x0", ctr),
                _fp_from_hash(dst, msg, b"x1", ctr))
        y = _sqrt_fq2(x * x * x + FQ2(B_G2))
        if y is not None:
            # deterministic sign choice: smaller (c0, c1) lexicographic
            if (y.c[0], y.c[1]) > ((-y).c[0], (-y).c[1]):
                y = -y
            pt = point_mul(H2, (x, y))
            if pt is not None:
                return pt
        ctr += 1


def hash_pop(pk_bytes: bytes):
    """The proof-of-possession message point: the pubkey hashed under
    its own domain tag, so a PoP can never double as a vote share."""
    return hash_to_g2(pk_bytes, dst=_DST_POP)


# --- the signature scheme (min-pubkey-size) ---------------------------------

def keygen(seed: bytes) -> Tuple[int, bytes]:
    """(sk scalar, 48-byte compressed G1 pubkey) from a seed."""
    if len(seed) < 16:
        raise ValueError("seed must be >= 16 bytes")
    sk = int.from_bytes(
        hashlib.sha512(b"AGNES-BLS-KEYGEN" + seed).digest(), "big") % R
    sk = sk or 1
    return sk, g1_compress(point_mul(sk, G1))


def sign(sk: int, msg: bytes) -> bytes:
    """192-byte uncompressed G2 signature [sk] H(msg)."""
    return g2_to_bytes(point_mul(sk, hash_to_g2(msg)))


def verify(pk_bytes: bytes, msg: bytes, sig_bytes: bytes) -> bool:
    """Single-share verification: e(g1, sig) == e(pk, H(msg)), as the
    one-final-exp product e(-g1, sig) * e(pk, H(msg)) == 1."""
    try:
        pk = g1_decompress(pk_bytes)
        sig = g2_from_bytes(sig_bytes)
    except ValueError:
        return False
    if pk is None or sig is None:
        return False
    return pairing_product_is_one(
        [(point_neg(G1), sig), (pk, hash_to_g2(msg))])


def verify_share(pk_pt, msg_point, sig_pt) -> bool:
    """verify() over already-decoded points and a precomputed message
    point — the serve lane's per-share FALLBACK check (one pairing
    product per share, message hash shared across the class)."""
    if pk_pt is None or sig_pt is None:
        return False
    return pairing_product_is_one(
        [(point_neg(G1), sig_pt), (pk_pt, msg_point)])


def aggregate_points(points) -> object:
    out = None
    for pt in points:
        out = point_add(out, pt)
    return out


def aggregate_verify_weighted(pk_points, weights: Sequence[int],
                              msg_point, agg_sig_pt) -> bool:
    """The per-class aggregate check: with apk = sum w_i * pk_i and
    asig = sum w_i * sig_i (the device MSM's outputs),

        e(g1, asig) == e(apk, H(class message))

    holds iff every weighted share signs the class message — weights
    are the validators' voting powers, so the ONE cleared lane carries
    the class's combined voting weight.  Checked as the one-final-exp
    product e(-g1, asig) * e(apk, H) == 1."""
    apk = None
    for pk, w in zip(pk_points, weights):
        apk = point_add(apk, point_mul(int(w), pk))
    if agg_sig_pt is None and apk is None:
        return True
    return pairing_product_is_one(
        [(point_neg(G1), agg_sig_pt), (apk, msg_point)])


# --- proof of possession ----------------------------------------------------

def pop_prove(sk: int, pk_bytes: bytes) -> bytes:
    """192-byte PoP: [sk] H_pop(pk) — proves knowledge of sk for pk,
    the rogue-key defense (README threat model)."""
    return g2_to_bytes(point_mul(sk, hash_pop(pk_bytes)))


def pop_verify(pk_bytes: bytes, pop_bytes: bytes) -> bool:
    try:
        pk = g1_decompress(pk_bytes)
        pop = g2_from_bytes(pop_bytes)
    except ValueError:
        return False
    if pk is None or pop is None:
        return False
    return pairing_product_is_one(
        [(point_neg(G1), pop), (pk, hash_pop(pk_bytes))])
