// Ed25519 implementation (RFC 8032).  See ed25519.hpp.
//
// Field: GF(2^255-19) in radix-2^51 (5 uint64 limbs, __int128
// products).  Curve constants (d, sqrt(-1), the base point) are
// *derived at startup* from their definitions rather than embedded as
// magic tables; only the group order L — spec data — is written out.
// Oracle for tests: agnes_tpu_torch/crypto/ed25519_ref.py + RFC vectors.

#include "ed25519.hpp"

#include <cstring>

#include "sha512.hpp"

namespace agnes {
namespace {

using u128 = unsigned __int128;

constexpr uint64_t kMask51 = (1ULL << 51) - 1;

// --- field ------------------------------------------------------------------

struct Fe {
  uint64_t v[5];
};

const Fe kFeZero = {{0, 0, 0, 0, 0}};
const Fe kFeOne = {{1, 0, 0, 0, 0}};

void fe_carry(Fe* f) {
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 4; ++i) {
      f->v[i + 1] += f->v[i] >> 51;
      f->v[i] &= kMask51;
    }
    uint64_t c = f->v[4] >> 51;
    f->v[4] &= kMask51;
    f->v[0] += 19 * c;   // 2^255 === 19
  }
}

Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
  for (int i = 0; i < 5; ++i) r.v[i] = a.v[i] + b.v[i];
  fe_carry(&r);
  return r;
}

Fe fe_sub(const Fe& a, const Fe& b) {
  // a + 4p - b keeps every limb positive (limbs < 2^52 < 4p_i)
  Fe r;
  r.v[0] = a.v[0] + ((1ULL << 53) - 76) - b.v[0];
  for (int i = 1; i < 5; ++i)
    r.v[i] = a.v[i] + ((1ULL << 53) - 4) - b.v[i];
  fe_carry(&r);
  return r;
}

Fe fe_mul(const Fe& a, const Fe& b) {
  const uint64_t a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3],
                 a4 = a.v[4];
  const uint64_t b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3],
                 b4 = b.v[4];
  const uint64_t t1 = 19 * b1, t2 = 19 * b2, t3 = 19 * b3, t4 = 19 * b4;
  u128 r0 = (u128)a0 * b0 + (u128)a1 * t4 + (u128)a2 * t3 + (u128)a3 * t2 +
            (u128)a4 * t1;
  u128 r1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * t4 + (u128)a3 * t3 +
            (u128)a4 * t2;
  u128 r2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 + (u128)a3 * t4 +
            (u128)a4 * t3;
  u128 r3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 + (u128)a3 * b0 +
            (u128)a4 * t4;
  u128 r4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 + (u128)a3 * b1 +
            (u128)a4 * b0;
  Fe out;
  u128 c;
  c = r0 >> 51; r0 &= kMask51; r1 += c;
  c = r1 >> 51; r1 &= kMask51; r2 += c;
  c = r2 >> 51; r2 &= kMask51; r3 += c;
  c = r3 >> 51; r3 &= kMask51; r4 += c;
  c = r4 >> 51; r4 &= kMask51; r0 += 19 * c;
  c = r0 >> 51; r0 &= kMask51; r1 += c;
  out.v[0] = (uint64_t)r0; out.v[1] = (uint64_t)r1; out.v[2] = (uint64_t)r2;
  out.v[3] = (uint64_t)r3; out.v[4] = (uint64_t)r4;
  return out;
}

Fe fe_sqr(const Fe& a) { return fe_mul(a, a); }

// exponent as 256-bit little-endian words; variable time (public data)
Fe fe_pow(const Fe& a, const uint64_t e[4]) {
  Fe r = kFeOne;
  for (int i = 255; i >= 0; --i) {
    r = fe_sqr(r);
    if ((e[i / 64] >> (i % 64)) & 1) r = fe_mul(r, a);
  }
  return r;
}

const uint64_t kPm2[4] = {0xFFFFFFFFFFFFFFEBULL, 0xFFFFFFFFFFFFFFFFULL,
                          0xFFFFFFFFFFFFFFFFULL,
                          0x7FFFFFFFFFFFFFFFULL};  // p - 2
const uint64_t kPm5d8[4] = {0xFFFFFFFFFFFFFFFDULL, 0xFFFFFFFFFFFFFFFFULL,
                            0xFFFFFFFFFFFFFFFFULL,
                            0x0FFFFFFFFFFFFFFFULL};  // (p - 5) / 8

Fe fe_invert(const Fe& a) { return fe_pow(a, kPm2); }

void fe_tobytes(const Fe& f, uint8_t out[32]) {
  Fe t = f;
  fe_carry(&t);
  fe_carry(&t);
  // value < 2^255 + eps; at most one conditional subtract of p
  uint64_t p0 = kMask51 - 18;  // 2^51 - 19
  bool ge = t.v[0] >= p0;
  for (int i = 1; i < 5; ++i) ge = ge && (t.v[i] == kMask51);
  if (ge) {
    t.v[0] -= p0;
    for (int i = 1; i < 5; ++i) t.v[i] = 0;
  }
  std::memset(out, 0, 32);
  for (int i = 0; i < 5; ++i) {
    int bit = 51 * i;
    for (int b = 0; b < 8; ++b) {   // (v << 7) spans up to 8 bytes
      int pos = bit / 8 + b;
      if (pos < 32) out[pos] |= (uint8_t)((t.v[i] << (bit % 8)) >> (8 * b));
    }
  }
}

void fe_frombytes(const uint8_t in[32], Fe* f) {
  for (int i = 0; i < 5; ++i) {
    int bit = 51 * i;
    uint64_t v = 0;
    for (int b = 7; b >= 0; --b) {
      int pos = bit / 8 + b;
      if (pos < 32) v = (v << 8) | in[pos];
    }
    f->v[i] = (v >> (bit % 8)) & kMask51;
  }
  // bit 255 (the sign bit) sits above limb 4's 51-bit mask: dropped.
}

bool fe_eq(const Fe& a, const Fe& b) {
  uint8_t ba[32], bb[32];
  fe_tobytes(a, ba);
  fe_tobytes(b, bb);
  return std::memcmp(ba, bb, 32) == 0;
}

bool fe_iszero(const Fe& a) { return fe_eq(a, kFeZero); }

Fe fe_from_u64(uint64_t x) {
  Fe f = kFeZero;
  f.v[0] = x & kMask51;
  f.v[1] = x >> 51;
  return f;
}

// --- derived curve constants ------------------------------------------------

struct Consts {
  Fe d, d2, sqrt_m1;
  Fe bx, by, bt;   // base point affine + x*y
  Consts();
};

// group point
struct Ge {
  Fe x, y, z, t;
};

Ge ge_identity() { return {kFeZero, kFeOne, kFeOne, kFeZero}; }

const Consts& C();

Ge ge_add(const Ge& p, const Ge& q) {
  // unified a=-1 twisted Edwards addition (complete)
  Fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  Fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  Fe c = fe_mul(fe_mul(p.t, q.t), C().d2);
  Fe zz = fe_mul(p.z, q.z);
  Fe d = fe_add(zz, zz);
  Fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  return {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

Ge ge_neg(const Ge& p) {
  return {fe_sub(kFeZero, p.x), p.y, p.z, fe_sub(kFeZero, p.t)};
}

// variable-time scalar mult, scalar as 256-bit LE words
Ge ge_scalar_mul(const uint64_t s[4], const Ge& p) {
  Ge r = ge_identity();
  for (int i = 255; i >= 0; --i) {
    r = ge_add(r, r);
    if ((s[i / 64] >> (i % 64)) & 1) r = ge_add(r, p);
  }
  return r;
}

bool ge_decompress(const uint8_t in[32], Ge* out) {
  uint8_t sign = in[31] >> 7;
  Fe y;
  fe_frombytes(in, &y);
  // reject non-canonical y (>= p)
  uint8_t canon[32];
  fe_tobytes(y, canon);
  uint8_t raw[32];
  std::memcpy(raw, in, 32);
  raw[31] &= 0x7F;
  if (std::memcmp(canon, raw, 32) != 0) return false;

  Fe y2 = fe_sqr(y);
  Fe u = fe_sub(y2, kFeOne);
  Fe v = fe_add(fe_mul(y2, C().d), kFeOne);
  Fe v3 = fe_mul(v, fe_sqr(v));
  Fe v7 = fe_mul(v3, fe_mul(v3, v));
  Fe x = fe_mul(fe_mul(u, v3), fe_pow(fe_mul(u, v7), kPm5d8));
  Fe vx2 = fe_mul(v, fe_sqr(x));
  if (fe_eq(vx2, u)) {
    // ok
  } else if (fe_eq(vx2, fe_sub(kFeZero, u))) {
    x = fe_mul(x, C().sqrt_m1);
  } else {
    return false;
  }
  uint8_t xb[32];
  fe_tobytes(x, xb);
  if (fe_iszero(x) && sign) return false;
  if ((xb[0] & 1) != sign) x = fe_sub(kFeZero, x);
  *out = {x, y, kFeOne, fe_mul(x, y)};
  return true;
}

void ge_compress(const Ge& p, uint8_t out[32]) {
  Fe zi = fe_invert(p.z);
  Fe x = fe_mul(p.x, zi);
  Fe y = fe_mul(p.y, zi);
  uint8_t xb[32];
  fe_tobytes(x, xb);
  fe_tobytes(y, out);
  out[31] |= (xb[0] & 1) << 7;
}

Consts::Consts() {
  // all derived from definitions; must not call anything that re-enters
  // C() (the magic-static is still under construction here)
  Fe n121665 = fe_sub(kFeZero, fe_from_u64(121665));
  d = fe_mul(n121665, fe_invert(fe_from_u64(121666)));  // -121665/121666
  d2 = fe_add(d, d);
  // sqrt(-1) = 2^((p-1)/4); (p-1)/4 = (2^255-20)/4 = 2^253 - 5
  const uint64_t e_quarter[4] = {0xFFFFFFFFFFFFFFFBULL,
                                 0xFFFFFFFFFFFFFFFFULL,
                                 0xFFFFFFFFFFFFFFFFULL,
                                 0x1FFFFFFFFFFFFFFFULL};
  sqrt_m1 = fe_pow(fe_from_u64(2), e_quarter);
  // base point: y = 4/5, x recovered with sign 0 (inline x-recovery —
  // ge_decompress would re-enter C())
  by = fe_mul(fe_from_u64(4), fe_invert(fe_from_u64(5)));
  Fe y2 = fe_sqr(by);
  Fe u = fe_sub(y2, kFeOne);
  Fe v = fe_add(fe_mul(y2, d), kFeOne);
  Fe v3 = fe_mul(v, fe_sqr(v));
  Fe v7 = fe_mul(v3, fe_mul(v3, v));
  Fe x = fe_mul(fe_mul(u, v3), fe_pow(fe_mul(u, v7), kPm5d8));
  if (!fe_eq(fe_mul(v, fe_sqr(x)), u)) x = fe_mul(x, sqrt_m1);
  uint8_t xb[32];
  fe_tobytes(x, xb);
  if (xb[0] & 1) x = fe_sub(kFeZero, x);   // canonical sign 0
  bx = x;
  bt = fe_mul(bx, by);
}

const Consts& C() {
  static Consts c;
  return c;
}

Ge ge_base() { return {C().bx, C().by, kFeOne, C().bt}; }

// --- scalars mod L ----------------------------------------------------------

struct U256 {
  uint64_t w[4];
};

const U256 kL = {{0x5812631A5CF5D3EDULL, 0x14DEF9DEA2F79CD6ULL, 0,
                  0x1000000000000000ULL}};  // RFC 8032 group order

bool u256_geq(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i] != b.w[i]) return a.w[i] > b.w[i];
  }
  return true;
}

void u256_sub(U256* a, const U256& b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 t = (u128)a->w[i] - b.w[i] - borrow;
    a->w[i] = (uint64_t)t;
    borrow = (t >> 64) & 1;
  }
}

// r = x mod L for a bit-addressable big-endian-scanned value
U256 mod_l_bits(const uint8_t* le_bytes, int n_bytes) {
  U256 r = {{0, 0, 0, 0}};
  for (int i = 8 * n_bytes - 1; i >= 0; --i) {
    // r <<= 1 (r < L < 2^253, shift is safe)
    for (int j = 3; j > 0; --j)
      r.w[j] = (r.w[j] << 1) | (r.w[j - 1] >> 63);
    r.w[0] <<= 1;
    r.w[0] |= (le_bytes[i / 8] >> (i % 8)) & 1;
    if (u256_geq(r, kL)) u256_sub(&r, kL);
  }
  return r;
}

U256 u256_frombytes(const uint8_t in[32]) {
  U256 r;
  for (int i = 0; i < 4; ++i) {
    r.w[i] = 0;
    for (int b = 7; b >= 0; --b) r.w[i] = (r.w[i] << 8) | in[8 * i + b];
  }
  return r;
}

void u256_tobytes(const U256& a, uint8_t out[32]) {
  for (int i = 0; i < 4; ++i)
    for (int b = 0; b < 8; ++b) out[8 * i + b] = (a.w[i] >> (8 * b)) & 0xFF;
}

U256 mulmod_l(const U256& a, const U256& b) {
  uint64_t prod[8] = {0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 t = (u128)a.w[i] * b.w[j] + prod[i + j] + carry;
      prod[i + j] = (uint64_t)t;
      carry = t >> 64;
    }
    prod[i + 4] = (uint64_t)carry;
  }
  uint8_t bytes[64];
  for (int i = 0; i < 8; ++i)
    for (int b = 0; b < 8; ++b)
      bytes[8 * i + b] = (prod[i] >> (8 * b)) & 0xFF;
  return mod_l_bits(bytes, 64);
}

U256 addmod_l(const U256& a, const U256& b) {
  U256 r;
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 t = (u128)a.w[i] + b.w[i] + carry;
    r.w[i] = (uint64_t)t;
    carry = t >> 64;
  }
  // a, b < L < 2^253: no word overflow; single conditional subtract
  if (u256_geq(r, kL)) u256_sub(&r, kL);
  return r;
}

void clamp(uint8_t h[32]) {
  h[0] &= 248;
  h[31] &= 127;
  h[31] |= 64;
}

}  // namespace

// --- public API -------------------------------------------------------------

void ed25519_pubkey(const uint8_t seed[32], uint8_t out_pk[32]) {
  uint8_t h[64];
  sha512(seed, 32, h);
  clamp(h);
  U256 a = u256_frombytes(h);
  ge_compress(ge_scalar_mul(a.w, ge_base()), out_pk);
}

void ed25519_sign(const uint8_t seed[32], const uint8_t* msg, uint64_t n,
                  uint8_t out_sig[64]) {
  uint8_t h[64];
  sha512(seed, 32, h);
  clamp(h);
  U256 a = u256_frombytes(h);
  uint8_t pk[32];
  ge_compress(ge_scalar_mul(a.w, ge_base()), pk);

  Sha512 hr;
  hr.update(h + 32, 32);
  hr.update(msg, n);
  uint8_t rh[64];
  hr.final(rh);
  U256 r = mod_l_bits(rh, 64);
  ge_compress(ge_scalar_mul(r.w, ge_base()), out_sig);  // R

  Sha512 hk;
  hk.update(out_sig, 32);
  hk.update(pk, 32);
  hk.update(msg, n);
  uint8_t kh[64];
  hk.final(kh);
  U256 k = mod_l_bits(kh, 64);
  U256 s = addmod_l(r, mulmod_l(k, a));
  u256_tobytes(s, out_sig + 32);
}

bool ed25519_verify(const uint8_t pk[32], const uint8_t* msg, uint64_t n,
                    const uint8_t sig[64]) {
  Ge a;
  if (!ge_decompress(pk, &a)) return false;
  U256 s = u256_frombytes(sig + 32);
  if (u256_geq(s, kL)) return false;  // S < L (RFC 8032 §5.1.7)

  Sha512 hk;
  hk.update(sig, 32);
  hk.update(pk, 32);
  hk.update(msg, n);
  uint8_t kh[64];
  hk.final(kh);
  U256 k = mod_l_bits(kh, 64);

  // COFACTORED check (the framework-wide policy; see
  // crypto/ed25519_ref.py verify): R must decode canonically, then
  // [8]([S]B + [k](-A)) == [8]R — multiply-by-8 makes single, batch
  // (MSM) and per-lane verification agree on every input, so vote
  // validity is a pure function of the signature bytes.
  Ge r;
  if (!ge_decompress(sig, &r)) return false;
  Ge q = ge_add(ge_scalar_mul(s.w, ge_base()),
                ge_scalar_mul(k.w, ge_neg(a)));
  for (int i = 0; i < 3; ++i) {
    q = ge_add(q, q);
    r = ge_add(r, r);
  }
  uint8_t qb[32], rb[32];
  ge_compress(q, qb);
  ge_compress(r, rb);
  return std::memcmp(qb, rb, 32) == 0;
}

}  // namespace agnes
