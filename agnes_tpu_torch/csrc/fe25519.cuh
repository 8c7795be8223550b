// GF(2^255 - 19) and edwards25519 arithmetic for one lane per thread,
// shared by the port's CUDA kernels (ed25519_verify.cu, ed25519_pow.cu,
// ed25519_straus.cu).
//
// Field elements are 10 signed int32 limbs in radix 2^25.5 (limb i
// holds 26 bits for even i, 25 for odd i) kept in registers; products
// accumulate in int64.  Every field value is kept "carried" (|limb| <=
// 2^25 for even, <= ~2^24 for odd limbs), so any sum or difference of
// two carried values (|limb| <= 2^26) is a valid multiply input:
// 19 * 2^26 < 2^31 and 10 products of 2^27 * 2^30.3 stay under 2^63.
// Right shifts of negative signed integers are arithmetic (floor) under
// nvcc, as C++20 defines them; the carries below rely on that
// deliberately.  Outside `__CUDACC__` the lane math is plain C++, so a
// host compiler can check it against big-integer arithmetic.
//
// The TPU kernels and the port's plain PyTorch versions carry 20 signed
// 13-bit limbs (radix 2^13) instead; fe_from_limbs13, fe_from_limbs13_weak
// and fe_store_limbs13 convert at the kernels' boundaries.

#ifndef AG_FE25519_CUH
#define AG_FE25519_CUH

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define AG_DEV __device__ __forceinline__
#else
#define AG_DEV static inline
#endif

#define AG_UNROLL _Pragma("unroll")
#define AG_NOUNROLL _Pragma("unroll 1")

namespace ag {

struct fe { int32_t v[10]; };
struct ext { fe X, Y, Z, T; };            // extended coordinates
struct niels { fe ypx, ymx, t2d, z2; };   // (Y+X, Y-X, 2dT, 2Z)

// -- field: GF(2^255 - 19), radix 2^25.5 ------------------------------------

AG_DEV void fe_zero(fe& h) { AG_UNROLL for (int i = 0; i < 10; ++i) h.v[i] = 0; }
AG_DEV void fe_one(fe& h) { fe_zero(h); h.v[0] = 1; }
AG_DEV void fe_copy(fe& h, const fe& f) { AG_UNROLL for (int i = 0; i < 10; ++i) h.v[i] = f.v[i]; }

AG_DEV void fe_load(fe& h, const int32_t* c) {
  AG_UNROLL for (int i = 0; i < 10; ++i) h.v[i] = c[i];
}

// Rounding carry of 64-bit columns into carried limbs (|col| < 2^62.5).
AG_DEV void fe_carry64(fe& h, int64_t* t) {
  AG_UNROLL for (int i = 0; i < 9; ++i) {
    const int w = 26 - (i & 1);
    const int64_t c = (t[i] + ((int64_t)1 << (w - 1))) >> w;
    t[i] -= c * ((int64_t)1 << w);
    t[i + 1] += c;
  }
  int64_t c = (t[9] + ((int64_t)1 << 24)) >> 25;
  t[9] -= c * ((int64_t)1 << 25);
  t[0] += c * 19;                       // 2^255 = 19 (mod p)
  c = (t[0] + ((int64_t)1 << 25)) >> 26;
  t[0] -= c * ((int64_t)1 << 26);
  t[1] += c;
  AG_UNROLL for (int i = 0; i < 10; ++i) h.v[i] = (int32_t)t[i];
}

// Rounding carry of int32 limbs (|limb| < 2^29), e.g. after an add.
AG_DEV void fe_carry32(fe& h) {
  AG_UNROLL for (int i = 0; i < 9; ++i) {
    const int w = 26 - (i & 1);
    const int32_t c = (h.v[i] + (1 << (w - 1))) >> w;
    h.v[i] -= c * (1 << w);
    h.v[i + 1] += c;
  }
  int32_t c = (h.v[9] + (1 << 24)) >> 25;
  h.v[9] -= c * (1 << 25);
  h.v[0] += c * 19;
  c = (h.v[0] + (1 << 25)) >> 26;
  h.v[0] -= c * (1 << 26);
  h.v[1] += c;
}

AG_DEV void fe_add(fe& h, const fe& f, const fe& g) {
  AG_UNROLL for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] + g.v[i];
  fe_carry32(h);
}

AG_DEV void fe_sub(fe& h, const fe& f, const fe& g) {
  AG_UNROLL for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] - g.v[i];
  fe_carry32(h);
}

AG_DEV void fe_neg(fe& h, const fe& f) {
  AG_UNROLL for (int i = 0; i < 10; ++i) h.v[i] = -f.v[i];
}

// h = f * g.  Limb i sits at bit ceil(25.5 i), so f_i g_j lands in
// column i+j with an extra factor 2 when i and j are both odd, and
// columns >= 10 wrap to i+j-10 with factor 19.
AG_DEV void fe_mul(fe& h, const fe& f, const fe& g) {
  int32_t g19[10], f2[10];
  AG_UNROLL for (int i = 0; i < 10; ++i) { g19[i] = 19 * g.v[i]; f2[i] = 2 * f.v[i]; }
  int64_t t[10];
  AG_UNROLL for (int k = 0; k < 10; ++k) t[k] = 0;
  AG_UNROLL for (int i = 0; i < 10; ++i) {
    AG_UNROLL for (int j = 0; j < 10; ++j) {
      const int32_t a = ((i & j) & 1) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      t[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe_carry64(h, t);
}

// h = f^2: the upper triangle of fe_mul, off-diagonal terms doubled.
AG_DEV void fe_sq(fe& h, const fe& f) {
  int32_t f19[10], f2[10], f4[10];
  AG_UNROLL for (int i = 0; i < 10; ++i) {
    f19[i] = 19 * f.v[i]; f2[i] = 2 * f.v[i]; f4[i] = 4 * f.v[i];
  }
  int64_t t[10];
  AG_UNROLL for (int k = 0; k < 10; ++k) t[k] = 0;
  AG_UNROLL for (int i = 0; i < 10; ++i) {
    AG_UNROLL for (int j = i; j < 10; ++j) {
      const int m = (i != j ? 2 : 1) * (((i & j) & 1) ? 2 : 1);
      const int32_t a = m == 1 ? f.v[i] : (m == 2 ? f2[i] : f4[i]);
      const int32_t b = (i + j >= 10) ? f19[j] : f.v[j];
      t[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe_carry64(h, t);
}

AG_DEV void fe_sqn(fe& h, const fe& f, int n) {
  fe_sq(h, f);
  AG_NOUNROLL for (int i = 1; i < n; ++i) fe_sq(h, h);
}

// Canonical limbs of a carried element: value in [0, p), limb i in
// [0, 2^w_i).  q = floor((h + 19) / 2^255) in {-1, 0, 1} is found by a
// carry pass; h - q p then normalizes with floor carries.
AG_DEV void fe_freeze(fe& h, const fe& f) {
  fe_copy(h, f);
  fe_carry32(h);
  int32_t q = (19 * h.v[9] + (1 << 24)) >> 25;
  AG_UNROLL for (int i = 0; i < 10; ++i) q = (h.v[i] + q) >> (26 - (i & 1));
  h.v[0] += 19 * q;
  AG_UNROLL for (int i = 0; i < 9; ++i) {
    const int w = 26 - (i & 1);
    const int32_t c = h.v[i] >> w;
    h.v[i + 1] += c;
    h.v[i] -= c * (1 << w);
  }
  h.v[9] &= (1 << 25) - 1;             // drop 2^255 q
}

AG_DEV bool fe_is_zero(const fe& f) {
  fe h;
  fe_freeze(h, f);
  int32_t acc = 0;
  AG_UNROLL for (int i = 0; i < 10; ++i) acc |= h.v[i];
  return acc == 0;
}

// z^((p-5)/8) = z^(2^252 - 3): 252 squarings + 11 multiplies.
AG_DEV void fe_pow22523(fe& out, const fe& z) {
  fe t0, t1, t2;
  fe_sq(t0, z);                 // 2
  fe_sqn(t1, t0, 2);            // 8
  fe_mul(t1, z, t1);            // 9
  fe_mul(t0, t0, t1);           // 11
  fe_sq(t0, t0);                // 22
  fe_mul(t0, t1, t0);           // 31 = 2^5 - 1
  fe_sqn(t1, t0, 5);
  fe_mul(t0, t1, t0);           // 2^10 - 1
  fe_sqn(t1, t0, 10);
  fe_mul(t1, t1, t0);           // 2^20 - 1
  fe_sqn(t2, t1, 20);
  fe_mul(t1, t2, t1);           // 2^40 - 1
  fe_sqn(t1, t1, 10);
  fe_mul(t0, t1, t0);           // 2^50 - 1
  fe_sqn(t1, t0, 50);
  fe_mul(t1, t1, t0);           // 2^100 - 1
  fe_sqn(t2, t1, 100);
  fe_mul(t1, t2, t1);           // 2^200 - 1
  fe_sqn(t1, t1, 50);
  fe_mul(t0, t1, t0);           // 2^250 - 1
  fe_sqn(t0, t0, 2);            // 2^252 - 4
  fe_mul(out, t0, z);           // 2^252 - 3
}

// y from 20 strict 13-bit limbs at stride B -> radix-2^25.5 limbs, and
// whether y < p.
AG_DEV bool fe_from_limbs13(fe& h, const int32_t* y, int64_t B, int64_t lane) {
  uint64_t w[4] = {0, 0, 0, 0};
  AG_UNROLL for (int k = 0; k < 20; ++k) {
    const uint64_t l = (uint64_t)(uint32_t)y[k * B + lane] & 0x1FFFu;
    const int bit = 13 * k, wi = bit >> 6, off = bit & 63;
    if (wi < 4) {
      w[wi] |= l << off;
      if (off > 51 && wi < 3) w[wi + 1] |= l >> (64 - off);
    }
  }
  w[3] &= 0x7FFFFFFFFFFFFFFFull;       // bit 255 is the sign, not y
  int off = 0;
  AG_UNROLL for (int i = 0; i < 10; ++i) {
    const int width = 26 - (i & 1);
    const int wi = off >> 6, sh = off & 63;
    uint64_t v = w[wi] >> sh;
    if (sh + width > 64 && wi < 3) v |= w[wi + 1] << (64 - sh);
    h.v[i] = (int32_t)(v & ((1ull << width) - 1));
    off += width;
  }
  const bool ge_p = w[3] == 0x7FFFFFFFFFFFFFFFull && w[2] == ~0ull &&
                    w[1] == ~0ull && w[0] >= 0xFFFFFFFFFFFFFFEDull;
  return !ge_p;
}

// Strict y + sign -> x; false if the encoding is not a curve point.
// Mirrors pallas_verify._decompress check for check.
AG_DEV bool decompress(fe& x, const fe& y, bool y_ok, int32_t sign,
                       const int32_t* d, const int32_t* sqrtm1) {
  fe one, y2, u, v, v2, v3, uv3, uv7, t, vx2, fd;
  fe_one(one);
  fe_sq(y2, y);
  fe_sub(u, y2, one);
  fe_load(fd, d);
  fe_mul(v, y2, fd);
  fe_add(v, v, one);
  fe_sq(v2, v);
  fe_mul(v3, v, v2);
  fe_mul(uv3, u, v3);
  fe_mul(t, v3, v);
  fe_mul(uv7, uv3, t);
  fe_pow22523(t, uv7);
  fe_mul(x, uv3, t);
  fe_sq(t, x);
  fe_mul(vx2, v, t);
  fe_sub(t, vx2, u);
  const bool root_direct = fe_is_zero(t);
  fe_add(t, vx2, u);
  const bool root_flip = fe_is_zero(t);
  fe_load(fd, sqrtm1);
  fe_mul(t, x, fd);
  if (root_flip) fe_copy(x, t);
  fe xf;
  fe_freeze(xf, x);
  int32_t acc = 0;
  AG_UNROLL for (int i = 0; i < 10; ++i) acc |= xf.v[i];
  const bool x_is_zero = acc == 0;
  if ((xf.v[0] & 1) != sign) {
    fe_neg(x, xf);
    fe_carry32(x);
  } else {
    fe_copy(x, xf);
  }
  return y_ok && (root_direct || root_flip) && !(x_is_zero && sign == 1);
}

// -- curve: extended twisted Edwards, a = -1 --------------------------------

// dbl-2008-hwcd: 4 squarings + 3 multiplies (4 with T).
AG_DEV void pt_dbl(ext& r, const ext& p, bool want_t) {
  fe A, B, C, E, F, G, H, s;
  fe_sq(A, p.X);
  fe_sq(B, p.Y);
  fe_sq(C, p.Z);
  fe_add(C, C, C);
  fe_add(s, p.X, p.Y);
  fe_sq(E, s);
  fe_sub(E, E, A);
  fe_sub(E, E, B);
  fe_sub(G, B, A);
  fe_sub(F, G, C);
  fe_add(H, A, B);
  fe_neg(H, H);
  fe_mul(r.X, E, F);
  fe_mul(r.Y, G, H);
  fe_mul(r.Z, F, G);
  if (want_t) fe_mul(r.T, E, H);
}

// r = p + q, q in projective-niels form; `affine` entries have Z = 1 so
// D = 2 Z1 needs no multiply (the fixed-B table).
AG_DEV void pt_add_niels(ext& r, const ext& p, const fe& ypx, const fe& ymx,
                         const fe& t2d, const fe* z2, bool want_t) {
  fe A, B, C, D, E, F, G, H, s;
  fe_sub(s, p.Y, p.X);
  fe_mul(A, s, ymx);
  fe_add(s, p.Y, p.X);
  fe_mul(B, s, ypx);
  fe_mul(C, p.T, t2d);
  if (z2) fe_mul(D, p.Z, *z2); else fe_add(D, p.Z, p.Z);
  fe_sub(E, B, A);
  fe_sub(F, D, C);
  fe_add(G, D, C);
  fe_add(H, B, A);
  fe_mul(r.X, E, F);
  fe_mul(r.Y, G, H);
  fe_mul(r.Z, F, G);
  if (want_t) fe_mul(r.T, E, H);
}

AG_DEV void to_niels(niels& n, const ext& p, const fe& d2) {
  fe_add(n.ypx, p.Y, p.X);
  fe_sub(n.ymx, p.Y, p.X);
  fe_mul(n.t2d, p.T, d2);
  fe_add(n.z2, p.Z, p.Z);
}

// Bit offset of radix-2^25.5 limb i: ceil(25.5 i).
AG_DEV constexpr int limb25_offset(int i) { return (51 * i + 1) / 2; }

// Any 20 signed radix-2^13 limbs at stride B (|limb| < 2^20; weak,
// unfrozen, possibly >= p) -> a carried element of the same value mod p.
// Limb k sits at bit 13k inside radix-2^25.5 limb j (the last whose
// offset is <= 13k), at weight at most 2^17 there, so each column stays
// below 2^39 and one rounding carry (folding 2^255 = 19) brings it in
// range.  Multiplication instead of a left shift keeps negative limbs
// well defined.
AG_DEV void fe_from_limbs13_weak(fe& h, const int32_t* a, int64_t B,
                                 int64_t lane) {
  int64_t t[10];
  AG_UNROLL for (int i = 0; i < 10; ++i) t[i] = 0;
  AG_UNROLL for (int k = 0; k < 20; ++k) {
    const int bit = 13 * k;
    int j = 0;
    AG_UNROLL for (int i = 1; i < 10; ++i) if (limb25_offset(i) <= bit) j = i;
    t[j] += (int64_t)a[k * B + lane] * ((int64_t)1 << (bit - limb25_offset(j)));
  }
  fe_carry64(h, t);
}

// Canonical value of f (in [0, p)) as 20 strict radix-2^13 limbs at
// stride B.
AG_DEV void fe_store_limbs13(const fe& f, int32_t* out, int64_t B,
                             int64_t lane) {
  fe h;
  fe_freeze(h, f);
  uint64_t w[4] = {0, 0, 0, 0};
  AG_UNROLL for (int i = 0; i < 10; ++i) {
    const int width = 26 - (i & 1), off = limb25_offset(i);
    const int wi = off >> 6, sh = off & 63;
    const uint64_t v = (uint64_t)(uint32_t)h.v[i];
    w[wi] |= v << sh;
    if (sh + width > 64 && wi < 3) w[wi + 1] |= v >> (64 - sh);
  }
  AG_UNROLL for (int k = 0; k < 20; ++k) {
    const int bit = 13 * k, wi = bit >> 6, sh = bit & 63;
    uint64_t v = w[wi] >> sh;
    if (sh + 13 > 64 && wi < 3) v |= w[wi + 1] << (64 - sh);
    out[k * B + lane] = (int32_t)(v & 0x1FFF);
  }
}

// r = p + q by the unified a = -1 law of the TPU kernels' `_pt_add` and
// the JAX twin's point_add (9 multiplies, the same operations in the same
// order, so the result is the same projective point, coordinate for
// coordinate).  r may alias p or q.
AG_DEV void pt_add(ext& r, const ext& p, const ext& q, const fe& d2) {
  fe a, b, c, d, e, f, g, h, s, t;
  fe_sub(s, p.Y, p.X);
  fe_sub(t, q.Y, q.X);
  fe_mul(a, s, t);
  fe_add(s, p.Y, p.X);
  fe_add(t, q.Y, q.X);
  fe_mul(b, s, t);
  fe_mul(c, p.T, q.T);
  fe_mul(c, c, d2);
  fe_mul(d, p.Z, q.Z);
  fe_add(d, d, d);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

}  // namespace ag

#endif  // AG_FE25519_CUH
