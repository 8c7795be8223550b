// GF(2^255 - 19) and edwards25519 arithmetic for one lane per thread in
// radix 2^25.5, kept for the measurement kernels of
// scripts/verify_probe.cu (its chains and one verify window in this field
// beside the radix-2^32 one).  The port's kernels compute in radix 2^32
// (fe25519_r32.cuh).
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
// host compiler can check it against big-integer arithmetic.  Only what
// the probe's kernels run is here: the field's add, subtract, multiply
// and square, and the doubling and niels add of the verify window.

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

}  // namespace ag

#endif  // AG_FE25519_CUH
