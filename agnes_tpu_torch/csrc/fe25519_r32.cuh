// GF(2^255 - 19) and edwards25519 arithmetic in radix 2^32, one lane per
// thread, for the port's Ed25519 kernels: the fused verify
// (ed25519_verify.cu), the batched power (ed25519_pow.cu) and [s]B - [k]A
// (ed25519_straus.cu).
//
// Replaces the radix-2^25.5 field of fe25519.cuh, which only the
// measurement kernels of scripts/verify_probe.cu still use.  The TPU
// kernels these serve (agnes_tpu/crypto/pallas_verify.py::_verify_kernel,
// line 409; pallas_ed25519.py::_pow_kernel, line 169, and _straus_kernel,
// line 146) compute on 20 signed 13-bit limbs; the boundary converts
// (fe_from_limbs13, fe_load13_weak, fe_store13).
//
// What bounds the verify kernel on this card is its integer instruction
// issue: a lane does 1,757 multiplies and 1,574 squarings and touches 588
// input bytes.  The radix-2^25.5 multiply spends 100 64-bit products
// (IMAD.WIDE, which issues at half the IMAD rate on the H100) and a carry
// pass of 64-bit shifts and adds on each call, and every add or subtract
// carries in full.  This field does instead:
//
//   - eight uint32 limbs, a value kept weakly reduced in [0, 2^256)
//     between operations (any representative of its residue);
//   - multiply: an 8 x 8 schoolbook of 64 32 x 32-bit products in PTX
//     carry chains (mad.lo.cc / madc.hi.cc) into 16 words, the products
//     split by the parity of their word into two accumulators, so each
//     row is one chain and each product one 64-bit multiply-add on an
//     aligned register pair (IMAD.WIDE.U32.X) whose words never change
//     halves between rows (rows shifted by one word instead cost ~6x the
//     register moves); the high half folded by 38 (2^256 = 38 mod p) and
//     one small final fold;
//   - squaring: the 28 off-diagonal products once, doubled, plus the 8
//     squares: 36 products;
//   - add and subtract: one 8-word carry (borrow) chain and a fold of
//     the carry (borrow) by 38, no carry pass;
//   - freeze to [0, p) only where a value is compared (the two is_zero
//     tests of decompress, the parity against the sign bit, the verify's
//     final projective equality) or stored (fe_store13: the pow and
//     Straus kernels' outputs).
//
// Outside __CUDA_ARCH__ only the carry-chain primitives differ: each PTX
// instruction is emulated in C++ with its carry flag, so a host compiler
// runs the very chains the card runs (tests/test_torch_verify_host.py).

#ifndef AG_FE25519_R32_CUH
#define AG_FE25519_R32_CUH

#include <stdint.h>

#ifndef AG_DEV
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define AG_DEV __device__ __forceinline__
#else
#define AG_DEV static inline
#endif
#define AG_UNROLL _Pragma("unroll")
#define AG_NOUNROLL _Pragma("unroll 1")
#endif

namespace ag {
namespace r32 {

struct fe { uint32_t v[8]; };
struct ext { fe X, Y, Z, T; };            // extended coordinates
struct niels { fe ypx, ymx, t2d, z2; };   // (Y+X, Y-X, 2dT, 2Z)

AG_DEV void fe_zero(fe& h) { AG_UNROLL for (int i = 0; i < 8; ++i) h.v[i] = 0; }
AG_DEV void fe_one(fe& h) { fe_zero(h); h.v[0] = 1; }

AG_DEV void fe_load(fe& h, const uint32_t* c) {
  AG_UNROLL for (int i = 0; i < 8; ++i) h.v[i] = c[i];
}

// -- carry-chain primitives ------------------------------------------------
// On the device each is one PTX instruction in its own asm volatile
// statement: the statements keep their order, and nothing between two of
// them writes the carry flag.  On the host each is the same instruction
// emulated with the flag in `cf`, so the chains below run unchanged under
// a host compiler.  Names follow PTX: _cc writes the flag, a `c` after
// the operation reads it.

#if defined(__CUDA_ARCH__)
#define AG_OP3(name, op)                                                     \
  AG_DEV uint32_t name(uint32_t a, uint32_t b, uint32_t&) {                  \
    uint32_t d;                                                              \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));              \
    return d;                                                                \
  }
#define AG_OP4(name, op)                                                     \
  AG_DEV uint32_t name(uint32_t a, uint32_t b, uint32_t c, uint32_t&) {      \
    uint32_t d;                                                              \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));  \
    return d;                                                                \
  }
AG_OP3(add_cc, "add.cc.u32")
AG_OP3(addc_cc, "addc.cc.u32")
AG_OP3(addc, "addc.u32")
AG_OP3(sub_cc, "sub.cc.u32")
AG_OP3(subc_cc, "subc.cc.u32")
AG_OP3(subc, "subc.u32")
AG_OP4(madlo_cc, "mad.lo.cc.u32")
AG_OP4(madclo_cc, "madc.lo.cc.u32")
AG_OP4(madchi_cc, "madc.hi.cc.u32")
AG_OP4(madchi, "madc.hi.u32")
#undef AG_OP3
#undef AG_OP4
AG_DEV uint32_t mullo(uint32_t a, uint32_t b) { return a * b; }
AG_DEV uint32_t mulhi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
#else
AG_DEV uint32_t add_cc(uint32_t a, uint32_t b, uint32_t& cf) {
  const uint64_t s = (uint64_t)a + b;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
AG_DEV uint32_t addc_cc(uint32_t a, uint32_t b, uint32_t& cf) {
  const uint64_t s = (uint64_t)a + b + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
AG_DEV uint32_t addc(uint32_t a, uint32_t b, uint32_t& cf) { return a + b + cf; }
AG_DEV uint32_t sub_cc(uint32_t a, uint32_t b, uint32_t& cf) {
  cf = a < b;
  return a - b;
}
AG_DEV uint32_t subc_cc(uint32_t a, uint32_t b, uint32_t& cf) {
  const uint64_t s = (uint64_t)b + cf;
  const uint32_t d = (uint32_t)((uint64_t)a - s);
  cf = (uint64_t)a < s;
  return d;
}
AG_DEV uint32_t subc(uint32_t a, uint32_t b, uint32_t& cf) { return a - b - cf; }
AG_DEV uint32_t mullo(uint32_t a, uint32_t b) { return a * b; }
AG_DEV uint32_t mulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
AG_DEV uint32_t madlo_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
  return add_cc(a * b, c, cf);
}
AG_DEV uint32_t madclo_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
  return addc_cc(a * b, c, cf);
}
AG_DEV uint32_t madchi_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
  return addc_cc(mulhi(a, b), c, cf);
}
AG_DEV uint32_t madchi(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
  return mulhi(a, b) + c + cf;
}
#endif  // __CUDA_ARCH__

// -- the chains -------------------------------------------------------------

// t[0..15] = a * b.  The product a_j b_i sits at words i + j (lo) and
// i + j + 1 (hi).  Products with i + j even go to `e`, those with i + j
// odd to `o`, shifted down a word (o[k] is word k + 1), so in both every
// word pair (2k, 2k + 1) only ever holds the lo and hi of one product: the
// card forms each as one 64-bit multiply-add on an aligned register pair
// and no word changes sides.  A row of either is one chain of 4 products
// over 8 words; its carry lands on a word that holds at most one earlier
// carry.
AG_DEV void mul_wide(uint32_t* t, const uint32_t* a, const uint32_t* b) {
  uint32_t e[16], o[16], cf = 0;
  AG_UNROLL for (int j = 0; j < 8; j += 2) {
    e[j] = mullo(a[j], b[0]);
    e[j + 1] = mulhi(a[j], b[0]);
    o[j] = mullo(a[j + 1], b[0]);
    o[j + 1] = mulhi(a[j + 1], b[0]);
  }
  AG_UNROLL for (int k = 8; k < 16; ++k) { e[k] = 0; o[k] = 0; }
  AG_UNROLL for (int i = 1; i < 8; ++i) {
    const int je = i & 1, se = i + je;        // e: j = je, je + 2, ...
    e[se] = madlo_cc(a[je], b[i], e[se], cf);
    e[se + 1] = madchi_cc(a[je], b[i], e[se + 1], cf);
    AG_UNROLL for (int j = je + 2; j < 8; j += 2) {
      e[i + j] = madclo_cc(a[j], b[i], e[i + j], cf);
      e[i + j + 1] = madchi_cc(a[j], b[i], e[i + j + 1], cf);
    }
    if (se + 8 < 16) e[se + 8] = addc(e[se + 8], 0u, cf);  // else 0: e < 2^512
    const int jo = 1 - je, so = i - je;       // o: j = jo, jo + 2, ...
    o[so] = madlo_cc(a[jo], b[i], o[so], cf);
    o[so + 1] = madchi_cc(a[jo], b[i], o[so + 1], cf);
    AG_UNROLL for (int j = jo + 2; j < 8; j += 2) {
      o[i + j - 1] = madclo_cc(a[j], b[i], o[i + j - 1], cf);
      o[i + j] = madchi_cc(a[j], b[i], o[i + j], cf);
    }
    o[so + 8] = addc(o[so + 8], 0u, cf);
  }
  t[0] = e[0];                  // o[15] (word 16) is 0: o < 2^480
  t[1] = add_cc(e[1], o[0], cf);
  AG_UNROLL for (int k = 2; k < 15; ++k) t[k] = addc_cc(e[k], o[k - 1], cf);
  t[15] = addc(e[15], o[14], cf);
}

// t[0..15] = a^2: the 28 products a_i a_j (i < j) once, split by the
// parity of i + j as in mul_wide (a row's products with j - i even into
// `e`, odd into `o`), doubled, plus the 8 squares on the diagonal (at
// even words, so also aligned pairs).  Each half-row is one chain; its
// carry lands on a word that holds at most one earlier carry.
AG_DEV void sqr_wide(uint32_t* t, const uint32_t* a) {
  uint32_t e[16], o[16], cf = 0;
  AG_UNROLL for (int k = 0; k < 16; ++k) { e[k] = 0; o[k] = 0; }
  AG_UNROLL for (int i = 0; i < 7; ++i) {
    int j = i + 1;                            // o: j = i + 1, i + 3, ...
    o[i + j - 1] = madlo_cc(a[i], a[j], o[i + j - 1], cf);
    o[i + j] = madchi_cc(a[i], a[j], o[i + j], cf);
    AG_UNROLL for (j = i + 3; j < 8; j += 2) {
      o[i + j - 1] = madclo_cc(a[i], a[j], o[i + j - 1], cf);
      o[i + j] = madchi_cc(a[i], a[j], o[i + j], cf);
    }
    o[i + j - 1] = addc(o[i + j - 1], 0u, cf);  // j is one pair past the last
    if (i + 2 < 8) {                          // e: j = i + 2, i + 4, ...
      j = i + 2;
      e[i + j] = madlo_cc(a[i], a[j], e[i + j], cf);
      e[i + j + 1] = madchi_cc(a[i], a[j], e[i + j + 1], cf);
      AG_UNROLL for (j = i + 4; j < 8; j += 2) {
        e[i + j] = madclo_cc(a[i], a[j], e[i + j], cf);
        e[i + j + 1] = madchi_cc(a[i], a[j], e[i + j + 1], cf);
      }
      e[i + j] = addc(e[i + j], 0u, cf);
    }
  }
  // s = e + (o << 32) (< 2^511), then t = 2 s + the diagonal
  e[1] = add_cc(e[1], o[0], cf);
  AG_UNROLL for (int k = 2; k < 16; ++k) e[k] = addc_cc(e[k], o[k - 1], cf);
  e[0] = add_cc(e[0], e[0], cf);
  AG_UNROLL for (int k = 1; k < 16; ++k) e[k] = addc_cc(e[k], e[k], cf);
  t[0] = add_cc(e[0], mullo(a[0], a[0]), cf);
  t[1] = addc_cc(e[1], mulhi(a[0], a[0]), cf);
  AG_UNROLL for (int i = 1; i < 8; ++i) {
    t[2 * i] = addc_cc(e[2 * i], mullo(a[i], a[i]), cf);
    t[2 * i + 1] = addc_cc(e[2 * i + 1], mulhi(a[i], a[i]), cf);
  }
}

// h = t mod p, weakly: t_lo + 38 t_hi (below 40 x 2^256), then the part
// above 2^256 folded once more by 38; a last carry (0 or 1) leaves the low
// words below 2^11, so its 38 lands in word 0 without a carry.  The
// products 38 t_{8+k} of even k are added into aligned pairs of t_lo; those
// of odd k do not overlap each other and are added as one shifted row.
AG_DEV void reduce_wide(fe& h, const uint32_t* t) {
  uint32_t cf = 0, c, u[8];
  h.v[0] = madlo_cc(t[8], 38u, t[0], cf);
  h.v[1] = madchi_cc(t[8], 38u, t[1], cf);
  AG_UNROLL for (int k = 2; k < 8; k += 2) {
    h.v[k] = madclo_cc(t[8 + k], 38u, t[k], cf);
    h.v[k + 1] = madchi_cc(t[8 + k], 38u, t[k + 1], cf);
  }
  c = addc(0u, 0u, cf);
  AG_UNROLL for (int k = 1; k < 8; k += 2) {  // u[k - 1] is word k
    u[k - 1] = mullo(t[8 + k], 38u);
    u[k] = mulhi(t[8 + k], 38u);
  }
  h.v[1] = add_cc(h.v[1], u[0], cf);
  AG_UNROLL for (int k = 2; k < 8; ++k) h.v[k] = addc_cc(h.v[k], u[k - 1], cf);
  c = addc(c, u[7], cf);
  h.v[0] = madlo_cc(c, 38u, h.v[0], cf);
  AG_UNROLL for (int k = 1; k < 8; ++k) h.v[k] = addc_cc(h.v[k], 0u, cf);
  c = addc(0u, 0u, cf);
  h.v[0] += 38u * c;
}

// h = f + c for a small c, with the chain; returns the carry out.
AG_DEV uint32_t add_small(fe& h, const fe& f, uint32_t c) {
  uint32_t cf = 0;
  h.v[0] = add_cc(f.v[0], c, cf);
  AG_UNROLL for (int k = 1; k < 8; ++k) h.v[k] = addc_cc(f.v[k], 0u, cf);
  return addc(0u, 0u, cf);
}

// h = f + g: a carry out of the chain is 2^256 = 38, folded back in (the
// second carry, if any, leaves the low words below 38).
AG_DEV void fe_add(fe& h, const fe& f, const fe& g) {
  uint32_t cf = 0;
  h.v[0] = add_cc(f.v[0], g.v[0], cf);
  AG_UNROLL for (int k = 1; k < 8; ++k) h.v[k] = addc_cc(f.v[k], g.v[k], cf);
  const uint32_t c = addc(0u, 0u, cf);
  const uint32_t c2 = add_small(h, h, 38u * c);
  h.v[0] += 38u * c2;
}

// h = f - g: a borrow out of the chain means 2^256 was added, so 38 is
// taken off (twice at most: after a second borrow the value is near
// 2^256).
AG_DEV void fe_sub(fe& h, const fe& f, const fe& g) {
  uint32_t cf = 0;
  h.v[0] = sub_cc(f.v[0], g.v[0], cf);
  AG_UNROLL for (int k = 1; k < 8; ++k) h.v[k] = subc_cc(f.v[k], g.v[k], cf);
  uint32_t b = subc(0u, 0u, cf);                  // 0 or 0xffffffff
  h.v[0] = sub_cc(h.v[0], b & 38u, cf);
  AG_UNROLL for (int k = 1; k < 8; ++k) h.v[k] = subc_cc(h.v[k], 0u, cf);
  b = subc(0u, 0u, cf);
  h.v[0] -= b & 38u;
}

// -- field operations common to both paths --------------------------------

AG_DEV void fe_mul(fe& h, const fe& f, const fe& g) {
  uint32_t t[16];
  mul_wide(t, f.v, g.v);
  reduce_wide(h, t);
}

AG_DEV void fe_sq(fe& h, const fe& f) {
  uint32_t t[16];
  sqr_wide(t, f.v);
  reduce_wide(h, t);
}

AG_DEV void fe_sqn(fe& h, const fe& f, int n) {
  fe_sq(h, f);
  AG_NOUNROLL for (int i = 1; i < n; ++i) fe_sq(h, h);
}

AG_DEV void fe_neg(fe& h, const fe& f) {
  fe z;
  fe_zero(z);
  fe_sub(h, z, f);
}

// The canonical value in [0, p): fold bit 255 (2^255 = 19), leaving
// h < 2^255 + 19 < 2p, then subtract p iff h + 19 reaches 2^255.
AG_DEV void fe_freeze(fe& h, const fe& f) {
  const uint32_t q = f.v[7] >> 31;
  fe g = f;
  g.v[7] &= 0x7FFFFFFFu;
  add_small(g, g, 19u * q);
  fe t;
  add_small(t, g, 19u);
  const uint32_t ge = t.v[7] >> 31;
  t.v[7] &= 0x7FFFFFFFu;
  AG_UNROLL for (int i = 0; i < 8; ++i) h.v[i] = ge ? t.v[i] : g.v[i];
}

AG_DEV bool fe_is_zero(const fe& f) {
  fe h;
  fe_freeze(h, f);
  uint32_t acc = 0;
  AG_UNROLL for (int i = 0; i < 8; ++i) acc |= h.v[i];
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

// z^(p-2) = z^(2^255 - 21) = 1/z (0 for z = 0): 254 squarings + 11
// multiplies, ref10's invert.  The same blocks as fe_pow22523 up to
// z^(2^250 - 1), then 5 squarings and z^11.
AG_DEV void fe_invert(fe& out, const fe& z) {
  fe z2, z9, z11, t0, t1, t2;
  fe_sq(z2, z);                 // 2
  fe_sqn(t0, z2, 2);            // 8
  fe_mul(z9, z, t0);            // 9
  fe_mul(z11, z2, z9);          // 11
  fe_sq(t0, z11);               // 22
  fe_mul(t0, z9, t0);           // 31 = 2^5 - 1
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
  fe_sqn(t0, t0, 5);            // 2^255 - 32
  fe_mul(out, t0, z11);         // 2^255 - 21
}

// One lane's 20 signed radix-2^13 limbs, contiguous (|limb| < 2^20; weak,
// unfrozen, possibly >= p or negative) -> a weakly reduced element of the
// same value mod p.  Each limb is summed into the 32-bit word its low bit
// falls in, in int64 (at most 3 limbs a word, each below 2^51 there); a
// signed carry pass leaves words in [0, 2^32) and the part above 2^256
// (|hi| < 2^12) in t[8], folded by 38 (2^256 = 38 mod p); a second pass
// leaves a carry c in {-1, 0, 1} out of word 7.  Then c = 1 means the
// words are below 2^19 and c = -1 that they are above 2^256 - 2^19, so
// adding 38 c to word 0 carries or borrows no further.  Multiplication
// instead of a left shift keeps negative limbs well defined; the right
// shifts of negative values are arithmetic (floor), as C++20 defines them.
AG_DEV void fe_load13_weak(fe& h, const int32_t* a) {
  int64_t t[9];
  AG_UNROLL for (int j = 0; j < 9; ++j) t[j] = 0;
  AG_UNROLL for (int k = 0; k < 20; ++k) {
    const int bit = 13 * k;
    t[bit >> 5] += (int64_t)a[k] * ((int64_t)1 << (bit & 31));
  }
  AG_UNROLL for (int j = 0; j < 8; ++j) {
    const int64_t c = t[j] >> 32;
    t[j] -= c * ((int64_t)1 << 32);
    t[j + 1] += c;
  }
  t[0] += 38 * t[8];
  AG_UNROLL for (int j = 0; j < 7; ++j) {
    const int64_t c = t[j] >> 32;
    t[j] -= c * ((int64_t)1 << 32);
    t[j + 1] += c;
  }
  const int64_t c = t[7] >> 32;
  t[7] -= c * ((int64_t)1 << 32);
  t[0] += 38 * c;
  AG_UNROLL for (int j = 0; j < 8; ++j) h.v[j] = (uint32_t)t[j];
}

// The canonical value of f (in [0, p)) as one lane's 20 strict radix-2^13
// limbs, contiguous.
AG_DEV void fe_store13(const fe& f, int32_t* out) {
  fe h;
  fe_freeze(h, f);
  AG_UNROLL for (int k = 0; k < 20; ++k) {
    const int bit = 13 * k, j = bit >> 5, off = bit & 31;
    uint32_t v = h.v[j] >> off;
    if (off > 19 && j < 7) v |= h.v[j + 1] << (32 - off);
    out[k] = (int32_t)(v & 0x1FFFu);
  }
}

// y from 20 strict 13-bit limbs at stride B -> radix-2^32 limbs (bit 255,
// the sign, dropped), and whether y < p.
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
  w[3] &= 0x7FFFFFFFFFFFFFFFull;
  AG_UNROLL for (int i = 0; i < 4; ++i) {
    h.v[2 * i] = (uint32_t)w[i];
    h.v[2 * i + 1] = (uint32_t)(w[i] >> 32);
  }
  const bool ge_p = w[3] == 0x7FFFFFFFFFFFFFFFull && w[2] == ~0ull &&
                    w[1] == ~0ull && w[0] >= 0xFFFFFFFFFFFFFFEDull;
  return !ge_p;
}

// Strict y + sign -> x; false if the encoding is not a curve point.
// Mirrors pallas_verify._decompress check for check.
AG_DEV bool decompress(fe& x, const fe& y, bool y_ok, int32_t sign,
                       const fe& d, const fe& sqrtm1) {
  fe one, y2, u, v, v2, v3, uv3, uv7, t, vx2;
  fe_one(one);
  fe_sq(y2, y);
  fe_sub(u, y2, one);
  fe_mul(v, y2, d);
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
  fe_mul(t, x, sqrtm1);
  if (root_flip) x = t;
  fe xf;
  fe_freeze(xf, x);
  uint32_t acc = 0;
  AG_UNROLL for (int i = 0; i < 8; ++i) acc |= xf.v[i];
  const bool x_is_zero = acc == 0;
  if ((int32_t)(xf.v[0] & 1) != sign) fe_neg(x, xf); else x = xf;
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
  fe_add(H, A, B);
  fe_sub(E, H, E);               // -E = A + B - (X+Y)^2
  fe_sub(G, A, B);               // -G = A - B
  fe_add(F, G, C);               // -F = C - G
  // X3 = E F = (-E)(-F), Y3 = G H = (-G)(-(A+B)), Z3 = F G = (-F)(-G),
  // T3 = E H = (-E)(-(A+B)): H keeps A + B, each product takes its
  // operands negated twice (or not at all)
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

}  // namespace r32
}  // namespace ag

#endif  // AG_FE25519_R32_CUH
