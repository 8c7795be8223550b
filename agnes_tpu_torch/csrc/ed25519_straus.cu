// [s]B - [k]A, one thread per lane, for Hopper (sm_90a).
//
// Replaces the TPU kernel agnes_tpu/crypto/pallas_ed25519.py::_straus_kernel
// (line 146) together with the table build of its wrapper
// straus_sub_pallas (line 198), which walked 260 MSB-first bit pairs of
// (s, k), a doubling and one unified add from {O, B, -A, B - A} each.
//
//   in : s, k    [B, 20]  int32  scalars as strict radix-2^13 limbs
//                                (< 2^260), rows contiguous
//        ax..at  [B, 20]  int32  A's extended coordinates (X, Y, Z, T),
//                                signed radix-2^13 limbs (weak), each at
//                                its own row stride (0: one row for all)
//        consts  [8 + 33 x 8 x 24] int32  2d, then the comb table:
//                                row i, entry j-1 = (y+x, y-x, 2dxy) of
//                                the affine j * 256^i * B, j = 1..8
//                                (radix-2^32 limbs, made by
//                                crypto/ed25519_point.py::straus_consts)
//   out: q       [4, B, 20]  int32  [s]B - [k]A, extended coordinates
//                                (X, Y, Z, T), each canonical (frozen)
//                                radix-2^13 limbs
//
// The output is a valid extended point (X Y = Z T) equal to the TPU
// kernel's as a group element; its projective representative differs
// (other formulas), so chip_smoke.py compares by group equality.
//
// Bound on this card: integer ALU work at throughput, and one thread's
// dependent chain of field multiplies at B = 1, the MSM path's only shape
// ([c]B with k = 0 and A the identity, crypto/msm.py::scalar_mul_base).
// The design does the least work it can on both:
//   - the field and curve code of fe25519_r32.cuh (pt_dbl, pt_add_niels,
//     to_niels): eight uint32 limbs, PTX carry chains;
//   - [s]B by a fixed-base comb with no doublings of its own (ref10's
//     ge_scalarmult_base, one row longer): s + 0x88..8 gives the signed
//     radix-16 digits e_i = nibble_i - 8 in [-8, 7] without a carry pass
//     (66 digits cover s < 2^260 exactly: the comb has 33 rows, where
//     ref10's 32 stop at 2^255); the odd digits' table entries are summed,
//     then 4 doublings, then the even digits' entries.  66 affine niels
//     adds of 7 multiplies; an add whose digit is 0 in every lane of the
//     warp is skipped;
//   - -[k]A by the verify kernel's walk (ed25519_verify.cu): a table of
//     e * (-A), e = 0..16, in projective niels in local memory, then per
//     signed 5-bit window (53 cover k < 2^260; digits from k + 0x1084..
//     likewise) 5 doublings and one table add.  The comb's odd sum enters
//     after the first doubling of the last window, so the walk's last 4
//     doublings are the comb's;
//   - where every lane of a warp has k = 0 the -A table and the walk are
//     skipped (a warp vote; [0]A is the identity whatever A is).  Lanes
//     past B take s = k = 0 and A = the identity and store nothing, so
//     they vote and reach the CTA barrier like the others.
// The constant block (2d and the comb table, 25,376 bytes) is copied once
// per CTA into shared memory, in CTAs of 256 threads.  On an H100 that
// placement and size were the fastest at B = 1 and within ~1% of reading
// the table through L1 at 128,000 lanes (PERF.md §6).
//
// The -A walk is a copy of ed25519_verify.cu's and not a shared header: the
// verify kernel's registers, stack and time were measured with its walk
// inlined as it is, and this kernel's walk differs (digits made in
// registers, the comb's sum entering its last window).

#include "fe25519_r32.cuh"

namespace ag {

constexpr int kCombRows = 33, kCombEnt = 8;
constexpr int kCombWords = kCombRows * kCombEnt * 24;
constexpr int kStrausConsts = 8 + kCombWords;
constexpr int kKWin = 53;                 // signed 5-bit windows of k
constexpr int kKEnt = 17;                 // e * (-A), e = 0..16

// u = v + h over 9 words, v the scalar < 2^260 from strict 13-bit limbs
// (zero where the lane is inactive), h a digit offset below 2^265.
AG_DEV void scalar_offset(uint32_t* u, const int32_t* limbs, const uint32_t* h,
                          bool active) {
  uint32_t v[9];
  AG_UNROLL for (int j = 0; j < 9; ++j) v[j] = 0;
  if (active) {
    AG_UNROLL for (int k = 0; k < 20; ++k) {
      const uint32_t l = (uint32_t)limbs[k] & 0x1FFFu;
      const int bit = 13 * k, j = bit >> 5, off = bit & 31;
      v[j] |= l << off;
      if (off > 19) v[j + 1] |= l >> (32 - off);
    }
  }
  uint32_t cf = 0;
  u[0] = r32::add_cc(v[0], h[0], cf);
  AG_UNROLL for (int j = 1; j < 8; ++j) u[j] = r32::addc_cc(v[j], h[j], cf);
  u[8] = r32::addc(v[8], h[8], cf);
}

// acc += e * 256^row * B for a comb digit e in [-8, 8] (0: the identity,
// (1, 1, 0)); the entry's negation swaps y+x and y-x and negates 2dxy.
AG_DEV void comb_add(r32::ext& acc, const uint32_t* comb, int row, int e) {
  using namespace r32;
  const int a = e < 0 ? -e : e;
  fe ypx, ymx, t2d;
  if (a == 0) {
    fe_one(ypx);
    fe_one(ymx);
    fe_zero(t2d);
  } else {
    const uint32_t* ent = comb + 24 * (kCombEnt * row + a - 1);
    fe_load(ypx, ent + (e < 0 ? 8 : 0));
    fe_load(ymx, ent + (e < 0 ? 0 : 8));
    fe_load(t2d, ent + 16);
    if (e < 0) fe_neg(t2d, t2d);
  }
  pt_add_niels(acc, acc, ypx, ymx, t2d, nullptr, true);
}

// The comb's odd (or even) digits summed into acc: byte i of u holds
// digits 2i (low nibble) and 2i + 1 (high nibble), both on row i.
template <class Warp>
AG_DEV void comb_pass(r32::ext& acc, const uint32_t* comb, const uint32_t* u,
                      bool odd) {
  uint32_t v[9];
  AG_UNROLL for (int j = 0; j < 9; ++j) v[j] = u[j];
  AG_NOUNROLL for (int row = 0; row < kCombRows; ++row) {
    const uint32_t byte = v[0] & 0xFFu;
    const int e = (int)(odd ? byte >> 4 : byte & 15u) - 8;
    AG_UNROLL for (int j = 0; j < 8; ++j)
      v[j] = (v[j] >> 8) | (v[j + 1] << 24);
    v[8] >>= 8;
    if (Warp::any(e != 0)) comb_add(acc, comb, row, e);
  }
}

// acc += d * (-A) from the projective-niels table, d in [-16, 15].
AG_DEV void ktab_add(r32::ext& acc, const r32::niels* atab, int d) {
  using namespace r32;
  const niels& n = atab[d < 0 ? -d : d];
  fe t2d;
  // -(Y+X, Y-X, 2dT, 2Z) = (Y-X, Y+X, -2dT, 2Z)
  if (d < 0) fe_neg(t2d, n.t2d); else t2d = n.t2d;
  pt_add_niels(acc, acc, d < 0 ? n.ymx : n.ypx, d < 0 ? n.ypx : n.ymx, t2d,
               &n.z2, true);
}

// The top window (bits 260..264) of u, shifted out: u <<= 5.
AG_DEV int top_window(uint32_t* u) {
  const int w = (int)((u[8] >> 4) & 31u);
  AG_UNROLL for (int j = 8; j > 0; --j) u[j] = (u[j] << 5) | (u[j - 1] >> 27);
  u[0] <<= 5;
  return w;
}

// [s]B - [k]A for one lane.  s and k point at its scalar rows; ax..at at
// its rows of A's coordinates; consts as at the top (in shared memory on
// the card).  `active` is false past B: the lane then computes
// [0]B - [0]O and its pointers are not read.  Warp::all / Warp::any are
// the warp's votes (one lane on its own on the host).
template <class Warp>
AG_DEV void straus_lane(const int32_t* s, const int32_t* k, const int32_t* ax,
                        const int32_t* ay, const int32_t* az,
                        const int32_t* at, const uint32_t* consts, bool active,
                        r32::ext& acc) {
  using namespace r32;
  // digit offsets: 8 in every nibble of 66 (radix 16); 16 in every
  // 5-bit window of 53 (bit 5i + 4)
  uint32_t h16[9], h32[9], us[9], uk[9];
  AG_UNROLL for (int j = 0; j < 8; ++j) h16[j] = 0x88888888u;
  h16[8] = 0x88u;
  AG_UNROLL for (int j = 0; j < 9; ++j) h32[j] = 0;
  AG_UNROLL for (int i = 0; i < kKWin; ++i) {
    const int bit = 5 * i + 4;
    h32[bit >> 5] |= 1u << (bit & 31);
  }
  scalar_offset(us, s, h16, active);
  scalar_offset(uk, k, h32, active);
  int32_t kor = 0;
  if (active) {
    AG_UNROLL for (int j = 0; j < 20; ++j) kor |= k[j];
  }

  const uint32_t* comb = consts + 8;
  fe_zero(acc.X);
  fe_one(acc.Y);
  fe_one(acc.Z);
  fe_zero(acc.T);
  const bool walk = !Warp::all(kor == 0);
  niels atab[kKEnt];
  if (walk) {
    fe d2;
    fe_load(d2, consts);
    ext na;                          // -A = (-X, Y, Z, -T)
    if (active) {
      fe_load13_weak(na.X, ax);
      fe_load13_weak(na.Y, ay);
      fe_load13_weak(na.Z, az);
      fe_load13_weak(na.T, at);
    } else {
      fe_zero(na.X);
      fe_one(na.Y);
      fe_one(na.Z);
      fe_zero(na.T);
    }
    fe_neg(na.X, na.X);
    fe_neg(na.T, na.T);
    fe_one(atab[0].ypx);
    fe_one(atab[0].ymx);
    fe_zero(atab[0].t2d);
    fe_one(atab[0].z2);
    fe_add(atab[0].z2, atab[0].z2, atab[0].z2);
    to_niels(atab[1], na, d2);
    ext e_na = na;
    AG_NOUNROLL for (int e = 2; e < kKEnt; ++e) {
      pt_add_niels(e_na, e_na, atab[1].ypx, atab[1].ymx, atab[1].t2d,
                   &atab[1].z2, true);
      to_niels(atab[e], e_na, d2);
    }
    AG_NOUNROLL for (int i = kKWin - 1; i > 0; --i) {
      const int d = top_window(uk) - 16;
      AG_NOUNROLL for (int j = 0; j < 4; ++j) pt_dbl(acc, acc, false);
      pt_dbl(acc, acc, true);
      ktab_add(acc, atab, d);
    }
    pt_dbl(acc, acc, true);           // the first of window 0's five
  }
  comb_pass<Warp>(acc, comb, us, true);
  AG_NOUNROLL for (int j = 0; j < 3; ++j) pt_dbl(acc, acc, false);
  pt_dbl(acc, acc, true);
  if (walk) ktab_add(acc, atab, top_window(uk) - 16);
  comb_pass<Warp>(acc, comb, us, false);
}

}  // namespace ag

#if defined(__CUDACC__)

constexpr int kThreads = 256;

struct CardWarp {
  static __device__ __forceinline__ bool all(bool p) {
    return __all_sync(0xFFFFFFFFu, p);
  }
  static __device__ __forceinline__ bool any(bool p) {
    return __any_sync(0xFFFFFFFFu, p);
  }
};

__global__ void __launch_bounds__(kThreads)
ed25519_straus_kernel(const int32_t* __restrict__ s,
                      const int32_t* __restrict__ k,
                      const int32_t* __restrict__ ax,
                      const int32_t* __restrict__ ay,
                      const int32_t* __restrict__ az,
                      const int32_t* __restrict__ at, int64_t sx, int64_t sy,
                      int64_t sz, int64_t st,
                      const int32_t* __restrict__ consts,
                      int32_t* __restrict__ out, int64_t B) {
  __shared__ __align__(16) uint32_t c[ag::kStrausConsts];
  for (int i = threadIdx.x; i < ag::kStrausConsts; i += kThreads)
    c[i] = (uint32_t)consts[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < B;
  const int64_t l = active ? lane : 0;
  ag::r32::ext q;
  ag::straus_lane<CardWarp>(s + 20 * l, k + 20 * l, ax + sx * l, ay + sy * l,
                            az + sz * l, at + st * l, c, active, q);
  if (active) {
    ag::r32::fe_store13(q.X, out + 20 * lane);
    ag::r32::fe_store13(q.Y, out + 20 * (B + lane));
    ag::r32::fe_store13(q.Z, out + 20 * (2 * B + lane));
    ag::r32::fe_store13(q.T, out + 20 * (3 * B + lane));
  }
}

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronize, returns cudaGetLastError() of the launch.
extern "C" int ag_ed25519_straus_sub(const int32_t* s, const int32_t* k,
                                     const int32_t* ax, const int32_t* ay,
                                     const int32_t* az, const int32_t* at,
                                     int64_t sx, int64_t sy, int64_t sz,
                                     int64_t st, const int32_t* consts,
                                     int32_t* out, int64_t B, void* stream) {
  if (B <= 0) return 0;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  ed25519_straus_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      s, k, ax, ay, az, at, sx, sy, sz, st, consts, out, B);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
