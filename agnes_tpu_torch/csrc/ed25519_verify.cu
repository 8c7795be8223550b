// Fused cofactored Ed25519 verify, one thread per lane, for Hopper (sm_90a).
//
// Replaces the TPU kernel agnes_tpu/crypto/pallas_verify.py::_verify_kernel
// (line 409) in both its variants, as a template over the window width W:
// W = 5 is signed5=True (52 signed 5-bit windows over a 17-entry table),
// W = 4 is signed5=False (65 unsigned 4-bit windows over a 16-entry
// table).  The same boundary and verdicts as the TPU kernel.
//
//   in : ya, yr  [20, B] int32  y of A and R as strict 13-bit limbs
//        sa, sr  [B]     int32  sign bit (bit 255) of A and R
//        sdig, kdig [nw, B] int32  digits of S and k, most significant
//                                 window first: W = 5, nw = 52 signed in
//                                 [-16, 15]; W = 4, nw = 65 in [0, 15]
//        consts  [432]   int32  d, 2d, sqrt(-1) and the 17-entry affine
//                                 niels table of e*B (radix-2^32 limbs,
//                                 made by crypto/verify.py::kernel_consts;
//                                 W = 4 reads the first 16 entries)
//   out: ok      [B]     int32  1 iff A and R decode (canonical y < p,
//                                 x^2 a residue, not x = 0 with sign 1)
//                                 and [8]([S]B - [k]A) == [8]R
//
// The S < L check and the prologue (SHA-512, mod-L reduction, digit
// recoding) stay outside, as in the Pallas version.
//
// Bound on this card: integer instruction issue.  Per lane the W = 5
// kernel does 1,757 field multiplies and 1,574 squarings (262,270 products
// of 32 x 32 bits as the radix-2^25.5 field counts them, the bound's
// yardstick in crypto/verify.py) on 588 bytes of input; the W = 4 kernel
// 1,943 multiplies and 1,574 squarings on 692 bytes.  No matrix product
// and no streamed tiles, so no tensor cores and no TMA.
//
// Design.  The field and curve code is fe25519_r32.cuh: eight 32-bit
// limbs in registers, products in PTX carry chains (64 products a
// multiply, 36 a squaring, where radix 2^25.5 takes 100 wide products and
// a 64-bit carry pass), adds and subtracts without a carry pass, a value
// frozen only where it is compared.  Per lane: decompress A and R (sqrt
// addition chain), build the projective-niels table of e*(-A) in local
// memory (17 x 128 bytes), run the windows of joint [S]B - [k]A (W
// doublings, one -A table add, one fixed-B table add each; the B table
// sits in shared memory; a negative digit of W = 5 negates its entry, a
// swap and one negation), then x8 both sides and compare projectively.
// The ragged edge is masked here (no padding of B).
//
// The launch: CTAs of 256 threads at the default launch bounds (ptxas
// then keeps a thread at 128 registers, a few dozen bytes of spills, so
// two CTAs share an SM).  Timed on the card against 64 and 128 threads,
// 512, and explicit minimum-block bounds, it ties with the fastest; the
// -A table in shared memory (2,192 bytes a thread: one CTA of 64 threads
// an SM) ran 2.2x slower than in local memory.  Numbers in PERF.md.

#include "fe25519_r32.cuh"

namespace ag {

constexpr int kConsts = 24 + 17 * 24;

template <int W> struct Window;
template <> struct Window<5> { static constexpr int kWin = 52, kEnt = 17; };
template <> struct Window<4> { static constexpr int kWin = 65, kEnt = 16; };

// The whole check for one lane; consts as described at the top.  The
// digit handling is written for signed digits; W = 4 digits are never
// negative, so its negation branches never run.
template <int W>
AG_DEV int32_t verify_lane(const int32_t* ya, const int32_t* sa,
                           const int32_t* yr, const int32_t* sr,
                           const int32_t* sdig, const int32_t* kdig,
                           const uint32_t* consts, int64_t B, int64_t lane) {
  using namespace r32;
  const uint32_t* btab = consts + 24;
  fe d, d2, sqrtm1, fy_a, fy_r, xa, xr;
  fe_load(d, consts);
  fe_load(d2, consts + 8);
  fe_load(sqrtm1, consts + 16);

  const bool yok_a = fe_from_limbs13(fy_a, ya, B, lane);
  const bool yok_r = fe_from_limbs13(fy_r, yr, B, lane);
  const bool ok_a = decompress(xa, fy_a, yok_a, sa[lane], d, sqrtm1);
  const bool ok_r = decompress(xr, fy_r, yok_r, sr[lane], d, sqrtm1);

  // table[e] = e * (-A), projective niels; -A = (-x, y, 1, -x y)
  constexpr int kEnt = Window<W>::kEnt;
  niels atab[kEnt];
  ext na, acc;
  fe_neg(na.X, xa);
  na.Y = fy_a;
  fe_one(na.Z);
  fe_mul(na.T, na.X, na.Y);
  fe_one(atab[0].ypx);
  fe_one(atab[0].ymx);
  fe_zero(atab[0].t2d);
  fe_one(atab[0].z2);
  fe_add(atab[0].z2, atab[0].z2, atab[0].z2);
  to_niels(atab[1], na, d2);
  acc = na;
  AG_NOUNROLL for (int e = 2; e < kEnt; ++e) {
    pt_add_niels(acc, acc, atab[1].ypx, atab[1].ymx, atab[1].t2d,
                 &atab[1].z2, true);
    to_niels(atab[e], acc, d2);
  }

  // the windows of [S]B - [k]A, most significant first
  fe_zero(acc.X);
  fe_one(acc.Y);
  fe_one(acc.Z);
  fe_zero(acc.T);
  AG_NOUNROLL for (int i = 0; i < Window<W>::kWin; ++i) {
    AG_NOUNROLL for (int j = 0; j < W - 1; ++j) pt_dbl(acc, acc, false);
    pt_dbl(acc, acc, true);

    const int32_t kd = kdig[i * B + lane];
    const niels& na_e = atab[kd < 0 ? -kd : kd];
    fe t2d;
    // -(Y+X, Y-X, 2dT, 2Z) = (Y-X, Y+X, -2dT, 2Z)
    if (kd < 0) fe_neg(t2d, na_e.t2d); else t2d = na_e.t2d;
    pt_add_niels(acc, acc, kd < 0 ? na_e.ymx : na_e.ypx,
                 kd < 0 ? na_e.ypx : na_e.ymx, t2d, &na_e.z2, true);

    const int32_t sd = sdig[i * B + lane];
    const uint32_t* be = btab + 24 * (sd < 0 ? -sd : sd);
    fe bypx, bymx;
    fe_load(bypx, be + (sd < 0 ? 8 : 0));
    fe_load(bymx, be + (sd < 0 ? 0 : 8));
    fe_load(t2d, be + 16);
    if (sd < 0) fe_neg(t2d, t2d);
    pt_add_niels(acc, acc, bypx, bymx, t2d, nullptr, false);
  }

  // cofactored equality: [8]Q == [8]R, cross-multiplied (R has Z = 1)
  ext R;
  R.X = xr;
  R.Y = fy_r;
  fe_one(R.Z);
  AG_UNROLL for (int j = 0; j < 3; ++j) {
    pt_dbl(acc, acc, false);
    pt_dbl(R, R, false);
  }
  fe l, r, t;
  fe_mul(l, acc.X, R.Z);
  fe_mul(r, R.X, acc.Z);
  fe_sub(t, l, r);
  const bool eqx = fe_is_zero(t);
  fe_mul(l, acc.Y, R.Z);
  fe_mul(r, R.Y, acc.Z);
  fe_sub(t, l, r);
  const bool eqy = fe_is_zero(t);
  return (ok_a && ok_r && eqx && eqy) ? 1 : 0;
}

}  // namespace ag

#if defined(__CUDACC__)

constexpr int kThreads = 256;

template <int W>
__global__ void __launch_bounds__(kThreads)
ed25519_verify_kernel(const int32_t* __restrict__ ya,
                      const int32_t* __restrict__ sa,
                      const int32_t* __restrict__ yr,
                      const int32_t* __restrict__ sr,
                      const int32_t* __restrict__ sdig,
                      const int32_t* __restrict__ kdig,
                      const int32_t* __restrict__ consts,
                      int32_t* __restrict__ out, int64_t B) {
  __shared__ __align__(16) uint32_t sconst[ag::kConsts];
  for (int i = threadIdx.x; i < ag::kConsts; i += blockDim.x)
    sconst[i] = (uint32_t)consts[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  out[lane] = ag::verify_lane<W>(ya, sa, yr, sr, sdig, kdig, sconst, B, lane);
}

template <int W>
static int launch_verify(const int32_t* ya, const int32_t* sa,
                         const int32_t* yr, const int32_t* sr,
                         const int32_t* sdig, const int32_t* kdig,
                         const int32_t* consts, int32_t* out, int64_t B,
                         void* stream) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  ed25519_verify_kernel<W><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      ya, sa, yr, sr, sdig, kdig, consts, out, B);
  return (int)cudaGetLastError();
}

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronize, and returns cudaGetLastError() of the launch.
extern "C" int ag_ed25519_verify_signed5(const int32_t* ya, const int32_t* sa,
                                         const int32_t* yr, const int32_t* sr,
                                         const int32_t* sdig, const int32_t* kdig,
                                         const int32_t* consts, int32_t* out,
                                         int64_t B, void* stream) {
  return launch_verify<5>(ya, sa, yr, sr, sdig, kdig, consts, out, B, stream);
}

extern "C" int ag_ed25519_verify_w4(const int32_t* ya, const int32_t* sa,
                                    const int32_t* yr, const int32_t* sr,
                                    const int32_t* sdig, const int32_t* kdig,
                                    const int32_t* consts, int32_t* out,
                                    int64_t B, void* stream) {
  return launch_verify<4>(ya, sa, yr, sr, sdig, kdig, consts, out, B, stream);
}

#endif  // __CUDACC__
