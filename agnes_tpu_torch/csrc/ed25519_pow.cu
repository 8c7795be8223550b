// Batched x^e mod 2^255 - 19 for a static exponent, one thread per lane,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel agnes_tpu/crypto/pallas_ed25519.py::_pow_kernel
// (line 169), which ran left-to-right square-and-multiply over e's bits.
//
//   in : x       [B, 20]  int32  x as 20 signed radix-2^13 limbs a row
//                                (weak: any sign, any residue;
//                                |limb| < 2^20), rows contiguous
//        chain   int             the exponent's schedule (below)
//        digits  [n]      int32  kChainWindow only: e's radix-16 digits,
//                                most significant first, digits[0] != 0
//   out: y       [B, 20]  int32  x^e mod p, canonical (frozen) radix-2^13
//                                limbs in [0, 2^13), value in [0, p)
//
// The wrapper (crypto/field.py::pow_p) picks the schedule from e:
//   kChainP58     e = (p-5)/8: fe_pow22523, 251 squarings + 11 multiplies;
//   kChainInvert  e = p-2:     fe_invert, 254 squarings + 11 multiplies;
//   kChainWindow  any other e >= 1: fixed 4-bit windows, a table of
//                 x^0..x^15 (7 squarings, 7 multiplies) in local memory,
//                 then per further digit 4 squarings and, where the digit
//                 is not 0, one multiply.
// Every lane takes the same schedule, so nothing diverges.  The output is
// frozen, so every schedule gives the plain version's limbs.
//
// Bound on this card: integer ALU work.  For the two exponents the port
// raises to, a lane does exactly the shortest known addition chain that
// the bound counts (crypto/field.py::pow_least_int32_ops: 14,905 int32
// operations for (p-5)/8 in the yardstick of 55 a squaring and 100 a
// multiply), against 160 bytes of memory a lane.  The design:
//   - the field of fe25519_r32.cuh: eight uint32 limbs, products in PTX
//     carry chains (36 products a squaring, 64 a multiply, where the
//     radix-2^25.5 field took 55 and 100 wide ones and a carry pass);
//   - rows read and written in place ([B, 20], a lane's 80 bytes
//     contiguous), no transposing copies around the launch;
//   - the running power and the chain's few temporaries stay in
//     registers; CTAs of 64 threads (64, 128 and 256 timed within 0.7% of
//     one another on an H100, PERF.md §6; 64 leaves the smallest last
//     wave).

#include "fe25519_r32.cuh"

namespace ag {

constexpr int kChainWindow = 0, kChainP58 = 1, kChainInvert = 2;

// x^e by fixed 4-bit windows over e's digits (most significant first).
AG_DEV void fe_pow_window(r32::fe& r, const r32::fe& x, const int32_t* digits,
                          int n_digits) {
  using namespace r32;
  fe tab[16];
  fe_one(tab[0]);
  tab[1] = x;
  AG_UNROLL for (int i = 2; i < 16; ++i) {
    if (i & 1) fe_mul(tab[i], tab[i - 1], x);
    else fe_sq(tab[i], tab[i / 2]);
  }
  r = tab[digits[0]];
  AG_NOUNROLL for (int i = 1; i < n_digits; ++i) {
    fe_sqn(r, r, 4);
    const int d = digits[i];
    if (d) fe_mul(r, r, tab[d]);
  }
}

// One lane: x and out point at its row of 20 limbs.
template <int CHAIN>
AG_DEV void pow_lane(const int32_t* x, int32_t* out, const int32_t* digits,
                     int n_digits) {
  using namespace r32;
  fe xv, r;
  fe_load13_weak(xv, x);
  if (CHAIN == kChainP58) fe_pow22523(r, xv);
  else if (CHAIN == kChainInvert) fe_invert(r, xv);
  else fe_pow_window(r, xv, digits, n_digits);
  fe_store13(r, out);
}

}  // namespace ag

#if defined(__CUDACC__)

constexpr int kThreads = 64;

template <int CHAIN>
__global__ void __launch_bounds__(kThreads)
fe_pow_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
              int64_t B, const int32_t* __restrict__ digits, int n_digits) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  ag::pow_lane<CHAIN>(x + 20 * lane, out + 20 * lane, digits, n_digits);
}

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronize, returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for an unknown chain).
extern "C" int ag_fe_pow(const int32_t* x, int32_t* out, int64_t B, int chain,
                         const int32_t* digits, int n_digits, void* stream) {
  if (B <= 0) return 0;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  switch (chain) {
    case ag::kChainP58:
      fe_pow_kernel<ag::kChainP58><<<blocks, kThreads, 0, st>>>(
          x, out, B, digits, n_digits);
      break;
    case ag::kChainInvert:
      fe_pow_kernel<ag::kChainInvert><<<blocks, kThreads, 0, st>>>(
          x, out, B, digits, n_digits);
      break;
    case ag::kChainWindow:
      fe_pow_kernel<ag::kChainWindow><<<blocks, kThreads, 0, st>>>(
          x, out, B, digits, n_digits);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
