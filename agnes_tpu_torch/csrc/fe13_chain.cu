// The field-multiply chain of the layout microbenchmark, one thread per
// lane, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/microbench_layout.py::_chain_kernel
// (line 65, launched through pl.pallas_call by its `bench`): n_chain
// rounds of kPar = 4 independent `_fe_mul(x + i, y)`, then the wrapping
// sum of the 4 results.
//
//   in : x, y  [20, T]  int32  radix-2^13 limbs, limbs first (the
//                              script's [20, T] and [20, T/128, 128]
//                              layouts are these same bytes)
//   out: out   [20, T]  int32  the sum of the 4 chains' raw limbs
//
// The output is limb for limb what the JAX kernel leaves, not a value
// mod p: the 20 x 20 schoolbook into 40 columns (the last one zero),
// 3 vectorized passes over the high half whose top limb keeps its full
// value, lo + 608 * hi, then 4 folding passes (`_carry0`).  Every add,
// multiply and left shift is done on uint32 and reinterpreted, and right
// shifts are arithmetic, so the kernel equals JAX's wrapping int32 on
// any input, not only on the script's [0, 8192) limbs (which never wrap:
// their largest column is below 2^30).
//
// Tiling.  The TPU block is a tile per grid step; here a block's lane
// count is the lanes of one CTA, which covers them in strides of its
// kThreads threads.  So the script's rows differ only in how many CTAs
// share the 16,384 lanes (32 at 512 lanes a block, 8 at 2,048), which on
// 132 SMs is the finding the microbenchmark makes on this card.
//
// Bound on this card: integer ALU work.  One _fe_mul is 400 schoolbook
// products, 20 for 608 * hi and 4 for the folds of the carry passes: 424
// IMADs (scripts/microbench_layout.py::PRODUCTS_PER_FE_MUL), which this
// kernel does as they stand; the 240 bytes a lane are negligible beside
// them.  A lane's state (4 chains of 20 limbs, y, the 40 columns of the
// product in flight) is about 140 registers, so a CTA of 256 threads may
// use up to 255 a thread without spilling.  Each thread's 4 chains are
// independent, which gives the scheduler 4 products to overlap behind
// every dependent one.
//
// The lane math is plain C++ outside `#if __CUDACC__`, so a host compiler
// can check it against the plain PyTorch version before a card runs it.

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define AG_FE13_FN __device__ __forceinline__
#define AG_FE13_UNROLL _Pragma("unroll")
#define AG_FE13_NOUNROLL _Pragma("unroll 1")
#else
#define AG_FE13_FN static inline
#define AG_FE13_UNROLL
#define AG_FE13_NOUNROLL
#endif

namespace agfe13 {

constexpr int kN = 20;             // limbs (NLIMBS)
constexpr int kBits = 13;          // BITS
constexpr int32_t kMask = 8191;    // LMASK
constexpr int32_t kFold = 608;     // FOLD = 2^260 mod p
constexpr int kHiPasses = 3;       // _vpass0(hi, None) passes
constexpr int kCarryPasses = 4;    // _carry0 passes
constexpr int kPar = 4;            // PAR

AG_FE13_FN int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
AG_FE13_FN int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// out = _fe_mul(a, b), limb for limb; out may alias a or b.
AG_FE13_FN void fe_mul(const int32_t* a, const int32_t* b, int32_t* out) {
  int32_t lo[kN], hi[kN];
  AG_FE13_UNROLL for (int k = 0; k < 2 * kN; ++k) {
    uint32_t acc = 0;
    const int ilo = k - (kN - 1) > 0 ? k - (kN - 1) : 0;
    const int ihi = k < kN - 1 ? k : kN - 1;
    AG_FE13_UNROLL for (int i = ilo; i <= ihi; ++i)
      acc += (uint32_t)a[i] * (uint32_t)b[k - i];
    if (k < kN) lo[k] = (int32_t)acc;
    else hi[k - kN] = (int32_t)acc;            // hi[kN - 1] is column 39: 0
  }
  // _vpass0(hi, None): the top limb keeps its full value
  AG_FE13_UNROLL for (int p = 0; p < kHiPasses; ++p) {
    AG_FE13_UNROLL for (int k = kN - 1; k >= 1; --k) {
      const int32_t keep = k == kN - 1 ? hi[k] : (hi[k] & kMask);
      hi[k] = wadd(keep, hi[k - 1] >> kBits);
    }
    hi[0] &= kMask;
  }
  AG_FE13_UNROLL for (int k = 0; k < kN; ++k)
    lo[k] = wadd(lo[k], wmul(kFold, hi[k]));
  // _carry0: _vpass0(r, FOLD) four times
  AG_FE13_UNROLL for (int p = 0; p < kCarryPasses; ++p) {
    const int32_t top = lo[kN - 1] >> kBits;
    AG_FE13_UNROLL for (int k = kN - 1; k >= 1; --k)
      lo[k] = wadd(lo[k] & kMask, lo[k - 1] >> kBits);
    lo[0] = wadd(lo[0] & kMask, wmul(top, kFold));
  }
  AG_FE13_UNROLL for (int k = 0; k < kN; ++k) out[k] = lo[k];
}

// One lane of the chain: x, y, out limbs-first with stride T.
AG_FE13_FN void chain_lane(const int32_t* x, const int32_t* y, int32_t* out,
                           int64_t T, int64_t lane, int n_chain) {
  int32_t xs[kPar][kN], yv[kN];
  AG_FE13_UNROLL for (int k = 0; k < kN; ++k) {
    const int32_t xk = x[k * T + lane];
    yv[k] = y[k * T + lane];
    AG_FE13_UNROLL for (int c = 0; c < kPar; ++c) xs[c][k] = wadd(xk, c);
  }
  AG_FE13_NOUNROLL for (int n = 0; n < n_chain; ++n) {
    AG_FE13_UNROLL for (int c = 0; c < kPar; ++c) fe_mul(xs[c], yv, xs[c]);
  }
  AG_FE13_UNROLL for (int k = 0; k < kN; ++k) {
    int32_t acc = xs[0][k];
    AG_FE13_UNROLL for (int c = 1; c < kPar; ++c) acc = wadd(acc, xs[c][k]);
    out[k * T + lane] = acc;
  }
}

}  // namespace agfe13

#if defined(__CUDACC__)

constexpr int kThreads = 256;

// One CTA per TPU block: lanes [blockIdx.x * block, + block) of T, in
// strides of the CTA's threads.
__global__ void __launch_bounds__(kThreads, 1)
fe13_chain_kernel(const int32_t* __restrict__ x,
                  const int32_t* __restrict__ y, int32_t* __restrict__ out,
                  int64_t T, int64_t block, int n_chain) {
  const int64_t base = (int64_t)blockIdx.x * block;
  for (int64_t j = threadIdx.x; j < block; j += blockDim.x) {
    const int64_t lane = base + j;
    if (lane >= T) return;
    agfe13::chain_lane(x, y, out, T, lane, n_chain);
  }
}

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does
// not synchronize, returns cudaGetLastError() of the launch.
extern "C" int ag_fe13_chain(const int32_t* x, const int32_t* y,
                             int32_t* out, int64_t T, int64_t block,
                             int n_chain, void* stream) {
  if (T <= 0) return 0;
  if (block <= 0 || n_chain < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (T + block - 1) / block;
  fe13_chain_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, out, T, block, n_chain);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
