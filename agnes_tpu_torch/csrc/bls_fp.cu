// BLS12-381 base-field Barrett multiply and reduce, one thread per field
// element, for Hopper (sm_90a).
//
// Replaces two TPU kernels of agnes_tpu/crypto/pallas_field.py:
//   _mul_kernel    (line 162): 33 x 12-bit schoolbook columns fused into
//                  the Barrett reduce — every fv_mul / fv_mul_pairs;
//   _reduce_kernel (line 177): the Barrett reduce and carry chain alone,
//                  after a caller-chosen number of carry passes —
//                  reduce_cols on 33-wide columns (fv_reduce,
//                  fv_reduce_stack, fv_mul_small, fv_strict).
//
//   mul    in : xa, ya [33, R] int32  limbs <= 2 * 4104, value < 4p
//          out: out    [33, R] int32  strict limbs of a value < 4p
//   reduce in : cols   [33, R] int32  non-negative columns, value below
//                                     2^768 - 2^762; `passes` carry passes
//          out: out    [33, R] int32  strict limbs of a value < 4p
//
// Both equal the JAX package's rolled path (bls_field_jax.reduce_cols
// after _mul_cols) limb for limb, not only mod p: the same columns, the
// same vectorized carry passes (the top limb keeps its full value), the
// same quotient limbs t[64:97] of the loosely carried x * mu, the same
// r = x - q p and the same signed carry chain over 24-bit limb pairs.
// Arithmetic wraps mod 2^32 like JAX's int32 (unsigned adds, multiplies
// and left shifts; arithmetic right shifts), so no signed overflow is
// undefined here even outside the contract.
//
// Work skipped because no output limb can see it (the tests hold the
// result to the rolled path, which computes everything):
//   - x * mu only from column 64 - kMuPasses: after kMuPasses carry
//     passes, column k depends on columns k - kMuPasses .. k alone, so
//     the quotient limbs (64 and up) are exact;
//   - q * p, r = x - q p and its passes only over limbs 0..33: the chain
//     runs upward from limb 0, and its 33 output limbs are the low 396
//     bits of r, which limbs 34 and up cannot reach.
//
// Bound on this card.  The least work of the multiply is the 33 x 33
// schoolbook (1,089 products), the columns 64..97 of x * mu (561) and
// the columns 0..33 of q * p (591): 2,241 products, each one 32-bit IMAD
// (crypto/bls_field.py::MUL_INT32_OPS), which outweighs its 396 bytes an
// element.  The reduce's 33-limb input needs 1 quotient product and a
// 3-limb q (96 more): 97 IMADs, so its 264 bytes an element bound it.
// This kernel does 1,089 + 660 + 591 products for the multiply; the
// reduce runs the same tail on its zero-extended input.  The design is
// the simple one: the element's limbs stay in one thread's registers
// and local memory for the whole body; the constant tables live in the
// constant bank.
//
// The lane math is plain C++ outside `#if __CUDACC__`, so a host compiler
// can check it against the plain PyTorch version before a card runs it.

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define AG_BLS_FN __device__ __forceinline__
#define AG_BLS_CONST __constant__
#define AG_BLS_UNROLL _Pragma("unroll")
#define AG_BLS_NOUNROLL _Pragma("unroll 1")
#else
#define AG_BLS_FN static inline
#define AG_BLS_CONST static const
#define AG_BLS_UNROLL
#define AG_BLS_NOUNROLL
#endif

namespace agbls {

constexpr int kN = 33;              // limbs of an element
constexpr int kN65 = 2 * kN - 1;    // product columns
constexpr int kMuShift = 64;        // Barrett shift 2^768, in limbs
constexpr int kMuN = 33;            // limbs of mu = floor(2^768 / p)
constexpr int kPN = 32;             // limbs of p
constexpr int kTN = kN65 + kMuN;    // columns of x * mu (98)
constexpr int32_t kMask = 4095;
// carry-pass counts, bls_field._MUL_PASSES, _MU_PASSES, _P_PASSES,
// _R_PASSES (pinned by tests/test_torch_bls_field.py)
constexpr int kMulPasses = 3;
constexpr int kMuPasses = 3;
constexpr int kPPasses = 3;
constexpr int kRPasses = 2;
constexpr int kT0 = kMuShift - kMuPasses;   // first x * mu column kept
constexpr int kLow = kN + 1;                // limbs 0..33 of q p and r

// 12-bit limbs of mu and p, generated from bls_field._MU_LIMBS and
// _P_LIMBS (pinned by tests/test_torch_bls_field.py)
AG_BLS_CONST int32_t kMu[kMuN] = {
    2606, 2331, 1381, 127, 994, 1969, 448, 1423, 1952, 1814, 921, 1949,
    2151, 3586, 1905, 3572, 2379, 2570, 4086, 1857, 2946, 657, 1722, 3194,
    2828, 257, 3624, 1116, 3230, 3900, 1490, 3459, 9};
AG_BLS_CONST int32_t kP[kPN] = {
    2731, 4090, 4095, 4095, 2558, 4091, 1023, 2837, 4094, 2751, 1054, 3938,
    1712, 2575, 210, 1651, 703, 2129, 1267, 1208, 1143, 3446, 2988, 1076,
    1974, 442, 2635, 3689, 2431, 3747, 273, 416};

AG_BLS_FN int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
AG_BLS_FN int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
AG_BLS_FN uint32_t wmul(int32_t a, int32_t b) {
  return (uint32_t)a * (uint32_t)b;
}

// One vectorized carry pass over x[0..n): limb k becomes its low 12 bits
// plus the arithmetic carry of limb k - 1; with keep_top the top limb
// keeps its full value (the JAX _vpass), else it is masked too (a prefix
// of a longer limb vector, whose limb n - 1 is interior).
template <int n>
AG_BLS_FN void vpass(int32_t* x, bool keep_top) {
  AG_BLS_UNROLL for (int k = n - 1; k >= 1; --k) {
    const int32_t lo = (k == n - 1 && keep_top) ? x[k] : (x[k] & kMask);
    x[k] = wadd(lo, x[k - 1] >> 12);
  }
  x[0] &= kMask;
}

// Barrett body from the loosened columns x[0..65) on: quotient, remainder,
// chain; writes the 33 strict limbs to out[i * stride].
AG_BLS_FN void barrett_tail(const int32_t* x, int32_t* out, int64_t stride) {
  // t = x * mu, columns kT0 .. kTN - 1
  int32_t t[kTN - kT0];
  AG_BLS_UNROLL for (int k = kT0; k < kTN; ++k) {
    uint32_t acc = 0;
    const int ilo = k - (kMuN - 1) > 0 ? k - (kMuN - 1) : 0;
    const int ihi = k < kN65 - 1 ? k : kN65 - 1;
    AG_BLS_UNROLL for (int i = ilo; i <= ihi; ++i) acc += wmul(x[i], kMu[k - i]);
    t[k - kT0] = (int32_t)acc;
  }
  AG_BLS_UNROLL for (int p = 0; p < kMuPasses; ++p) vpass<kTN - kT0>(t, true);
  const int32_t* q = t + (kMuShift - kT0);          // limbs 64..96
  // r = x - q p over limbs 0..33
  int32_t r[kLow];
  AG_BLS_UNROLL for (int k = 0; k < kLow; ++k) {
    uint32_t acc = 0;
    const int ilo = k - (kPN - 1) > 0 ? k - (kPN - 1) : 0;
    const int ihi = k < kN - 1 ? k : kN - 1;
    AG_BLS_UNROLL for (int i = ilo; i <= ihi; ++i) acc += wmul(q[i], kP[k - i]);
    r[k] = (int32_t)acc;
  }
  AG_BLS_UNROLL for (int p = 0; p < kPPasses; ++p) vpass<kLow>(r, false);
  AG_BLS_UNROLL for (int k = 0; k < kLow; ++k) r[k] = wsub(x[k], r[k]);
  AG_BLS_UNROLL for (int p = 0; p < kRPasses; ++p) vpass<kLow>(r, false);
  // sequential signed chain over 24-bit limb pairs (limb 33 dropped)
  int32_t c = 0;
  AG_BLS_UNROLL for (int k = 0; k < kLow / 2; ++k) {
    const int32_t s = wadd(r[2 * k], (int32_t)((uint32_t)r[2 * k + 1] << 12));
    const int32_t tt = wadd(s, c);
    const int32_t v = tt & 0xFFFFFF;
    out[(2 * k) * stride] = v & kMask;
    if (2 * k + 1 < kN) out[(2 * k + 1) * stride] = v >> 12;
    c = tt >> 24;
  }
}

// Kernel 4's element: schoolbook columns, kMulPasses passes, the tail.
AG_BLS_FN void mul_lane(const int32_t* xa, const int32_t* ya, int32_t* out,
                        int64_t R, int64_t row) {
  int32_t a[kN], b[kN];
  AG_BLS_UNROLL for (int i = 0; i < kN; ++i) {
    a[i] = xa[i * R + row];
    b[i] = ya[i * R + row];
  }
  int32_t x[kN65];
  AG_BLS_UNROLL for (int k = 0; k < kN65; ++k) {
    uint32_t acc = 0;
    const int ilo = k - (kN - 1) > 0 ? k - (kN - 1) : 0;
    const int ihi = k < kN - 1 ? k : kN - 1;
    AG_BLS_UNROLL for (int i = ilo; i <= ihi; ++i) acc += wmul(a[i], b[k - i]);
    x[k] = (int32_t)acc;
  }
  AG_BLS_UNROLL for (int p = 0; p < kMulPasses; ++p) vpass<kN65>(x, true);
  barrett_tail(x, out + row, R);
}

// Kernel 5's element: `passes` passes over the 33 columns (top limb
// kept), zero-extended to 65 limbs, the tail.
AG_BLS_FN void reduce_lane(const int32_t* cols, int32_t* out, int64_t R,
                           int passes, int64_t row) {
  int32_t x[kN65];
  AG_BLS_UNROLL for (int i = 0; i < kN; ++i) x[i] = cols[i * R + row];
  AG_BLS_NOUNROLL for (int p = 0; p < passes; ++p) vpass<kN>(x, true);
  AG_BLS_UNROLL for (int i = kN; i < kN65; ++i) x[i] = 0;
  barrett_tail(x, out + row, R);
}

}  // namespace agbls

#if defined(__CUDACC__)

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
bls_fp_mul_kernel(const int32_t* __restrict__ xa,
                  const int32_t* __restrict__ ya, int32_t* __restrict__ out,
                  int64_t R) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  agbls::mul_lane(xa, ya, out, R, row);
}

__global__ void __launch_bounds__(kThreads)
bls_fp_reduce_kernel(const int32_t* __restrict__ cols,
                     int32_t* __restrict__ out, int64_t R, int passes) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  agbls::reduce_lane(cols, out, R, passes, row);
}

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronize, and returns cudaGetLastError() of the launch.
extern "C" int ag_bls_fp_mul(const int32_t* xa, const int32_t* ya,
                             int32_t* out, int64_t R, void* stream) {
  if (R <= 0) return 0;
  const int64_t blocks = (R + kThreads - 1) / kThreads;
  bls_fp_mul_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      xa, ya, out, R);
  return (int)cudaGetLastError();
}

extern "C" int ag_bls_fp_reduce(const int32_t* cols, int32_t* out, int64_t R,
                                int passes, void* stream) {
  if (R <= 0) return 0;
  const int64_t blocks = (R + kThreads - 1) / kThreads;
  bls_fp_reduce_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(cols, out, R, passes);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
