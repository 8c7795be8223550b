// Batched x^e mod 2^255 - 19 for a static exponent, one thread per lane,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel agnes_tpu/crypto/pallas_ed25519.py::_pow_kernel
// (line 169): left-to-right square-and-multiply over the exponent's bits.
//
//   in : x     [20, B]   int32  x as 20 signed radix-2^13 limbs (weak:
//                               any sign, any residue; |limb| < 2^20)
//        bits  [n_bits]  int32  e's bits, most significant first
//   out: y     [20, B]   int32  x^e mod p, canonical (frozen) radix-2^13
//                               limbs in [0, 2^13), value in [0, p)
//
// The TPU kernel took the bits lane-replicated ([n_bits, 512]) because
// Mosaic could not broadcast along sublanes and lanes at once; here every
// thread reads the same bit, so the exponent comes once and branching on
// it does not diverge.  The input's limbs are weak and signed (the MSM
// path passes a product straight from the field multiply), and the
// radix-2^13 and radix-2^25.5 limb boundaries do not align, so the load
// accumulates each 13-bit limb into its 25.5-bit column in int64 and
// carries once (fe25519.cuh: fe_from_limbs13_weak).
//
// Bound on this card: integer ALU work.  x^((p-5)/8) needs at least the
// shortest known addition chain, 251 squarings (55 32x32->64-bit
// products each) and 11 multiplies (100 products): 14,905 products,
// counted as 14,905 int32 operations a lane (one IMAD.WIDE a product) (crypto/field.py::
// pow_least_int32_ops); memory is 160 bytes a lane.  chip_smoke.py
// derives the bound from that count and the card's SM count and clock.
// This kernel does more: its square-and-multiply loop over the bits
// (252 squarings, 251 multiplies: 38,960 operations, pow_int32_ops), 2.6
// times the chain.  The design is the simple one: the running power stays
// in registers for the whole loop, with no other state.

#include "fe25519.cuh"

namespace ag {

AG_DEV void pow_lane(const int32_t* x, const int32_t* bits, int n_bits,
                     int32_t* out, int64_t B, int64_t lane) {
  fe xv, r;
  fe_from_limbs13_weak(xv, x, B, lane);
  fe_one(r);
  AG_NOUNROLL for (int i = 0; i < n_bits; ++i) {
    fe_sq(r, r);
    if (bits[i]) fe_mul(r, r, xv);
  }
  fe_store_limbs13(r, out, B, lane);
}

}  // namespace ag

#if defined(__CUDACC__)

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fe_pow_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ bits,
              int n_bits, int32_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  ag::pow_lane(x, bits, n_bits, out, B, lane);
}

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does
// not synchronize, returns cudaGetLastError() of the launch.
extern "C" int ag_fe_pow(const int32_t* x, const int32_t* bits, int n_bits,
                         int32_t* out, int64_t B, void* stream) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  fe_pow_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, bits, n_bits, out, B);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
