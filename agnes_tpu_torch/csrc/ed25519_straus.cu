// [s]B - [k]A by Shamir's trick, one thread per lane, for Hopper (sm_90a).
//
// Replaces the TPU kernel agnes_tpu/crypto/pallas_ed25519.py::_straus_kernel
// (line 146) together with the table build of its wrapper
// straus_sub_pallas (line 198): 260 MSB-first steps, each a doubling and
// one add from the table {O, B, -A, B - A} picked by the bit pair.
//
//   in : s, k    [20, B]     int32  scalars as strict radix-2^13 limbs
//                                   (< 2^260)
//        a       [4, 20, B]  int32  A's extended coordinates (X, Y, Z, T)
//                                   as signed radix-2^13 limbs (weak)
//        consts  [40]        int32  2d, then B's x, y and xy (radix-2^25.5
//                                   limbs, made by
//                                   crypto/ed25519_point.py::straus_consts)
//   out: q       [4, 20, B]  int32  [s]B - [k]A, extended coordinates,
//                                   each canonical (frozen) radix-2^13 limbs
//
// Every addition, the doublings and the identity adds included, is the
// unified law of the TPU kernel's `_pt_add`, in the same order from the
// same table, so the output is the same projective point coordinate for
// coordinate: frozen, the TPU kernel's and the plain version's limbs.
//
// Bound on this card: integer ALU work.  [s]B - [k]A needs at least a
// joint double-and-add over the bits the scalars have: for scalars below
// L about 252 dedicated doublings (4 squarings, 3 multiplies) and one add
// (8 multiplies) per bit pair that is not (0, 0), half to 0.6 of what
// this kernel does (crypto/ed25519_point.py::straus_least_int32_ops
// counts it on the data).  This kernel does 1 + 2 x 260 unified
// adds of 9 multiplies (100 32x32->64-bit products each), the doublings
// and identity adds included, 468,900 operations a lane (one
// IMAD.WIDE a product); 800 bytes a
// lane.  On the MSM path it runs once, for [c]B at B = 1, where one
// thread's dependent chain of 4,689 multiplies sets the time (latency,
// not throughput).  The design is the simple one: the table lives in
// local memory and the scalars' bits are read from global memory per
// step.

#include "fe25519.cuh"

namespace ag {

constexpr int kStrausBits = 260;

AG_DEV void straus_lane(const int32_t* s, const int32_t* k, const int32_t* a,
                        const int32_t* consts, int32_t* out, int64_t B,
                        int64_t lane) {
  fe d2;
  fe_load(d2, consts);
  ext tab[4];                       // indexed by bs + 2 bk
  fe_zero(tab[0].X);
  fe_one(tab[0].Y);
  fe_one(tab[0].Z);
  fe_zero(tab[0].T);
  fe_load(tab[1].X, consts + 10);
  fe_load(tab[1].Y, consts + 20);
  fe_one(tab[1].Z);
  fe_load(tab[1].T, consts + 30);
  ext A;
  fe_from_limbs13_weak(A.X, a, B, lane);
  fe_from_limbs13_weak(A.Y, a + 20 * B, B, lane);
  fe_from_limbs13_weak(A.Z, a + 40 * B, B, lane);
  fe_from_limbs13_weak(A.T, a + 60 * B, B, lane);
  fe_neg(tab[2].X, A.X);            // -A = (-X, Y, Z, -T)
  fe_carry32(tab[2].X);
  fe_copy(tab[2].Y, A.Y);
  fe_copy(tab[2].Z, A.Z);
  fe_neg(tab[2].T, A.T);
  fe_carry32(tab[2].T);
  pt_add(tab[3], tab[1], tab[2], d2);

  ext acc = tab[0];
  AG_NOUNROLL for (int i = 0; i < kStrausBits; ++i) {
    const int idx = kStrausBits - 1 - i, limb = idx / 13, off = idx % 13;
    const int bs = (s[limb * B + lane] >> off) & 1;
    const int bk = (k[limb * B + lane] >> off) & 1;
    pt_add(acc, acc, acc, d2);
    pt_add(acc, acc, tab[bs + 2 * bk], d2);
  }
  fe_store_limbs13(acc.X, out, B, lane);
  fe_store_limbs13(acc.Y, out + 20 * B, B, lane);
  fe_store_limbs13(acc.Z, out + 40 * B, B, lane);
  fe_store_limbs13(acc.T, out + 60 * B, B, lane);
}

}  // namespace ag

#if defined(__CUDACC__)

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ed25519_straus_kernel(const int32_t* __restrict__ s,
                      const int32_t* __restrict__ k,
                      const int32_t* __restrict__ a,
                      const int32_t* __restrict__ consts,
                      int32_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  ag::straus_lane(s, k, a, consts, out, B, lane);
}

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does
// not synchronize, returns cudaGetLastError() of the launch.
extern "C" int ag_ed25519_straus_sub(const int32_t* s, const int32_t* k,
                                     const int32_t* a, const int32_t* consts,
                                     int32_t* out, int64_t B, void* stream) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  ed25519_straus_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(s, k, a, consts, out, B);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
