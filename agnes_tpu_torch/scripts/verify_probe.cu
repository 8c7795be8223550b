// Probe kernels behind the verify kernel's design (verify_probe.py): the
// issue rates of the integer multiply forms, dependent chains of field
// operations in the two fields of csrc/, and one window of the verify loop
// for a static count of its instructions.  A measurement tool; no path of
// the port launches these.
#include "fe25519.cuh"
#include "fe25519_r32.cuh"

// -- issue rates: eight independent chains a thread ------------------------
#define AG_TPUT(NAME, BODY)                                                   \
  __global__ void NAME(uint32_t* out, int n) {                                \
    uint32_t a[8];                                                            \
    uint64_t w[8];                                                            \
    const uint32_t m = 0x9E3779B1u + blockIdx.x;                              \
    for (int k = 0; k < 8; ++k) { a[k] = threadIdx.x * 7u + k; w[k] = a[k]; } \
    for (int i = 0; i < n; ++i) {                                             \
      _Pragma("unroll") for (int k = 0; k < 8; ++k) { BODY; }                 \
    }                                                                         \
    uint32_t acc = 0;                                                         \
    for (int k = 0; k < 8; ++k)                                               \
      acc ^= a[k] ^ (uint32_t)w[k] ^ (uint32_t)(w[k] >> 32);                  \
    out[blockIdx.x * blockDim.x + threadIdx.x] = acc;                         \
  }
AG_TPUT(t_imad, asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a[k]) : "r"(m), "r"(m)))
AG_TPUT(t_imad_hi, asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(a[k]) : "r"(m), "r"(m)))
AG_TPUT(t_imad_wide_u32, asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(w[k]) : "r"((uint32_t)w[k]), "r"(m)))
AG_TPUT(t_imad_wide_s32, asm volatile("mad.wide.s32 %0, %1, %2, %0;" : "+l"(w[k]) : "r"((uint32_t)w[k]), "r"(m)))
AG_TPUT(t_iadd3, asm volatile("add.u32 %0, %0, %1;\n\tadd.u32 %0, %0, %2;" : "+r"(a[k]) : "r"(m), "r"(a[(k + 1) & 7])))

// -- dependent chains of one field operation a thread ----------------------
// OP 0: x = x y; 1: x = x^2; 2: x = (x + y) - y.
template <int OP>
__global__ void chain_r25(int32_t* out, int n) {
  using namespace ag;
  fe x, y;
  const uint32_t s = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < 10; ++i) {
    x.v[i] = (int32_t)((s * 2654435761u + i * 977u) & 0xFFFFFF);
    y.v[i] = (int32_t)((s * 40503u + i * 131u) & 0xFFFFFF);
  }
  for (int k = 0; k < n; ++k) {
    if (OP == 0) fe_mul(x, x, y);
    else if (OP == 1) fe_sq(x, x);
    else { fe_add(x, x, y); fe_sub(x, x, y); }
  }
  int32_t acc = 0;
  for (int i = 0; i < 10; ++i) acc ^= x.v[i];
  out[s] = acc;
}

template <int OP>
__global__ void chain_r32(int32_t* out, int n) {
  using namespace ag::r32;
  fe x, y;
  const uint32_t s = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < 8; ++i) {
    x.v[i] = s * 2654435761u + i * 977u;
    y.v[i] = s * 40503u + i * 131u;
  }
  for (int k = 0; k < n; ++k) {
    if (OP == 0) fe_mul(x, x, y);
    else if (OP == 1) fe_sq(x, x);
    else { fe_add(x, x, y); fe_sub(x, x, y); }
  }
  uint32_t acc = 0;
  for (int i = 0; i < 8; ++i) acc ^= x.v[i];
  out[s] = (int32_t)acc;
}

// -- one window of the W = 5 verify loop ------------------------------------
// W doublings, a -A table add (local memory) and a B table add (shared
// memory), as in ed25519_verify.cu.  DO = false keeps the same set-up and
// reads one table entry instead of the window, so the difference of the two
// instruction counts is the window.
#define AG_WINDOW(NAME, NS, LIMB, NL)                                         \
  template <bool DO>                                                          \
  __global__ void NAME(LIMB* io, const int32_t* kd, const int32_t* sd) {      \
    using namespace NS;                                                       \
    __shared__ LIMB bt[17 * 3 * NL];                                          \
    for (int i = threadIdx.x; i < 17 * 3 * NL; i += blockDim.x) bt[i] = io[i];\
    __syncthreads();                                                          \
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;                   \
    niels atab[17];                                                           \
    for (int e = 0; e < 17; ++e) {                                            \
      fe_load(atab[e].ypx, io + 4 * NL * e);                                  \
      fe_load(atab[e].ymx, io + 4 * NL * e + NL);                             \
      fe_load(atab[e].t2d, io + 4 * NL * e + 2 * NL);                         \
      fe_load(atab[e].z2, io + 4 * NL * e + 3 * NL);                          \
    }                                                                         \
    ext acc;                                                                  \
    fe_load(acc.X, io + lane);                                                \
    fe_load(acc.Y, io + lane + NL);                                           \
    fe_load(acc.Z, io + lane + 2 * NL);                                       \
    fe_load(acc.T, io + lane + 3 * NL);                                       \
    if (DO) {                                                                 \
      _Pragma("unroll") for (int j = 0; j < 4; ++j) pt_dbl(acc, acc, false);  \
      pt_dbl(acc, acc, true);                                                 \
      const int32_t k = kd[lane];                                             \
      const niels& na = atab[k < 0 ? -k : k];                                 \
      fe t2d;                                                                 \
      if (k < 0) fe_neg(t2d, na.t2d); else t2d = na.t2d;                      \
      pt_add_niels(acc, acc, k < 0 ? na.ymx : na.ypx,                         \
                   k < 0 ? na.ypx : na.ymx, t2d, &na.z2, true);               \
      const int32_t s = sd[lane];                                             \
      const LIMB* be = bt + 3 * NL * (s < 0 ? -s : s);                        \
      fe bypx, bymx;                                                          \
      fe_load(bypx, be + (s < 0 ? NL : 0));                                   \
      fe_load(bymx, be + (s < 0 ? 0 : NL));                                   \
      fe_load(t2d, be + 2 * NL);                                              \
      if (s < 0) fe_neg(t2d, t2d);                                            \
      pt_add_niels(acc, acc, bypx, bymx, t2d, nullptr, false);                \
    } else {                                                                  \
      const niels& q = atab[kd[lane] & 15];                                   \
      const LIMB* be = bt + 3 * NL * (sd[lane] & 15);                         \
      for (int i = 0; i < NL; ++i)                                            \
        acc.X.v[i] ^= q.ypx.v[i] ^ q.ymx.v[i] ^ q.t2d.v[i] ^ q.z2.v[i] ^      \
                      be[i] ^ be[i + NL] ^ be[i + 2 * NL];                    \
    }                                                                         \
    for (int i = 0; i < NL; ++i)                                              \
      io[lane + i] = acc.X.v[i] ^ acc.Y.v[i] ^ acc.Z.v[i];                    \
  }
AG_WINDOW(window_r25, ag, int32_t, 10)
AG_WINDOW(window_r32, ag::r32, uint32_t, 8)

extern "C" {
#define AG_ENTRY(NAME, KERN, T)                                               \
  int NAME(void* out, int n, int blocks, int threads) {                       \
    KERN<<<blocks, threads>>>((T*)out, n);                                    \
    return (int)cudaGetLastError();                                           \
  }
AG_ENTRY(p_imad, t_imad, uint32_t)
AG_ENTRY(p_imad_hi, t_imad_hi, uint32_t)
AG_ENTRY(p_imad_wide_u32, t_imad_wide_u32, uint32_t)
AG_ENTRY(p_imad_wide_s32, t_imad_wide_s32, uint32_t)
AG_ENTRY(p_iadd3, t_iadd3, uint32_t)
AG_ENTRY(p_r25_mul, chain_r25<0>, int32_t)
AG_ENTRY(p_r25_sq, chain_r25<1>, int32_t)
AG_ENTRY(p_r25_addsub, chain_r25<2>, int32_t)
AG_ENTRY(p_r32_mul, chain_r32<0>, int32_t)
AG_ENTRY(p_r32_sq, chain_r32<1>, int32_t)
AG_ENTRY(p_r32_addsub, chain_r32<2>, int32_t)

// never launched: instantiates the window kernels for cuobjdump
void p_windows(void* io, const int32_t* kd, const int32_t* sd) {
  window_r25<true><<<1, 32>>>((int32_t*)io, kd, sd);
  window_r25<false><<<1, 32>>>((int32_t*)io, kd, sd);
  window_r32<true><<<1, 32>>>((uint32_t*)io, kd, sd);
  window_r32<false><<<1, 32>>>((uint32_t*)io, kd, sd);
}
}
