// BLS12-381 base-field Barrett multiply and reduce for Hopper (sm_90a):
// a group of G threads per field element, row-major limbs.
//
// Replaces two TPU kernels of agnes_tpu/crypto/pallas_field.py:
//   _mul_kernel    (line 162): 33 x 12-bit schoolbook columns fused into
//                  the Barrett reduce — every fv_mul / fv_mul_pairs;
//   _reduce_kernel (line 177): the Barrett reduce and carry chain alone,
//                  after a caller-chosen number of carry passes —
//                  reduce_cols on 33-wide columns (fv_reduce,
//                  fv_reduce_stack, fv_mul_small, fv_strict).
//
//   mul    in : xa, ya  rows of 33 int32 limbs at row strides sa, sb
//                       (a stride of 0 broadcasts one row); limbs
//                       <= 2 * 4104, value < 4p
//          out: out     [R, 33] int32, contiguous: strict limbs < 4p
//   reduce in : cols    rows of 33 int32 columns at row stride sc,
//                       non-negative, below 2^19; `passes` in {1, 2}
//          out: out     [R, 33] int32, contiguous: strict limbs < 4p
//
// Both equal the JAX package's rolled path (bls_field_jax.reduce_cols
// after _mul_cols) limb for limb, not only mod p: the same columns mod
// 2^32, the same vectorized carry passes (the top limb keeps its full
// value), the same quotient limbs t[64:97] of the loosely carried
// x * mu, the same r = x - q p and the same signed carry chain over
// 24-bit limb pairs.  Arithmetic wraps mod 2^32 like JAX's int32
// (unsigned adds, multiplies and left shifts; arithmetic right shifts);
// a column is a sum mod 2^32, so any order of its products gives the
// same integer.
//
// Work skipped because no output limb can see it (the tests hold the
// result to the rolled path, which computes everything):
//   - x * mu only from column 64 - kMuPasses: after kMuPasses carry
//     passes, column k depends on columns k - kMuPasses .. k alone, so
//     the quotient limbs (64 and up) are exact;
//   - q * p, r = x - q p and its passes only over limbs 0..33: the chain
//     runs upward from limb 0, and its 33 output limbs are the low 396
//     bits of r, which limbs 34 and up cannot reach;
//   - the reduce's q * p only over q limbs 0..2 (kQReduce).  Its input
//     x has 33 limbs below 2^31 after its passes, so x < 2^416,
//     x * mu < 2^804 and the quotient q < 2^36: with non-negative loose
//     limbs, q limbs 3 and up are zero.  That needs the x * mu columns
//     61..64 not to wrap int32, which input columns below 2^19 ensure
//     (every caller's columns are below 12 x 8,208 < 2^17; the wrapper
//     takes only the lane's pass counts, 1 and 2).  Its x * mu is then
//     the 10 products of limbs 29..32 into columns 61..64, and the
//     quotient's passes touch columns 61..67 alone.
//
// Bound on this card.  The least work of the multiply is the 33 x 33
// schoolbook (1,089 products), the columns 64..97 of x * mu (561) and
// the columns 0..33 of q * p (591): 2,241 products, each one 32-bit IMAD
// (crypto/bls_field.py::MUL_INT32_OPS), which outweighs its 396 bytes an
// element: operations bound it.  The reduce's 33-limb input needs 1
// quotient product and a 3-limb q (96 more): 97 IMADs against 264 bytes
// an element, so bytes bound it.
//
// Design.  The TPU kernels tile (8, 128) limbs-first for VMEM; nothing on
// Hopper needs that layout, so the kernels read the callers' row-major
// rows in place (a broadcast operand at stride 0 is never copied) and
// write contiguous rows.  A CTA holds up to kMaxElems elements and
// kThreads threads.  The multiply stages its operand rows through shared
// memory with coalesced loads (its windows want zeros around them); the
// reduce's lanes read their own limbs of a row; both stage the output
// rows for coalesced stores.  Each element belongs to a group of G lanes
// (G in {2, 4, 8, 16, 32}, chosen per launch from R by the wrapper from
// measured tables): small launches (the lane's stacks of a few rows to a
// few hundred) get up to 32 times the threads, so no thread runs the
// whole element's thousands of dependent steps, and large ones take the
// fewest lanes that keep the card busy.  Every product is a Toeplitz
// window: a lane owns a contiguous run of L output columns and computes
// them from a window of L + 32 limbs read from shared memory (zero-padded
// so the same straight-line code serves every lane) against the other
// operand (the element's b, or the constants kMu / kP in the constant
// bank).  The lane then holds its columns in registers for the carry
// passes, where limb k takes limb k - 1's carry: a run of K passes costs
// one exchange, each lane reading the K limbs under its own from shared
// memory and passing over them too.  The body is unrolled only over one
// lane's columns, so it is about G times shorter than a whole element's.
// The final chain over 17 limb pairs is a short serial scan on the
// group's lane 0.
//
// The lane math is plain C++ outside `#if __CUDACC__`, so a host compiler
// can check it against the plain PyTorch version before a card runs it:
// a group's cooperative steps are written once (`Team`, `AG_EACH_LANE`),
// one thread's own lane between two `__syncwarp`s on the card, and every
// lane of the group in turn, phase by phase, on the host.

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
constexpr int kQReduce = 3;                 // q limbs the reduce can see

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

// One vectorized carry pass over a whole vector x[0..n) held by one
// thread: limb k becomes its low 12 bits plus the arithmetic carry of
// limb k - 1; the top limb is masked too (a prefix of a longer vector).
template <int n>
AG_BLS_FN void vpass_prefix(int32_t* x) {
  AG_BLS_UNROLL for (int k = n - 1; k >= 1; --k)
    x[k] = wadd(x[k] & kMask, x[k - 1] >> 12);
  x[0] &= kMask;
}

// --- a group of G lanes ------------------------------------------------------

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// An n-limb vector spread over G lanes: lane g holds limbs
// [L g - off, L g - off + L).  The padding (limb indices below 0) sits
// under limb 0, so the top limb is always the last of lane G - 1.
template <int G, int n>
struct Spread {
  static constexpr int L = ceil_div(n, G);
  static constexpr int off = L * G - n;
};

// The group's cooperative steps.  Lanes share data only through shared
// memory, and a lane reads between two syncs only words written before
// the first of them, so running the lanes of a phase one after another
// (the host) computes exactly what the card computes with them side by
// side.  State a lane keeps across a sync lives in arrays of kSlots
// entries indexed by the slot `s` of AG_EACH_LANE: on the card one entry
// (the thread's registers), on the host one entry a lane.
// (the group sizes, bls_field.GROUP_SIZES, are pinned by
// tests/test_torch_bls_field.py)
template <int G>
struct Team {
  static_assert(G == 2 || G == 4 || G == 8 || G == 16 || G == 32,
                "group size");
#if defined(__CUDA_ARCH__)
  static constexpr int kSlots = 1;
  int lane;
  __device__ __forceinline__ void sync() const { __syncwarp(); }
#else
  static constexpr int kSlots = G;
  int lane;
  void sync() const {}
#endif
};

// for each lane of the group (slot s, lane g): the thread's own lane on
// the card, every lane in turn on the host
#if defined(__CUDA_ARCH__)
#define AG_EACH_LANE(tm, s, g) for (int s = 0, g = (tm).lane; s < 1; ++s)
#else
#define AG_EACH_LANE(tm, s, g) \
  for (int s = 0, g = 0; s < (tm).kSlots; ++s, ++g)
#endif

// One carry pass over a lane's L limbs: `cin` is the carry of the limb
// under them, `top` the mask of the last limb (-1 keeps the vector's top).
template <int L>
AG_BLS_FN void vpass_lane(int32_t* v, int32_t cin, int32_t top) {
  AG_BLS_UNROLL for (int l = L - 1; l >= 1; --l)
    v[l] = wadd(v[l] & (l == L - 1 ? top : kMask), v[l - 1] >> 12);
  v[0] = wadd(v[0] & (L == 1 ? top : kMask), cin);
}

// Limbs a lane publishes for the next run of passes: its top
// min(kHalo, L), in xch[par][lane][0..).
constexpr int kHalo = 3;                    // the longest run of passes
static_assert(kMulPasses <= kHalo && kMuPasses <= kHalo &&
              kPPasses <= kHalo && kRPasses <= kHalo, "halo");

template <int G, int L>
AG_BLS_FN void publish(int32_t (*xch)[G][kHalo], int par, int g,
                       const int32_t* v) {
  constexpr int P = L < kHalo ? L : kHalo;
  AG_BLS_UNROLL for (int t = 0; t < P; ++t) xch[par][g][t] = v[L - P + t];
}

// K carry passes of the group over a spread vector v (kSlots x L) with
// one exchange: before the last sync every lane published its top limbs
// in xch[par].  A lane takes the K limbs under its own from there (zeros
// under the vector) and runs the K passes over those and its own; a
// limb's value after pass j depends on the j limbs under it, so its own
// limbs come out exact.
template <int G, int L, int K>
AG_BLS_FN void group_passes(const Team<G>& tm, int32_t (*v)[L],
                            int32_t (*xch)[G][kHalo], int par,
                            bool keep_top) {
  constexpr int P = L < kHalo ? L : kHalo;
  AG_EACH_LANE(tm, s, g) {
    int32_t h[K + L];
    AG_BLS_UNROLL for (int d = 1; d <= K; ++d) {     // the limb d under
      const int lane = g - (d + L - 1) / L;
      const int pos = L - 1 - (d - 1) % L;
      h[K - d] = lane >= 0 ? xch[par][lane][pos - (L - P)] : 0;
    }
    AG_BLS_UNROLL for (int l = 0; l < L; ++l) h[K + l] = v[s][l];
    const int32_t top = (keep_top && g == G - 1) ? -1 : kMask;
    AG_BLS_UNROLL for (int p = 0; p < K; ++p) vpass_lane<K + L>(h, 0, top);
    AG_BLS_UNROLL for (int l = 0; l < L; ++l) v[s][l] = h[K + l];
  }
}

// The shared tail of both kernels, from the raw columns 0..33 of q * p
// (r, spread, its top limbs published in xch[0]): kPPasses passes,
// r = x - r, kRPasses passes, then the signed chain over 24-bit limb
// pairs on lane 0 into out[0..33).  x[0..34) holds x's limbs; rbuf is
// 34 words.
template <int G>
AG_BLS_FN void barrett_tail(const Team<G>& tm,
                            int32_t (*r)[Spread<G, kLow>::L],
                            int32_t (*xch)[G][kHalo], const int32_t* x,
                            int32_t* rbuf, int32_t* out) {
  using Rs = Spread<G, kLow>;
  group_passes<G, Rs::L, kPPasses>(tm, r, xch, 0, false);
  AG_EACH_LANE(tm, s, g) {
    AG_BLS_UNROLL for (int l = 0; l < Rs::L; ++l) {
      const int c = Rs::L * g - Rs::off + l;
      r[s][l] = wsub(c >= 0 ? x[c] : 0, r[s][l]);
    }
    publish<G, Rs::L>(xch, 1, g, r[s]);
  }
  tm.sync();
  group_passes<G, Rs::L, kRPasses>(tm, r, xch, 1, false);
  AG_EACH_LANE(tm, s, g) {
    AG_BLS_UNROLL for (int l = 0; l < Rs::L; ++l) {
      const int c = Rs::L * g - Rs::off + l;
      if (c >= 0) rbuf[c] = r[s][l];
    }
  }
  tm.sync();
  // sequential signed chain over 24-bit limb pairs (limb 33 dropped),
  // unrolled so that every load of r is issued ahead of the carries
  AG_EACH_LANE(tm, s, g) {
    if (g == 0) {
      int32_t c = 0;
      AG_BLS_UNROLL for (int k = 0; k < kLow / 2; ++k) {
        const int32_t sum = wadd(rbuf[2 * k],
                                 (int32_t)((uint32_t)rbuf[2 * k + 1] << 12));
        const int32_t tt = wadd(sum, c);
        const int32_t v = tt & 0xFFFFFF;
        out[2 * k] = v & kMask;
        if (2 * k + 1 < kN) out[2 * k + 1] = v >> 12;
        c = tt >> 24;
      }
    }
  }
}

// --- kernel 4: the multiply ----------------------------------------------------

// One element's shared memory.  `a` is the zero-padded window buffer of
// the first operand, then of q (q[-kQPad..0) and q[33] zero), then r
// (34 words) and the output row (33 words).  x holds the carried product
// limbs 0..64 and zeros 65..97 (the x * mu windows' reach).
template <int G>
struct MulSmem {
  using X = Spread<G, kN65>;
  using Rs = Spread<G, kLow>;
  static constexpr int kAPad = (kN - 1) + X::off;       // zeros under a[0]
  static constexpr int kQPad = (kPN - 1) + Rs::off;     // zeros under q[0]
  static constexpr int kA = kAPad + kN65;
  static constexpr int kQ = kQPad + kN + 1;
  static constexpr int kRegion = kA > kQ ? kA : kQ;
  static_assert(kRegion >= kLow + kN, "r and the output row fit");
  static constexpr int kUsed = kRegion + kN + kTN + 2 * G * kHalo;
  int32_t a[kRegion];
  int32_t b[kN];
  int32_t x[kTN];
  int32_t xch[2][G][kHalo];
  int32_t pad[1 + (kUsed & 1)];    // an odd stride spreads the banks
};

// The multiply of one element whose a (at a[kAPad..kAPad + 33), zero
// around it), b and x[65..98) = 0 are staged; leaves the output row at
// a[kLow..kLow + 33).
template <int G>
AG_BLS_FN void mul_elem(const Team<G>& tm, MulSmem<G>& S) {
  using M = MulSmem<G>;
  using X = Spread<G, kN65>;
  using T = Spread<G, kTN - kT0>;
  using Rs = Spread<G, kLow>;
  constexpr int kS = Team<G>::kSlots;
  int32_t x[kS][X::L], t[kS][T::L], r[kS][Rs::L];

  // schoolbook: lane columns c0 .. c0 + L - 1 of a * b
  AG_EACH_LANE(tm, s, g) {
    const int c0 = X::L * g - X::off;
    int32_t w[X::L + kN - 1];                       // a[c0 - 32 + i]
    AG_BLS_UNROLL for (int i = 0; i < X::L + kN - 1; ++i)
      w[i] = S.a[M::kAPad + c0 - (kN - 1) + i];
    uint32_t acc[X::L];
    AG_BLS_UNROLL for (int l = 0; l < X::L; ++l) acc[l] = 0;
    AG_BLS_UNROLL for (int j = 0; j < kN; ++j) {
      const int32_t bj = S.b[j];
      AG_BLS_UNROLL for (int l = 0; l < X::L; ++l)
        acc[l] += wmul(w[l + kN - 1 - j], bj);
    }
    AG_BLS_UNROLL for (int l = 0; l < X::L; ++l) x[s][l] = (int32_t)acc[l];
    publish<G, X::L>(S.xch, 0, g, x[s]);
  }
  tm.sync();
  // kMulPasses passes (top limb kept), then x to shared memory.  The
  // window buffer is free now: zero q's padding for later.
  group_passes<G, X::L, kMulPasses>(tm, x, S.xch, 0, true);
  AG_EACH_LANE(tm, s, g) {
    AG_BLS_UNROLL for (int l = 0; l < X::L; ++l) {
      const int c = X::L * g - X::off + l;
      if (c >= 0) S.x[c] = x[s][l];
    }
    for (int i = g; i < M::kQPad; i += G) S.a[i] = 0;
    if (g == 0) S.a[M::kQPad + kN] = 0;
  }
  tm.sync();
  // t = x * mu, columns kT0 .. kTN - 1 (a lane's run k0 .. k0 + L - 1)
  AG_EACH_LANE(tm, s, g) {
    const int i0 = T::L * g - T::off;               // first t index
    const int k0 = kT0 + i0;
    int32_t w[T::L + kMuN - 1];                     // x[k0 - 32 + i]
    AG_BLS_UNROLL for (int i = 0; i < T::L + kMuN - 1; ++i)
      w[i] = S.x[k0 - (kMuN - 1) + i];
    uint32_t acc[T::L];
    AG_BLS_UNROLL for (int l = 0; l < T::L; ++l) acc[l] = 0;
    AG_BLS_UNROLL for (int j = 0; j < kMuN; ++j) {
      AG_BLS_UNROLL for (int l = 0; l < T::L; ++l)
        acc[l] += wmul(w[l + kMuN - 1 - j], kMu[j]);
    }
    // columns under kT0 (a lane's padding) carry at most up to column
    // kT0 - 1 + kMuPasses < 64 in the passes: q never sees them
    AG_BLS_UNROLL for (int l = 0; l < T::L; ++l) t[s][l] = (int32_t)acc[l];
    publish<G, T::L>(S.xch, 1, g, t[s]);
  }
  tm.sync();
  // kMuPasses passes (top limb kept), then q = t[3..36) to shared memory
  group_passes<G, T::L, kMuPasses>(tm, t, S.xch, 1, true);
  AG_EACH_LANE(tm, s, g) {
    AG_BLS_UNROLL for (int l = 0; l < T::L; ++l) {
      const int i = T::L * g - T::off + l - (kMuShift - kT0);
      if (i >= 0 && i < kN) S.a[M::kQPad + i] = t[s][l];
    }
  }
  tm.sync();
  // q * p, columns 0..33 (a lane's run c0 .. c0 + L - 1)
  AG_EACH_LANE(tm, s, g) {
    const int c0 = Rs::L * g - Rs::off;
    int32_t w[Rs::L + kPN - 1];                     // q[c0 - 31 + i]
    AG_BLS_UNROLL for (int i = 0; i < Rs::L + kPN - 1; ++i)
      w[i] = S.a[M::kQPad + c0 - (kPN - 1) + i];
    uint32_t acc[Rs::L];
    AG_BLS_UNROLL for (int l = 0; l < Rs::L; ++l) acc[l] = 0;
    AG_BLS_UNROLL for (int j = 0; j < kPN; ++j) {
      AG_BLS_UNROLL for (int l = 0; l < Rs::L; ++l)
        acc[l] += wmul(w[l + kPN - 1 - j], kP[j]);
    }
    AG_BLS_UNROLL for (int l = 0; l < Rs::L; ++l) r[s][l] = (int32_t)acc[l];
    publish<G, Rs::L>(S.xch, 0, g, r[s]);
  }
  tm.sync();
  barrett_tail<G>(tm, r, S.xch, S.x, S.a, S.a + kLow);
}

// --- kernel 5: the reduce ------------------------------------------------------

// p's limbs again, in global memory: the reduce's lanes read windows of
// them at lane-dependent offsets, which the constant bank would serialize
// (the table equals kP; tests/test_torch_bls_field.py pins both)
#if defined(__CUDACC__)
__device__ int32_t kPG[kPN] = {
    2731, 4090, 4095, 4095, 2558, 4091, 1023, 2837, 4094, 2751, 1054, 3938,
    1712, 2575, 210, 1651, 703, 2129, 1267, 1208, 1143, 3446, 2988, 1076,
    1974, 442, 2635, 3689, 2431, 3747, 273, 416};
AG_BLS_FN int32_t p_limb(int i) {
  return (i >= 0 && i < kPN) ? __ldg(&kPG[i]) : 0;
}
#else
AG_BLS_FN int32_t p_limb(int i) { return (i >= 0 && i < kPN) ? kP[i] : 0; }
#endif

template <int G>
struct RedSmem {
  static constexpr int kUsed = kLow + kLow + kN + 2 * G * kHalo;
  int32_t x[kLow];      // x limbs 0..32 after the passes, x[33] = 0
  int32_t r[kLow];      // r before the chain
  int32_t out[kN];      // the output row
  int32_t xch[2][G][kHalo];
  int32_t pad[1 + (kUsed & 1)];
};

// The reduce of one element: its lanes read the element's 33 columns
// from `row` (zeros for a null row); leaves the output row in S.out.
template <int G>
AG_BLS_FN void reduce_elem(const Team<G>& tm, RedSmem<G>& S, int passes,
                           const int32_t* row) {
  using X = Spread<G, kN>;
  using Rs = Spread<G, kLow>;
  constexpr int kS = Team<G>::kSlots;
  int32_t x[kS][X::L], r[kS][Rs::L];

  AG_EACH_LANE(tm, s, g) {
    AG_BLS_UNROLL for (int l = 0; l < X::L; ++l) {
      const int c = X::L * g - X::off + l;
      x[s][l] = (row && c >= 0) ? row[c] : 0;
    }
    publish<G, X::L>(S.xch, 0, g, x[s]);
    if (g == 0) S.x[kN] = 0;
  }
  tm.sync();
  // `passes` passes (top limb kept), then x to shared memory
  if (passes == 1)
    group_passes<G, X::L, 1>(tm, x, S.xch, 0, true);
  else
    group_passes<G, X::L, 2>(tm, x, S.xch, 0, true);
  AG_EACH_LANE(tm, s, g) {
    AG_BLS_UNROLL for (int l = 0; l < X::L; ++l) {
      const int c = X::L * g - X::off + l;
      if (c >= 0) S.x[c] = x[s][l];
    }
  }
  tm.sync();
  // every lane: t columns 61..67 from x limbs 29..32, kMuPasses passes,
  // q limbs 0..2; then the lane's q * p columns from p's window
  AG_EACH_LANE(tm, s, g) {
    int32_t xt[4], t[7];
    AG_BLS_UNROLL for (int i = 0; i < 4; ++i) xt[i] = S.x[kN - 4 + i];
    AG_BLS_UNROLL for (int k = 0; k < 7; ++k) {
      uint32_t acc = 0;
      AG_BLS_UNROLL for (int i = 0; i < 4; ++i) {
        const int j = kT0 + k - (kN - 4 + i);           // mu limb
        if (j >= 0 && j < kMuN) acc += wmul(xt[i], kMu[j]);
      }
      t[k] = (int32_t)acc;
    }
    AG_BLS_UNROLL for (int p = 0; p < kMuPasses; ++p) vpass_prefix<7>(t);
    const int32_t* q = t + (kMuShift - kT0);
    const int c0 = Rs::L * g - Rs::off;
    int32_t w[Rs::L + kQReduce - 1];                    // p[c0 - 2 + i]
    AG_BLS_UNROLL for (int i = 0; i < Rs::L + kQReduce - 1; ++i)
      w[i] = p_limb(c0 - (kQReduce - 1) + i);
    AG_BLS_UNROLL for (int l = 0; l < Rs::L; ++l) {
      uint32_t acc = 0;
      AG_BLS_UNROLL for (int j = 0; j < kQReduce; ++j)
        acc += wmul(w[l + kQReduce - 1 - j], q[j]);
      r[s][l] = (int32_t)acc;
    }
    publish<G, Rs::L>(S.xch, 0, g, r[s]);
  }
  tm.sync();
  barrett_tail<G>(tm, r, S.xch, S.x, S.r, S.out);
}

}  // namespace agbls

#if defined(__CUDACC__)

constexpr int kThreads = 128;       // threads a CTA at most
constexpr int kMaxElems = 32;       // elements a CTA at most (shared memory)

// a CTA of E elements, T = E * G threads
template <int G>
struct Cta {
  static constexpr int E = kThreads / G < kMaxElems ? kThreads / G
                                                    : kMaxElems;
  static constexpr int T = E * G;
};

template <int G>
__global__ void __launch_bounds__(Cta<G>::T)
bls_fp_mul_kernel(const int32_t* __restrict__ xa, int64_t sa,
                  const int32_t* __restrict__ ya, int64_t sb,
                  int32_t* __restrict__ out, int64_t R) {
  using namespace agbls;
  using M = MulSmem<G>;
  constexpr int E = Cta<G>::E, T = Cta<G>::T;
  static_assert(sizeof(M) / 4 % 2 == 1, "an odd stride");
  __shared__ M sm[E];
  const int64_t row0 = (int64_t)blockIdx.x * E;
  for (int w = threadIdx.x; w < E * kN; w += T) {
    const int e = w / kN, l = w - e * kN;
    const int64_t row = row0 + e;
    const bool ok = row < R;
    sm[e].a[M::kAPad + l] = ok ? xa[row * sa + l] : 0;
    sm[e].b[l] = ok ? ya[row * sb + l] : 0;
  }
  for (int w = threadIdx.x; w < E * M::kAPad; w += T)
    sm[w / M::kAPad].a[w % M::kAPad] = 0;
  constexpr int kTop = M::kRegion - M::kAPad - kN;  // zeros above a[32]
  for (int w = threadIdx.x; w < E * kTop; w += T)
    sm[w / kTop].a[M::kAPad + kN + w % kTop] = 0;
  for (int w = threadIdx.x; w < E * (kTN - kN65); w += T)
    sm[w / (kTN - kN65)].x[kN65 + w % (kTN - kN65)] = 0;
  __syncthreads();
  mul_elem<G>(Team<G>{(int)threadIdx.x % G}, sm[threadIdx.x / G]);
  __syncthreads();
  for (int w = threadIdx.x; w < E * kN; w += T) {
    const int e = w / kN, l = w - e * kN;
    const int64_t row = row0 + e;
    if (row < R) out[row * kN + l] = sm[e].a[kLow + l];
  }
}

template <int G>
__global__ void __launch_bounds__(Cta<G>::T)
bls_fp_reduce_kernel(const int32_t* __restrict__ cols, int64_t sc,
                     int32_t* __restrict__ out, int64_t R, int passes) {
  using namespace agbls;
  constexpr int E = Cta<G>::E, T = Cta<G>::T;
  static_assert(sizeof(RedSmem<G>) / 4 % 2 == 1, "an odd stride");
  __shared__ RedSmem<G> sm[E];
  const int64_t row0 = (int64_t)blockIdx.x * E;
  const int64_t mine = row0 + threadIdx.x / G;
  reduce_elem<G>(Team<G>{(int)threadIdx.x % G}, sm[threadIdx.x / G], passes,
                 mine < R ? cols + mine * sc : nullptr);
  __syncthreads();
  for (int w = threadIdx.x; w < E * kN; w += T) {
    const int e = w / kN, l = w - e * kN;
    const int64_t row = row0 + e;
    if (row < R) out[row * kN + l] = sm[e].out[l];
  }
}

template <int G>
static int launch_mul(const int32_t* xa, int64_t sa, const int32_t* ya,
                      int64_t sb, int32_t* out, int64_t R,
                      cudaStream_t stream) {
  const int64_t blocks = (R + Cta<G>::E - 1) / Cta<G>::E;
  bls_fp_mul_kernel<G><<<(unsigned)blocks, Cta<G>::T, 0, stream>>>(
      xa, sa, ya, sb, out, R);
  return (int)cudaGetLastError();
}

template <int G>
static int launch_reduce(const int32_t* cols, int64_t sc, int32_t* out,
                         int64_t R, int passes, cudaStream_t stream) {
  const int64_t blocks = (R + Cta<G>::E - 1) / Cta<G>::E;
  bls_fp_reduce_kernel<G><<<(unsigned)blocks, Cta<G>::T, 0, stream>>>(
      cols, sc, out, R, passes);
  return (int)cudaGetLastError();
}

// Plain C entry points (loaded with ctypes).  Each launches one kernel on
// `stream`, does not synchronize, and returns cudaGetLastError() of the
// launch; a group size other than 2, 4, 8, 16, 32 or a reduce pass count
// other than 1, 2 is cudaErrorInvalidValue, and R <= 0 launches nothing.
extern "C" int ag_bls_fp_mul(const int32_t* xa, int64_t sa,
                             const int32_t* ya, int64_t sb, int32_t* out,
                             int64_t R, int group, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 2: return launch_mul<2>(xa, sa, ya, sb, out, R, st);
    case 4: return launch_mul<4>(xa, sa, ya, sb, out, R, st);
    case 8: return launch_mul<8>(xa, sa, ya, sb, out, R, st);
    case 16: return launch_mul<16>(xa, sa, ya, sb, out, R, st);
    case 32: return launch_mul<32>(xa, sa, ya, sb, out, R, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ag_bls_fp_reduce(const int32_t* cols, int64_t sc,
                                int32_t* out, int64_t R, int passes,
                                int group, void* stream) {
  if (R <= 0) return 0;
  if (passes < 1 || passes > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 2: return launch_reduce<2>(cols, sc, out, R, passes, st);
    case 4: return launch_reduce<4>(cols, sc, out, R, passes, st);
    case 8: return launch_reduce<8>(cols, sc, out, R, passes, st);
    case 16: return launch_reduce<16>(cols, sc, out, R, passes, st);
    case 32: return launch_reduce<32>(cols, sc, out, R, passes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // __CUDACC__
