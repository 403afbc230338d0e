// merge.cuh -- kernel K5, the lane merge of the MSM buckets, and the lane
// tree it shares with K2's fused merge K2m (insert.cuh).
//
// K5 replaces libff_tpu/msm/pallas_insert3.py:204 _merge_kernel (with
// _lane_merge, :36; entry point _merge_lanes_kernel_call, :250), both
// branches: k = 1 (G1 over Fp) and k = 2 (G2 over Fq2).  In: K2's raw
// projective buckets, coordinates (K, n, L) limb-major with n = W * B
// rows of L lanes, L any power of two (the TPU kernel needs L % 128 == 0
// for its (Ls, 128) tiles; the tree below is defined for every L).  Out:
// (K, n, 1), each row's lane total.  The input is not written.
//
// The order of additions is _lane_merge's for the lanes that reach lane
// 0: level h = L/2, L/4, ..., 1 replaces lane l < h by rcb_add(P_l,
// P_(l+h)).  The TPU kernel's Ls-halving slices are the levels h >= 128
// (lane s*128 + i pairs with lane (s + Ls/2)*128 + i), and its roll
// butterfly at stride s gives lane i rcb_add(P_i, P_(i+s)), of which
// lanes i < s reach lane 0: the levels h = 64 .. 1.  So lane 0's total is
// the TPU kernel's bit for bit, and the same sequence of additions as the
// halving loop of pippenger._reduce_buckets.  Any schedule that forms
// exactly these pairs, each in this operand order, gives the same bits:
// every complete add is deterministic.
//
// Bound on an H100: integer multiply issue.  n * (L - 1) complete adds of
// 12 (G1) or 42 (G2) Montgomery products, each 136 lo and 128 hi
// multiply-adds, at mul.lo 64 and mul.hi 32 a clock per SM: 1.178 (G1)
// and 4.124 ms (G2) at (32 * 128 rows, 1024 lanes), against 0.120 and
// 0.241 ms for the bytes (the input read once, the totals written once).
// The operations bind, so the design keeps every partial sum on chip and
// every thread busy.
//
// Design: one warp a row, r = min(32 / kThreads, L) elements on it (G1
// and the one-thread G2 body: 32 threads an element each; G2 over CIOS:
// fp2_pair.cuh's Fp2Pair, 16 pairs of threads, each thread holding one
// coefficient of every Fq2 value, so a G2 partial is 24 words a thread as
// on G1).  Element u of the warp owns the lanes l = u + r j, j < m = L / r.
//   The levels h >= r pair lanes of the same residue mod r, so element u
//   runs them alone, as the same halving tree over its own m lanes, and
//   walks that tree depth first: pair i (i < m/2) adds its leaves j and j
//   + m/2, j the bit reversal of i, read from the input; while bit k of i
//   is set, the partial of level k waiting in slot k is added before it
//   (slot first: its lanes are the lower ones).  A binary counter over
//   the pairs, so at most log2(m) - 1 partials wait at once.  The first
//   kNearSlots wait in shared memory (a thread's slots interleaved with
//   its neighbours', so no bank conflicts; registers would need a
//   constant slot index), deeper ones in a scratch array of the caller's:
//   at L = 1024 only G2 over pairs has one, written and read once a row.
//   No level waits for another thread.
//   The levels h < r cross elements: a butterfly of __shfl_down_sync,
//   element u taking the partial of element u + h (u + h of the pairs on
//   G2: its own coefficient, kThreads * h threads down).  Only those
//   log2(r) levels (5 on G1, 4 on G2) leave elements idle: at L = 1024 a
//   G1 warp takes 31 + 5 add times for 1023 adds, a G2 warp 63 + 4.  (The
//   elements u >= h of level h add what no lane below h reads; masking
//   them off gained nothing on an H100.)
// Each add step is one call site of rcb_add, whichever phase feeds it,
// so the kernel holds one copy of the formula.  A block is one warp, one
// row: a block's resources free as soon as its row is done.  A partial
// is 96 bytes a thread (192 for the one-thread G2 body), so the shared
// slots take at most 12 KB a block on G1 and on G2 over pairs: 16 blocks
// an SM at 128 registers.  With 4096 rows that is under two waves; at 12
// warps an SM (G2 at the 168 registers it takes unbounded) it is 2.6,
// and G2 runs slower there on an H100 (tune_merge; PERF.md).  An element
// without lanes (L < r) computes on lane 0's values, which no lane
// reaching lane 0 reads.
//
// MsmConfig.kmul (pallas_insert3.py:251-256) picks the product: each of
// merge.cu (CIOS), merge_sos.cu and merge_sos2.cu instantiates the kernel
// for one product through LFF_MERGE_ENTRY.  Fp2Pair has CIOS rows only,
// so the SOS and SOS2 G2 branches, which exist for parity, run the same
// tree on fp2.cuh's one-thread Fp2Field: never CIOS under their name.
#pragma once

#include <climits>

#include "formulas.cuh"
#include "fp2_pair.cuh"

namespace lff {

// __launch_bounds__'s blocks (warps) an SM of the G1 kernel and of the
// G2 kernel over pairs, chosen with tune_merge: G1 fits 128 registers
// without spills; G2 spills a few dozen bytes at 128, but 16 warps an SM
// beat 12 at 168.  The one-thread G2 body asks for 1 and takes 255.
#ifndef LFF_K5_MIN_BLOCKS_G1
#define LFF_K5_MIN_BLOCKS_G1 16
#endif
#ifndef LFF_K5_MIN_BLOCKS_G2
#define LFF_K5_MIN_BLOCKS_G2 16
#endif

// Slots a thread keeps in shared memory; deeper ones (L > 32 r) wait in a
// scratch array of the caller's.  Four keep a one-warp block of G1 or of
// G2 over pairs at 12 KB, so that 16 blocks fit an SM.
constexpr int kNearSlots = 4;

// Where the rows' lanes lie.  Limb-major (K5's (K, n, L)): limb k of lane
// l of row g at c[k * stride + g * L + l], stride = n * L.  Lane-major
// (K2m: the chain kernel's (W, L, B, K) buckets, row g = w * B + b): an
// element's K words contiguous at ((w * L + l) * B + b) * K.  The layout
// is a template argument of the kernel, so each build holds only the
// loads it runs (a runtime choice cost K5 g2 registers and 3%).
struct LaneRows {
  const uint32_t* c[3];
  size_t stride;  // limb-major only
  long long n;    // rows
  int L, B, K;    // B and K lane-major only
};

// The lane totals: coordinate c, limb k of row g at c[k * stride + row].
struct Rows {
  uint32_t* c[3];
  size_t stride;
  size_t row;
};

// One coordinate of an element whose words are contiguous, as 16-byte
// loads (a pair thread reads its own coefficient's 8 words).
__device__ __forceinline__ void load_words(const uint32_t* p, Fe<8>& r) {
  const uint4 a = __ldg((const uint4*)p), b = __ldg((const uint4*)p + 1);
  r = Fe<8>{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void load_words(const uint32_t* p, Fe2& r) {
  load_words(p, r.c0);
  load_words(p + 8, r.c1);
}

template <class F, bool kLaneMajor>
__device__ __forceinline__ Pt<F> load_lane(const LaneRows& r, long long g,
                                           int l) {
  Pt<F> q;
  if constexpr (kLaneMajor) {
    const size_t e =
        (((size_t)(g / r.B) * r.L + l) * r.B + (size_t)(g % r.B)) * r.K +
        (F::kThreads == 2 ? 8 * (threadIdx.x & 1) : 0);
    load_words(r.c[0] + e, q.x);
    load_words(r.c[1] + e, q.y);
    load_words(r.c[2] + e, q.z);
  } else {
    const size_t e = (size_t)g * r.L + l;
    q = Pt<F>{F::load(r.c[0], r.stride, e), F::load(r.c[1], r.stride, e),
              F::load(r.c[2], r.stride, e)};
  }
  return q;
}

template <class F>
__device__ __forceinline__ void store_pt(const Rows& r, const Pt<F>& p) {
  F::store(r.c[0], r.stride, r.row, p.x);
  F::store(r.c[1], r.stride, r.row, p.y);
  F::store(r.c[2], r.stride, r.row, p.z);
}

// A thread's words of a coordinate in shared memory, word w at s[w * st].
__device__ __forceinline__ void put(uint32_t* s, int st, const Fe<8>& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) s[k * st] = a.v[k];
}
__device__ __forceinline__ void put(uint32_t* s, int st, const Fe2& a) {
  put(s, st, a.c0);
  put(s + 8 * st, st, a.c1);
}
__device__ __forceinline__ void get(const uint32_t* s, int st, Fe<8>& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) a.v[k] = s[k * st];
}
__device__ __forceinline__ void get(const uint32_t* s, int st, Fe2& a) {
  get(s, st, a.c0);
  get(s + 8 * st, st, a.c1);
}

// The value that the thread d lanes up holds (the whole warp calls it).
__device__ __forceinline__ void shfl_down(Fe<8>& a, int d) {
#pragma unroll
  for (int k = 0; k < 8; k++)
    a.v[k] = __shfl_down_sync(0xffffffffu, a.v[k], d);
}
__device__ __forceinline__ void shfl_down(Fe2& a, int d) {
  shfl_down(a.c0, d);
  shfl_down(a.c1, d);
}

template <class F>
struct MergeShape {
  using E = typename F::E;
  static constexpr int kRow = 32 / F::kThreads;       // elements a warp
  static constexpr int kWords = 3 * (int)(sizeof(E) / sizeof(uint32_t));
  static constexpr int kMinBlocks =
      F::kThreads == 2 ? LFF_K5_MIN_BLOCKS_G2
                       : (sizeof(E) == sizeof(Fe<8>) ? LFF_K5_MIN_BLOCKS_G1
                                                     : 1);
  // the slots a thread needs at L lanes: log2(m) - 1, m = L / min(kRow, L)
  __host__ __device__ static int slots(int L) {
    int b = 0;
    for (int m = L / (L < kRow ? L : kRow); m > 2; m >>= 1) b++;
    return b;
  }
  // words of the caller's scratch a row needs: the slots past kNearSlots
  __host__ __device__ static int far_words(int L) {
    const int d = slots(L) - kNearSlots;
    return d > 0 ? d * kWords * 32 : 0;
  }
};

// One block of one warp a row (the note above); `slots` holds a
// thread's first kNearSlots partials, dynamic shared memory sized by the
// launch, and `far` (far_words(L) a row) the rest.
template <class F, bool kLaneMajor>
__global__ void __launch_bounds__(32, MergeShape<F>::kMinBlocks)
    merge_kernel(LaneRows in, Rows out, uint32_t* far, F f) {
  using S = MergeShape<F>;
  extern __shared__ uint32_t slots[];
  const long long g = blockIdx.x;
  const int L = in.L;
  const int r = L < S::kRow ? L : S::kRow;  // the row's elements with lanes
  const int u = (int)threadIdx.x / F::kThreads;
  const int t = u < r ? u : 0;              // lanes t + r j of this element
  const int m = L / r;
  const int half = m / 2;
  const int bits = half > 1 ? 31 - __clz(half) : 0;  // log2(half)
  const int in_steps = m - 1;
  const int steps = in_steps + (31 - __clz(r));      // + log2(r) levels
  // slot k's words, 32 apart (a thread's interleaved with its warp's)
  constexpr int st = 32;
  const auto slot = [&](int k) {
    return k < kNearSlots
               ? slots + threadIdx.x + k * S::kWords * st
               : far + (size_t)g * S::far_words(L) + threadIdx.x +
                     (k - kNearSlots) * S::kWords * st;
  };
  Pt<F> c;
  if (m == 1) c = load_lane<F, kLaneMajor>(in, g, t);
  int i = 0;         // the pair of leaves being walked
  int k = 0;         // the level of the partial in c
  bool fresh = true;  // the next in-thread step starts pair i
  for (int step = 0; step < steps; step++) {
    Pt<F> a, b;
    if (step < in_steps) {
      if (fresh) {
        const int j = bits ? (int)(__brev((unsigned)i) >> (32 - bits)) : 0;
        a = load_lane<F, kLaneMajor>(in, g, t + r * j);
        b = load_lane<F, kLaneMajor>(in, g, t + r * (j + half));
        k = 0;
      } else {  // slot k waits for c's level-k partial
        const uint32_t* s = slot(k);
        get(s, st, a.x);
        get(s + S::kWords / 3 * st, st, a.y);
        get(s + 2 * S::kWords / 3 * st, st, a.z);
        b = c;
        k++;
      }
    } else {  // level h = r/2 .. 1 across the warp's elements
      const int h = r >> (step - in_steps + 1);
      a = c;
      b = c;
      shfl_down(b.x, h * F::kThreads);
      shfl_down(b.y, h * F::kThreads);
      shfl_down(b.z, h * F::kThreads);
    }
    c = rcb_add(f, a, b);
    if (step < in_steps) {
      fresh = ((i >> k) & 1) == 0;
      if (fresh) {  // pair i's run ends: c waits in slot k, or is the total
        if (i + 1 < half) {
          uint32_t* s = slot(k);
          put(s, st, c.x);
          put(s + S::kWords / 3 * st, st, c.y);
          put(s + 2 * S::kWords / 3 * st, st, c.z);
        }
        i++;
      }
    }
  }
  if (u == 0) {
    Rows o = out;
    o.row = (size_t)g;
    store_pt<F>(o, c);
  }
}

// The tree over in's rows into out, on stream s of the current device.
template <bool kLaneMajor, class F>
int merge_launch(const LaneRows& in, const Rows& out, uint32_t* far,
                 const F& f, cudaStream_t s) {
  using S = MergeShape<F>;
  if (in.n == 0) return 0;
  const int near = min(S::slots(in.L), kNearSlots);
  if (S::far_words(in.L) > 0 && far == nullptr)
    return (int)cudaErrorInvalidValue;
  int device = 0, most = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)near * S::kWords * 4 * 32;
  if (bytes > (size_t)most || in.n > INT_MAX) return (int)cudaErrorInvalidValue;
  const auto kernel = merge_kernel<F, kLaneMajor>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<F, kLaneMajor><<<(unsigned)in.n, 32, bytes, s>>>(in, out, far,
                                                                f);
  return (int)cudaGetLastError();
}

// The tree over the product M on branch k (k = 1: G1, b3 = 9; k = 2: G2,
// b3_mont the 16 Montgomery limbs of the Fq2 constant b3, c0 then c1):
// G2 over CIOS on pairs of threads, over SOS and SOS2 one thread an
// element; in lane-major (K2m) or limb-major (K5).
template <Mul M, bool kLaneMajor>
int merge_rows(int k, const LaneRows& in, const Rows& out, uint32_t* far,
               const FieldParams<8>& P, const uint32_t* b3_mont,
               cudaStream_t s) {
  if (k == 1)
    return merge_launch<kLaneMajor>(in, out, far, FpField<9, M>{P}, s);
  Fe2 b3;
  for (int i = 0; i < 8; i++) {
    b3.c0.v[i] = b3_mont[i];
    b3.c1.v[i] = b3_mont[8 + i];
  }
  if constexpr (M == Mul::Cios) {
    return merge_launch<kLaneMajor>(in, out, far, Fp2Pair{P, b3}, s);
  } else {
    return merge_launch<kLaneMajor>(in, out, far, Fp2Field<M>{P, b3}, s);
  }
}

// The words of scratch a row of L lanes needs on branch k over the
// product M (merge_rows' `far`, n rows of them): 0 unless m = L / r > 32
// (L > 1024 on G1, 512 on G2 over pairs).
template <Mul M>
int merge_far_words(int k, int L) {
  if (L < 1 || (L & (L - 1)) != 0 || (k != 1 && k != 2)) return -1;
  if (k == 1) return MergeShape<FpField<9, M>>::far_words(L);
  if constexpr (M == Mul::Cios) {
    return MergeShape<Fp2Pair>::far_words(L);
  } else {
    return MergeShape<Fp2Field<M>>::far_words(L);
  }
}

// K5.  kmul: the product this library was built for ((int)M), checked;
// b: the three input coordinates (K, n, L); o: three outputs (K, n, 1);
// far: n * merge_far_words(k, L) words of scratch (null when that is 0).
// k = 1: b3 must be 9 (alt_bn128 G1) and b3_mont is unused; k = 2: b3_mont
// holds the 16 Montgomery limbs of the Fq2 constant b3 (c0 then c1).
template <Mul M>
int merge_entry(int kmul, void* const* b, void* const* o, void* far,
                long long n, int L, int n32, int k, int b3,
                const uint32_t* b3_mont, const uint32_t* p,
                const uint32_t* one_mont, uint32_t inv, int device,
                void* stream) {
  if (kmul != (int)M || n32 != 8 || n < 0 || L < 1 || (L & (L - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (!(k == 1 && b3 == 9) && !(k == 2 && b3_mont != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LaneRows in{{(const uint32_t*)b[0], (const uint32_t*)b[1],
               (const uint32_t*)b[2]},
              (size_t)n * L, n, L, 0, 0};
  Rows out{{(uint32_t*)o[0], (uint32_t*)o[1], (uint32_t*)o[2]}, (size_t)n, 0};
  return merge_rows<M, false>(k, in, out, (uint32_t*)far,
                              field_params(p, one_mont, inv), b3_mont,
                              (cudaStream_t)stream);
}

}  // namespace lff

// The C entry point `merge_far_words` of a library over the product M,
// for K5 and K2m: merge_far_words<M>, or -1 for another product.
#define LFF_MERGE_FAR_WORDS(M)                                               \
  extern "C" int merge_far_words(int kmul, int k, int L) {                   \
    return kmul == (int)M ? lff::merge_far_words<M>(k, L) : -1;              \
  }

// The C entry points `merge_lanes` and `merge_far_words` of one library,
// over the product M.
#define LFF_MERGE_ENTRY(M)                                                   \
  LFF_MERGE_FAR_WORDS(M)                                                     \
  extern "C" int merge_lanes(int kmul, void* const* b, void* const* o,       \
                             void* far, long long n, int L, int n32, int k,  \
                             int b3, const uint32_t* b3_mont,                \
                             const uint32_t* p, const uint32_t* one_mont,    \
                             uint32_t inv, int device, void* stream) {       \
    return lff::merge_entry<M>(kmul, b, o, far, n, L, n32, k, b3, b3_mont,   \
                               p, one_mont, inv, device, stream);            \
  }
