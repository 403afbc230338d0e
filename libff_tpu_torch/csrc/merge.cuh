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
//   kNear (MergeShape: four at 8 limbs) wait in shared memory (a
//   thread's slots interleaved with its neighbours', so no bank
//   conflicts; registers would need a constant slot index), deeper ones
//   in a scratch array of the caller's: at L = 1024 at 8 limbs only G2
//   over pairs has one, written and read once a row.
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
// for one product through LFF_MERGE_ENTRY.  At 8 limbs the SOS and SOS2
// G2 branches, which exist for parity, run the same tree on fp2.cuh's
// one-thread Fp2Field: never CIOS under their name.
//
// At 24 limbs (BW6-761: its G1, b3 = -3, and its G2 over Fq, b3 = 12,
// both FpField<24, b3> on one thread an element) merge_n24.cu,
// merge_sos_n24.cu and merge_sos2_n24.cu build the tree, and K2m's tail
// in insert*_n24.cu.  A partial is 72 words a thread (288 bytes) and a
// product 2,328 multiply-adds (SOS2: 2,352), fp.cuh's one __noinline__
// copy: the 24-limb blocks an SM are their own macro
// (LFF_K5_MIN_BLOCKS_G1_N24), three slots fit at 8 blocks, and at L =
// 1024 a thread's fourth slot waits in the scratch.
//
// At 12 limbs (BLS12-381 and BLS12-377: G1 with b3 = 12 and 3, G2 over
// Fq2 with nr = -1 and -5) merge_n12.cu, merge_sos_n12.cu and
// merge_sos2_n12.cu build the same tree at LFF_N32 = 12, and K2m's tail
// in insert*_n12.cu.  G2 runs on pairs over every product there
// (Fp2Pair<12, NR, M>: the pair's lazy sums reduced in the product's
// order), so a thread's part of a partial is 36 words on G1 and on G2, as
// at 8 limbs it is 24; a one-thread G2 body would hold 72.  A product is
// 588 multiply-adds (600 over SOS2), 2.24 times an 8-limb one, and the
// bound is that many times K5's at 8 limbs on the same rows.  A partial
// is 144 bytes a thread: the 12-limb blocks an SM are their own macros
// (LFF_K5_MIN_BLOCKS_G1_N12, _G2_N12, chosen with tune_merge on an H100,
// PERF.md), and the slots in shared memory as many as those blocks fit.
#pragma once

#include <climits>
#include <type_traits>

#include "formulas.cuh"
#include "fp2_pair.cuh"

// The width of the C entries a library exports (merge_lanes,
// merge_far_words and insert.cuh's insert and insert_v1): merge.cu and
// its product variants at 8 limbs, the *_n12.cu and *_n24.cu sources at
// 12 and 24.
#ifndef LFF_N32
#define LFF_N32 8
#endif

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
// The same at 12 limbs, G1 (one thread an element, every product) and G2
// (pairs, every product), chosen with tune_merge on an H100: G1 at 16
// (128 registers, 208 bytes of spills) 5.34-5.43 ms, at 12 and 10 (168
// registers) 5.62-5.68, at ptxas's own 212 registers (8) 7.42-7.45; G2 at
// 12 (168 registers, 360-416 bytes of spills) 26.3-26.4 ms, at 8 (255)
// 26.7-28.5, at 16 (128, 2.6-3.2 KB) 28.4-28.5 (PERF.md).
#ifndef LFF_K5_MIN_BLOCKS_G1_N12
#define LFF_K5_MIN_BLOCKS_G1_N12 16
#endif
#ifndef LFF_K5_MIN_BLOCKS_G2_N12
#define LFF_K5_MIN_BLOCKS_G2_N12 12
#endif
// The same at 24 limbs (BW6-761: G1 and G2 both one thread an element on
// the Fp branch, every product): a partial is 72 words a thread, and with
// the two operands and the formula's values a thread takes every register
// it may, so 8 one-warp blocks an SM (255 registers each) is the most
// that does not cut the registers a thread gets.
#ifndef LFF_K5_MIN_BLOCKS_G1_N24
#define LFF_K5_MIN_BLOCKS_G1_N24 8
#endif

// Slots a thread may keep in shared memory (MergeShape::kNear takes as
// many as its blocks an SM fit, up to this); deeper ones wait in a
// scratch array of the caller's.  A partial is 96 bytes a thread at 8
// limbs (four slots: 12 KB a one-warp block, 16 blocks an SM), 144 at 12
// (G1's 16 blocks fit two slots, G2's 12 four), 288 at 24 (8 blocks fit
// three: a slot is 9 KB a one-warp block).
constexpr int kNearSlots = 4;
// An H100 SM's shared memory and what each block reserves of it
constexpr int kSmemPerSm = 233472;
constexpr int kSmemPerBlockReserved = 1024;

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
// loads (a pair thread reads its own coefficient's 8 words; a 12-limb
// element is three loads).
template <int N>
__device__ __forceinline__ void load_words(const uint32_t* p, Fe<N>& r) {
#pragma unroll
  for (int q = 0; q < N / 4; q++) {
    const uint4 a = __ldg((const uint4*)p + q);
    r.v[4 * q] = a.x;
    r.v[4 * q + 1] = a.y;
    r.v[4 * q + 2] = a.z;
    r.v[4 * q + 3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void load_words(const uint32_t* p, Fe2<N>& r) {
  load_words(p, r.c0);
  load_words(p + N, r.c1);
}

template <class F, bool kLaneMajor>
__device__ __forceinline__ Pt<F> load_lane(const LaneRows& r, long long g,
                                           int l) {
  // a pair thread's coefficient: its words lie one coefficient on
  constexpr int kPart = (int)(sizeof(typename F::E) / sizeof(uint32_t));
  Pt<F> q;
  if constexpr (kLaneMajor) {
    const size_t e =
        (((size_t)(g / r.B) * r.L + l) * r.B + (size_t)(g % r.B)) * r.K +
        (F::kThreads == 2 ? kPart * (threadIdx.x & 1) : 0);
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
template <int N>
__device__ __forceinline__ void put(uint32_t* s, int st, const Fe<N>& a) {
#pragma unroll
  for (int k = 0; k < N; k++) s[k * st] = a.v[k];
}
template <int N>
__device__ __forceinline__ void put(uint32_t* s, int st, const Fe2<N>& a) {
  put(s, st, a.c0);
  put(s + N * st, st, a.c1);
}
template <int N>
__device__ __forceinline__ void get(const uint32_t* s, int st, Fe<N>& a) {
#pragma unroll
  for (int k = 0; k < N; k++) a.v[k] = s[k * st];
}
template <int N>
__device__ __forceinline__ void get(const uint32_t* s, int st, Fe2<N>& a) {
  get(s, st, a.c0);
  get(s + N * st, st, a.c1);
}

// The value that the thread d lanes up holds (the whole warp calls it).
template <int N>
__device__ __forceinline__ void shfl_down(Fe<N>& a, int d) {
#pragma unroll
  for (int k = 0; k < N; k++)
    a.v[k] = __shfl_down_sync(0xffffffffu, a.v[k], d);
}
template <int N>
__device__ __forceinline__ void shfl_down(Fe2<N>& a, int d) {
  shfl_down(a.c0, d);
  shfl_down(a.c1, d);
}

template <class F>
struct MergeShape {
  using E = typename F::E;
  static constexpr int kRow = 32 / F::kThreads;       // elements a warp
  static constexpr int kWords = 3 * (int)(sizeof(E) / sizeof(uint32_t));
  // 24 limbs: a thread's part of an element is 24 words on the Fp branch
  // (the 12-limb G2 on pairs also holds 24, but on two threads)
  static constexpr bool kN24 = F::kG1 && kWords / 3 == 24;
  // 12 limbs: a thread's part of an element is 12 or 24 words
  static constexpr bool kN12 = !kN24 && kWords / 3 % 12 == 0;
  static constexpr int kMinBlocks =
      kN24   ? LFF_K5_MIN_BLOCKS_G1_N24
      : kN12 ? (F::kThreads == 2 ? LFF_K5_MIN_BLOCKS_G2_N12
                                 : (F::kG1 ? LFF_K5_MIN_BLOCKS_G1_N12 : 1))
             : (F::kThreads == 2 ? LFF_K5_MIN_BLOCKS_G2
                                 : (F::kG1 ? LFF_K5_MIN_BLOCKS_G1 : 1));
  // the slots kMinBlocks one-warp blocks an SM fit, at most kNearSlots
  static constexpr int kFit =
      (kSmemPerSm / kMinBlocks - kSmemPerBlockReserved) / (kWords * 4 * 32);
  static constexpr int kNear = kFit < kNearSlots ? kFit : kNearSlots;
  static_assert(kNear >= 1, "a block keeps one slot in shared memory");
  // the slots a thread needs at L lanes: log2(m) - 1, m = L / min(kRow, L)
  __host__ __device__ static int slots(int L) {
    int b = 0;
    for (int m = L / (L < kRow ? L : kRow); m > 2; m >>= 1) b++;
    return b;
  }
  // words of the caller's scratch a row needs: the slots past kNear
  __host__ __device__ static int far_words(int L) {
    const int d = slots(L) - kNear;
    return d > 0 ? d * kWords * 32 : 0;
  }
};

// One block of one warp a row (the note above); `slots` holds a
// thread's first kNear partials, dynamic shared memory sized by the
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
    return k < S::kNear
               ? slots + threadIdx.x + k * S::kWords * st
               : far + (size_t)g * S::far_words(L) + threadIdx.x +
                     (k - S::kNear) * S::kWords * st;
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
  const int near = min(S::slots(in.L), S::kNear);
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

// The G2 lane tree's field context at N limbs over the product M: two
// threads an element (fp2_pair.cuh's Fp2Pair) over CIOS, and at 12 limbs
// over every product; the 8-limb SOS and SOS2 branches on one thread
// (fp2.cuh's Fp2Field).
template <int N, int NR, Mul M>
using TreeField2 = std::conditional_t<N != 8 || M == Mul::Cios,
                                      Fp2Pair<N, NR, M>, Fp2Field<N, NR, M>>;

template <int N, int NR, Mul M>
inline TreeField2<N, NR, M> tree_field2(const FieldParams<N>& P,
                                        const uint32_t* b3_mont) {
  if constexpr (N != 8 || M == Mul::Cios) {
    return fp2_pair<N, NR, M>(P, b3_mont);
  } else {
    return Fp2Field<N, NR, M>{P, fe2_from<N>(b3_mont)};
  }
}

// The branches a library of width N takes, as its C entries name them:
// k = 1 (G1) with b3 the curve's 3b, a compile-time addition chain (9:
// alt_bn128 at 8 limbs; 12: BLS12-381, 3: BLS12-377 at 12; -3: BW6-761's
// G1, 12: its G2 over Fq, at 24, both k = 1), and k = 2
// (G2) with b3 the Fq2's non-residue nr - p (-1 at 8 limbs; -1, -5 at
// 12) and b3_mont the 2N Montgomery limbs of the twist's Fq2 constant
// b3.  fn(integral_constant k, integral_constant b3) for a branch the
// width has, cudaErrorInvalidValue for any other.
template <int N, class Fn>
int on_branch(int k, int b3, const uint32_t* b3_mont, Fn&& fn) {
  using K1 = std::integral_constant<int, 1>;
  using K2 = std::integral_constant<int, 2>;
  if constexpr (N == 8) {
    if (k == 1 && b3 == 9) return fn(K1{}, std::integral_constant<int, 9>{});
    if (k == 2 && b3 == -1 && b3_mont != nullptr)
      return fn(K2{}, std::integral_constant<int, -1>{});
  } else if constexpr (N == 12) {
    if (k == 1 && b3 == 12)
      return fn(K1{}, std::integral_constant<int, 12>{});
    if (k == 1 && b3 == 3) return fn(K1{}, std::integral_constant<int, 3>{});
    if (k == 2 && b3 == -1 && b3_mont != nullptr)
      return fn(K2{}, std::integral_constant<int, -1>{});
    if (k == 2 && b3 == -5 && b3_mont != nullptr)
      return fn(K2{}, std::integral_constant<int, -5>{});
  } else if constexpr (N == 24) {
    if (k == 1 && b3 == -3) return fn(K1{}, std::integral_constant<int, -3>{});
    if (k == 1 && b3 == 12)
      return fn(K1{}, std::integral_constant<int, 12>{});
  }
  return (int)cudaErrorInvalidValue;
}

// The tree over the product M on on_branch's branch (k, b3) of width N:
// G2 on tree_field2's context; in lane-major (K2m) or limb-major (K5).
template <Mul M, bool kLaneMajor, int N>
int merge_rows(int k, int b3, const LaneRows& in, const Rows& out,
               uint32_t* far, const FieldParams<N>& P,
               const uint32_t* b3_mont, cudaStream_t s) {
  return on_branch<N>(k, b3, b3_mont, [&](auto K, auto B3) {
    if constexpr (decltype(K)::value == 1) {
      return merge_launch<kLaneMajor>(
          in, out, far, FpField<N, decltype(B3)::value, M>{P}, s);
    } else {
      return merge_launch<kLaneMajor>(
          in, out, far, tree_field2<N, decltype(B3)::value, M>(P, b3_mont),
          s);
    }
  });
}

// The words of scratch a row of L lanes needs on branch k over the
// product M at N limbs (merge_rows' `far`, n rows of them): 0 unless m =
// L / r > 32 (at 8 limbs L > 1024 on G1, 512 on G2 over pairs) less the
// near slots (at 24 limbs L > 512).  The shape depends on neither b3 nor
// nr.  -1 for k = 2 at 24 limbs, which has no G2 branch.
template <Mul M, int N>
int merge_far_words(int k, int L) {
  if (L < 1 || (L & (L - 1)) != 0 || (k != 1 && k != 2)) return -1;
  if (k == 1) return MergeShape<FpField<N, N == 8 ? 9 : 12, M>>::far_words(L);
  if constexpr (N == 24) {
    return -1;  // no G2 branch over Fq2 at 24 limbs
  } else {
    return MergeShape<TreeField2<N, -1, M>>::far_words(L);
  }
}

// K5.  kmul: the product this library was built for ((int)M), checked;
// n32: its width N, checked; b: the three input coordinates (K, n, L);
// o: three outputs (K, n, 1); far: n * merge_far_words(k, L) words of
// scratch (null when that is 0); (k, b3, b3_mont): one of on_branch's
// branches.
template <Mul M, int N>
int merge_entry(int kmul, void* const* b, void* const* o, void* far,
                long long n, int L, int n32, int k, int b3,
                const uint32_t* b3_mont, const uint32_t* p,
                const uint32_t* one_mont, uint32_t inv, int device,
                void* stream) {
  if (kmul != (int)M || n32 != N || n < 0 || L < 1 || (L & (L - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (on_branch<N>(k, b3, b3_mont, [](auto, auto) { return 0; }) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LaneRows in{{(const uint32_t*)b[0], (const uint32_t*)b[1],
               (const uint32_t*)b[2]},
              (size_t)n * L, n, L, 0, 0};
  Rows out{{(uint32_t*)o[0], (uint32_t*)o[1], (uint32_t*)o[2]}, (size_t)n, 0};
  return merge_rows<M, false>(k, b3, in, out, (uint32_t*)far,
                              field_params<N>(p, one_mont, inv), b3_mont,
                              (cudaStream_t)stream);
}

}  // namespace lff

// The C entry point `merge_far_words` of a library over the product M
// at LFF_N32 limbs, for K5 and K2m: merge_far_words<M, LFF_N32>, or -1
// for another product.
#define LFF_MERGE_FAR_WORDS(M)                                               \
  extern "C" int merge_far_words(int kmul, int k, int L) {                   \
    return kmul == (int)M ? lff::merge_far_words<M, LFF_N32>(k, L) : -1;     \
  }

// The C entry points `merge_lanes` and `merge_far_words` of one library,
// over the product M at LFF_N32 limbs.
#define LFF_MERGE_ENTRY(M)                                                   \
  LFF_MERGE_FAR_WORDS(M)                                                     \
  extern "C" int merge_lanes(int kmul, void* const* b, void* const* o,       \
                             void* far, long long n, int L, int n32, int k,  \
                             int b3, const uint32_t* b3_mont,                \
                             const uint32_t* p, const uint32_t* one_mont,    \
                             uint32_t inv, int device, void* stream) {       \
    return lff::merge_entry<M, LFF_N32>(kmul, b, o, far, n, L, n32, k, b3,   \
                                        b3_mont, p, one_mont, inv, device,   \
                                        stream);                             \
  }
