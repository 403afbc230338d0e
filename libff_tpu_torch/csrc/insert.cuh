// insert.cuh -- kernel K2: the MSM bucket insert, with its fused lane
// merge, over any of fp.cuh's Montgomery products.
//
// K2 replaces libff_tpu/msm/pallas_insert3.py:74 _insert_kernel (entry
// point insert_pallas3, :301), both branches: k = 1 (G1 over Fp) and k = 2
// (G2 over Fq2, whose madd runs on K4, fp2.cuh).  Same contract: signed
// digits d (W, T, L), affine points (K, T, L) with their negated y and an
// infinity flag (T, L), K = 8 or 2 x 8 limb rows; out: projective buckets
// (K, W, B, L), bucket |d| - 1 of lane l and window w accumulating
// +-P_(t*L + l) over t in order with the complete mixed add
// (formulas.rcb_madd_a0).  A zero digit or a point at infinity leaves the
// bucket as it is.  Buckets start as the identity (0, 1, 0)
// (pallas_insert3.py:91-97).
//
// Bound on an H100: the multiplies.  A G1 madd is 11 Montgomery products,
// a G2 madd 39 base products (13 Fq2 products of three, two of them by
// b3), each 136 mul.lo and 128 mul.hi multiply-adds at the rates K7c
// measures: 8.5 ms on the G1 path's 32.9 M madds, 7.5 ms on G2's 8.2 M.
// The bytes (the digits and the points read once, the buckets written
// once) take under a twentieth of that.
//
// Design.  A bucket (w, l, b) depends only on its own points, taken in t
// order, so the W * L * B bucket chains are independent; walking each
// chain in t order with the same rcb_madd and the same product gives the
// TPU kernel's raw buckets bit for bit, whatever its time block tb was.
// Three launches:
//
//   bucket_lists   (the sort) one thread per (w, l) lists the steps t
//                  whose digit is non-zero and whose point is finite,
//                  grouped by bucket and in t order within a bucket (a
//                  stable counting sort): off (W, L, B + 1) int32, the
//                  start of each bucket's list; ent (W, L, T), each entry
//                  2t + 1 for a negative digit, 2t for a positive one,
//                  then -1 to the end of the row; int16 while T <= 16384,
//                  else int32.  The digits and the infinity flags (bool
//                  bytes, as the caller holds them) are read with
//                  neighbouring lanes on neighbouring words, kSortBatch
//                  steps in flight; the counters live in shared memory,
//                  one column per thread, kSortChunk buckets a pass.
//                  kSortBlocksPerSM
//                  blocks an SM walk all the lanes, so that the rows being
//                  written at once fit in L2: with every lane at once the
//                  scattered 2-byte writes left their sectors part-written
//                  and the sort took twice as long.
//   chain_kernel   S threads per (w, l), S = ceil(T / kEntries).  Thread
//                  s owns the buckets whose lists start in the s-th of S
//                  equal shares of the lane's list: a run of consecutive
//                  buckets, a contiguous segment of the list of about
//                  T / S entries, whatever the digits (the top window's
//                  steps, for one, all fall in its first buckets).  The
//                  thread walks its segment in one flat loop, each bucket
//                  in a register accumulator that starts at the identity
//                  and is stored once when its list ends.  So the buckets
//                  are never read, never initialised in memory, and
//                  written once; and since a warp takes as long as its
//                  longest segment, the segments differ only by the one
//                  chain that straddles a share's end (about T / B
//                  entries: 8 on the G1 path, 2 on G2).  Lanes are the
//                  fastest thread index, so a warp's list reads coalesce.
//                  The threads of a warp finish their buckets at
//                  different times, so each stores a bucket's limbs
//                  contiguous, (W, L, B, K) per coordinate: whole 32-byte
//                  sectors.  In the contract's (K, W, B, L) each store
//                  would be one word of a sector that seven other threads
//                  fill later; on G2 those part-written sectors cost more
//                  than the madds.
//   limb_major_kernel  the raw buckets from (W, L, B, K) into (K, W, B,
//                  L) through shared memory, 32 lanes of one (w, b) a
//                  block: the bucket bytes read and written once more.
//
// The wrapper repacks the points beforehand into one record per point,
// x, y and -y contiguous (3 K words), so a madd reads its x and its y or
// -y as 16-byte loads: 64 bytes on G1, 128 on G2, where the TPU layout
// (K, T, L) costs one 32-byte sector per limb.
//
// kEntries, kSortBlocksPerSM and the blocks an SM that __launch_bounds__
// asks for were chosen on an H100 with tune_insert.py, which builds this
// header with other values of their LFF_ macros (PERF.md).
// On the two MSM paths kEntries gives S = 2 (G1) and 1 (G2): one wave of
// blocks, every thread with as many entries as the next.  Runs of a fixed
// count of buckets a thread, tried first, lost up to 2x to the digits'
// skew.  A G2 thread holds a 48-word accumulator, a 32-word point and the
// Karatsuba temporaries in 255 registers with a few spills; asking for 3
// blocks an SM (168 registers) spills a kilobyte and runs slower.
//
// The fused merge K2m (merge=True, pallas_insert3.py:172-201): the lane
// totals (K, W, B, 1) in merge.cuh's order.  The chain kernel writes the
// raw buckets lane-major as for K2, and merge.cuh's tree runs on them as
// a second launch on the same stream, reading that layout directly (an
// element's K words are one or two whole sectors), so neither the repack
// nor limb-major stores from threads that finish apart are paid.  The
// TPU kernel fuses the merge to keep the buckets in VMEM; here fusing
// saves only the bucket bytes (0.24 ms at 3.35 TB/s on G2) and costs the
// tail its parallelism: a tail inside the chain kernel can start a
// window's merge only once every block of that window has stored, which
// leaves it to the window's last block (CUDA's threadFenceReduction
// pattern: W = 32 blocks of 4 warps after everything else), or to blocks
// that wait on others, which CUDA does not promise to make progress.  A
// finer split of the tail into (window, bucket chunk) tasks has the same
// limit: a chunk is ready only when the whole window is.  The second
// launch gives the tree every SM: on an H100 K2m takes 0.95-1.0x of K2 +
// K5 on the same inputs, where the last-block tail took 2.1x (G1) and
// 4.0x (G2) (chip_smoke.py's tail_ms; PERF.md).  The C entry is still
// one call and the wrapper counts it once, as K2m.
//
// MsmConfig.kmul (pallas_insert3.py:302, :339, :343) picks the product:
// each of insert.cu (CIOS, with the sort and K6), insert_sos.cu and
// insert_sos2.cu instantiates this header for one product through
// LFF_INSERT_ENTRY, so the three compile in parallel; every product gives
// the same buckets.
#pragma once

#include "merge.cuh"

namespace lff {

// The constants tune_insert.py varies, each open to -D at build time.
#ifndef LFF_SORT_BLOCKS_PER_SM
#define LFF_SORT_BLOCKS_PER_SM 4
#endif
#ifndef LFF_ENTRIES_G1
#define LFF_ENTRIES_G1 512
#endif
#ifndef LFF_ENTRIES_G2
#define LFF_ENTRIES_G2 256
#endif
#ifndef LFF_MIN_BLOCKS_G1
#define LFF_MIN_BLOCKS_G1 4
#endif
#ifndef LFF_MIN_BLOCKS_G2
#define LFF_MIN_BLOCKS_G2 1
#endif

constexpr int kSortThreads = 32;
constexpr int kSortChunk = 128;  // buckets counted per pass over the digits
constexpr int kSortBatch = 16;   // steps whose loads are in flight at once
constexpr int kSortBlocksPerSM = LFF_SORT_BLOCKS_PER_SM;
constexpr int kChainThreads = 128;
// list entries a thread walks, G1 and G2
constexpr int kEntriesG1 = LFF_ENTRIES_G1;
constexpr int kEntriesG2 = LFF_ENTRIES_G2;
// __launch_bounds__'s blocks an SM
constexpr int kMinBlocksG1 = LFF_MIN_BLOCKS_G1;
constexpr int kMinBlocksG2 = LFF_MIN_BLOCKS_G2;
constexpr int kLayoutThreads = 256;

// The bucket of a step, or -1 for a step that adds nothing.
__device__ __forceinline__ int list_bucket(int dig, int inf, int B) {
  return (dig == 0 || inf != 0) ? -1 : min(abs(dig) - 1, B - 1);
}

// Steps t0 .. t0 + kSortBatch - 1 of one lane, all loads issued before
// any is used; a step past T reads as a zero digit.
__device__ __forceinline__ void load_steps(const int32_t* __restrict__ dl,
                                           const uint8_t* __restrict__ fl,
                                           int t0, int T, int L, int* dig,
                                           int* inf) {
#pragma unroll
  for (int k = 0; k < kSortBatch; k++) {
    const bool in = t0 + k < T;
    dig[k] = in ? __ldg(dl + (size_t)(t0 + k) * L) : 0;
    inf[k] = in ? __ldg(fl + (size_t)(t0 + k) * L) : 0;
  }
}

template <class Entry>
__global__ void __launch_bounds__(kSortThreads)
    bucket_lists_kernel(const int32_t* __restrict__ d,
                        const uint8_t* __restrict__ pinf,
                        int32_t* __restrict__ off, Entry* __restrict__ ent,
                        int W, int T, int L, int B) {
  __shared__ int32_t cnt[kSortChunk * kSortThreads];
  int32_t* c = cnt + threadIdx.x;  // this thread's counter of bucket b0 + j
                                   // at c[j * kSortThreads]
  // a grid of few blocks walks the lanes, so that the rows of entries
  // being written at once stay in L2 until their sectors are whole
  for (long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       gid < (long long)W * L; gid += (long long)gridDim.x * blockDim.x) {
    const int w = (int)(gid / L);
    const int l = (int)(gid % L);
    const int32_t* dl = d + (size_t)w * T * L + l;  // step t at dl[t * L]
    const uint8_t* fl = pinf + l;
    int32_t* o = off + (size_t)gid * (B + 1);
    Entry* e = ent + (size_t)gid * T;
    int base = 0;
    for (int b0 = 0; b0 < B; b0 += kSortChunk) {
      const int nb = min(kSortChunk, B - b0);
      for (int j = 0; j < nb; j++) c[j * kSortThreads] = 0;
      for (int t0 = 0; t0 < T; t0 += kSortBatch) {
        int dig[kSortBatch], inf[kSortBatch];
        load_steps(dl, fl, t0, T, L, dig, inf);
#pragma unroll
        for (int k = 0; k < kSortBatch; k++) {
          const unsigned j = list_bucket(dig[k], inf[k], B) - b0;
          if (j < (unsigned)nb) c[j * kSortThreads]++;
        }
      }
      for (int j = 0; j < nb; j++) {  // counts -> starts
        const int n = c[j * kSortThreads];
        o[b0 + j] = base;
        c[j * kSortThreads] = base;
        base += n;
      }
      for (int t0 = 0; t0 < T; t0 += kSortBatch) {
        int dig[kSortBatch], inf[kSortBatch];
        load_steps(dl, fl, t0, T, L, dig, inf);
#pragma unroll
        for (int k = 0; k < kSortBatch; k++) {
          const unsigned j = list_bucket(dig[k], inf[k], B) - b0;
          if (j < (unsigned)nb)
            e[c[j * kSortThreads]++] = (Entry)(2 * (t0 + k) + (dig[k] < 0));
        }
      }
    }
    o[B] = base;
    for (int i = base; i < T; i++) e[i] = (Entry)-1;
  }
}

// The sort.  d (W, T, L) int32, pinf (T, L) bool (one byte each); wide:
// int32 entries (else int16, which needs T <= 16384).
inline int bucket_lists_entry(const void* d, const void* pinf, void* off,
                              void* ent, int wide, int W, int T, int L,
                              int B, int device, void* stream) {
  if (W < 0 || T < 0 || L < 0 || B <= 0 || (wide != 0 && wide != 1) ||
      (!wide && T > 16384))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long lane_blocks =
      ((long long)W * L + kSortThreads - 1) / kSortThreads;
  const long long blocks = lane_blocks < (long long)sms * kSortBlocksPerSM
                               ? lane_blocks
                               : (long long)sms * kSortBlocksPerSM;
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    bucket_lists_kernel<int32_t><<<(unsigned)blocks, kSortThreads, 0, s>>>(
        (const int32_t*)d, (const uint8_t*)pinf, (int32_t*)off,
        (int32_t*)ent, W, T, L, B);
  else
    bucket_lists_kernel<int16_t><<<(unsigned)blocks, kSortThreads, 0, s>>>(
        (const int32_t*)d, (const uint8_t*)pinf, (int32_t*)off,
        (int16_t*)ent, W, T, L, B);
  return (int)cudaGetLastError();
}

// One coordinate of a bucket as 16-byte stores (merge.cuh's load_words
// reads a point record's or a bucket's the same way): two at 8 limbs,
// three at 12.
template <int N>
__device__ __forceinline__ void store_words(uint32_t* p, const Fe<N>& a) {
#pragma unroll
  for (int q = 0; q < N / 4; q++)
    ((uint4*)p)[q] = make_uint4(a.v[4 * q], a.v[4 * q + 1], a.v[4 * q + 2],
                                a.v[4 * q + 3]);
}

__device__ __forceinline__ void store_words(uint32_t* p, const Fe2& a) {
  store_words(p, a.c0);
  store_words(p + 8, a.c1);
}

// The chain kernel's share of a lane and occupancy target by branch.
template <class F>
struct ChainShape {
  static constexpr bool kG1 = F::kG1;
  static constexpr int kEntries = kG1 ? kEntriesG1 : kEntriesG2;
  static constexpr int kMinBlocks = kG1 ? kMinBlocksG1 : kMinBlocksG2;
};

// Threads per (w, l) for T steps.
template <class F>
__host__ __device__ constexpr int chain_threads(int T) {
  return T <= ChainShape<F>::kEntries
             ? 1
             : (T + ChainShape<F>::kEntries - 1) / ChainShape<F>::kEntries;
}

// The first bucket b < B whose list starts at or after entry x, or B.
__device__ __forceinline__ int first_bucket_from(const int32_t* o, int B,
                                                 int x) {
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (o[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <class F>
__global__ void __launch_bounds__(kChainThreads, ChainShape<F>::kMinBlocks)
    chain_kernel(const int32_t* __restrict__ off, const void* __restrict__ ent,
                 int wide, const uint32_t* __restrict__ rec, uint32_t* bx,
                 uint32_t* by, uint32_t* bz, int W, int T, int L, int B,
                 F f) {
  using E = typename F::E;
  constexpr int K = sizeof(E) / sizeof(uint32_t);
  const int S = chain_threads<F>(T);
  const long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (gid >= (long long)W * S * L) return;
  const int l = (int)(gid % L);
  const int s = (int)(gid / L % S);
  const int w = (int)(gid / L / S);
  const size_t row = (size_t)w * L + l;  // the lane's row of the lists
  const int32_t* o = off + row * (B + 1);
  const int16_t* e16 = (const int16_t*)ent + row * T;
  const int32_t* e32 = (const int32_t*)ent + row * T;

  // this thread's buckets: those whose lists start in [n s / S, n (s+1) / S)
  const long long n = o[B];
  int b = first_bucket_from(o, B, (int)((n * s + S - 1) / S));
  const int b1 = s == S - 1 ? B
                            : first_bucket_from(o, B,
                                                (int)((n * (s + 1) + S - 1) /
                                                      S));
  if (b < b1) {
    const E z = f.zero(), one = f.one();
    int i = o[b], next = o[b + 1];
    Pt<F> acc{z, one, z};
    for (;;) {
      while (i == next) {  // bucket b's list has ended: store it once
        const size_t e = (row * B + b) * K;  // (W, L, B, K): whole sectors
        store_words(bx + e, acc.x);
        store_words(by + e, acc.y);
        store_words(bz + e, acc.z);
        if (++b == b1) break;
        next = o[b + 1];
        acc = Pt<F>{z, one, z};
      }
      if (b == b1) break;
      const int en = wide ? e32[i] : e16[i];
      i++;
      const uint32_t* q = rec + ((size_t)(en >> 1) * L + l) * (3 * K);
      E qx, qy;
      load_words(q, qx);
      load_words(q + (1 + (en & 1)) * K, qy);
      acc = rcb_madd(f, acc, qx, qy);
    }
  }
}

// The raw buckets from the chain kernel's lane-major arrays (W, L, B, K)
// into the contract's (K, W, B, L), one coordinate of a (w, b) row of 32
// lanes a block: whole sectors read, whole lines written.
template <int K>
__global__ void __launch_bounds__(kLayoutThreads)
    limb_major_kernel(const uint32_t* __restrict__ sx,
                      const uint32_t* __restrict__ sy,
                      const uint32_t* __restrict__ sz, uint32_t* bx,
                      uint32_t* by, uint32_t* bz, int W, int L, int B) {
  __shared__ uint32_t tile[K][33];
  const uint32_t* in = blockIdx.z == 0 ? sx : blockIdx.z == 1 ? sy : sz;
  uint32_t* out = blockIdx.z == 0 ? bx : blockIdx.z == 1 ? by : bz;
  const int w = (int)(blockIdx.x / B), b = (int)(blockIdx.x % B);
  const int l0 = blockIdx.y * 32;
  for (int i = threadIdx.x; i < 32 * K; i += kLayoutThreads) {
    const int l = i / K, k = i % K;
    if (l0 + l < L)
      tile[k][l] = in[(((size_t)w * L + l0 + l) * B + b) * K + k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * K; i += kLayoutThreads) {
    const int k = i / 32, l = i % 32;
    if (l0 + l < L)
      out[(((size_t)k * W + w) * B + b) * L + l0 + l] = tile[k][l];
  }
}

// The chain kernel into the lane-major scratch `lane`, then, unless the
// caller merges (bx null), the repack from it into bx, by, bz.
template <class F>
int chain_launch(const void* off, const void* ent, int wide, const void* rec,
                 void* const* lane, void* bx, void* by, void* bz, int W,
                 int T, int L, int B, const F& f, cudaStream_t s) {
  constexpr int K = sizeof(typename F::E) / sizeof(uint32_t);
  const long long threads = (long long)W * chain_threads<F>(T) * L;
  const long long blocks = (threads + kChainThreads - 1) / kChainThreads;
  chain_kernel<F><<<(unsigned)blocks, kChainThreads, 0, s>>>(
      (const int32_t*)off, ent, wide, (const uint32_t*)rec,
      (uint32_t*)lane[0], (uint32_t*)lane[1], (uint32_t*)lane[2], W, T, L, B,
      f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || bx == nullptr) return (int)err;
  const dim3 grid((unsigned)((long long)W * B), (unsigned)((L + 31) / 32), 3);
  limb_major_kernel<K><<<grid, kLayoutThreads, 0, s>>>(
      (const uint32_t*)lane[0], (const uint32_t*)lane[1],
      (const uint32_t*)lane[2], (uint32_t*)bx, (uint32_t*)by, (uint32_t*)bz,
      W, L, B);
  return (int)cudaGetLastError();
}

// K2 after the sort: off and ent from bucket_lists (wide as there), rec
// the point records (T * L, 3, K) words, lane three (W, L, B, K) scratch
// arrays for the raw buckets.  kmul: the product this library was built
// for ((int)M), checked; k = 1: b3 must be 9 (alt_bn128 G1) and b3_mont
// is unused; k = 2: b3_mont holds the 16 Montgomery limbs of the Fq2
// constant b3 (c0 then c1).  m null: the raw buckets into bx, by, bz (K,
// W, B, L); else K2m, the lane totals into the three (K, W, B, 1) arrays
// of m, merge.cuh's tree over `lane` (bx, by, bz unused) with `far`, W *
// B * merge_far_words(k, L) words of scratch (null when that is 0).
template <Mul M>
int insert_entry(int kmul, const void* off, const void* ent, int wide,
                 const void* rec, void* const* lane, void* bx, void* by,
                 void* bz, int W, int T, int L, int B, int n32, int k, int b3,
                 const uint32_t* b3_mont, const uint32_t* p,
                 const uint32_t* one_mont, uint32_t inv, void* const* m,
                 void* far, int device, void* stream) {
  if (kmul != (int)M || n32 != 8 || W < 0 || T < 0 || L < 0 || B <= 0 ||
      (wide != 0 && wide != 1) || lane == nullptr)
    return (int)cudaErrorInvalidValue;
  if (!(k == 1 && b3 == 9) && !(k == 2 && b3_mont != nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == nullptr && (bx == nullptr || by == nullptr || bz == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m != nullptr && (L & (L - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  const FieldParams<8> P = field_params(p, one_mont, inv);
  const cudaStream_t s = (cudaStream_t)stream;
  void* const rx = m == nullptr ? bx : nullptr;  // null: no repack
  int rc;
  if (k == 1) {
    rc = chain_launch(off, ent, wide, rec, lane, rx, by, bz, W, T, L, B,
                      FpField<8, 9, M>{P}, s);
  } else {
    Fp2Field<M> f{P, {}};
    for (int i = 0; i < 8; i++) {
      f.b3.c0.v[i] = b3_mont[i];
      f.b3.c1.v[i] = b3_mont[8 + i];
    }
    rc = chain_launch(off, ent, wide, rec, lane, rx, by, bz, W, T, L, B, f,
                      s);
  }
  if (rc != 0 || m == nullptr) return rc;
  const long long n = (long long)W * B;
  const LaneRows in{{(const uint32_t*)lane[0], (const uint32_t*)lane[1],
                     (const uint32_t*)lane[2]},
                    0, n, L, B, 8 * k};
  const Rows out{{(uint32_t*)m[0], (uint32_t*)m[1], (uint32_t*)m[2]},
                 (size_t)n, 0};
  return merge_rows<M, true>(k, in, out, (uint32_t*)far, P, b3_mont, s);
}

// K2 over 12-limb Fp (insert_n12.cu), the arguments as insert_entry's:
// G1 only (k = 1, b3 = 12 for BLS12-381 or 3 for BLS12-377), the CIOS
// product only, the raw buckets only (m null).  The chain kernel is the
// 8-limb one over FpField<12, B3>: a bucket is 36 words, a point record
// 36, and kEntries and the blocks an SM are G1's (tuned at 8 limbs).
inline int insert_entry_n12(int kmul, const void* off, const void* ent,
                            int wide, const void* rec, void* const* lane,
                            void* bx, void* by, void* bz, int W, int T,
                            int L, int B, int n32, int k, int b3,
                            const uint32_t* p, const uint32_t* one_mont,
                            uint32_t inv, void* const* m, int device,
                            void* stream) {
  if (kmul != (int)Mul::Cios || n32 != 12 || W < 0 || T < 0 || L < 0 ||
      B <= 0 || (wide != 0 && wide != 1) || lane == nullptr || k != 1 ||
      (b3 != 12 && b3 != 3) || m != nullptr || bx == nullptr ||
      by == nullptr || bz == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  const FieldParams<12> P = field_params<12>(p, one_mont, inv);
  const cudaStream_t s = (cudaStream_t)stream;
  if (b3 == 12)
    return chain_launch(off, ent, wide, rec, lane, bx, by, bz, W, T, L, B,
                        FpField<12, 12>{P}, s);
  return chain_launch(off, ent, wide, rec, lane, bx, by, bz, W, T, L, B,
                      FpField<12, 3>{P}, s);
}

}  // namespace lff

// The C entry points `insert` and `merge_far_words` (merge.cuh) of one
// library, over the product M.
#define LFF_INSERT_ENTRY(M)                                                  \
  LFF_MERGE_FAR_WORDS(M)                                                     \
  extern "C" int insert(int kmul, const void* off, const void* ent,          \
                        int wide, const void* rec, void* const* lane,        \
                        void* bx, void* by, void* bz, int W, int T, int L,   \
                        int B, int n32, int k, int b3,                       \
                        const uint32_t* b3_mont, const uint32_t* p,          \
                        const uint32_t* one_mont, uint32_t inv,              \
                        void* const* m, void* far, int device,               \
                        void* stream) {                                      \
    return lff::insert_entry<M>(kmul, off, ent, wide, rec, lane, bx, by, bz, \
                                W, T, L, B, n32, k, b3, b3_mont, p,          \
                                one_mont, inv, m, far, device, stream);      \
  }
