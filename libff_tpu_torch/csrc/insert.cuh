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
//   bucket_lists   (the sort) lists, per (w, l), the steps t whose digit
//                  is non-zero and whose point is finite, grouped by
//                  bucket and in t order within a bucket (a stable
//                  counting sort): off (W, L, B + 1) int32, the start of
//                  each bucket's list; ent (W, L, T), each entry 2t + 1
//                  for a negative digit, 2t for a positive one, then -1
//                  to the end of the row; int16 while T <= 16384, else
//                  int32.  Its bound is bytes: the digits and the flags
//                  (bool bytes, as the caller holds them) read once, the
//                  lists written once.  A block owns 32 neighbouring
//                  lanes of one window: it reads their digit and flag rows
//                  as whole 128-byte lines into a tile of one-byte keys
//                  (16-bit past B = 255) and sign words in shared memory;
//                  then each warp lists one lane at a time: it counts the
//                  lane's keys (shared-memory atomics), scans the counts
//                  into starts, and ranks the steps 32 at a time among
//                  their peers (one ballot a key bit) into a row of
//                  entries in shared memory, which it stores as 16-byte
//                  words.  So the digits are read once and the lists
//                  written once, whole sectors, where one thread a lane
//                  read each lane's steps twice and scattered 2-byte
//                  stores over its own row (1.03 ms against 0.24 on an
//                  H100, G1 path, PERF.md).  A lane longer than the tile
//                  (kSortTile steps) is listed from device memory.
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
//                  contiguous, (W, L, B, Kp) per coordinate, Kp the K
//                  words padded to whole 32-byte sectors (lane_words: 8
//                  at 8 limbs, 16 on G2 and at 12 limbs).  In the
//                  contract's (K, W, B, L) each store would be one word of
//                  a sector that seven other threads fill later; on G2
//                  those part-written sectors cost more than the madds,
//                  and at 12 limbs a 48-byte coordinate without its pad
//                  left every other sector half written until the
//                  thread's next bucket.
//   limb_major_kernel  the raw buckets from (W, L, B, Kp) into (K, W, B,
//                  L) through shared memory, 32 lanes of one (w, b) a
//                  block: the bucket bytes read and written once more.
//
// The wrapper repacks the points beforehand into one record per point,
// x, y and -y contiguous (3 K words), so a madd reads its x and its y or
// -y as 16-byte loads: 64 bytes on G1, 128 on G2, where the TPU layout
// (K, T, L) costs one 32-byte sector per limb.
//
// kEntries, the blocks an SM that __launch_bounds__ asks for and the
// sort's tile and warps were chosen on an H100 with tune_insert.py, which
// builds this header with other values of their LFF_ macros (PERF.md).
// On the two 8-limb MSM paths kEntries gives S = 2 (G1) and 1 (G2): one
// wave of blocks, every thread with as many entries as the next.  Runs
// of a fixed count of buckets a thread, tried first, lost up to 2x to the
// digits' skew.  A G2 thread holds a 48-word accumulator, a 32-word point
// and the Karatsuba temporaries in 255 registers with a few spills;
// asking for 3 blocks an SM (168 registers) spills a kilobyte and runs
// slower.
//
// At 12 limbs (BLS12-381 and BLS12-377 G1, insert_n12.cu) the bound is
// the same, the multiplies: a 12-limb product is 300 mul.lo and 288
// mul.hi multiply-adds, 2.24 times an 8-limb one.  At G1's 8-limb
// settings, 4 blocks an SM capped the chain kernel at 128 registers,
// where the bucket (36 words), the point (24) and the madd's first-level
// values (60) beside CIOS's row accumulator spill 260-272 bytes on the
// inner loop, and its 48-byte coordinates left half-written sectors: it
// ran at 32% of its bound (59.2 ms on the path).  Now a coordinate takes
// 16 words in the lane-major arrays (whole sectors), and the 12-limb
// constants are their own: 3 blocks an SM (168 registers, at most 12
// bytes of spills) and kEntries = 342, so that the path's 32 x 3 x 1024
// threads fill two waves of 3 x 132 blocks (37.5 ms on an H100, 51% of
// the bound).  Tried and measured on an H100 (PERF.md):
// keeping the bucket, the point and a scratch element in shared memory
// with the next point fetched by cp.async, in a madd order that keeps
// three elements in registers, ran 4 blocks an SM at 128 registers
// without spills and was the fastest on even digits, but lost 8-9 ms on
// the path's digits, whose chains end at different steps in a warp, and
// at 3 blocks an SM it lost to registers; so the bucket stays in
// registers.
//
// The G2 of BLS12-381 and BLS12-377 (insert_n12.cu, nr = -1 and -5)
// runs the chain kernel on two threads a chain, over fp2_pair.cuh's
// Fp2Pair<12, NR>: thread c of a pair (adjacent lanes, chains' lanes next
// fastest) holds coefficient c of the bucket and of the point, 36 + 24
// words, close to the 12-limb G1 thread's load, and each Fq2 product is
// redc_pair's two lazy sums, a pair's multiply-adds as many as
// Karatsuba's three products (so the bound is unchanged).  Both threads
// read the same list entry and walk the same list, so they never
// diverge; each loads its own 12 words of a point record's coordinates
// and stores its own 12 words of a bucket's lane-major coordinate (24
// words, no pad), at the same step as its partner, so the pair's 96
// bytes fill whole sectors.  Its constants are its own, chosen with
// tune_insert.py on an H100: 3 blocks an SM (168 registers, 228 and 408
// bytes of spills for nr = -1 and -5; at 2, 241-248 registers and no
// spills, and at 4, 128 registers and 4 KB of spills, ran slower) and
// kEntriesG2N12 = 86, so that the path's T = 256 steps take S = 3 pairs
// a lane: 1536 blocks, 3.9 waves of 3 x 132 (S = 1, 2 and 4 ran 11-37%
// slower).  On one thread a chain (Fp2Field<12, NR>) a 72-word bucket
// and a 48-word point beside the Karatsuba temporaries took 255
// registers and spilled 680 and 952 bytes on the inner loop, and ran
// 2.5 times as long (PERF.md).
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
// the same buckets.  insert_n12.cu (with K6), insert_sos_n12.cu and
// insert_sos2_n12.cu do the same at LFF_N32 = 12, where K2m's tree reads
// the chain kernel's lane-major stride (ChainShape::kLaneWords: 16 words
// a coordinate on G1, 24 on the G2 pairs) and the G2 chains run on pairs
// over every product.
#pragma once

#include "merge.cuh"

namespace lff {

// The constants tune_insert.py varies, each open to -D at build time.
#ifndef LFF_SORT_TILE
#define LFF_SORT_TILE 1024
#endif
#ifndef LFF_SORT_WARPS
#define LFF_SORT_WARPS 16
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
#ifndef LFF_ENTRIES_G1_N12
#define LFF_ENTRIES_G1_N12 342
#endif
#ifndef LFF_MIN_BLOCKS_G1_N12
#define LFF_MIN_BLOCKS_G1_N12 3
#endif
#ifndef LFF_ENTRIES_G2_N12
#define LFF_ENTRIES_G2_N12 86
#endif
#ifndef LFF_MIN_BLOCKS_G2_N12
#define LFF_MIN_BLOCKS_G2_N12 3
#endif

// The sort: the steps of a lane that a block holds in shared memory, its
// warps, the lanes it owns (one 128-byte line of digits), the buckets a
// pass counts and the rows of digits a warp has in flight.
constexpr int kSortTile = LFF_SORT_TILE;
constexpr int kSortWarps = LFF_SORT_WARPS;
constexpr int kSortThreads = 32 * kSortWarps;
constexpr int kSortLanes = 32;
constexpr int kSortBins = 256;
constexpr int kSortBatch = 16;
static_assert(kSortTile > 0 && kSortTile % 32 == 0, "whole groups of 32");
constexpr int kChainThreads = 128;
// list entries a chain thread walks (on the 12-limb G2 a pair of
// threads): G1 and G2, each at 8 and at 12 limbs
constexpr int kEntriesG1 = LFF_ENTRIES_G1;
constexpr int kEntriesG1N12 = LFF_ENTRIES_G1_N12;
constexpr int kEntriesG2 = LFF_ENTRIES_G2;
constexpr int kEntriesG2N12 = LFF_ENTRIES_G2_N12;
// __launch_bounds__'s blocks an SM
constexpr int kMinBlocksG1 = LFF_MIN_BLOCKS_G1;
constexpr int kMinBlocksG1N12 = LFF_MIN_BLOCKS_G1_N12;
constexpr int kMinBlocksG2 = LFF_MIN_BLOCKS_G2;
constexpr int kMinBlocksG2N12 = LFF_MIN_BLOCKS_G2_N12;
constexpr int kLayoutThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// The sort key of a step: its bucket, or B for a step that adds nothing.
__device__ __forceinline__ int sort_key(int dig, int inf, int B) {
  return (dig == 0 || inf != 0) ? B : min(abs(dig) - 1, B - 1);
}

// A lane's keys in the block's tile: row[t] the key of step t, bit c of
// signs[t] the sign of its digit (c the lane's column in the block).
template <class Key>
struct TileKeys {
  const Key* row;
  const uint32_t* signs;
  int c;
  __device__ __forceinline__ unsigned key(int t) const { return row[t]; }
  __device__ __forceinline__ int neg(int t) const {
    return (signs[t] >> c) & 1;
  }
};

// A lane's keys straight from the digits and flags in device memory, for
// a lane longer than a tile.
struct GlobalKeys {
  const int32_t* dl;  // step t at dl[t * L]
  const uint8_t* fl;
  int L, B;
  __device__ __forceinline__ unsigned key(int t) const {
    return (unsigned)sort_key(__ldg(dl + (size_t)t * L),
                              __ldg(fl + (size_t)t * L), B);
  }
  __device__ __forceinline__ int neg(int t) const {
    return __ldg(dl + (size_t)t * L) < 0;
  }
};

// The lanes of the warp whose k equals this lane's, k < 2^bits: one
// ballot a bit (the mask __match_any_sync gives).
__device__ __forceinline__ unsigned peers_of(unsigned k, int bits) {
  unsigned m = kFullMask;
  for (int j = 0; j < bits; j++) {
    const unsigned v = __ballot_sync(kFullMask, (k >> j) & 1);
    m &= (k >> j) & 1 ? v : ~v;
  }
  return m;
}

// One warp lists one lane: its row of off, o (B + 1 starts), and its row
// of entries (in shared or device memory), from its T keys, kSortBins
// buckets a pass.  A pass counts its buckets' keys (shared-memory
// atomics), scans the counts into starts across the warp, then takes the
// steps 32 at a time: each goes to its bucket's start plus the number of
// its peers (peers_of) at earlier steps of the group, and the starts move
// past the group: a stable counting sort.  cnt: kSortBins words of shared
// memory for this warp.
template <class Keys, class Entry>
__device__ __forceinline__ void sort_lane(const Keys& keys, Entry* row,
                                          int32_t* o, int* cnt, int T,
                                          int B) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  int base = 0;
  for (int b0 = 0; b0 < B; b0 += kSortBins) {
    const unsigned nb = (unsigned)min(kSortBins, B - b0);
    const int bits = 32 - __clz(nb);  // a key of the pass, or nb: not in it
    for (int j = lane; j < (int)nb; j += 32) cnt[j] = 0;
    __syncwarp();
    for (int t = lane; t < T; t += 32) {
      const unsigned k = keys.key(t) - b0;
      if (k < nb) atomicAdd(cnt + k, 1);
    }
    __syncwarp();
    // each lane sums a run of `per` counts; the runs are scanned across
    // the warp, then each run in the lane
    const int per = ((int)nb + 31) / 32;
    const int j0 = min(lane * per, (int)nb), j1 = min(j0 + per, (int)nb);
    int sum = 0;
    for (int j = j0; j < j1; j++) sum += cnt[j];
    int incl = sum;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFullMask, incl, s);
      if (lane >= s) incl += v;
    }
    int start = base + incl - sum;
    for (int j = j0; j < j1; j++) {
      const int n = cnt[j];
      cnt[j] = start;
      o[b0 + j] = start;
      start += n;
    }
    base += __shfl_sync(kFullMask, incl, 31);
    __syncwarp();
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const unsigned k = min((t < T ? keys.key(t) : (unsigned)B) - b0, nb);
      const bool in = k < nb;
      const unsigned peers = peers_of(k, bits);
      if (in)
        row[cnt[k] + __popc(peers & below)] = (Entry)(2 * t + keys.neg(t));
      __syncwarp();
      if (in && (peers >> lane) == 1) cnt[k] += __popc(peers);  // last peer
      __syncwarp();
    }
  }
  if (lane == 0) o[B] = base;
  for (int i = base + lane; i < T; i += 32) row[i] = (Entry)-1;
  __syncwarp();
}

// The sort's shared memory: with a tile (T <= kSortTile) a row of entries
// and kSortBins counters a warp, the tile's sign words and its keys (a row
// a lane, padded by one 32-bit word so that a warp's stores of one step
// fall on 32 banks); without, the counters only.
template <class Key, class Entry>
struct SortSmem {
  static constexpr int kStride = kSortTile + 4 / (int)sizeof(Key);
  static constexpr size_t kRows = sizeof(Entry) * kSortWarps * kSortTile;
  static constexpr size_t kCnt = 4 * kSortWarps * kSortBins;
  static constexpr size_t kSigns = 4 * kSortTile;
  static constexpr size_t kKeys = sizeof(Key) * kSortLanes * kStride;
  static constexpr size_t bytes(bool tile) {
    return tile ? kRows + kCnt + kSigns + kKeys : kCnt;
  }
};

// A block lists kSortLanes neighbouring lanes of one window.  With T <=
// kSortTile its warps first read the lanes' digit and flag rows as whole
// lines (kSortBatch rows a warp in flight) into the tile of keys and sign
// words; then each warp lists its lanes in turn into its row of entries
// and stores the row as 16-byte words.  A longer lane is listed from
// device memory straight into ent.
template <class Key, class Entry>
__global__ void __launch_bounds__(kSortThreads)
    bucket_lists_kernel(const int32_t* __restrict__ d,
                        const uint8_t* __restrict__ pinf,
                        int32_t* __restrict__ off, Entry* __restrict__ ent,
                        int T, int L, int B) {
  using S = SortSmem<Key, Entry>;
  extern __shared__ uint4 sort_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int lane_blocks = (L + kSortLanes - 1) / kSortLanes;
  const int w = (int)(blockIdx.x / lane_blocks);
  const int l0 = (int)(blockIdx.x % lane_blocks) * kSortLanes;
  const int nl = min(kSortLanes, L - l0);
  const size_t row0 = (size_t)w * L + l0;  // the block's first lane row
  const int32_t* dw = d + (size_t)w * T * L + l0;
  char* sm = (char*)sort_smem;
  const bool tile = T <= kSortTile;
  int* cnt = (int*)(sm + (tile ? S::kRows : 0)) + warp * kSortBins;
  if (!tile) {
    for (int c = warp; c < nl; c += kSortWarps)
      sort_lane(GlobalKeys{dw + c, pinf + l0 + c, L, B},
                ent + (row0 + c) * T, off + (row0 + c) * (B + 1), cnt, T, B);
    return;
  }
  uint32_t* signs = (uint32_t*)(sm + S::kRows + S::kCnt);
  Key* keys = (Key*)(sm + S::kRows + S::kCnt + S::kSigns);
  const bool mine = lane < nl;
  for (int t0 = warp * kSortBatch; t0 < T; t0 += kSortWarps * kSortBatch) {
    int dig[kSortBatch], inf[kSortBatch];
#pragma unroll
    for (int k = 0; k < kSortBatch; k++) {
      const bool in = mine && t0 + k < T;
      dig[k] = in ? __ldg(dw + (size_t)(t0 + k) * L + lane) : 0;
      inf[k] = in ? __ldg(pinf + (size_t)(t0 + k) * L + l0 + lane) : 0;
    }
#pragma unroll
    for (int k = 0; k < kSortBatch; k++) {
      if (t0 + k < T) {
        keys[lane * S::kStride + t0 + k] = (Key)sort_key(dig[k], inf[k], B);
        const unsigned neg = __ballot_sync(kFullMask, dig[k] < 0);
        if (lane == 0) signs[t0 + k] = neg;
      }
    }
  }
  __syncthreads();
  Entry* row = (Entry*)sm + warp * kSortTile;
  const bool vec = (T * sizeof(Entry)) % 16 == 0;
  for (int c = warp; c < nl; c += kSortWarps) {
    sort_lane(TileKeys<Key>{keys + c * S::kStride, signs, c}, row,
              off + (row0 + c) * (B + 1), cnt, T, B);
    Entry* e = ent + (row0 + c) * T;
    if (vec) {
      const int n = (int)(T * sizeof(Entry) / 16);
      for (int i = lane; i < n; i += 32)
        ((uint4*)e)[i] = ((const uint4*)row)[i];
    } else {
      for (int i = lane; i < T; i += 32) e[i] = row[i];
    }
    __syncwarp();
  }
}

template <class Key, class Entry>
int sort_launch(const void* d, const void* pinf, void* off, void* ent, int W,
                int T, int L, int B, cudaStream_t s) {
  const size_t smem = SortSmem<Key, Entry>::bytes(T <= kSortTile);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_lists_kernel<Key, Entry>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)W * ((L + kSortLanes - 1) / kSortLanes);
  bucket_lists_kernel<Key, Entry><<<(unsigned)blocks, kSortThreads, smem,
                                    s>>>(
      (const int32_t*)d, (const uint8_t*)pinf, (int32_t*)off, (Entry*)ent, T,
      L, B);
  return (int)cudaGetLastError();
}

// The keys are bytes while B <= 255 (B itself marks a step that adds
// nothing), 16-bit words while B <= 65535.
template <class Entry>
int sort_launch(const void* d, const void* pinf, void* off, void* ent, int W,
                int T, int L, int B, cudaStream_t s) {
  if (B <= 255)
    return sort_launch<uint8_t, Entry>(d, pinf, off, ent, W, T, L, B, s);
  if (B <= 65535)
    return sort_launch<uint16_t, Entry>(d, pinf, off, ent, W, T, L, B, s);
  return sort_launch<uint32_t, Entry>(d, pinf, off, ent, W, T, L, B, s);
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

template <int N>
__device__ __forceinline__ void store_words(uint32_t* p, const Fe2<N>& a) {
  store_words(p, a.c0);
  store_words(p + N, a.c1);
}

// The words of one coordinate of a bucket in the chain kernels'
// lane-major arrays: its K words padded to whole 32-byte sectors (12
// limbs take 16), so that no store leaves a sector part-written for a
// later store to fill.
template <class E>
__host__ __device__ constexpr int lane_words() {
  return (sizeof(E) / sizeof(uint32_t) + 7) / 8 * 8;
}

// One coordinate at p in the lane-major arrays, its pad zeroed.
template <class E>
__device__ __forceinline__ void store_lane(uint32_t* p, const E& a) {
  store_words(p, a);
#pragma unroll
  for (int q = sizeof(E) / 16; q < lane_words<E>() / 4; q++)
    ((uint4*)p)[q] = make_uint4(0, 0, 0, 0);
}

// The chain kernel's shape by branch: the threads of a chain (1, or 2
// on fp2_pair.cuh's Fp2Pair, a coefficient a thread), the words of an
// element (all its threads') and of one coordinate in the lane-major
// arrays, the share of a lane and the occupancy target.
template <class F>
struct ChainShape {
  static constexpr int kThreads = F::kThreads;
  static constexpr int kPart = sizeof(typename F::E) / sizeof(uint32_t);
  static constexpr int kWords = kThreads * kPart;
  static constexpr int kLaneWords = (kWords + 7) / 8 * 8;
  static constexpr bool kG1 = F::kG1;
  static constexpr bool kN12 = kWords / (kG1 ? 1 : 2) == 12;  // limbs
  static constexpr int kEntries = kG1 ? (kN12 ? kEntriesG1N12 : kEntriesG1)
                                      : (kN12 ? kEntriesG2N12 : kEntriesG2);
  static constexpr int kMinBlocks =
      kG1 ? (kN12 ? kMinBlocksG1N12 : kMinBlocksG1)
          : (kN12 ? kMinBlocksG2N12 : kMinBlocksG2);
  // a pair's two parts fill whole sectors together: no pad to zero
  static_assert(kThreads == 1 || kWords == kLaneWords, "whole sectors");
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
  using Shape = ChainShape<F>;
  constexpr int K = Shape::kWords;
  const int S = chain_threads<F>(T);
  // a chain's threads are adjacent lanes (both walk the same list, so
  // they never diverge); thread c holds coefficient c, words c kPart on
  const long long gid =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) / Shape::kThreads;
  const int part = Shape::kThreads == 2 ? (threadIdx.x & 1) * Shape::kPart
                                        : 0;
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
        const size_t e = (row * B + b) * Shape::kLaneWords;  // sectors
        if constexpr (Shape::kThreads == 1) {
          store_lane(bx + e, acc.x);
          store_lane(by + e, acc.y);
          store_lane(bz + e, acc.z);
        } else {  // the pair stores at the same step
          store_words(bx + e + part, acc.x);
          store_words(by + e + part, acc.y);
          store_words(bz + e + part, acc.z);
        }
        if (++b == b1) break;
        next = o[b + 1];
        acc = Pt<F>{z, one, z};
      }
      if (b == b1) break;
      const int en = wide ? e32[i] : e16[i];
      i++;
      const uint32_t* q = rec + ((size_t)(en >> 1) * L + l) * (3 * K);
      E qx, qy;
      load_words(q + part, qx);
      load_words(q + (1 + (en & 1)) * K + part, qy);
      acc = rcb_madd(f, acc, qx, qy);
    }
  }
}

// The raw buckets from the chain kernel's lane-major arrays (W, L, B, Kp),
// Kp = lane_words, into the contract's (K, W, B, L), one coordinate of a
// (w, b) row of 32 lanes a block: whole sectors read, whole lines written.
template <int K, int Kp>
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
      tile[k][l] = in[(((size_t)w * L + l0 + l) * B + b) * Kp + k];
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
  using Shape = ChainShape<F>;
  const long long threads =
      (long long)W * chain_threads<F>(T) * L * Shape::kThreads;
  const long long blocks = (threads + kChainThreads - 1) / kChainThreads;
  chain_kernel<F><<<(unsigned)blocks, kChainThreads, 0, s>>>(
      (const int32_t*)off, ent, wide, (const uint32_t*)rec,
      (uint32_t*)lane[0], (uint32_t*)lane[1], (uint32_t*)lane[2], W, T, L, B,
      f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || bx == nullptr) return (int)err;
  const dim3 grid((unsigned)((long long)W * B), (unsigned)((L + 31) / 32), 3);
  limb_major_kernel<Shape::kWords, Shape::kLaneWords>
      <<<grid, kLayoutThreads, 0, s>>>(
      (const uint32_t*)lane[0], (const uint32_t*)lane[1],
      (const uint32_t*)lane[2], (uint32_t*)bx, (uint32_t*)by, (uint32_t*)bz,
      W, L, B);
  return (int)cudaGetLastError();
}

// The G2 chain kernel's field context at N limbs over the product M: one
// thread a chain (fp2.cuh's Fp2Field) at 8 limbs, two (fp2_pair.cuh's
// Fp2Pair) at 12.
template <int N, int NR, Mul M>
using ChainField2 =
    std::conditional_t<N == 8, Fp2Field<N, NR, M>, Fp2Pair<N, NR, M>>;

template <int N, int NR, Mul M>
inline ChainField2<N, NR, M> chain_field2(const FieldParams<N>& P,
                                          const uint32_t* b3_mont) {
  if constexpr (N == 8) {
    return Fp2Field<N, NR, M>{P, fe2_from<N>(b3_mont)};
  } else {
    return fp2_pair<N, NR, M>(P, b3_mont);
  }
}

// The chain kernel over `chain` into the lane-major scratch `lane`, then
// the raw buckets repacked into bx, by, bz (m null), or K2m: merge.cuh's
// tree over `tree` on the lane-major buckets into the three (K, W, B, 1)
// arrays of m, with `far` its scratch.
template <class FC, class FT>
int insert_run(const FC& chain, const FT& tree, const void* off,
               const void* ent, int wide, const void* rec, void* const* lane,
               void* bx, void* by, void* bz, int W, int T, int L, int B,
               void* const* m, void* far, cudaStream_t s) {
  void* const rx = m == nullptr ? bx : nullptr;  // null: no repack
  const int rc = chain_launch(off, ent, wide, rec, lane, rx, by, bz, W, T, L,
                              B, chain, s);
  if (rc != 0 || m == nullptr) return rc;
  const long long n = (long long)W * B;
  const LaneRows in{{(const uint32_t*)lane[0], (const uint32_t*)lane[1],
                     (const uint32_t*)lane[2]},
                    0, n, L, B, ChainShape<FC>::kLaneWords};
  const Rows out{{(uint32_t*)m[0], (uint32_t*)m[1], (uint32_t*)m[2]},
                 (size_t)n, 0};
  return merge_launch<true>(in, out, (uint32_t*)far, tree, s);
}

// K2 after the sort: off and ent from bucket_lists (wide as there), rec
// the point records (T * L, 3, K) words, lane three (W, L, B, Kp) scratch
// arrays for the raw buckets (Kp = lane_words).  kmul: the product this
// library was built for ((int)M), checked; n32: its width N, checked;
// (k, b3, b3_mont): one of merge.cuh's on_branch branches.  m null: the
// raw buckets into bx, by, bz (K, W, B, L); else K2m, the lane totals
// into the three (K, W, B, 1) arrays of m, merge.cuh's tree over `lane`
// (bx, by, bz unused) with `far`, W * B * merge_far_words(k, L) words of
// scratch (null when that is 0).
template <Mul M, int N>
int insert_entry(int kmul, const void* off, const void* ent, int wide,
                 const void* rec, void* const* lane, void* bx, void* by,
                 void* bz, int W, int T, int L, int B, int n32, int k, int b3,
                 const uint32_t* b3_mont, const uint32_t* p,
                 const uint32_t* one_mont, uint32_t inv, void* const* m,
                 void* far, int device, void* stream) {
  if (kmul != (int)M || n32 != N || W < 0 || T < 0 || L < 0 || B <= 0 ||
      (wide != 0 && wide != 1) || lane == nullptr)
    return (int)cudaErrorInvalidValue;
  if (on_branch<N>(k, b3, b3_mont, [](auto, auto) { return 0; }) != 0)
    return (int)cudaErrorInvalidValue;
  if (m == nullptr && (bx == nullptr || by == nullptr || bz == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m != nullptr && (L & (L - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  const FieldParams<N> P = field_params<N>(p, one_mont, inv);
  const cudaStream_t s = (cudaStream_t)stream;
  return on_branch<N>(k, b3, b3_mont, [&](auto K, auto B3) {
    constexpr int b = decltype(B3)::value;
    if constexpr (decltype(K)::value == 1) {
      const FpField<N, b, M> f{P};
      return insert_run(f, f, off, ent, wide, rec, lane, bx, by, bz, W, T,
                        L, B, m, far, s);
    } else {
      return insert_run(chain_field2<N, b, M>(P, b3_mont),
                        tree_field2<N, b, M>(P, b3_mont), off, ent, wide, rec,
                        lane, bx, by, bz, W, T, L, B, m, far, s);
    }
  });
}

// K6, the v1 insert at N limbs: G1 only (b3 one of on_branch's G1
// constants), CIOS, raw buckets (N, W, B, L), from the sort's lists, the
// point records and the lane-major scratch as K2 takes them: K2's G1
// branch (its chain kernel and repack) under K6's own entry point.
template <int N>
int insert_v1_entry(const void* off, const void* ent, int wide,
                    const void* rec, void* const* lane, void* bx, void* by,
                    void* bz, int W, int T, int L, int B, int n32, int b3,
                    const uint32_t* p, const uint32_t* one_mont, uint32_t inv,
                    int device, void* stream) {
  return insert_entry<Mul::Cios, N>((int)Mul::Cios, off, ent, wide, rec,
                                    lane, bx, by, bz, W, T, L, B, n32, 1, b3,
                                    nullptr, p, one_mont, inv, nullptr,
                                    nullptr, device, stream);
}

}  // namespace lff

// The C entry points `insert` and `merge_far_words` (merge.cuh) of one
// library, over the product M at LFF_N32 limbs.
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
    return lff::insert_entry<M, LFF_N32>(                                    \
        kmul, off, ent, wide, rec, lane, bx, by, bz, W, T, L, B, n32, k, b3, \
        b3_mont, p, one_mont, inv, m, far, device, stream);                  \
  }

// The C entry point `insert_v1` (K6) of the CIOS library at LFF_N32
// limbs.
#define LFF_INSERT_V1_ENTRY                                                  \
  extern "C" int insert_v1(const void* off, const void* ent, int wide,       \
                           const void* rec, void* const* lane, void* bx,     \
                           void* by, void* bz, int W, int T, int L, int B,   \
                           int n32, int b3, const uint32_t* p,               \
                           const uint32_t* one_mont, uint32_t inv,           \
                           int device, void* stream) {                       \
    return lff::insert_v1_entry<LFF_N32>(off, ent, wide, rec, lane, bx, by,  \
                                         bz, W, T, L, B, n32, b3, p,         \
                                         one_mont, inv, device, stream);     \
  }
