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
// (pallas_insert3.py:91-97).  Order and formula are the TPU kernel's, so
// the raw buckets are bit-identical to it whatever its time block tb was.
//
// Design: one thread per (window, lane) owns that lane's B buckets and
// walks t = 0..T-1; nothing is shared between threads, so no atomics and
// no ordering across blocks are needed (the TPU kernel's sequential grid
// axis becomes the thread's loop).  Buckets stay in device memory, limb
// index outermost then (w, b, l), so the lanes of a warp touching the
// same bucket index read neighbouring words.
//
// The fused merge (merge=True, pallas_insert3.py:172-201): after the walk
// over t the lane axis is tree-summed in the same launch, in merge.cuh's
// order, and the totals go to (K, W, B, 1).  L % 128 == 0, as
// insert_pallas3 requires, puts every block in one window.  Each block
// fences its stores and counts itself in a per-window counter (zeroed by
// the wrapper); the block that arrives last in window w merges that
// window's buckets in place, one warp per bucket (CUDA's
// threadFenceReduction pattern).  No second launch and no host round
// trip; but only W blocks run the merge, so it adds about W * B * (L - 1)
// adds on W * 4 warps to the insert's time.
//
// MsmConfig.kmul (pallas_insert3.py:302, :339, :343) picks the product:
// each of insert.cu (CIOS, with K6), insert_sos.cu and insert_sos2.cu
// instantiates this header for one product through LFF_INSERT_ENTRY, so
// the three compile in parallel; every product gives the same buckets.
//
// Bound on an H100: the scattered bucket read-modify-write (48 words per
// G1 madd, 96 per G2 madd, one 32-byte sector each when the lanes' bucket
// indices differ) and the madd itself (11 Montgomery products for G1, 39
// base products for G2).  A G2 thread holds a 48-word bucket, a 32-word
// point and the Karatsuba temporaries, more than 255 registers, so ptxas
// spills to local memory (its -v lines are in the build log).  Sorting
// points by bucket is the later redesign that removes the scatter.
#pragma once

#include "merge.cuh"

namespace lff {

constexpr int kInsertThreads = 128;

template <class F, bool MERGE>
__global__ void __launch_bounds__(kInsertThreads)
    insert_kernel(const int32_t* __restrict__ d,
                  const uint32_t* __restrict__ px,
                  const uint32_t* __restrict__ py,
                  const uint32_t* __restrict__ pneg,
                  const int32_t* __restrict__ pinf, uint32_t* bx,
                  uint32_t* by, uint32_t* bz, int W, int T, int L, int B,
                  int* counter, Rows merged, F f) {
  using E = typename F::E;
  const long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (gid >= (long long)W * L) return;
  const int w = (int)(gid / L);
  const int l = (int)(gid % L);
  const size_t bstride = (size_t)W * B * L;  // limb stride of the buckets
  const size_t base = (size_t)w * B * L + l;  // bucket b at base + b * L
  const size_t pstride = (size_t)T * L;      // limb stride of the points

  const E z = f.zero(), o = f.one();
  for (int b = 0; b < B; b++) {
    const size_t e = base + (size_t)b * L;
    F::store(bx, bstride, e, z);
    F::store(by, bstride, e, o);
    F::store(bz, bstride, e, z);
  }
  for (int t = 0; t < T; t++) {
    const int dig = d[((size_t)w * T + t) * L + l];
    const size_t pe = (size_t)t * L + l;
    if (dig == 0 || pinf[pe] != 0) continue;
    const int idx = min(abs(dig) - 1, B - 1);
    const size_t e = base + (size_t)idx * L;
    const Pt<F> cur{F::load(bx, bstride, e), F::load(by, bstride, e),
                    F::load(bz, bstride, e)};
    const E qx = F::load(px, pstride, pe);
    const E qy = F::load(dig < 0 ? pneg : py, pstride, pe);
    const Pt<F> r = rcb_madd(f, cur, qx, qy);
    F::store(bx, bstride, e, r.x);
    F::store(by, bstride, e, r.y);
    F::store(bz, bstride, e, r.z);
  }
  if constexpr (MERGE) {
    // every thread of the block is live (W * L % kInsertThreads == 0) and
    // in window w.  Release: the block's bucket stores, then the count.
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(&counter[w], 1) == L / kInsertThreads - 1;
      __threadfence();  // acquire: the other blocks' stores, then reads
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const Rows rows{{bx, by, bz}, bstride, 0};
    for (int b = threadIdx.x / 32; b < B; b += kInsertThreads / 32) {
      Rows row = rows, out = merged;
      row.row = ((size_t)w * B + b) * L;
      out.row = (size_t)w * B + b;
      warp_tree(f, threadIdx.x % 32, L, row, row, out);
    }
  }
}

template <class F>
int insert_launch(const void* d, const void* px, const void* py,
                  const void* pneg, const void* pinf, void* bx, void* by,
                  void* bz, int W, int T, int L, int B, int* counter,
                  const Rows& merged, const F& f, cudaStream_t s) {
  const long long blocks =
      ((long long)W * L + kInsertThreads - 1) / kInsertThreads;
  auto kernel = &insert_kernel<F, false>;
  if (counter != nullptr) kernel = &insert_kernel<F, true>;
  kernel<<<(unsigned)blocks, kInsertThreads, 0, s>>>(
      (const int32_t*)d, (const uint32_t*)px, (const uint32_t*)py,
      (const uint32_t*)pneg, (const int32_t*)pinf, (uint32_t*)bx,
      (uint32_t*)by, (uint32_t*)bz, W, T, L, B, counter, merged, f);
  return (int)cudaGetLastError();
}

// K2.  kmul: the product this library was built for ((int)M), checked;
// k = 1: b3 must be 9 (alt_bn128 G1) and b3_mont is unused; k = 2:
// b3_mont holds the 16 Montgomery limbs of the Fq2 constant b3 (c0 then
// c1).  counter null: the raw buckets; else the fused merge, with counter
// W zeroed ints and m three (K, W, B, 1) outputs, and L % 128 == 0.
template <Mul M>
int insert_entry(int kmul, const void* d, const void* px, const void* py,
                 const void* pneg, const void* pinf, void* bx, void* by,
                 void* bz, int W, int T, int L, int B, int n32, int k, int b3,
                 const uint32_t* b3_mont, const uint32_t* p,
                 const uint32_t* one_mont, uint32_t inv, int* counter,
                 void* const* m, int device, void* stream) {
  if (kmul != (int)M || n32 != 8 || W < 0 || T < 0 || L < 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (!(k == 1 && b3 == 9) && !(k == 2 && b3_mont != nullptr))
    return (int)cudaErrorInvalidValue;
  if (counter != nullptr && (L % kInsertThreads != 0 || m == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  Rows merged{};
  if (counter != nullptr) {
    for (int i = 0; i < 3; i++) merged.c[i] = (uint32_t*)m[i];
    merged.stride = (size_t)W * B;
  }
  const FieldParams<8> P = field_params(p, one_mont, inv);
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    return insert_launch(d, px, py, pneg, pinf, bx, by, bz, W, T, L, B,
                         counter, merged, FpField<9, M>{P}, s);
  Fp2Field<M> f{P, {}};
  for (int i = 0; i < 8; i++) {
    f.b3.c0.v[i] = b3_mont[i];
    f.b3.c1.v[i] = b3_mont[8 + i];
  }
  return insert_launch(d, px, py, pneg, pinf, bx, by, bz, W, T, L, B,
                       counter, merged, f, s);
}

}  // namespace lff

// The C entry point `insert` of one library, over the product M.
#define LFF_INSERT_ENTRY(M)                                                  \
  extern "C" int insert(int kmul, const void* d, const void* px,             \
                        const void* py, const void* pneg, const void* pinf,  \
                        void* bx, void* by, void* bz, int W, int T, int L,   \
                        int B, int n32, int k, int b3,                       \
                        const uint32_t* b3_mont, const uint32_t* p,          \
                        const uint32_t* one_mont, uint32_t inv,              \
                        int* counter, void* const* m, int device,            \
                        void* stream) {                                      \
    return lff::insert_entry<M>(kmul, d, px, py, pneg, pinf, bx, by, bz, W,  \
                                T, L, B, n32, k, b3, b3_mont, p, one_mont,   \
                                inv, counter, m, device, stream);            \
  }
