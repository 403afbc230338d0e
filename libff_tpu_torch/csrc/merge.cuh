// merge.cuh -- the lane tree of the MSM bucket merge, one warp per
// (window, bucket), and kernel K5 over it.  K5 (merge.cu, merge_sos.cu,
// merge_sos2.cu) and the fused merge branch of K2 (insert.cuh) both run
// the tree.
//
// The order of additions is libff_tpu/msm/pallas_insert3.py:36
// _lane_merge's for the lanes that reach lane 0: level h = L/2, L/4, ...,
// 1 replaces lane l < h by rcb_add(P_l, P_(l+h)).  The TPU kernel's
// Ls-halving slices are the levels h >= 128 (lane s*128 + i pairs with
// lane (s + Ls/2)*128 + i), and its roll butterfly at stride s gives lane
// i rcb_add(P_i, P_(i+s)), of which lanes i < s reach lane 0: the levels
// h = 64 .. 1.  So lane 0's total is the TPU kernel's bit for bit, and is
// the same sequence of additions as the halving loop of
// pippenger._reduce_buckets.
#pragma once

#include "formulas.cuh"

namespace lff {

// Three limb-major coordinate arrays and the element index of lane 0 of
// one (window, bucket) row: lane l of coordinate c, limb k is at
// c[k * stride + row + l].
struct Rows {
  uint32_t* c[3];
  size_t stride;
  size_t row;
};

template <class F>
__device__ __forceinline__ Pt<F> load_pt(const Rows& r, size_t l) {
  return Pt<F>{F::load(r.c[0], r.stride, r.row + l),
               F::load(r.c[1], r.stride, r.row + l),
               F::load(r.c[2], r.stride, r.row + l)};
}

template <class F>
__device__ __forceinline__ void store_pt(const Rows& r, size_t l,
                                         const Pt<F>& p) {
  F::store(r.c[0], r.stride, r.row + l, p.x);
  F::store(r.c[1], r.stride, r.row + l, p.y);
  F::store(r.c[2], r.stride, r.row + l, p.z);
}

// The whole warp calls this for one row of L lanes (L a power of two).
// Level L/2 reads `in`, the later levels read and write `tmp` (lanes
// < L/2; `tmp` may be `in` itself, for a merge in place), and level 1
// writes the total to lane 0 of `out`.  Thread t of the warp takes the
// lanes l = t mod 32 of each level, so neighbouring threads touch
// neighbouring words; a lane written at level h is read at level h/2 by
// another thread, so __syncwarp() orders the levels.
template <class F>
__device__ __forceinline__ void warp_tree(const F& f, int lane, int L,
                                          const Rows& in, const Rows& tmp,
                                          const Rows& out) {
  if (L == 1) {
    if (lane == 0) store_pt<F>(out, 0, load_pt<F>(in, 0));
    return;
  }
  for (int h = L / 2; h >= 1; h >>= 1) {
    const Rows& src = (h == L / 2) ? in : tmp;
    const Rows& dst = (h == 1) ? out : tmp;
    for (int l = lane; l < h; l += 32)
      store_pt<F>(dst, l, rcb_add(f, load_pt<F>(src, l),
                                  load_pt<F>(src, (size_t)l + h)));
    __syncwarp();
  }
}

// Kernel K5: the lane merge of the MSM buckets.
//
// Replaces libff_tpu/msm/pallas_insert3.py:204 _merge_kernel (with
// _lane_merge, :36; entry point _merge_lanes_kernel_call, :250), both
// branches: k = 1 (G1 over Fp) and k = 2 (G2 over Fq2, on K4).  In: K2's
// raw projective buckets, coordinates (K, n, L) limb-major with n = W * B
// rows of L lanes, L any power of two (the TPU kernel needs L % 128 == 0
// for its (Ls, 128) tiles; the tree below is defined for every L).  Out:
// (K, n, 1), each row's lane total in warp_tree's order, equal to the
// TPU kernel's lane 0 bit for bit.  The input is not written.
//
// Design: one warp per row, four rows per block; warp_tree walks the
// levels, the first reading the input, the later ones a scratch array (K,
// n, L/2) per coordinate that the wrapper allocates (a G2 row of 1024
// lanes is 192 KB, so the tree does not fit in shared memory beside other
// blocks).  One launch computes the whole tree.  At L = 1024 a warp
// takes 16 + 8 + 4 + 2 + 1 full passes and 5 part-empty ones, 36 add times
// for 1023 adds, 89% of its threads busy.
//
// Bound on an H100: integer multiply issue.  n * (L - 1) complete adds of
// 12 (G1) or 42 (G2) Montgomery products, each 136 lo and 128 hi
// multiply-adds, at the issue rates K7c measures (issue_rates.cu: mul.lo
// about 61, mul.hi about 31 a clock per SM, 24 ps a product): about 1.2
// and 4.3 ms at (32 * 128, 1024), against 0.12 and 0.24 ms for the bytes
// (the input read once, 3 * K * 4 * n * L).  The operations bind.
//
// MsmConfig.kmul (pallas_insert3.py:251-256) picks the product: each of
// merge.cu (CIOS), merge_sos.cu and merge_sos2.cu instantiates the kernel
// for one product through LFF_MERGE_ENTRY.

constexpr int kMergeWarps = 4;  // rows per block

template <class F>
__global__ void __launch_bounds__(32 * kMergeWarps)
    merge_kernel(Rows in, Rows tmp, Rows out, long long n, int L, F f) {
  const long long g = blockIdx.x * (long long)kMergeWarps + threadIdx.x / 32;
  if (g >= n) return;  // whole warps leave; warp_tree syncs only its warp
  in.row = (size_t)g * L;
  tmp.row = (size_t)g * (L / 2);
  out.row = (size_t)g;
  warp_tree(f, threadIdx.x % 32, L, in, tmp, out);
}

template <class F>
int merge_launch(const Rows& in, const Rows& tmp, const Rows& out,
                 long long n, int L, const F& f, cudaStream_t s) {
  const long long blocks = (n + kMergeWarps - 1) / kMergeWarps;
  merge_kernel<F><<<(unsigned)blocks, 32 * kMergeWarps, 0, s>>>(in, tmp, out,
                                                                n, L, f);
  return (int)cudaGetLastError();
}

// K5.  kmul: the product this library was built for ((int)M), checked;
// b: the three input coordinates (K, n, L); s: three scratch arrays
// (K, n, L/2), unused (may be null) for L <= 2; o: three outputs (K, n, 1).
// k = 1: b3 must be 9 (alt_bn128 G1) and b3_mont is unused; k = 2: b3_mont
// holds the 16 Montgomery limbs of the Fq2 constant b3 (c0 then c1).
template <Mul M>
int merge_entry(int kmul, void* const* b, void* const* s, void* const* o,
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
  if (n == 0) return 0;
  Rows in{}, tmp{}, out{};
  for (int i = 0; i < 3; i++) {
    in.c[i] = (uint32_t*)b[i];
    tmp.c[i] = (uint32_t*)s[i];
    out.c[i] = (uint32_t*)o[i];
  }
  in.stride = (size_t)n * L;
  tmp.stride = (size_t)n * (L / 2);
  out.stride = (size_t)n;
  const FieldParams<8> P = field_params(p, one_mont, inv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (k == 1) return merge_launch(in, tmp, out, n, L, FpField<9, M>{P}, st);
  Fp2Field<M> f{P, {}};
  for (int i = 0; i < 8; i++) {
    f.b3.c0.v[i] = b3_mont[i];
    f.b3.c1.v[i] = b3_mont[8 + i];
  }
  return merge_launch(in, tmp, out, n, L, f, st);
}

}  // namespace lff

// The C entry point `merge_lanes` of one library, over the product M.
#define LFF_MERGE_ENTRY(M)                                                   \
  extern "C" int merge_lanes(int kmul, void* const* b, void* const* s,       \
                             void* const* o, long long n, int L, int n32,    \
                             int k, int b3, const uint32_t* b3_mont,         \
                             const uint32_t* p, const uint32_t* one_mont,    \
                             uint32_t inv, int device, void* stream) {       \
    return lff::merge_entry<M>(kmul, b, s, o, n, L, n32, k, b3, b3_mont, p,  \
                               one_mont, inv, device, stream);               \
  }
