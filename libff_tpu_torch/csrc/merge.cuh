// merge.cuh -- the lane tree of the MSM bucket merge, one warp per
// (window, bucket).  K5 (merge.cu) and the fused merge branch of K2
// (insert.cu) both run it.
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

}  // namespace lff
