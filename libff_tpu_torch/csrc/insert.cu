// insert.cu -- kernel K2: the MSM bucket insert.
//
// Replaces libff_tpu/msm/pallas_insert3.py:74 _insert_kernel (entry point
// insert_pallas3, :301), G1 branch.  Same contract: signed digits
// d (W, T, L), affine points (8, T, L) with their negated y and an
// infinity flag (T, L); out: projective buckets (8, W, B, L), bucket
// |d| - 1 of lane l and window w accumulating +-P_(t*L + l) over t in
// order with the complete mixed add (formulas.rcb_madd_a0).  A zero digit
// or a point at infinity leaves the bucket as it is.  Buckets start as
// the identity (0, 1, 0) (pallas_insert3.py:91-97).  Order and formula
// are the TPU kernel's, so the raw buckets are bit-identical to it.
//
// Design: one thread per (window, lane) owns that lane's B buckets and
// walks t = 0..T-1; nothing is shared between threads, so no atomics and
// no ordering across blocks are needed (the TPU kernel's sequential grid
// axis becomes the thread's loop).  Buckets stay in device memory, limb
// index outermost then (w, b, l), so the lanes of a warp touching the
// same bucket index read neighbouring words.
//
// Bound on an H100: the scattered bucket read-modify-write (48 words per
// madd, one 32-byte sector each when the lanes' bucket indices differ)
// and the 11-product madd.  Sorting points by bucket is the later
// redesign that removes the scatter.
#include "formulas.cuh"

using namespace lff;

namespace {

template <int B3>
__global__ void __launch_bounds__(128)
    insert_kernel(const int32_t* __restrict__ d,
                  const uint32_t* __restrict__ px,
                  const uint32_t* __restrict__ py,
                  const uint32_t* __restrict__ pneg,
                  const int32_t* __restrict__ pinf, uint32_t* bx,
                  uint32_t* by, uint32_t* bz, int W, int T, int L, int B,
                  FieldParams<8> P) {
  const long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (gid >= (long long)W * L) return;
  const int w = (int)(gid / L);
  const int l = (int)(gid % L);
  const size_t bstride = (size_t)W * B * L;  // limb stride of the buckets
  const size_t base = (size_t)w * B * L + l;  // bucket b at base + b * L
  const size_t pstride = (size_t)T * L;      // limb stride of the points

  const Fe<8> z = zero<8>(), o = one(P);
  for (int b = 0; b < B; b++) {
    const size_t e = base + (size_t)b * L;
    store<8>(bx, bstride, e, z);
    store<8>(by, bstride, e, o);
    store<8>(bz, bstride, e, z);
  }
  for (int t = 0; t < T; t++) {
    const int dig = d[((size_t)w * T + t) * L + l];
    const size_t pe = (size_t)t * L + l;
    if (dig == 0 || pinf[pe] != 0) continue;
    const int idx = min(abs(dig) - 1, B - 1);
    const size_t e = base + (size_t)idx * L;
    const Pt<8> cur{load<8>(bx, bstride, e), load<8>(by, bstride, e),
                    load<8>(bz, bstride, e)};
    const Fe<8> qx = load<8>(px, pstride, pe);
    const Fe<8> qy = load<8>(dig < 0 ? pneg : py, pstride, pe);
    const Pt<8> r = rcb_madd<B3>(cur, qx, qy, P);
    store<8>(bx, bstride, e, r.x);
    store<8>(by, bstride, e, r.y);
    store<8>(bz, bstride, e, r.z);
  }
}

}  // namespace

extern "C" int insert(const void* d, const void* px, const void* py,
                      const void* pneg, const void* pinf, void* bx, void* by,
                      void* bz, int W, int T, int L, int B, int n32, int b3,
                      const uint32_t* p, const uint32_t* one_mont,
                      uint32_t inv, int device, void* stream) {
  if (n32 != 8 || b3 != 9 || W < 0 || T < 0 || L < 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long threads_total = (long long)W * L;
  if (threads_total == 0) return 0;
  FieldParams<8> P{};
  for (int k = 0; k < 8; k++) {
    P.p[k] = p[k];
    P.one[k] = one_mont[k];
  }
  P.inv = inv;
  const int threads = 128;
  const long long blocks = (threads_total + threads - 1) / threads;
  insert_kernel<9><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)d, (const uint32_t*)px, (const uint32_t*)py,
      (const uint32_t*)pneg, (const int32_t*)pinf, (uint32_t*)bx,
      (uint32_t*)by, (uint32_t*)bz, W, T, L, B, P);
  return (int)cudaGetLastError();
}
