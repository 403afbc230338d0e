// insert.cu -- kernel K2: the MSM bucket insert.
//
// Replaces libff_tpu/msm/pallas_insert3.py:74 _insert_kernel (entry point
// insert_pallas3, :301), both branches: k = 1 (G1 over Fp) and k = 2 (G2
// over Fq2, whose madd runs on K4, fp2.cuh).  Same contract: signed
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
// Bound on an H100: the scattered bucket read-modify-write (48 words per
// G1 madd, 96 per G2 madd, one 32-byte sector each when the lanes' bucket
// indices differ) and the madd itself (11 Montgomery products for G1, 39
// base products for G2).  A G2 thread holds a 48-word bucket, a 32-word
// point and the Karatsuba temporaries, more than 255 registers, so ptxas
// spills to local memory (its -v lines are in the build log).  Sorting
// points by bucket is the later redesign that removes the scatter.
#include "formulas.cuh"

using namespace lff;

namespace {

template <class F>
__global__ void __launch_bounds__(128)
    insert_kernel(const int32_t* __restrict__ d,
                  const uint32_t* __restrict__ px,
                  const uint32_t* __restrict__ py,
                  const uint32_t* __restrict__ pneg,
                  const int32_t* __restrict__ pinf, uint32_t* bx,
                  uint32_t* by, uint32_t* bz, int W, int T, int L, int B,
                  F f) {
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
}

template <class F>
int launch(const void* d, const void* px, const void* py, const void* pneg,
           const void* pinf, void* bx, void* by, void* bz, int W, int T,
           int L, int B, const F& f, cudaStream_t s) {
  const int threads = 128;
  const long long blocks = ((long long)W * L + threads - 1) / threads;
  insert_kernel<F><<<(unsigned)blocks, threads, 0, s>>>(
      (const int32_t*)d, (const uint32_t*)px, (const uint32_t*)py,
      (const uint32_t*)pneg, (const int32_t*)pinf, (uint32_t*)bx,
      (uint32_t*)by, (uint32_t*)bz, W, T, L, B, f);
  return (int)cudaGetLastError();
}

}  // namespace

// k = 1: b3 must be 9 (alt_bn128 G1) and b3_mont is unused; k = 2: b3_mont
// holds the 16 Montgomery limbs of the Fq2 constant b3 (c0 then c1).
extern "C" int insert(const void* d, const void* px, const void* py,
                      const void* pneg, const void* pinf, void* bx, void* by,
                      void* bz, int W, int T, int L, int B, int n32, int k,
                      int b3, const uint32_t* b3_mont, const uint32_t* p,
                      const uint32_t* one_mont, uint32_t inv, int device,
                      void* stream) {
  if (n32 != 8 || W < 0 || T < 0 || L < 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (!(k == 1 && b3 == 9) && !(k == 2 && b3_mont != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  FieldParams<8> P{};
  for (int i = 0; i < 8; i++) {
    P.p[i] = p[i];
    P.one[i] = one_mont[i];
  }
  P.inv = inv;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    return launch(d, px, py, pneg, pinf, bx, by, bz, W, T, L, B,
                  FpField<9>{P}, s);
  Fp2Field f{P, {}};
  for (int i = 0; i < 8; i++) {
    f.b3.c0.v[i] = b3_mont[i];
    f.b3.c1.v[i] = b3_mont[8 + i];
  }
  return launch(d, px, py, pneg, pinf, bx, by, bz, W, T, L, B, f, s);
}
