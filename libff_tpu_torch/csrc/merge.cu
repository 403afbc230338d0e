// merge.cu -- kernel K5: the lane merge of the MSM buckets.
//
// Replaces libff_tpu/msm/pallas_insert3.py:204 _merge_kernel (with
// _lane_merge, :36; entry point _merge_lanes_kernel_call, :250), both
// branches: k = 1 (G1 over Fp) and k = 2 (G2 over Fq2, on K4).  In: K2's
// raw projective buckets, coordinates (K, n, L) limb-major with n = W * B
// rows of L lanes, L any power of two (the TPU kernel needs L % 128 == 0
// for its (Ls, 128) tiles; the tree below is defined for every L).  Out:
// (K, n, 1), each row's lane total in the order of merge.cuh, equal to the
// TPU kernel's lane 0 bit for bit.  The input is not written.
//
// Design: one warp per row, four rows per block; merge.cuh's warp_tree
// walks the levels, the first reading the input, the later ones a scratch
// array (K, n, L/2) per coordinate that the wrapper allocates (a G2 row of
// 1024 lanes is 192 KB, so the tree does not fit in shared memory beside
// other blocks).  One launch computes the whole tree.  At L = 1024 a warp
// takes 16 + 8 + 4 + 2 + 1 full passes and 5 part-empty ones, 36 add times
// for 1023 adds, 89% of its threads busy.
//
// Bound on an H100: integer multiply issue.  n * (L - 1) complete adds of
// 12 (G1) or 42 (G2) Montgomery products at 264 IMADs: 0.80 and 2.78 ms at
// (32 * 128, 1024) and 16.7 T IMAD/s, against 0.12 and 0.24 ms for the
// bytes (the input read once, 3 * K * 4 * n * L).  The operations bind.
#include "merge.cuh"

using namespace lff;

namespace {

constexpr int kWarps = 4;  // rows per block

template <class F>
__global__ void __launch_bounds__(32 * kWarps)
    merge_kernel(Rows in, Rows tmp, Rows out, long long n, int L, F f) {
  const long long g = blockIdx.x * (long long)kWarps + threadIdx.x / 32;
  if (g >= n) return;  // whole warps leave; warp_tree syncs only its warp
  in.row = (size_t)g * L;
  tmp.row = (size_t)g * (L / 2);
  out.row = (size_t)g;
  warp_tree(f, threadIdx.x % 32, L, in, tmp, out);
}

template <class F>
int launch(const Rows& in, const Rows& tmp, const Rows& out, long long n,
           int L, const F& f, cudaStream_t s) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  merge_kernel<F><<<(unsigned)blocks, 32 * kWarps, 0, s>>>(in, tmp, out, n,
                                                           L, f);
  return (int)cudaGetLastError();
}

}  // namespace

// b: the three input coordinates (K, n, L); s: three scratch arrays
// (K, n, L/2), unused (may be null) for L <= 2; o: three outputs (K, n, 1).
// k = 1: b3 must be 9 (alt_bn128 G1) and b3_mont is unused; k = 2: b3_mont
// holds the 16 Montgomery limbs of the Fq2 constant b3 (c0 then c1).
extern "C" int merge_lanes(void* const* b, void* const* s, void* const* o,
                           long long n, int L, int n32, int k, int b3,
                           const uint32_t* b3_mont, const uint32_t* p,
                           const uint32_t* one_mont, uint32_t inv,
                           int device, void* stream) {
  if (n32 != 8 || n < 0 || L < 1 || (L & (L - 1)) != 0)
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
  FieldParams<8> P{};
  for (int i = 0; i < 8; i++) {
    P.p[i] = p[i];
    P.one[i] = one_mont[i];
  }
  P.inv = inv;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k == 1) return launch(in, tmp, out, n, L, FpField<9>{P}, st);
  Fp2Field f{P, {}};
  for (int i = 0; i < 8; i++) {
    f.b3.c0.v[i] = b3_mont[i];
    f.b3.c1.v[i] = b3_mont[8 + i];
  }
  return launch(in, tmp, out, n, L, f, st);
}
