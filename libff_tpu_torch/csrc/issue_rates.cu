// issue_rates.cu -- kernel K7c: issue rates of the card's 32-bit integer
// instructions, the measurements behind the multiply bound that
// chip_smoke.py charges every field kernel.
//
// Replaces profile/vpu_issue.py:53 _bench (its pallas_call at :74), the
// TPU harness that measured its VPU's issue rates per op class.  One
// small kernel per body, templated on the body; each thread takes
// elements e (a grid-stride loop), runs R op groups on registers seeded
// from a[e] and b[e], and writes one folded word.  Bodies:
//   0 mul_lo   8 independent chains x <- mul.lo(x, b)
//   1 mul_hi   8 independent chains x <- mul.hi(x, b)
//   2 carry    fp.cuh's carry-chain rows as CIOS runs them: t[0..7] +=
//              lo(a * y_j) on mad.lo.cc/madc.lo.cc into t8, t9, then
//              t[1..8] += hi(a * y_j) on mad.hi.cc/madc.hi.cc into t9;
//              16 IMADs a group, serial through the carry flag
//   3 cheap    8 independent chains x <- ((x + b) & 0xFFFF) >> 1
//   4 mac      vpu_issue.py's group p = lo*b; lo += p & 0xFFFF; hi +=
//              p >> 16 on 4 accumulator pairs (1 multiply, 4 cheap ops)
//   5-8 chain  K = 1, 2, 4, 8 interleaved serial chains x <- mad.lo(x, b, a)
// Launched with one element a thread and 256-thread blocks (full
// occupancy), or with one 128-thread block per SM (4 warps a SM, one a
// scheduler), where a serial chain shows its latency.  Every op is inline
// PTX (bench_ops.cuh, fp.cuh's rows), so what is timed is what was
// written.  Bound: operations (R ops against 8 bytes an element).
#include "bench_ops.cuh"
#include "fp.cuh"

using namespace lff;

namespace {

// K interleaved chains of op over R / K steps, folded by xor
template <int K, class Op>
__device__ __forceinline__ uint32_t chains(uint32_t a, int R, Op op) {
  uint32_t x[K];
#pragma unroll
  for (int i = 0; i < K; i++) x[i] = a + i;
#pragma unroll 4
  for (int s = 0; s < R / K; s++) {
#pragma unroll
    for (int i = 0; i < K; i++) x[i] = op(x[i]);
  }
  uint32_t acc = x[0];
#pragma unroll
  for (int i = 1; i < K; i++) acc ^= x[i];
  return acc;
}

template <int BODY>
__device__ __forceinline__ uint32_t body(uint32_t a, uint32_t b, int R) {
  if constexpr (BODY == 0) {
    return chains<8>(a, R, [b](uint32_t x) { return op_mul_lo(x, b); });
  } else if constexpr (BODY == 1) {
    return chains<8>(a, R, [b](uint32_t x) { return op_mul_hi(x, b); });
  } else if constexpr (BODY == 2) {
    uint32_t t[10], y[8];
#pragma unroll
    for (int k = 0; k < 10; k++) t[k] = a + k;
#pragma unroll
    for (int j = 0; j < 8; j++) y[j] = b + j;
#pragma unroll 4
    for (int s = 0; s < R / 16; s++) {
      t[9] = mad_lo_row(t, a, y, 0);
      t[9] += mad_hi_row(t, a, y);
    }
    uint32_t acc = t[0];
#pragma unroll
    for (int k = 1; k < 10; k++) acc ^= t[k];
    return acc;
  } else if constexpr (BODY == 3) {
    return chains<8>(a, R, [b](uint32_t x) {
      return op_shr(op_and(op_add(x, b), 0xFFFFu), 1u);
    });
  } else if constexpr (BODY == 4) {
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      lo[k] = a + k;
      hi[k] = b + k;
    }
#pragma unroll 4
    for (int s = 0; s < R / 4; s++) {
#pragma unroll
      for (int k = 0; k < 4; k++) {
        const uint32_t p = op_mul_lo(lo[k], b);
        lo[k] = op_add(lo[k], op_and(p, 0xFFFFu));
        hi[k] = op_add(hi[k], op_shr(p, 16u));
      }
    }
    uint32_t acc = lo[0] ^ hi[0];
#pragma unroll
    for (int k = 1; k < 4; k++) acc ^= lo[k] ^ hi[k];
    return acc;
  } else {
    constexpr int K = 1 << (BODY - 5);
    return chains<K>(a, R, [a, b](uint32_t x) { return op_mad_lo(x, b, a); });
  }
}

template <int BODY>
__global__ void __launch_bounds__(256)
    issue_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b,
                 long long n, int R) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += step)
    out[e] = body<BODY>(a[e], b[e], R);
}

template <int BODY>
void launch(unsigned blocks, int threads, uint32_t* out, const uint32_t* a,
            const uint32_t* b, long long n, int R, cudaStream_t s) {
  issue_kernel<BODY><<<blocks, threads, 0, s>>>(out, a, b, n, R);
}

}  // namespace

// K7c: body 0..8 over out, a, b (n,) words, R op groups an element (R a
// multiple of 16).  blocks > 0: that many blocks of `threads` walk all n
// elements; blocks = 0: one element a thread.
extern "C" int issue_body(int body, void* out, const void* a, const void* b,
                          long long n, int R, int blocks, int threads,
                          int device, void* stream) {
  if (body < 0 || body > 8 || n < 0 || R < 0 || R % 16 != 0 || blocks < 0 ||
      threads < 32 || threads > 256 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned g =
      blocks > 0 ? (unsigned)blocks : (unsigned)((n + threads - 1) / threads);
  auto* o = (uint32_t*)out;
  auto* x = (const uint32_t*)a;
  auto* y = (const uint32_t*)b;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (body) {
    case 0: launch<0>(g, threads, o, x, y, n, R, s); break;
    case 1: launch<1>(g, threads, o, x, y, n, R, s); break;
    case 2: launch<2>(g, threads, o, x, y, n, R, s); break;
    case 3: launch<3>(g, threads, o, x, y, n, R, s); break;
    case 4: launch<4>(g, threads, o, x, y, n, R, s); break;
    case 5: launch<5>(g, threads, o, x, y, n, R, s); break;
    case 6: launch<6>(g, threads, o, x, y, n, R, s); break;
    case 7: launch<7>(g, threads, o, x, y, n, R, s); break;
    default: launch<8>(g, threads, o, x, y, n, R, s); break;
  }
  return (int)cudaGetLastError();
}
