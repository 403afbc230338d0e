// roofline_n12.cu -- K7b lone over 12-limb Fp (BLS12-381's, BLS12-377's
// Fq): one serial chain x <- mul(x, b) of `reps` products an element,
// from x = a, with nothing else in the thread, as roofline.cu's
// lone_chain_kernel at 8 limbs.  At one element its time over reps is the
// latency of one lone dependent product: the step of the 12-limb latency
// chains (the Fermat ladder of K1e inv n12, the Horner scan of K3 scan
// n12).  Bound: latency, not the card's rates.
//
// Two products, both giving the canonical residue: fp.cuh's CIOS (variant
// 0) and chain_mul.cuh's two-accumulator product (variant 1), which
// horner.cu runs at 12 limbs.  Its own translation unit, as the other
// 12-limb sources.
#include "chain_mul.cuh"

using namespace lff;

namespace {

constexpr int kThreads = 256;

template <int V>
__global__ void __launch_bounds__(kThreads)
    lone_chain_n12_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b,
                          long long n, int reps, FieldParams<12> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  Fe<12> x = load<12>(a, n, e);
  const Fe<12> y = load<12>(b, n, e);
#pragma unroll 1
  for (int r = 0; r < reps; r++) x = V == 0 ? mul(x, y, P) : mul_eo(x, y, P);
  store<12>(out, n, e, x);
}

}  // namespace

// K7b lone at 12 limbs: out, a, b (12, n) canonical Montgomery limbs; one
// chain of `reps` products an element, by fp.cuh's CIOS (variant 0) or
// chain_mul.cuh's mul_eo (variant 1)
extern "C" int mul_lone_chain_n12(int variant, void* out, const void* a,
                                  const void* b, long long n, int reps,
                                  int n32, const uint32_t* p, uint32_t inv,
                                  int device, void* stream) {
  if (n32 != 12 || n < 0 || reps < 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const FieldParams<12> P = field_params<12>(p, nullptr, inv);
  auto* o = (uint32_t*)out;
  auto* x = (const uint32_t*)a;
  auto* y = (const uint32_t*)b;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    lone_chain_n12_kernel<0><<<blocks, kThreads, 0, s>>>(o, x, y, n, reps, P);
  else
    lone_chain_n12_kernel<1><<<blocks, kThreads, 0, s>>>(o, x, y, n, reps, P);
  return (int)cudaGetLastError();
}
