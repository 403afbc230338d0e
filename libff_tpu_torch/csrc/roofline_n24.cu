// roofline_n24.cu -- K7b lone over 24-limb Fp (BW6-761's 761-bit Fq): one
// serial chain x <- mul(x, b) of `reps` products an element, from x = a,
// with nothing else in the thread, as roofline_n12.cu at 12 limbs.  At one
// element its time over reps is the latency of one lone dependent
// product: the step of the 24-limb latency chains (the Fermat ladder of
// K1e inv n24, the Horner scan of K3 scan g1 n24, both over fp.cuh's
// 24-limb CIOS, the one product here, variant 0).  Bound: latency, not
// the card's rates.  Its own translation unit, as the other 24-limb
// sources.
#include "fp.cuh"

using namespace lff;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lone_chain_n24_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b,
                          long long n, int reps, FieldParams<24> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  Fe<24> x = load<24>(a, n, e);
  const Fe<24> y = load<24>(b, n, e);
#pragma unroll 1
  for (int r = 0; r < reps; r++) x = mul(x, y, P);
  store<24>(out, n, e, x);
}

}  // namespace

// K7b lone at 24 limbs: out, a, b (24, n) canonical Montgomery limbs; one
// chain of `reps` CIOS products an element (variant 0, the only one)
extern "C" int mul_lone_chain_n24(int variant, void* out, const void* a,
                                  const void* b, long long n, int reps,
                                  int n32, const uint32_t* p, uint32_t inv,
                                  int device, void* stream) {
  if (n32 != 24 || n < 0 || reps < 0 || variant != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  lone_chain_n24_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, reps,
      field_params<24>(p, nullptr, inv));
  return (int)cudaGetLastError();
}
