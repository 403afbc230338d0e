// fp_ops.cu -- kernel K1e: elementwise prime-field add, sub and
// Montgomery mul over limb-major (8, n) arrays, one thread per element.
//
// The field work outside the group and insert kernels (the negated y of
// the MSM's points, proj_to_jacobian, to_affine, the Fermat inverse) runs
// here.  In the JAX package XLA fused those ops
// (libff_tpu/fields/fp.py:206-276); on the TPU the in-kernel form of the
// same arithmetic is libff_tpu/msm/pallas_insert.py:87 _KernelField, which
// this kernel shares through fp.cuh.
//
// Bound on an H100: memory for add/sub (three 32-byte rows per element),
// integer multiply issue for mul (136 IMADs per element).  Limb-major
// layout makes every limb load a coalesced 128-byte warp transaction.
#include "fp.cuh"

using namespace lff;

namespace {

enum Op { kAdd = 0, kSub = 1, kMul = 2 };

template <int OP>
__global__ void __launch_bounds__(256)
    fp_elementwise(uint32_t* out, const uint32_t* a, const uint32_t* b,
                   long long n, FieldParams<8> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const Fe<8> x = load<8>(a, n, e);
  const Fe<8> y = load<8>(b, n, e);
  Fe<8> r;
  if constexpr (OP == kAdd) {
    r = add(x, y, P);
  } else if constexpr (OP == kSub) {
    r = sub(x, y, P);
  } else {
    r = mul(x, y, P);
  }
  store<8>(out, n, e, r);
}

template <int OP>
int launch(void* out, const void* a, const void* b, long long n, int n32,
           const uint32_t* p, uint32_t inv, int device, void* stream) {
  if (n32 != 8 || n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  FieldParams<8> P{};
  for (int k = 0; k < 8; k++) P.p[k] = p[k];
  P.inv = inv;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fp_elementwise<OP><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fp_add(void* out, const void* a, const void* b, long long n, int n32,
           const uint32_t* p, uint32_t inv, int device, void* stream) {
  return launch<kAdd>(out, a, b, n, n32, p, inv, device, stream);
}

int fp_sub(void* out, const void* a, const void* b, long long n, int n32,
           const uint32_t* p, uint32_t inv, int device, void* stream) {
  return launch<kSub>(out, a, b, n, n32, p, inv, device, stream);
}

int fp_mul(void* out, const void* a, const void* b, long long n, int n32,
           const uint32_t* p, uint32_t inv, int device, void* stream) {
  return launch<kMul>(out, a, b, n, n32, p, inv, device, stream);
}

}  // extern "C"
