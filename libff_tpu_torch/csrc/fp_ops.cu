// fp_ops.cu -- two elementwise kernels, one thread per element.
//
// K1e: prime-field add, sub and Montgomery mul over limb-major (8, n)
// arrays, or over g such arrays one after another ((g, 8, n): an Fq2
// array (2, 8, n) is two, and Fq2 add and sub act coefficient-wise).  The
// field work outside the group and insert kernels (the negated y of the
// MSM's points, proj_to_jacobian, to_affine, the Fermat inverse) runs
// here.  In the JAX package XLA fused those ops
// (libff_tpu/fields/fp.py:206-276); on the TPU the in-kernel form of the
// same arithmetic is libff_tpu/msm/pallas_insert.py:87 _KernelField, which
// this kernel shares through fp.cuh.
//
// K4e: Fq2 Karatsuba mul and complex sqr over (2, 8, n) arrays, on the
// Fq2 layer fp2.cuh that replaces libff_tpu/msm/pallas_insert.py:133
// _KernelField2 (K4).  It is how K4 is held against its plain version on
// the card; on the MSM path it runs in the G2 to_affine and
// proj_to_jacobian.
//
// Bound on an H100: memory for Fp add/sub/mul and Fq2 add/sub, multiply
// issue for the Fq2 products.  At the issue rates K7c measures
// (issue_rates.cu: mul.lo about 61, mul.hi about 31 a clock per SM), an Fp
// product's 136 lo and 128 hi multiply-adds take about 24 ps of the
// card, less than its 96 bytes at 3.35 TB/s (29 ps); an Fq2 product's
// three take about 73 ps against 57 ps for its 192 bytes.  Limb-major
// layout makes every limb load a coalesced 128-byte warp transaction.
#include "fp2.cuh"

using namespace lff;

namespace {

enum Op { kAdd = 0, kSub = 1, kMul = 2 };

// element e of group g at column e of the (8, n) array at out + g*8*n
template <int OP>
__global__ void __launch_bounds__(256)
    fp_elementwise(uint32_t* out, const uint32_t* a, const uint32_t* b,
                   long long n, long long total, FieldParams<8> P) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long off = (t / n) * 8 * n;
  const long long e = t % n;
  const Fe<8> x = load<8>(a + off, n, e);
  const Fe<8> y = load<8>(b + off, n, e);
  Fe<8> r;
  if constexpr (OP == kAdd) {
    r = add(x, y, P);
  } else if constexpr (OP == kSub) {
    r = sub(x, y, P);
  } else {
    r = mul(x, y, P);
  }
  store<8>(out + off, n, e, r);
}

template <bool SQR>
__global__ void __launch_bounds__(256)
    fp2_elementwise(uint32_t* out, const uint32_t* a, const uint32_t* b,
                    long long n, FieldParams<8> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const Fe2 x = load2(a, n, e);
  Fe2 r;
  if constexpr (SQR) {
    r = sqr(x, P);
  } else {
    r = mul(x, load2(b, n, e), P);
  }
  store2(out, n, e, r);
}

template <int OP>
int launch(void* out, const void* a, const void* b, long long n, int groups,
           int n32, const uint32_t* p, uint32_t inv, int device,
           void* stream) {
  if (n32 != 8 || n < 0 || groups < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = n * groups;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  fp_elementwise<OP><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, total,
      field_params(p, nullptr, inv));
  return (int)cudaGetLastError();
}

template <bool SQR>
int launch2(void* out, const void* a, const void* b, long long n, int n32,
            const uint32_t* p, uint32_t inv, int device, void* stream) {
  if (n32 != 8 || n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fp2_elementwise<SQR><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n,
      field_params(p, nullptr, inv));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1e: n elements in each of `groups` (8, n) arrays
int fp_add(void* out, const void* a, const void* b, long long n, int groups,
           int n32, const uint32_t* p, uint32_t inv, int device,
           void* stream) {
  return launch<kAdd>(out, a, b, n, groups, n32, p, inv, device, stream);
}

int fp_sub(void* out, const void* a, const void* b, long long n, int groups,
           int n32, const uint32_t* p, uint32_t inv, int device,
           void* stream) {
  return launch<kSub>(out, a, b, n, groups, n32, p, inv, device, stream);
}

int fp_mul(void* out, const void* a, const void* b, long long n, int groups,
           int n32, const uint32_t* p, uint32_t inv, int device,
           void* stream) {
  return launch<kMul>(out, a, b, n, groups, n32, p, inv, device, stream);
}

// K4e: n Fq2 elements, (2, 8, n) arrays; fq2_sqr ignores b
int fq2_mul(void* out, const void* a, const void* b, long long n, int n32,
            const uint32_t* p, uint32_t inv, int device, void* stream) {
  return launch2<false>(out, a, b, n, n32, p, inv, device, stream);
}

int fq2_sqr(void* out, const void* a, const void* b, long long n, int n32,
            const uint32_t* p, uint32_t inv, int device, void* stream) {
  return launch2<true>(out, a, b, n, n32, p, inv, device, stream);
}

}  // extern "C"
