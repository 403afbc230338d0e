// fp_ops.cu -- the elementwise field kernels, one thread per element.
//
// K1e: prime-field add, sub and Montgomery mul over limb-major (8, n)
// arrays, or over g such arrays one after another ((g, 8, n): an Fq2
// array (2, 8, n) is two, and Fq2 add and sub act coefficient-wise).  The
// field work outside the group and insert kernels (the negated y of the
// MSM's points, proj_to_jacobian, to_affine) runs here.  In the JAX
// package XLA fused those ops (libff_tpu/fields/fp.py:206-276); on the
// TPU the in-kernel form of the same arithmetic is
// libff_tpu/msm/pallas_insert.py:87 _KernelField, which this kernel shares
// through fp.cuh.
//
// K4e: Fq2 Karatsuba mul and complex sqr over (2, 8, n) arrays, on the
// Fq2 layer fp2.cuh that replaces libff_tpu/msm/pallas_insert.py:133
// _KernelField2 (K4).  It is how K4 is held against its plain version on
// the card; on the MSM path it runs in the G2 to_affine and
// proj_to_jacobian.
//
// K1e inv and K4e inv: the Fermat inverse a^(p-2) of n Fp elements
// (libff_tpu/fields/fp.py:465-468, the lax.scan of pow_static at :447-463
// under jit) and the Fq2 inverse (a0 - a1 u) / (a0^2 - nr a1^2)
// (libff_tpu/fields/tower.py:301-307), each in one launch, whatever n.
// Each thread runs fp.cuh's pow_ladder over the exponent's bits in
// registers; the host passes p - 2's words and its leading bit.  Both map
// 0 to 0.  On the MSM path each runs once, on the one element of
// to_affine, so what bounds it there is the latency of 362 dependent CIOS
// products (alt_bn128's Fq), not the card's issue rate: the launch
// replaces 362 K1e launches and the Python between them.  At many
// elements the multiplies bound it (362 products an element against 64
// bytes moved).
//
// Widths: this file builds the 8-limb library (alt_bn128's Fq, every
// entry); fp_ops_n12.cu builds K1e and K1e inv again at LFF_N32 = 12
// (BLS12-381's and BLS12-377's Fq), its own translation unit.  The Fq2
// entries are 8-limb only.  At 12 limbs a product is 588 IMADs (about
// 52 ps of the card) against 144 bytes (43 ps), and the inverse's ladder
// is 608 (BLS12-381) or 554 (BLS12-377) dependent products.
//
// Bound on an H100: memory for Fp add/sub/mul and Fq2 add/sub, multiply
// issue for the Fq2 products.  At the issue rates K7c measures
// (issue_rates.cu: mul.lo about 61, mul.hi about 31 a clock per SM), an Fp
// product's 136 lo and 128 hi multiply-adds take about 24 ps of the
// card, less than its 96 bytes at 3.35 TB/s (29 ps); an Fq2 product's
// three take about 73 ps against 57 ps for its 192 bytes.  Limb-major
// layout makes every limb load a coalesced 128-byte warp transaction.
#include "fp2.cuh"

// the limb count of the library's field (8 unless a width's own source
// sets it before including this file)
#ifndef LFF_N32
#define LFF_N32 8
#endif

using namespace lff;

namespace {

enum Op { kAdd = 0, kSub = 1, kMul = 2 };

constexpr int N = LFF_N32;

// element e of group g at column e of the (N, n) array at out + g*N*n
template <int OP>
__global__ void __launch_bounds__(256)
    fp_elementwise(uint32_t* out, const uint32_t* a, const uint32_t* b,
                   long long n, long long total, FieldParams<N> P) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long off = (t / n) * N * n;
  const long long e = t % n;
  const Fe<N> x = load<N>(a + off, n, e);
  const Fe<N> y = load<N>(b + off, n, e);
  Fe<N> r;
  if constexpr (OP == kAdd) {
    r = add(x, y, P);
  } else if constexpr (OP == kSub) {
    r = sub(x, y, P);
  } else {
    r = mul(x, y, P);
  }
  store<N>(out + off, n, e, r);
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

// the exponent of an inverse: p - 2 as 32-bit words, little-endian, and
// the index of its leading bit; with the field, one kernel parameter
struct InvParams {
  FieldParams<N> P;
  uint32_t e[N];
  int top;
};

constexpr int kInvThreads = 128;

// K1e inv.  __grid_constant__: the ladder indexes q.e by the bit, and
// reads it where the launch put it, with no copy in local memory.
__global__ void __launch_bounds__(kInvThreads)
    fp_inv_kernel(uint32_t* out, const uint32_t* a, long long n,
                  const __grid_constant__ InvParams q) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  store<N>(out, n, e, pow_ladder(load<N>(a, n, e), q.e, q.top, q.P));
}

#if LFF_N32 == 8

// K4e inv with nr = -1: t = a0^2 - nr a1^2 = a0^2 + a1^2, ti = t^(p-2),
// out = (a0 ti, -a1 ti)
__global__ void __launch_bounds__(kInvThreads)
    fq2_inv_kernel(uint32_t* out, const uint32_t* a, long long n,
                   const __grid_constant__ InvParams q) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const FieldParams<8>& P = q.P;
  const Fe2 x = load2(a, n, e);
  const Fe<8> t = add(mul(x.c0, x.c0, P), mul(x.c1, x.c1, P), P);
  const Fe<8> ti = pow_ladder(t, q.e, q.top, P);
  store2(out, n, e, Fe2{mul(x.c0, ti, P), neg(mul(x.c1, ti, P), P)});
}
#endif

template <int OP>
int launch(void* out, const void* a, const void* b, long long n, int groups,
           int n32, const uint32_t* p, uint32_t inv, int device,
           void* stream) {
  if (n32 != N || n < 0 || groups < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = n * groups;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  fp_elementwise<OP><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, total,
      field_params<N>(p, nullptr, inv));
  return (int)cudaGetLastError();
}

#if LFF_N32 == 8
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
#endif

template <bool FQ2>
int launch_inv(void* out, const void* a, long long n, int n32,
               const uint32_t* p, uint32_t inv, const uint32_t* e, int top,
               int device, void* stream) {
  if (n32 != N || n < 0 || top < 1 || top >= 32 * N)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  InvParams q;
  q.P = field_params<N>(p, nullptr, inv);
  for (int k = 0; k < N; k++) q.e[k] = e[k];
  q.top = top;
  const long long blocks = (n + kInvThreads - 1) / kInvThreads;
  auto* o = (uint32_t*)out;
  auto* x = (const uint32_t*)a;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (FQ2) {
#if LFF_N32 == 8
    fq2_inv_kernel<<<(unsigned)blocks, kInvThreads, 0, s>>>(o, x, n, q);
#endif
  } else {
    fp_inv_kernel<<<(unsigned)blocks, kInvThreads, 0, s>>>(o, x, n, q);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1e: n elements in each of `groups` (N, n) arrays; n32 must be N
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

#if LFF_N32 == 8
// K4e: n Fq2 elements, (2, 8, n) arrays; fq2_sqr ignores b
int fq2_mul(void* out, const void* a, const void* b, long long n, int n32,
            const uint32_t* p, uint32_t inv, int device, void* stream) {
  return launch2<false>(out, a, b, n, n32, p, inv, device, stream);
}

int fq2_sqr(void* out, const void* a, const void* b, long long n, int n32,
            const uint32_t* p, uint32_t inv, int device, void* stream) {
  return launch2<true>(out, a, b, n, n32, p, inv, device, stream);
}

#endif

// K1e inv: the inverses of n Fp elements, (N, n) arrays; e holds p - 2's
// N words and top the index of its leading bit
int fp_inv(void* out, const void* a, long long n, int n32, const uint32_t* p,
           uint32_t inv, const uint32_t* e, int top, int device,
           void* stream) {
  return launch_inv<false>(out, a, n, n32, p, inv, e, top, device, stream);
}

#if LFF_N32 == 8
// K4e inv: the inverses of n Fq2 elements, (2, 8, n) arrays
int fq2_inv(void* out, const void* a, long long n, int n32, const uint32_t* p,
            uint32_t inv, const uint32_t* e, int top, int device,
            void* stream) {
  return launch_inv<true>(out, a, n, n32, p, inv, e, top, device, stream);
}
#endif

}  // extern "C"
