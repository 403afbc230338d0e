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
// K4e: Fq2 Karatsuba mul and complex sqr over (2, N, n) arrays, on the
// Fq2 layer fp2.cuh that replaces libff_tpu/msm/pallas_insert.py:133
// _KernelField2 (K4).  It is how K4 is held against its plain version on
// the card; on the MSM path it runs in the G2 to_affine and
// proj_to_jacobian.  The caller passes the non-residue nr as a small
// negative integer, checked against those the width is built for (-1 at
// 8 limbs; -1 and -5 at 12, BLS12-381's and BLS12-377's Fq2).
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
// Widths: this file builds the 8-limb library (alt_bn128's Fq and Fq2,
// every entry); fp_ops_n12.cu builds every entry again at LFF_N32 = 12
// (BLS12-381's and BLS12-377's Fq and Fq2), its own translation unit.
// At 12 limbs a product is 588 IMADs (about 52 ps of the card) against
// 144 bytes (43 ps), and the inverse's ladder is 608 (BLS12-381) or 554
// (BLS12-377) dependent products.  fp_ops_n24.cu builds the Fp entries
// at LFF_N32 = 24 (BW6-761's Fq; its Fq2 entries refuse every call): a
// product is 2,328 IMADs (about 208 ps) against 288 bytes (86 ps), and
// the inverse's ladder 1,104 dependent products (q - 2 has 761 bits).
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

// whether this width builds the Fq2 entries: not at 24 limbs (BW6-761
// has no Fq2; its G2 lies over Fq)
constexpr bool kFq2 = N != 24;

// the Fq2 non-residues of this width's kernels: nr = -1 (alt_bn128,
// BLS12-381) at 8 and 12 limbs, -5 (BLS12-377) at 12
constexpr bool nr_built(int nr) {
  return kFq2 && (nr == -1 || (N == 12 && nr == -5));
}

template <bool SQR, int NR>
__global__ void __launch_bounds__(256)
    fp2_elementwise(uint32_t* out, const uint32_t* a, const uint32_t* b,
                    long long n, FieldParams<N> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const Fe2<N> x = load2<N>(a, n, e);
  Fe2<N> r;
  if constexpr (SQR) {
    r = sqr2<NR>(x, P);
  } else {
    r = mul2<NR>(x, load2<N>(b, n, e), P);
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

// K4e inv: t = a0^2 - nr a1^2 = a0^2 + |nr| a1^2, ti = t^(p-2), out =
// (a0 ti, -a1 ti)
template <int NR>
__global__ void __launch_bounds__(kInvThreads)
    fq2_inv_kernel(uint32_t* out, const uint32_t* a, long long n,
                   const __grid_constant__ InvParams q) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const FieldParams<N>& P = q.P;
  const Fe2<N> x = load2<N>(a, n, e);
  const Fe<N> t = add(mul(x.c0, x.c0, P),
                      mul_small<-NR, N>(mul(x.c1, x.c1, P), P), P);
  const Fe<N> ti = pow_ladder(t, q.e, q.top, P);
  store2(out, n, e, Fe2<N>{mul(x.c0, ti, P), neg(mul(x.c1, ti, P), P)});
}

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

template <bool SQR>
int launch2(void* out, const void* a, const void* b, long long n, int n32,
            int nr, const uint32_t* p, uint32_t inv, int device,
            void* stream) {
  if (n32 != N || n < 0 || !nr_built(nr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const cudaStream_t s = (cudaStream_t)stream;
  const FieldParams<N> P = field_params<N>(p, nullptr, inv);
  auto* o = (uint32_t*)out;
  auto* x = (const uint32_t*)a;
  auto* y = (const uint32_t*)b;
#if LFF_N32 != 24
  if (nr == -1) {
    fp2_elementwise<SQR, -1><<<blocks, threads, 0, s>>>(o, x, y, n, P);
  } else {
#if LFF_N32 == 12
    fp2_elementwise<SQR, -5><<<blocks, threads, 0, s>>>(o, x, y, n, P);
#endif
  }
#endif
  return (int)cudaGetLastError();
}

// FQ2: nr is the Fq2's non-residue (nr_built); otherwise unused
template <bool FQ2>
int launch_inv(void* out, const void* a, long long n, int n32, int nr,
               const uint32_t* p, uint32_t inv, const uint32_t* e, int top,
               int device, void* stream) {
  if (n32 != N || n < 0 || top < 1 || top >= 32 * N ||
      (FQ2 && !nr_built(nr)))
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
#if LFF_N32 != 24
    if (nr == -1) {
      fq2_inv_kernel<-1><<<(unsigned)blocks, kInvThreads, 0, s>>>(o, x, n, q);
    } else {
#if LFF_N32 == 12
      fq2_inv_kernel<-5><<<(unsigned)blocks, kInvThreads, 0, s>>>(o, x, n, q);
#endif
    }
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

// K4e: n Fq2 elements, (2, N, n) arrays, over Fq[u]/(u^2 - nr), nr = -1
// or -5 (nr_built); fq2_sqr ignores b
int fq2_mul(void* out, const void* a, const void* b, long long n, int n32,
            int nr, const uint32_t* p, uint32_t inv, int device,
            void* stream) {
  return launch2<false>(out, a, b, n, n32, nr, p, inv, device, stream);
}

int fq2_sqr(void* out, const void* a, const void* b, long long n, int n32,
            int nr, const uint32_t* p, uint32_t inv, int device,
            void* stream) {
  return launch2<true>(out, a, b, n, n32, nr, p, inv, device, stream);
}

// K1e inv: the inverses of n Fp elements, (N, n) arrays; e holds p - 2's
// N words and top the index of its leading bit
int fp_inv(void* out, const void* a, long long n, int n32, const uint32_t* p,
           uint32_t inv, const uint32_t* e, int top, int device,
           void* stream) {
  return launch_inv<false>(out, a, n, n32, 0, p, inv, e, top, device,
                           stream);
}

// K4e inv: the inverses of n Fq2 elements, (2, N, n) arrays, nr as K4e's
int fq2_inv(void* out, const void* a, long long n, int n32, int nr,
            const uint32_t* p, uint32_t inv, const uint32_t* e, int top,
            int device, void* stream) {
  return launch_inv<true>(out, a, n, n32, nr, p, inv, e, top, device,
                          stream);
}

}  // extern "C"
