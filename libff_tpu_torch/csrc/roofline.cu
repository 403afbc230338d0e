// roofline.cu -- the field-mul benches: kernels K7a, K7b and K7d.
//
// K7a replaces profile/roofline.py:65 _sol_pallas_mul_time (its
// pallas_call at :108): the no-stall bound of a Montgomery product, the op
// mix of the product with its dependences removed.  The TPU version runs
// the 16-bit CIOS mix of fields/fp.py; the mix copied here is that of
// fp.cuh's CIOS mul on 32-bit limbs.  Per synthetic product: 8 rows, each
// of 8 mad.lo and 8 mad.hi of the row's limb, its quotient's mul.lo, and
// 8 mad.lo and 8 mad.hi of the quotient (136 lo, 128 hi: the 264 IMADs of
// fp.cuh), 6 adds per row (the 48 addc), then 9 subtracts, one compare
// and 8 selects.  The multiply-adds go to 16 accumulators (8 lo, 8 hi)
// with no carry flag between them, so each thread has 16 independent
// chains; every op is inline PTX on values from the inputs (bench_ops.cuh)
// and all of them flow into the output.  One thread per element, `reps`
// synthetic products each.  Bound: operations (reps * 264 IMADs against
// 96 bytes an element).
//
// K7b replaces profile/roofline.py:158 _real_pallas_mul_time (call :193):
// real Montgomery products, `chains` = 8 independent serial chains
// x <- mul(x, b) per element, started from F.add of the inputs as
// roofline.py:176 does (chains 1..7 start from the same value, as there),
// summed with F.add and written once.  One thread per element; built for
// each of fp.cuh's three products.  Bound: operations (32 products of 264
// or 272 IMADs against 96 bytes).
//
// K7b lone: one serial chain x <- mul(x, b) of `reps` CIOS products an
// element, from x = a, with nothing else in the thread.  At one element
// its time over reps is the latency of one lone dependent product, the
// step of every latency chain of the port (the Fermat ladder of K1e inv
// and K4e inv, the Horner scan of K3): a chain of k such products cannot
// take less than k times it.  Bound: latency, not the card's rates.
//
// K7d replaces profile/g2_phases.py:62 fq2_mul_ns (call :95): K7b over
// Fq2 (fp2.cuh's Karatsuba product, nr = p - 1), 4 chains, over each base
// product.  Bound: operations (8 Fq2 products of 3 base products against
// 192 bytes).
//
// What the TPU kernels did with their (Ls, 128) tiles and sequential grid,
// one thread per element does here: nothing is shared, the chains give
// each thread the independent work that hides the multiply latency, and
// the card's warps hide the rest.
#include "bench_ops.cuh"
#include "fp2.cuh"

using namespace lff;

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;     // K7b: products in flight per element
constexpr int kChains2 = 4;    // K7d

__global__ void __launch_bounds__(kThreads)
    sol_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b,
               long long n, int reps) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t x[8], y[8], lo[8], hi[8], s[6];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    x[k] = a[k * n + e];
    y[k] = b[k * n + e];
    lo[k] = x[k];
    hi[k] = y[k];
  }
#pragma unroll
  for (int k = 0; k < 6; k++) s[k] = x[k];
#pragma unroll 1
  for (int r = 0; r < reps; r++) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
#pragma unroll
      for (int j = 0; j < 8; j++) lo[j] = op_mad_lo(x[i], y[j], lo[j]);
#pragma unroll
      for (int j = 0; j < 8; j++) hi[j] = op_mad_hi(x[i], y[j], hi[j]);
      const uint32_t m = op_mul_lo(x[i], y[7 - i]);
#pragma unroll
      for (int j = 0; j < 8; j++) lo[j] = op_mad_lo(m, y[j], lo[j]);
#pragma unroll
      for (int j = 0; j < 8; j++) hi[j] = op_mad_hi(m, y[j], hi[j]);
#pragma unroll
      for (int k = 0; k < 6; k++) s[k] = op_add(s[k], lo[k]);
    }
    uint32_t d[8];
#pragma unroll
    for (int k = 0; k < 8; k++) d[k] = op_sub(lo[k], hi[k]);
    const uint32_t d8 = op_sub(s[0], s[1]);
    // the final select: lo = (d8 == 0) ? d : lo
    asm volatile(
        "{\n\t.reg .pred q;\n\t"
        "setp.eq.u32 q, %8, 0;\n\t"
        "selp.b32 %0, %9, %0, q;\n\t"
        "selp.b32 %1, %10, %1, q;\n\t"
        "selp.b32 %2, %11, %2, q;\n\t"
        "selp.b32 %3, %12, %3, q;\n\t"
        "selp.b32 %4, %13, %4, q;\n\t"
        "selp.b32 %5, %14, %5, q;\n\t"
        "selp.b32 %6, %15, %6, q;\n\t"
        "selp.b32 %7, %16, %7, q;\n\t"
        "}"
        : "+r"(lo[0]), "+r"(lo[1]), "+r"(lo[2]), "+r"(lo[3]), "+r"(lo[4]),
          "+r"(lo[5]), "+r"(lo[6]), "+r"(lo[7])
        : "r"(d8), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]),
          "r"(d[5]), "r"(d[6]), "r"(d[7]));
  }
#pragma unroll
  for (int k = 0; k < 8; k++)
    out[k * n + e] = lo[k] ^ hi[k] ^ (k < 6 ? s[k] : 0u);
}

template <Mul M>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b,
                 long long n, int reps, FieldParams<8> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const Fe<8> x = load<8>(a, n, e), y = load<8>(b, n, e);
  Fe<8> xs[kChains];
  xs[0] = add(x, y, P);
#pragma unroll
  for (int k = 1; k < kChains; k++) xs[k] = add(x, add(y, x, P), P);
#pragma unroll 1
  for (int r = 0; r < reps; r++) {
#pragma unroll
    for (int k = 0; k < kChains; k++) xs[k] = mont_mul<M>(xs[k], y, P);
  }
  Fe<8> acc = xs[0];
#pragma unroll
  for (int k = 1; k < kChains; k++) acc = add(acc, xs[k], P);
  store<8>(out, n, e, acc);
}

__global__ void __launch_bounds__(kThreads)
    lone_chain_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b,
                      long long n, int reps, FieldParams<8> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  Fe<8> x = load<8>(a, n, e);
  const Fe<8> y = load<8>(b, n, e);
#pragma unroll 1
  for (int r = 0; r < reps; r++) x = mul(x, y, P);
  store<8>(out, n, e, x);
}

template <Mul M>
__global__ void __launch_bounds__(kThreads)
    chain2_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b,
                  long long n, int reps, FieldParams<8> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const Fe2<8> x = load2<8>(a, n, e), y = load2<8>(b, n, e);
  Fe2<8> xs[kChains2];
  xs[0] = add(x, y, P);
#pragma unroll
  for (int k = 1; k < kChains2; k++) xs[k] = add(x, add(y, x, P), P);
#pragma unroll 1
  for (int r = 0; r < reps; r++) {
#pragma unroll
    for (int k = 0; k < kChains2; k++) xs[k] = mul2<-1, M>(xs[k], y, P);
  }
  Fe2<8> acc = xs[0];
#pragma unroll
  for (int k = 1; k < kChains2; k++) acc = add(acc, xs[k], P);
  store2(out, n, e, acc);
}

unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <Mul M>
void launch_chains(bool fq2, uint32_t* out, const uint32_t* a,
                   const uint32_t* b, long long n, int reps,
                   const FieldParams<8>& P, cudaStream_t s) {
  if (fq2) {
    chain2_kernel<M><<<blocks(n), kThreads, 0, s>>>(out, a, b, n, reps, P);
  } else {
    chain_kernel<M><<<blocks(n), kThreads, 0, s>>>(out, a, b, n, reps, P);
  }
}

// K7b (fq2 false) or K7d (fq2 true) over the product kmul (0 CIOS, 1 SOS,
// 2 SOS2)
int chains(bool fq2, int kmul, void* out, const void* a, const void* b,
           long long n, int reps, int n32, const uint32_t* p, uint32_t inv,
           int device, void* stream) {
  if (n32 != 8 || n < 0 || reps < 0 || kmul < 0 || kmul > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const FieldParams<8> P = field_params(p, nullptr, inv);
  auto* o = (uint32_t*)out;
  auto* x = (const uint32_t*)a;
  auto* y = (const uint32_t*)b;
  const cudaStream_t s = (cudaStream_t)stream;
  if (kmul == 0) launch_chains<Mul::Cios>(fq2, o, x, y, n, reps, P, s);
  if (kmul == 1) launch_chains<Mul::Sos>(fq2, o, x, y, n, reps, P, s);
  if (kmul == 2) launch_chains<Mul::Sos2>(fq2, o, x, y, n, reps, P, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7a: out, a, b (8, n); `reps` synthetic products an element.
int sol_mix(void* out, const void* a, const void* b, long long n, int reps,
            int device, void* stream) {
  if (n < 0 || reps < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  sol_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, reps);
  return (int)cudaGetLastError();
}

// K7b: out, a, b (8, n) canonical Montgomery limbs; `reps` rounds of 8
// products an element.
int mul_chain(int kmul, void* out, const void* a, const void* b, long long n,
              int reps, int n32, const uint32_t* p, uint32_t inv, int device,
              void* stream) {
  return chains(false, kmul, out, a, b, n, reps, n32, p, inv, device, stream);
}

// K7d: out, a, b (2, 8, n) canonical Fq2 limbs (nr = p - 1); `reps`
// rounds of 4 Fq2 products an element.
int fq2_mul_chain(int kmul, void* out, const void* a, const void* b,
                  long long n, int reps, int n32, const uint32_t* p,
                  uint32_t inv, int device, void* stream) {
  return chains(true, kmul, out, a, b, n, reps, n32, p, inv, device, stream);
}

// K7b lone: out, a, b (8, n) canonical Montgomery limbs; one chain of
// `reps` CIOS products an element
int mul_lone_chain(void* out, const void* a, const void* b, long long n,
                   int reps, int n32, const uint32_t* p, uint32_t inv,
                   int device, void* stream) {
  if (n32 != 8 || n < 0 || reps < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  lone_chain_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, reps,
      field_params(p, nullptr, inv));
  return (int)cudaGetLastError();
}

}  // extern "C"
