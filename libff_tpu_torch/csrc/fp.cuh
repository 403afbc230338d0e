// fp.cuh -- the in-kernel prime-field layer (kernel K1 of the port).
//
// Replaces libff_tpu/msm/pallas_insert.py:87 _KernelField, the adapter the
// Pallas kernels use over libff_tpu/fields/fp.py:246 PrimeField._cios (the
// unrolled radix-2^16 CIOS Montgomery product) and its
// mul_small_const addition chains.  The TPU has no 32x32->64 multiply, so
// the JAX package works in 16-bit limbs; Hopper has one (IMAD.WIDE,
// mad.lo/mad.hi), so here an element is N 32-bit limbs with the same
// R = 2^(32N) = 2^(64 n64), and 8 rounds of 32-bit CIOS reduce by the same
// R as 16 rounds of 16-bit CIOS.  Every result is the canonical residue
// (< p), which is unique, so the bits equal the JAX package's after the
// limb repack (limb32[i] = limb16[2i] | limb16[2i+1] << 16).
//
// What bounds it on an H100: integer multiply-add issue.  A Montgomery
// product is 2N^2 + N 32-bit multiplies (136 for N = 8) and the carries
// ride on the hardware carry flag: each carry chain below is ONE asm
// block (mad.lo.cc / madc.lo.cc / madc.hi.cc / addc), so nothing the
// compiler schedules can land between two links of a chain.  Values stay
// in registers; the kernels that include this header load an element once
// and store it once.
//
// The PTX chains are written out for N = 8 (254-bit fields: alt_bn128's
// Fq and Fr).  Wider fields add their own chains in a later slice.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lff {

template <int N>
struct FieldParams {
  uint32_t p[N];    // modulus, little-endian 32-bit limbs
  uint32_t one[N];  // R mod p, the Montgomery one
  uint32_t inv;     // -p^-1 mod 2^32
};

template <int N>
struct Fe {
  uint32_t v[N];
};

// Element e of a limb-major (N, stride) array: limb k at base[k*stride + e].
template <int N>
__device__ __forceinline__ Fe<N> load(const uint32_t* base, size_t stride,
                                      size_t e) {
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.v[k] = base[k * stride + e];
  return r;
}

template <int N>
__device__ __forceinline__ void store(uint32_t* base, size_t stride, size_t e,
                                      const Fe<N>& a) {
#pragma unroll
  for (int k = 0; k < N; k++) base[k * stride + e] = a.v[k];
}

template <int N>
__device__ __forceinline__ Fe<N> zero() {
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.v[k] = 0;
  return r;
}

template <int N>
__device__ __forceinline__ Fe<N> one(const FieldParams<N>& P) {
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.v[k] = P.one[k];
  return r;
}

template <int N>
__device__ __forceinline__ bool is_zero(const Fe<N>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < N; k++) acc |= a.v[k];
  return acc == 0;
}

template <int N>
__device__ __forceinline__ Fe<N> select(bool c, const Fe<N>& a,
                                        const Fe<N>& b) {
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// a + b mod p for canonical a, b: the sum with its carry, then the sum
// minus p with its borrow; keep the difference unless it went negative
// (fp.py:206-212).
__device__ __forceinline__ Fe<8> add(const Fe<8>& a, const Fe<8>& b,
                                     const FieldParams<8>& P) {
  Fe<8> s, d;
  uint32_t c, hb;
  asm volatile(
      "add.cc.u32  %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32    %8, 0, 0;"
      : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]),
        "=r"(s.v[4]), "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7]), "=r"(c)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  asm volatile(
      "sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %25, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(hb)
      : "r"(s.v[0]), "r"(s.v[1]), "r"(s.v[2]), "r"(s.v[3]), "r"(s.v[4]),
        "r"(s.v[5]), "r"(s.v[6]), "r"(s.v[7]), "r"(P.p[0]), "r"(P.p[1]),
        "r"(P.p[2]), "r"(P.p[3]), "r"(P.p[4]), "r"(P.p[5]), "r"(P.p[6]),
        "r"(P.p[7]), "r"(c));
  // hb = carry - borrow: 0 when s + carry*2^256 >= p, all ones otherwise
  return select(hb == 0, d, s);
}

// a - b mod p: the difference with its borrow, then p added back where it
// borrowed (fp.py:214-225).
__device__ __forceinline__ Fe<8> sub(const Fe<8>& a, const Fe<8>& b,
                                     const FieldParams<8>& P) {
  Fe<8> d;
  uint32_t brw;
  asm volatile(
      "sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(brw)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]),
        "+r"(d.v[4]), "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7])
      : "r"(P.p[0] & brw), "r"(P.p[1] & brw), "r"(P.p[2] & brw),
        "r"(P.p[3] & brw), "r"(P.p[4] & brw), "r"(P.p[5] & brw),
        "r"(P.p[6] & brw), "r"(P.p[7] & brw));
  return d;
}

__device__ __forceinline__ Fe<8> neg(const Fe<8>& a, const FieldParams<8>& P) {
  return sub(zero<8>(), a, P);
}

__device__ __forceinline__ Fe<8> dbl(const Fe<8>& a, const FieldParams<8>& P) {
  return add(a, a, P);
}

// Montgomery product a*b*2^-256 mod p, canonical: 32-bit CIOS over a
// ten-word accumulator t0..t9 (fp.py:246-276 with 32-bit words).  Per row
// i: t += a_i*b (low halves, then high halves, one carry chain each),
// m = t0 * inv, t += m*p (the same two chains; t0 becomes 0), shift down
// one word.  The accumulator stays below 2p, so one conditional
// subtraction of p ends it.
__device__ __forceinline__ Fe<8> mul(const Fe<8>& a, const Fe<8>& b,
                                     const FieldParams<8>& P) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0,
           t8 = 0, t9 = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t ai = a.v[i];
    asm volatile(
        "mad.lo.cc.u32  %0, %10, %11, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
        "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
        "addc.cc.u32    %8, %8, 0;\n\t"
        "addc.u32       %9, 0, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
          "+r"(t6), "+r"(t7), "+r"(t8), "=r"(t9)
        : "r"(ai), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
    asm volatile(
        "mad.hi.cc.u32  %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32       %8, %8, 0;"
        : "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6),
          "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(ai), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
    const uint32_t m = t0 * P.inv;
    // t0 + lo(m*p0) is 0 mod 2^32 by the choice of m; only its carry is kept
    asm volatile(
        "{\n\t.reg .u32 z;\n\t"
        "mad.lo.cc.u32  z, %10, %11, %9;\n\t"
        "madc.lo.cc.u32 %0, %10, %12, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %14, %2;\n\t"
        "madc.lo.cc.u32 %3, %10, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %16, %4;\n\t"
        "madc.lo.cc.u32 %5, %10, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %10, %18, %6;\n\t"
        "addc.cc.u32    %7, %7, 0;\n\t"
        "addc.u32       %8, %8, 0;\n\t"
        "}"
        : "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6),
          "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(t0), "r"(m), "r"(P.p[0]), "r"(P.p[1]), "r"(P.p[2]),
          "r"(P.p[3]), "r"(P.p[4]), "r"(P.p[5]), "r"(P.p[6]), "r"(P.p[7]));
    asm volatile(
        "mad.hi.cc.u32  %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32       %8, %8, 0;"
        : "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6),
          "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(m), "r"(P.p[0]), "r"(P.p[1]), "r"(P.p[2]), "r"(P.p[3]),
          "r"(P.p[4]), "r"(P.p[5]), "r"(P.p[6]), "r"(P.p[7]));
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8;
    t8 = t9;
  }
  Fe<8> r, d;
  uint32_t hb;
  r.v[0] = t0; r.v[1] = t1; r.v[2] = t2; r.v[3] = t3;
  r.v[4] = t4; r.v[5] = t5; r.v[6] = t6; r.v[7] = t7;
  asm volatile(
      "sub.cc.u32  %0, %9, %18;\n\t"
      "subc.cc.u32 %1, %10, %19;\n\t"
      "subc.cc.u32 %2, %11, %20;\n\t"
      "subc.cc.u32 %3, %12, %21;\n\t"
      "subc.cc.u32 %4, %13, %22;\n\t"
      "subc.cc.u32 %5, %14, %23;\n\t"
      "subc.cc.u32 %6, %15, %24;\n\t"
      "subc.cc.u32 %7, %16, %25;\n\t"
      "subc.u32    %8, %17, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(hb)
      : "r"(t0), "r"(t1), "r"(t2), "r"(t3), "r"(t4), "r"(t5), "r"(t6),
        "r"(t7), "r"(t8), "r"(P.p[0]), "r"(P.p[1]), "r"(P.p[2]),
        "r"(P.p[3]), "r"(P.p[4]), "r"(P.p[5]), "r"(P.p[6]), "r"(P.p[7]));
  // hb = t8 - borrow: 0 when t >= p (fp.py:275's need), all ones otherwise
  return select(hb == 0, d, r);
}

__device__ __forceinline__ Fe<8> sqr(const Fe<8>& a, const FieldParams<8>& P) {
  return mul(a, a, P);
}

// a * K for a small compile-time constant K >= 1, by the binary addition
// chain of fp.py:118-141 (b3 = 9 for alt_bn128: 2a, 4a, 8a, 8a + a).
template <int K, int N>
__device__ __forceinline__ Fe<N> mul_small(const Fe<N>& a,
                                           const FieldParams<N>& P) {
  static_assert(K >= 1, "mul_small takes a positive constant");
  if constexpr (K == 1) {
    return a;
  } else {
    const Fe<N> h = mul_small<K / 2, N>(a, P);
    const Fe<N> h2 = dbl(h, P);
    if constexpr (K % 2 == 1) {
      return add(h2, a, P);
    } else {
      return h2;
    }
  }
}

}  // namespace lff
