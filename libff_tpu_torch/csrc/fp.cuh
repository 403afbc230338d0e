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
// Three products, the JAX package's in-kernel multipliers
// (pallas_insert.py:96-99), chosen at compile time by the tag Mul through
// mont_mul<M> (CIOS is the default everywhere).  Counted from their PTX,
// per product:
//   Mul::Cios  mul       8 rows of 8 mad.lo + 8 mad.hi, the quotient's
//                        mul.lo, 8 mad.lo + 8 mad.hi: 264 IMADs (136 lo,
//                        128 hi); 48 addc, then 9 subc and 8 selects.
//   Mul::Sos   mul_sos   (fp.py:278 mul_sos) the whole 16-word product
//                        first, 64 mad.lo + 64 mad.hi, then 8 waves of one
//                        quotient and 8 mad.lo + 8 mad.hi: 264 IMADs; 64
//                        adds with carry, then the same subtract.
//   Mul::Sos2  mul_sos2  (fp.py:329 mul_sos2) the same product, then 4
//                        waves that each retire two words with a 64-bit
//                        quotient t_low64 * (-p^-1 mod 2^64) (4 IMADs) and
//                        16 mad.lo + 16 mad.hi: 272 IMADs; 64 adds.
// On an H100 the two kinds do not cost the same: K7c (issue_rates.cu)
// measures mul.hi at half the rate of mul.lo (about 31 and 61 a clock per
// SM), so the 128 hi multiply-adds of a product take twice the issue time
// of as many lo ones.
//
// SOS and SOS2 were built for the TPU's VPU, which has no carry flag:
// there they trade the CIOS carry chain for relaxed 16-bit columns.  Here
// every row is a carry chain of one instruction a link either way; what
// changes is the order of the rows and the accumulator, 17 words where
// CIOS keeps 10.
//
// The PTX chains are written out for N = 8 (254-bit fields: alt_bn128's
// Fq and Fr) and for N = 12 (377- and 381-bit fields: BLS12-377's and
// BLS12-381's Fq), all three products at both.  At N = 12 a CIOS row is
// still one asm block (27 operands, under the 30 that GCC-style inline
// asm allows), and so is each row of the SOS products (mad_lo_row and
// mad_hi_row, 28 and 26 operands: SOS adds its product and its
// reduction by rows of one carry chain each, not by columns, so no
// chain holds more than a row's words); but an add's or a subtract's
// 12 + 12 inputs and 13 outputs are not: those chains run as two blocks
// of 6 limbs, the carry (or borrow) handed from the first to the second
// in a register and set again as the second block's first instruction,
// so no flag is asked to live between two asm statements.  A 12-limb
// product is 300 mul.lo and 288 mul.hi multiply-adds (SOS2: 306 and
// 294), 2.24 times the 8-limb one's issue time.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lff {

template <int N>
struct FieldParams {
  uint32_t p[N];    // modulus, little-endian 32-bit limbs
  uint32_t one[N];  // R mod p, the Montgomery one
  uint32_t inv;     // -p^-1 mod 2^32
  uint32_t inv_hi;  // the high word of -p^-1 mod 2^64 (Mul::Sos2)
};

// The field context of the C entry points, from the host's limbs of p and
// of the Montgomery one (null: zeros) and -p^-1 mod 2^32.  -inv is p^-1
// mod 2^32; one Newton step y(2 - p y) lifts it to p^-1 mod 2^64.
template <int N = 8>
inline FieldParams<N> field_params(const uint32_t* p, const uint32_t* one,
                                   uint32_t inv) {
  FieldParams<N> P{};
  for (int i = 0; i < N; i++) {
    P.p[i] = p[i];
    P.one[i] = one != nullptr ? one[i] : 0;
  }
  P.inv = inv;
  const uint64_t p64 = p[0] | (uint64_t)p[1] << 32;
  uint64_t y = (uint32_t)(0u - inv);
  y *= 2 - p64 * y;
  P.inv_hi = (uint32_t)((0 - y) >> 32);
  return P;
}

// The in-kernel Montgomery product: CIOS, SOS or SOS with block-2
// reduction (see the note above).
enum class Mul { Cios = 0, Sos = 1, Sos2 = 2 };

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
// (fp.py:206-212).  On any 256-bit a, b it gives fp.py's bits: where the
// sum carries out of 2^256 the difference is kept, modulo 2^256.
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
  // hb = carry - borrow: all ones when s + carry*2^256 < p, else 0 (or 1,
  // when a + b >= 2^256 + p, which only operands >= p reach)
  return select(hb != 0xFFFFFFFFu, d, s);
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


// The canonical residue of r + top * 2^256 < 2p: r - p with its borrow,
// kept unless the whole value was below p.
__device__ __forceinline__ Fe<8> reduce_once(const uint32_t* r, uint32_t top,
                                             const FieldParams<8>& P) {
  Fe<8> d;
  uint32_t hb;
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
      : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(r[4]), "r"(r[5]),
        "r"(r[6]), "r"(r[7]), "r"(top), "r"(P.p[0]), "r"(P.p[1]),
        "r"(P.p[2]), "r"(P.p[3]), "r"(P.p[4]), "r"(P.p[5]), "r"(P.p[6]),
        "r"(P.p[7]));
  // hb = top - borrow: 0 when the value >= p (fp.py:275's need), all ones
  // otherwise
  Fe<8> v;
#pragma unroll
  for (int k = 0; k < 8; k++) v.v[k] = r[k];
  return select(hb == 0, d, v);
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
  const uint32_t r[8] = {t0, t1, t2, t3, t4, t5, t6, t7};
  return reduce_once(r, t8, P);
}


// -- N = 12: the 6-limb halves of the add and subtract chains -------------

// r[0..5] = a[0..5] + b[0..5] + cin (cin 0 or 1); returns the carry out.
// The first instruction sets the carry flag from cin (cin + 2^32 - 1
// carries exactly when cin = 1).
__device__ __forceinline__ uint32_t add6(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b, uint32_t cin) {
  uint32_t c;
  asm volatile(
      "{\n\t.reg .u32 z;\n\t"
      "add.cc.u32  z, %19, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %0, %7, %13;\n\t"
      "addc.cc.u32 %1, %8, %14;\n\t"
      "addc.cc.u32 %2, %9, %15;\n\t"
      "addc.cc.u32 %3, %10, %16;\n\t"
      "addc.cc.u32 %4, %11, %17;\n\t"
      "addc.cc.u32 %5, %12, %18;\n\t"
      "addc.u32    %6, 0, 0;\n\t"
      "}"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(cin));
  return c;
}

// r[0..5] = a[0..5] - b[0..5] - bin (bin 0 or 1); returns the borrow out,
// 0 or 1.  The first instruction sets the borrow from bin (0 - bin
// borrows exactly when bin = 1).
__device__ __forceinline__ uint32_t sub6(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b, uint32_t bin) {
  uint32_t w;
  asm volatile(
      "{\n\t.reg .u32 z;\n\t"
      "sub.cc.u32  z, 0, %19;\n\t"
      "subc.cc.u32 %0, %7, %13;\n\t"
      "subc.cc.u32 %1, %8, %14;\n\t"
      "subc.cc.u32 %2, %9, %15;\n\t"
      "subc.cc.u32 %3, %10, %16;\n\t"
      "subc.cc.u32 %4, %11, %17;\n\t"
      "subc.cc.u32 %5, %12, %18;\n\t"
      "subc.u32    %6, 0, 0;\n\t"
      "}"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(w)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(bin));
  return 0u - w;  // w is 0 or all ones
}

// a + b mod p at N = 12, as the 8-limb add: the difference s - p is kept
// unless the sum s (with its carry c) is below p, that is unless c = 0
// and s - p borrowed.
__device__ __forceinline__ Fe<12> add(const Fe<12>& a, const Fe<12>& b,
                                      const FieldParams<12>& P) {
  Fe<12> s, d;
  uint32_t c = add6(s.v, a.v, b.v, 0);
  c = add6(s.v + 6, a.v + 6, b.v + 6, c);
  uint32_t w = sub6(d.v, s.v, P.p, 0);
  w = sub6(d.v + 6, s.v + 6, P.p + 6, w);
  return select(c != 0 || w == 0, d, s);
}

// a - b mod p at N = 12: the difference with its borrow, then p added
// back where it borrowed (one block: 12 in-out and 12 inputs).
__device__ __forceinline__ Fe<12> sub(const Fe<12>& a, const Fe<12>& b,
                                      const FieldParams<12>& P) {
  Fe<12> d;
  uint32_t w = sub6(d.v, a.v, b.v, 0);
  w = sub6(d.v + 6, a.v + 6, b.v + 6, w);
  const uint32_t m = 0u - w;
  asm volatile(
      "add.cc.u32  %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32    %11, %11, %23;"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]),
        "+r"(d.v[4]), "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7]),
        "+r"(d.v[8]), "+r"(d.v[9]), "+r"(d.v[10]), "+r"(d.v[11])
      : "r"(P.p[0] & m), "r"(P.p[1] & m), "r"(P.p[2] & m), "r"(P.p[3] & m),
        "r"(P.p[4] & m), "r"(P.p[5] & m), "r"(P.p[6] & m), "r"(P.p[7] & m),
        "r"(P.p[8] & m), "r"(P.p[9] & m), "r"(P.p[10] & m),
        "r"(P.p[11] & m));
  return d;
}

// The canonical residue of r + top * 2^384 < 2p (top 0 or 1): r - p,
// kept unless the whole value was below p (top = 0 and r - p borrowed).
__device__ __forceinline__ Fe<12> reduce_once(const uint32_t* r, uint32_t top,
                                              const FieldParams<12>& P) {
  Fe<12> d, v;
  uint32_t w = sub6(d.v, r, P.p, 0);
  w = sub6(d.v + 6, r + 6, P.p + 6, w);
#pragma unroll
  for (int k = 0; k < 12; k++) v.v[k] = r[k];
  return select(top == w, d, v);
}

// The 12-limb CIOS product, the 8-limb mul's rows over a fourteen-word
// accumulator t0..t13; each row's chain is one asm block.
__device__ __forceinline__ Fe<12> mul(const Fe<12>& a, const Fe<12>& b,
                                      const FieldParams<12>& P) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0,
           t8 = 0, t9 = 0, t10 = 0, t11 = 0, t12 = 0, t13 = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const uint32_t ai = a.v[i];
    asm volatile(
        "mad.lo.cc.u32  %0, %14, %15, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %16, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %14, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %19, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %20, %5;\n\t"
        "madc.lo.cc.u32 %6, %14, %21, %6;\n\t"
        "madc.lo.cc.u32 %7, %14, %22, %7;\n\t"
        "madc.lo.cc.u32 %8, %14, %23, %8;\n\t"
        "madc.lo.cc.u32 %9, %14, %24, %9;\n\t"
        "madc.lo.cc.u32 %10, %14, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %14, %26, %11;\n\t"
        "addc.cc.u32    %12, %12, 0;\n\t"
        "addc.u32       %13, 0, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
          "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9), "+r"(t10), "+r"(t11),
          "+r"(t12), "=r"(t13)
        : "r"(ai), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(b.v[8]),
          "r"(b.v[9]), "r"(b.v[10]), "r"(b.v[11]));
    asm volatile(
        "mad.hi.cc.u32  %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %15, %1;\n\t"
        "madc.hi.cc.u32 %2, %13, %16, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %19, %5;\n\t"
        "madc.hi.cc.u32 %6, %13, %20, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %21, %7;\n\t"
        "madc.hi.cc.u32 %8, %13, %22, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %23, %9;\n\t"
        "madc.hi.cc.u32 %10, %13, %24, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %25, %11;\n\t"
        "addc.u32       %12, %12, 0;"
        : "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6),
          "+r"(t7), "+r"(t8), "+r"(t9), "+r"(t10), "+r"(t11), "+r"(t12),
          "+r"(t13)
        : "r"(ai), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(b.v[8]),
          "r"(b.v[9]), "r"(b.v[10]), "r"(b.v[11]));
    const uint32_t m = t0 * P.inv;
    // t0 + lo(m*p0) is 0 mod 2^32 by the choice of m; only its carry is kept
    asm volatile(
        "{\n\t.reg .u32 z;\n\t"
        "mad.lo.cc.u32  z, %14, %15, %13;\n\t"
        "madc.lo.cc.u32 %0, %14, %16, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %14, %19, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %20, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %21, %5;\n\t"
        "madc.lo.cc.u32 %6, %14, %22, %6;\n\t"
        "madc.lo.cc.u32 %7, %14, %23, %7;\n\t"
        "madc.lo.cc.u32 %8, %14, %24, %8;\n\t"
        "madc.lo.cc.u32 %9, %14, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %14, %26, %10;\n\t"
        "addc.cc.u32    %11, %11, 0;\n\t"
        "addc.u32       %12, %12, 0;\n\t"
        "}"
        : "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6),
          "+r"(t7), "+r"(t8), "+r"(t9), "+r"(t10), "+r"(t11), "+r"(t12),
          "+r"(t13)
        : "r"(t0), "r"(m), "r"(P.p[0]), "r"(P.p[1]), "r"(P.p[2]),
          "r"(P.p[3]), "r"(P.p[4]), "r"(P.p[5]), "r"(P.p[6]), "r"(P.p[7]),
          "r"(P.p[8]), "r"(P.p[9]), "r"(P.p[10]), "r"(P.p[11]));
    asm volatile(
        "mad.hi.cc.u32  %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %15, %1;\n\t"
        "madc.hi.cc.u32 %2, %13, %16, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %19, %5;\n\t"
        "madc.hi.cc.u32 %6, %13, %20, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %21, %7;\n\t"
        "madc.hi.cc.u32 %8, %13, %22, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %23, %9;\n\t"
        "madc.hi.cc.u32 %10, %13, %24, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %25, %11;\n\t"
        "addc.u32       %12, %12, 0;"
        : "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6),
          "+r"(t7), "+r"(t8), "+r"(t9), "+r"(t10), "+r"(t11), "+r"(t12),
          "+r"(t13)
        : "r"(m), "r"(P.p[0]), "r"(P.p[1]), "r"(P.p[2]), "r"(P.p[3]),
          "r"(P.p[4]), "r"(P.p[5]), "r"(P.p[6]), "r"(P.p[7]), "r"(P.p[8]),
          "r"(P.p[9]), "r"(P.p[10]), "r"(P.p[11]));
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8;
    t8 = t9; t9 = t10; t10 = t11; t11 = t12; t12 = t13;
  }
  const uint32_t r[12] = {t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11};
  return reduce_once(r, t12, P);
}

// -- every width ------------------------------------------------------------

template <int N>
__device__ __forceinline__ Fe<N> neg(const Fe<N>& a, const FieldParams<N>& P) {
  return sub(zero<N>(), a, P);
}

template <int N>
__device__ __forceinline__ Fe<N> dbl(const Fe<N>& a, const FieldParams<N>& P) {
  return add(a, a, P);
}

template <int N>
__device__ __forceinline__ Fe<N> sqr(const Fe<N>& a, const FieldParams<N>& P) {
  return mul(a, a, P);
}

// t[0..N-1] += lo(x * y_j) and t[N] += cin, one carry chain; returns the
// carry out of t[N].  N = 8 or 12 (28 operands at 12, under asm's 30).
template <int N = 8>
__device__ __forceinline__ uint32_t mad_lo_row(uint32_t* t, uint32_t x,
                                               const uint32_t* y,
                                               uint32_t cin) {
  uint32_t c;
  if constexpr (N == 8) {
    asm volatile(
        "mad.lo.cc.u32  %0, %10, %11, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
        "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
        "addc.cc.u32    %8, %8, %19;\n\t"
        "addc.u32       %9, 0, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=r"(c)
        : "r"(x), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]),
          "r"(y[5]), "r"(y[6]), "r"(y[7]), "r"(cin));
  } else {
    static_assert(N == 12, "the rows are written for 8 and 12 limbs");
    asm volatile(
        "mad.lo.cc.u32  %0, %14, %15, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %16, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %14, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %19, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %20, %5;\n\t"
        "madc.lo.cc.u32 %6, %14, %21, %6;\n\t"
        "madc.lo.cc.u32 %7, %14, %22, %7;\n\t"
        "madc.lo.cc.u32 %8, %14, %23, %8;\n\t"
        "madc.lo.cc.u32 %9, %14, %24, %9;\n\t"
        "madc.lo.cc.u32 %10, %14, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %14, %26, %11;\n\t"
        "addc.cc.u32    %12, %12, %27;\n\t"
        "addc.u32       %13, 0, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
          "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "=r"(c)
        : "r"(x), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]),
          "r"(y[5]), "r"(y[6]), "r"(y[7]), "r"(y[8]), "r"(y[9]),
          "r"(y[10]), "r"(y[11]), "r"(cin));
  }
  return c;
}

// t[1..N] += hi(x * y_j), one carry chain; returns the carry out of t[N].
template <int N = 8>
__device__ __forceinline__ uint32_t mad_hi_row(uint32_t* t, uint32_t x,
                                               const uint32_t* y) {
  uint32_t c;
  if constexpr (N == 8) {
    asm volatile(
        "mad.hi.cc.u32  %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32       %8, 0, 0;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
          "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=r"(c)
        : "r"(x), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]),
          "r"(y[5]), "r"(y[6]), "r"(y[7]));
  } else {
    static_assert(N == 12, "the rows are written for 8 and 12 limbs");
    asm volatile(
        "mad.hi.cc.u32  %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %15, %1;\n\t"
        "madc.hi.cc.u32 %2, %13, %16, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %19, %5;\n\t"
        "madc.hi.cc.u32 %6, %13, %20, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %21, %7;\n\t"
        "madc.hi.cc.u32 %8, %13, %22, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %23, %9;\n\t"
        "madc.hi.cc.u32 %10, %13, %24, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %25, %11;\n\t"
        "addc.u32       %12, 0, 0;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
          "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]),
          "+r"(t[11]), "+r"(t[12]), "=r"(c)
        : "r"(x), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]),
          "r"(y[5]), "r"(y[6]), "r"(y[7]), "r"(y[8]), "r"(y[9]),
          "r"(y[10]), "r"(y[11]));
  }
  return c;
}

// x * y added at word k of the accumulator t: both rows, the carry `cin`
// owed to word k + N taken in; returns the carry (0..2) owed to word
// k + N + 1.
template <int N = 8>
__device__ __forceinline__ uint32_t mad_row(uint32_t* t, uint32_t x,
                                            const uint32_t* y, uint32_t cin) {
  const uint32_t c = mad_lo_row<N>(t, x, y, cin);
  return c + mad_hi_row<N>(t, x, y);
}

// The 2N-word product a*b into t[0..2N] (t[2N] ends 0: a*b < 2^(64N)).
template <int N>
__device__ __forceinline__ void full_product(uint32_t* t, const Fe<N>& a,
                                             const Fe<N>& b) {
#pragma unroll
  for (int k = 0; k < 2 * N + 1; k++) t[k] = 0;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) c = mad_row<N>(t + i, a.v[i], b.v, c);
  t[2 * N] = c;
}

// The Montgomery reduction of a 2N-word value t[0..2N] below p R (t[2N]
// is 0), by SOS's waves (M = Sos) or by block-2 waves (M = Sos2), then
// one conditional subtraction: the canonical residue of t R^-1.
//   Sos:  N waves; wave i's quotient m = t_i * inv zeroes word i, and the
//         carry it owes word i + N + 1 rides into the next wave's row.
//   Sos2: N/2 waves, each zeroing words i and i + 1 with the quotient
//         m = (t_i + t_(i+1) 2^32) (-p^-1 mod 2^64) mod 2^64 = m0 + m1
//         2^32, added as m0 p at word i and m1 p at word i + 1.
// Either way the quotients sum to the one M < R with t + M p = 0 mod R,
// so the value before the subtraction is (t + M p) / R < 2p, CIOS's.
template <Mul M, int N>
__device__ __forceinline__ Fe<N> sos_redc(uint32_t* t,
                                          const FieldParams<N>& P) {
  static_assert(M == Mul::Sos || M == Mul::Sos2, "an SOS reduction");
  uint32_t c = 0;
  if constexpr (M == Mul::Sos) {
#pragma unroll
    for (int i = 0; i < N; i++) c = mad_row<N>(t + i, t[i] * P.inv, P.p, c);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      uint32_t m0, m1;
      asm volatile(
          "{\n\t.reg .u32 h;\n\t"
          "mul.lo.u32 %0, %2, %4;\n\t"
          "mul.hi.u32 h, %2, %4;\n\t"
          "mad.lo.u32 h, %2, %5, h;\n\t"
          "mad.lo.u32 %1, %3, %4, h;\n\t"
          "}"
          : "=r"(m0), "=r"(m1)
          : "r"(t[i]), "r"(t[i + 1]), "r"(P.inv), "r"(P.inv_hi));
      c = mad_row<N>(t + i, m0, P.p, c);
      c = mad_row<N>(t + i + 1, m1, P.p, c);
    }
  }
  return reduce_once(t + N, t[2 * N] + c, P);
}

// Montgomery product by SOS: the product first, then SOS's N reduction
// waves (t stays below 2^(64N + 1)).
template <int N>
__device__ __forceinline__ Fe<N> mul_sos(const Fe<N>& a, const Fe<N>& b,
                                         const FieldParams<N>& P) {
  uint32_t t[2 * N + 1];
  full_product(t, a, b);
  return sos_redc<Mul::Sos>(t, P);
}

// Montgomery product by SOS with block-2 reduction: the product, then
// N/2 waves of a 64-bit quotient.
template <int N>
__device__ __forceinline__ Fe<N> mul_sos2(const Fe<N>& a, const Fe<N>& b,
                                          const FieldParams<N>& P) {
  static_assert(N % 2 == 0, "the block-2 reduction needs an even limb count");
  uint32_t t[2 * N + 1];
  full_product(t, a, b);
  return sos_redc<Mul::Sos2>(t, P);
}

template <Mul M, int N>
__device__ __forceinline__ Fe<N> mont_mul(const Fe<N>& a, const Fe<N>& b,
                                          const FieldParams<N>& P) {
  if constexpr (M == Mul::Sos) {
    return mul_sos(a, b, P);
  } else if constexpr (M == Mul::Sos2) {
    return mul_sos2(a, b, P);
  } else {
    return mul(a, b, P);
  }
}

// a * K for a small compile-time constant K >= 1, by the binary addition
// chain of fp.py:118-141 (b3 = 9 for alt_bn128: 2a, 4a, 8a, 8a + a; 12 for
// BLS12-381, 3 for BLS12-377).
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

// x^e by the left-to-right binary ladder of fp.py:447-463 (pow_static):
// from the bit below e's leading one, bit `top`, down to bit 0, square
// always and multiply by x on a set bit.  e is 32-bit words,
// little-endian.  With e = p - 2 it is the Fermat inverse (fp.py:465-468),
// 0 to 0.  Every product depends on the one before, so one element's
// ladder is a latency chain of top + popcount(e) - 1 CIOS products (362
// for alt_bn128's Fq), kept in registers.
template <int N>
__device__ __forceinline__ Fe<N> pow_ladder(const Fe<N>& x, const uint32_t* e,
                                            int top, const FieldParams<N>& P) {
  Fe<N> acc = x;
#pragma unroll 1
  for (int i = top - 1; i >= 0; i--) {
    acc = mul(acc, acc, P);
    if ((e[i >> 5] >> (i & 31)) & 1u) acc = mul(acc, x, P);
  }
  return acc;
}

}  // namespace lff
