// chain_mul.cuh -- a 12-limb Montgomery product for latency chains: two
// accumulators, so two carry chains run side by side.
//
// fp.cuh's CIOS row is four carry chains one after the other: a_i b's low
// halves, its high halves (which read what the low chain wrote), the
// quotient's low and high halves.  A chain of dependent products (the
// Horner scan, a Fermat ladder) waits for every link: a lone 12-limb
// CIOS product takes about 2,900 clocks on an H100.  Here (the even/odd
// split of supranational's sppark, mont_t) the partial products a_j b_i
// with j even go to one accumulator E, low half at word j and high half
// at word j + 1, and those with j odd to another, O, one word up: each
// row is then one chain over E and one over O, both n words long and
// independent of each other, and so is the quotient's row (p's even
// words into E, its odd words into O).  Between rows the two swap roles:
// the Montgomery shift leaves O one word lower than E, so O's word 1 is
// added into E's word 0 and O moves down two words as it takes the next
// row's odd products.  After the last row O is added into E a word up.
//
// Every carry chain is one asm block, as in fp.cuh; the chains' dropped
// carries (the odd row's top, the quotient's odd row) are zero for any
// canonical a, b and p < 2^382, and the result is below 2p, so one
// conditional subtraction gives the canonical residue: fp.cuh's CIOS
// bits.  libff_tpu_torch/roofline.py's mul_eo_words is its word-level
// model, which the CPU tests run against the CIOS product.  Its IMADs
// are CIOS's (300 low, 288 high); what changes is the depth of the
// dependence between them.
#pragma once

#include "fp.cuh"

namespace lff {

// O <- O / 2^64 + a_odd bi, after E0 += O1 (the carry going on into O):
// the start of a row that is not the first
__device__ __forceinline__ void eo_shift_row(uint32_t& e0, uint32_t* o,
                                             const uint32_t* a, uint32_t bi) {
  asm volatile(
      "add.cc.u32     %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %13, %19, %3;\n\t"
      "madc.hi.cc.u32 %2, %13, %19, %4;\n\t"
      "madc.lo.cc.u32 %3, %14, %19, %5;\n\t"
      "madc.hi.cc.u32 %4, %14, %19, %6;\n\t"
      "madc.lo.cc.u32 %5, %15, %19, %7;\n\t"
      "madc.hi.cc.u32 %6, %15, %19, %8;\n\t"
      "madc.lo.cc.u32 %7, %16, %19, %9;\n\t"
      "madc.hi.cc.u32 %8, %16, %19, %10;\n\t"
      "madc.lo.cc.u32 %9, %17, %19, %11;\n\t"
      "madc.hi.cc.u32 %10, %17, %19, %12;\n\t"
      "madc.lo.cc.u32 %11, %18, %19, 0;\n\t"
      "madc.hi.u32    %12, %18, %19, 0;"
      : "+r"(e0), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]),
        "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7]), "+r"(o[8]),
        "+r"(o[9]), "+r"(o[10]), "+r"(o[11])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(a[9]), "r"(a[11]),
        "r"(bi));
}

// acc += x_even m (low half of x_2k m at word 2k, high at 2k + 1), the
// carry out into top; x is a (the row's products) or p (the quotient's)
__device__ __forceinline__ void eo_even_row(uint32_t* acc, uint32_t& top,
                                            const uint32_t* x, uint32_t m) {
  asm volatile(
      "mad.lo.cc.u32  %0, %13, %19, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
      "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
      "addc.u32       %12, %12, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(top)
      : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(x[8]), "r"(x[10]),
        "r"(m));
}

// acc += p_odd m (low half of p_2k+1 m at word 2k, high at 2k + 1); its
// carry out is zero
__device__ __forceinline__ void eo_odd_row(uint32_t* acc, const uint32_t* p,
                                           uint32_t m) {
  asm volatile(
      "mad.lo.cc.u32  %0, %12, %18, %0;\n\t"
      "madc.hi.cc.u32 %1, %12, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %13, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %18, %7;\n\t"
      "madc.lo.cc.u32 %8, %16, %18, %8;\n\t"
      "madc.hi.cc.u32 %9, %16, %18, %9;\n\t"
      "madc.lo.cc.u32 %10, %17, %18, %10;\n\t"
      "madc.hi.u32    %11, %17, %18, %11;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11])
      : "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]),
        "r"(m));
}

// one row: E takes a_even bi at word 0, O a_odd bi at word 0 (one word
// up), then the quotient of E's word 0
__device__ __forceinline__ void eo_row(uint32_t* e, uint32_t* o,
                                       const uint32_t* a, uint32_t bi,
                                       bool first, const FieldParams<12>& P) {
  if (first) {
#pragma unroll
    for (int k = 0; k < 12; k += 2) {
      o[k] = a[k + 1] * bi;
      o[k + 1] = __umulhi(a[k + 1], bi);
      e[k] = a[k] * bi;
      e[k + 1] = __umulhi(a[k], bi);
    }
  } else {
    eo_shift_row(e[0], o, a, bi);
    eo_even_row(e, o[11], a, bi);
  }
  const uint32_t m = e[0] * P.inv;
  eo_odd_row(o, P.p, m);
  eo_even_row(e, o[11], P.p, m);
}

// a b 2^-384 mod p, canonical, for canonical a, b
__device__ __forceinline__ Fe<12> mul_eo(const Fe<12>& a, const Fe<12>& b,
                                         const FieldParams<12>& P) {
  uint32_t ev[12], od[12];
#pragma unroll
  for (int i = 0; i < 12; i += 2) {
    eo_row(ev, od, a.v, b.v[i], i == 0, P);
    eo_row(od, ev, a.v, b.v[i + 1], false, P);
  }
  // after the last row od is E: ev += od / 2^32
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
      "addc.u32    %11, %11, 0;"
      : "+r"(ev[0]), "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]),
        "+r"(ev[5]), "+r"(ev[6]), "+r"(ev[7]), "+r"(ev[8]), "+r"(ev[9]),
        "+r"(ev[10]), "+r"(ev[11])
      : "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]), "r"(od[5]),
        "r"(od[6]), "r"(od[7]), "r"(od[8]), "r"(od[9]), "r"(od[10]),
        "r"(od[11]));
  return reduce_once(ev, 0, P);
}

}  // namespace lff
