// fp2_pair.cuh -- Fq2 with two threads per element, the field context of
// K3's G2 branch (group_ops.cu) and of the CIOS G2 branch of the lane tree
// (merge.cuh: K5 and K2m's tail).
//
// Thread c of a pair (lanes 2i, 2i + 1 of a warp) holds coefficient c of
// every Fq2 value of one element, so a G2 formula keeps half of its values
// on each thread: rcb_add's P, Q and t0..t5, 96 words on one thread, are
// 48 here.  Additions act on the own coefficient alone.  A product swaps
// the operands' other coefficients with __shfl_xor_sync and reduces once,
// lazily (nr = p - 1, so u^2 = -1):
//   c0 = REDC(a0 b0 + a1 (p - b1)),   c1 = REDC(a1 b0 + a0 b1),
// two 8x8 products summed into one Montgomery reduction (CIOS rows).
// Bounds: every operand is canonical (< p), so each sum is below 2 p^2 <
// p R (p < 2^254, R = 2^256); p - b1 keeps it non-negative (it is p for
// b1 = 0, and a1 p = 0 mod p); the Montgomery reduction of a value below
// p R ends below 2 p, and one conditional subtraction gives the canonical
// residue.  That residue is unique, so c0 and c1 are fp2.cuh's Karatsuba
// bits (v0 - v1, (a0+a1)(b0+b1) - v0 - v1, each canonical).  A square is
// one CIOS product a thread: c0 = (a0 + a1)(a0 - a1), c1 = a0 (2 a1), the
// values of fp2.cuh's complex square.  Per thread: 400 of a product's 784
// multiply-adds; per pair the same count as Karatsuba's three products.
//
// K3's G2 branch and the lane tree's CIOS G2 branch run on it.  K2's
// chains keep fp2.cuh's one-thread layer through formulas.cuh, and so do
// the lane tree's SOS and SOS2 G2 branches: this layer has CIOS rows only.
// The lane tree shuffles whole partials between pairs (kThreads * h lanes
// down, so each thread meets its own coefficient) with the full warp's
// mask; every product here shuffles within its pair alone.
#pragma once

#include "fp2.cuh"

namespace lff {

// The pair's two lanes in the warp, for the shuffles.
__device__ __forceinline__ unsigned pair_mask() {
  return 3u << ((threadIdx.x & 31u) & 30u);
}

__device__ __forceinline__ Fe<8> pair_other(const Fe<8>& a) {
  const unsigned m = pair_mask();
  Fe<8> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = __shfl_xor_sync(m, a.v[k], 1);
  return r;
}

// REDC(a u + a' v), a' the pair's other thread's a, for canonical a, a',
// u, v (a u + a' v < 2p^2 < p R), by CIOS over a ten-word accumulator:
// row i adds a_i u and a'_i v (a'_i shuffled in as the row needs it, so a'
// never occupies eight registers), then the row's quotient times p, then
// shifts a word down.  Between rows the accumulator stays below 3p; it
// ends below 2p, and one conditional subtraction gives the canonical
// residue.
__device__ __forceinline__ Fe<8> redc_pair(const Fe<8>& a, const Fe<8>& u,
                                           const Fe<8>& v,
                                           const FieldParams<8>& P) {
  const unsigned m = pair_mask();
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    t[9] += mad_row(t, a.v[i], u.v, 0);
    t[9] += mad_row(t, __shfl_xor_sync(m, a.v[i], 1), v.v, 0);
    t[9] += mad_row(t, t[0] * P.inv, P.p, 0);
#pragma unroll
    for (int k = 0; k < 9; k++) t[k] = t[k + 1];
    t[9] = 0;
  }
  return reduce_once(t, t[8], P);
}

// formulas.cuh's field context over a pair of threads.  Blocks hold an
// even number of threads, so a thread's coefficient is threadIdx.x & 1;
// the context itself is the same on every thread, the kernel's parameter.
// The two threads of a pair differ in c, so every choice by c is a
// select, never a branch, which would split the warp.
struct Fp2Pair {
  using E = Fe<8>;
  static constexpr int kThreads = 2;  // threads an element
  static constexpr bool kG1 = false;
  FieldParams<8> P;
  Fe2 b3;        // 3b' in Montgomery form

  static __device__ __forceinline__ uint32_t c() { return threadIdx.x & 1u; }

  __device__ __forceinline__ E add(const E& a, const E& b) const {
    return lff::add(a, b, P);
  }
  __device__ __forceinline__ E sub(const E& a, const E& b) const {
    return lff::sub(a, b, P);
  }
  __device__ __forceinline__ E dbl(const E& a) const { return lff::dbl(a, P); }
  // c0: a0 b0 + a1 (p - b1); c1: a1 b0 + a0 b1
  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    const E bo = pair_other(b);
    const bool c1 = c() != 0;
    const E u = lff::select(c1, bo, b);
    const E v = lff::sub(lff::select(c1, b, lff::zero<8>()),
                         lff::select(c1, lff::zero<8>(), bo), P);
    return redc_pair(a, u, v, P);
  }
  // c0: (a0 + a1)(a0 - a1); c1: a0 (2 a1)
  __device__ __forceinline__ E sqr(const E& a) const {
    const E ao = pair_other(a);
    const bool c1 = c() != 0;
    const E x = lff::add(lff::select(c1, lff::zero<8>(), a), ao, P);
    const E y = lff::select(c1, lff::dbl(a, P), lff::sub(a, ao, P));
    return lff::mul(x, y, P);
  }
  // a b3: c0 = a0 b3.c0 + a1 (p - b3.c1), c1 = a1 b3.c0 + a0 b3.c1
  __device__ __forceinline__ E mul_b3(const E& a) const {
    const E v = lff::select(c() != 0, b3.c1,
                            lff::sub(lff::zero<8>(), b3.c1, P));
    return redc_pair(a, b3.c0, v, P);
  }
  __device__ __forceinline__ E zero() const { return lff::zero<8>(); }
  __device__ __forceinline__ E one() const {
    return lff::select(c() != 0, lff::zero<8>(), lff::one<8>(P));
  }
  // both coefficients zero; the pair agrees on the answer (both threads
  // shuffle, whatever their own coefficient)
  static __device__ __forceinline__ bool is_zero(const E& a) {
    const int z = lff::is_zero(a);
    const int o = __shfl_xor_sync(pair_mask(), z, 1);
    return z && o;
  }
  static __device__ __forceinline__ E select(bool s, const E& a, const E& b) {
    return lff::select(s, a, b);
  }
  // this thread's coefficient of element e of a (2, 8, n) array
  static __device__ __forceinline__ E load(const uint32_t* base,
                                           size_t stride, size_t e) {
    return lff::load<8>(base + c() * 8 * stride, stride, e);
  }
  static __device__ __forceinline__ void store(uint32_t* base, size_t stride,
                                               size_t e, const E& a) {
    lff::store<8>(base + c() * 8 * stride, stride, e, a);
  }
};

}  // namespace lff
