// fp2_pair.cuh -- Fq2 with two threads per element, the field context of
// K3's G2 branch (group_ops.cu) and of the CIOS G2 branch of the lane tree
// (merge.cuh: K5 and K2m's tail).
//
// Thread c of a pair (lanes 2i, 2i + 1 of a warp) holds coefficient c of
// every Fq2 value of one element, so a G2 formula keeps half of its values
// on each thread: rcb_add's P, Q and t0..t5, 96 words on one thread at 8
// limbs, are 48 here (72 at 12 limbs).  Additions act on the own
// coefficient alone.  A product swaps the operands' other coefficients
// with __shfl_xor_sync and reduces once, lazily:
//   c0 = REDC(a0 b0 + a1 w),   c1 = REDC(a1 b0 + a0 b1),   w = nr b1,
// two N x N products summed into one Montgomery reduction (CIOS rows by
// default; the context's M, MsmConfig.kmul, may ask for SOS's or SOS2's
// order instead, the same residue).
// w is made on thread 0 from the shuffled b1, as a canonical residue
// (p - b1 for nr = -1, by mul_small<5> and a negation for nr = -5): a
// lazily reduced w would break the bound.  Bounds: every operand is
// canonical (< p), so each term is below p^2 and each sum below 2 p^2 <
// p R (p < 2^254, R = 2^256 at 8 limbs; p < 2^381, R = 2^384 at 12); the
// Montgomery reduction of a value below p R ends below 2 p, and one
// conditional subtraction gives the canonical residue.  That residue is
// unique, so c0 and c1 are fp2.cuh's Karatsuba bits (v0 + nr v1,
// (a0+a1)(b0+b1) - v0 - v1, each canonical).  A square is one product
// (fp.cuh's mont_mul<M>) a thread, the values of fp2.cuh's complex square: with nr = -1
// c0 = (a0 + a1)(a0 - a1), c1 = a0 (2 a1); with another nr thread 0
// makes t = (a0 + a1)(a0 + nr a1) and thread 1 v = a0 a1, a shuffle
// hands each the other's, and c0 = t - v - nr v, c1 = 2v (the product a a
// through redc_pair, 1.5 products a thread, ran BLS12-377's dbl at 1.9x
// BLS12-381's on an H100).  Per thread at 8 limbs: 400 of a product's 784
// multiply-adds; per pair the same count as Karatsuba's three products.  The product by b3 takes nr b3.c1 as a constant made on
// the host (the context's nb3, host_mul_nr).
//
// K3's G2 branch (at 12 limbs padd and pmadd on two pairs an element,
// split_ops.cuh, CIOS only as in the JAX package), the lane tree's G2
// branch (over CIOS at 8 limbs, over every product at 12) and K2's
// 12-limb G2 chains (every product) run on it.  K2's 8-limb G2 chains
// keep fp2.cuh's one-thread layer through formulas.cuh, and so do the
// 8-limb lane tree's SOS and SOS2 G2 branches.
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

template <int N>
__device__ __forceinline__ Fe<N> pair_other(const Fe<N>& a) {
  const unsigned m = pair_mask();
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.v[k] = __shfl_xor_sync(m, a.v[k], 1);
  return r;
}

// REDC(a u + a' v), a' the pair's other thread's a, for canonical a, a',
// u, v (a u + a' v < 2p^2 < p R).  M = Mul::Cios: CIOS over an (N +
// 2)-word accumulator: row i adds a_i u and a'_i v (a'_i shuffled in as
// the row needs it, so a' never occupies N registers), then the row's
// quotient times p, then shifts a word down.  Between rows the
// accumulator stays below 3p; it ends below 2p, and one conditional
// subtraction gives the canonical residue.  M = Mul::Sos or Mul::Sos2
// (MsmConfig.kmul): the 2N-word sum first, the same rows of a_i u and
// a'_i v without the quotients, then fp.cuh's SOS or block-2 reduction
// waves (sos_redc).  The quotients of every order sum to the one M < R
// with a u + a' v + M p = 0 mod R, so all three end at the same value
// below 2p and the same canonical residue.  Each row's chain is one asm
// block (28 operands at N = 12).
template <Mul M = Mul::Cios, int N>
__device__ __forceinline__ Fe<N> redc_pair(const Fe<N>& a, const Fe<N>& u,
                                           const Fe<N>& v,
                                           const FieldParams<N>& P) {
  const unsigned m = pair_mask();
  if constexpr (M == Mul::Cios) {
    uint32_t t[N + 2];
#pragma unroll
    for (int k = 0; k < N + 2; k++) t[k] = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
      t[N + 1] += mad_row<N>(t, a.v[i], u.v, 0);
      t[N + 1] += mad_row<N>(t, __shfl_xor_sync(m, a.v[i], 1), v.v, 0);
      t[N + 1] += mad_row<N>(t, t[0] * P.inv, P.p, 0);
#pragma unroll
      for (int k = 0; k < N + 1; k++) t[k] = t[k + 1];
      t[N + 1] = 0;
    }
    return reduce_once(t, t[N], P);
  } else {
    uint32_t t[2 * N + 1];
#pragma unroll
    for (int k = 0; k < 2 * N + 1; k++) t[k] = 0;
    // row i's carries are owed to word i + N + 1, which no earlier row
    // reached
#pragma unroll
    for (int i = 0; i < N; i++) {
      t[i + N + 1] += mad_row<N>(t + i, a.v[i], u.v, 0);
      t[i + N + 1] +=
          mad_row<N>(t + i, __shfl_xor_sync(m, a.v[i], 1), v.v, 0);
    }
    return sos_redc<M>(t, P);
  }
}

// formulas.cuh's field context over a pair of threads, N limbs a
// coefficient, non-residue NR.  Blocks hold an even number of threads, so
// a thread's coefficient is threadIdx.x & 1; the context itself is the
// same on every thread, the kernel's parameter.  The two threads of a
// pair differ in c, so every choice by c is a select, never a branch,
// which would split the warp.
template <int N, int NR, Mul M = Mul::Cios>
struct Fp2Pair {
  using E = Fe<N>;
  static constexpr int kThreads = 2;  // threads an element
  static constexpr bool kG1 = false;
  FieldParams<N> P;
  Fe2<N> b3;     // 3b' in Montgomery form
  Fe<N> nb3;     // nr b3.c1, canonical, in Montgomery form

  static __device__ __forceinline__ uint32_t c() { return threadIdx.x & 1u; }

  __device__ __forceinline__ E add(const E& a, const E& b) const {
    return lff::add(a, b, P);
  }
  __device__ __forceinline__ E sub(const E& a, const E& b) const {
    return lff::sub(a, b, P);
  }
  __device__ __forceinline__ E dbl(const E& a) const { return lff::dbl(a, P); }
  // c0: a0 b0 + a1 (nr b1); c1: a1 b0 + a0 b1
  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    const E bo = pair_other(b);
    const bool c1 = c() != 0;
    const E u = lff::select(c1, bo, b);
    const E v = lff::select(c1, b, mul_nr<NR>(bo, P));
    return redc_pair<M>(a, u, v, P);
  }
  // one product a thread.  nr = -1: c0 = (a0 + a1)(a0 - a1), c1 =
  // a0 (2 a1).  Else thread 0 makes t = (a0 + a1)(a0 + nr a1) and thread
  // 1 v = a1 a0; they swap them, and c0 = t - v - nr v, c1 = 2v
  // (fp2.cuh's complex square)
  __device__ __forceinline__ E sqr(const E& a) const {
    const E ao = pair_other(a);
    const bool c1 = c() != 0;
    if constexpr (NR == -1) {
      const E x = lff::add(lff::select(c1, lff::zero<N>(), a), ao, P);
      const E y = lff::select(c1, lff::dbl(a, P), lff::sub(a, ao, P));
      return mont_mul<M>(x, y, P);
    } else {
      const E x = lff::select(c1, a, lff::add(a, ao, P));
      const E y = lff::select(c1, ao, add_nr<NR>(a, ao, P));
      const E m = mont_mul<M>(x, y, P);
      const E mo = pair_other(m);
      return lff::select(c1, lff::dbl(m, P),
                         lff::sub(m, add_nr<NR>(mo, mo, P), P));
    }
  }
  // a b3: c0 = a0 b3.c0 + a1 (nr b3.c1), c1 = a1 b3.c0 + a0 b3.c1
  __device__ __forceinline__ E mul_b3(const E& a) const {
    return redc_pair<M>(a, b3.c0, lff::select(c() != 0, b3.c1, nb3), P);
  }
  __device__ __forceinline__ E zero() const { return lff::zero<N>(); }
  __device__ __forceinline__ E one() const {
    return lff::select(c() != 0, lff::zero<N>(), lff::one<N>(P));
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
  // this thread's coefficient of element e of a (2, N, n) array
  static __device__ __forceinline__ E load(const uint32_t* base,
                                           size_t stride, size_t e) {
    return lff::load<N>(base + c() * N * stride, stride, e);
  }
  static __device__ __forceinline__ void store(uint32_t* base, size_t stride,
                                               size_t e, const E& a) {
    lff::store<N>(base + c() * N * stride, stride, e, a);
  }
};

// nr c mod p for a canonical c, on the host (the C entries build the
// context there): |NR| c by words, less p while it is p or more, then p
// minus it, 0 staying 0.  On Montgomery limbs it gives nr c's, the map
// being linear.
template <int N, int NR>
inline Fe<N> host_mul_nr(const Fe<N>& c, const FieldParams<N>& P) {
  uint32_t t[N + 1];
  uint64_t carry = 0;
  for (int i = 0; i < N; i++) {
    const uint64_t v = (uint64_t)c.v[i] * (uint32_t)(-NR) + carry;
    t[i] = (uint32_t)v;
    carry = v >> 32;
  }
  t[N] = (uint32_t)carry;
  auto below_p = [&]() {
    if (t[N] != 0) return false;
    for (int i = N - 1; i >= 0; i--)
      if (t[i] != P.p[i]) return t[i] < P.p[i];
    return false;
  };
  auto minus = [&](const uint32_t* x, const uint32_t* y, uint32_t* r, int n) {
    uint64_t borrow = 0;
    for (int i = 0; i < n; i++) {
      const uint64_t d = (uint64_t)x[i] - y[i] - borrow;
      r[i] = (uint32_t)d;
      borrow = (d >> 32) & 1;
    }
    return (uint32_t)borrow;
  };
  while (!below_p()) t[N] -= minus(t, P.p, t, N);
  Fe<N> r{};
  bool zero = true;
  for (int i = 0; i < N; i++) zero = zero && t[i] == 0;
  if (!zero) minus(P.p, t, r.v, N);
  return r;
}

// The context of a C entry's b3_mont, b3's 2N Montgomery limbs (c0's,
// then c1's); nr b3.c1 made here, on the host.
template <int N, int NR, Mul M = Mul::Cios>
inline Fp2Pair<N, NR, M> fp2_pair(const FieldParams<N>& P,
                                  const uint32_t* b3_mont) {
  const Fe2<N> b3 = fe2_from<N>(b3_mont);
  return Fp2Pair<N, NR, M>{P, b3, host_mul_nr<N, NR>(b3.c1, P)};
}

}  // namespace lff
