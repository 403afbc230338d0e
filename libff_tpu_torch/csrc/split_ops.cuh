// split_ops.cuh -- K3's complete projective additions (RCB15 padd and
// pmadd) split by products over two halves of an element's threads: the
// G1 pair body of K3's 12-limb G1 branch (group_ops_n12.cu) and the G2
// quad body of its 12-limb G2 branches (group_ops_g2_n12.cu,
// group_ops_g2_nr5_n12.cu).
//
// One schedule serves both, templated on the field context F:
//   - FpField<12, b3>: one thread a value, so an element takes two
//     threads (lanes 2i, 2i + 1), a half one thread;
//   - Fp2Pair<12, NR>: two threads a value (fp2_pair.cuh, thread c of a
//     pair holding coefficient c), so an element takes four threads
//     (lanes 4i..4i + 3), a half one pair, and each "product" below is
//     an Fq2 product on a pair (redc_pair: the same multiply-add count a
//     pair as Karatsuba's three products).
// Half h of an element is lanes F::kThreads h.. of its group; the other
// half's value comes by __shfl_xor_sync(..., F::kThreads) within the
// group (half_swap), so on G2 each thread meets its own coefficient.
//
// One thread a 12-limb G1 element keeps both points (72 registers), up
// to six 12-limb temporaries and a CIOS accumulator live: 242-253
// registers for the one-thread add and madd, so 8 warps an SM or fewer
// hide the products' carry chains; a G2 pair element (a coefficient a
// thread) needs the whole 255 and fits 2 blocks of 128 an SM.  Here the
// two halves run each level's independent products side by side, three
// a half for rcb_add (6 and 6; the two b3 products one a half) and
// rcb_madd (5 and 6, one slot repeated), and each half keeps only what
// its own products need.  The halves run one instruction stream: every
// choice by half is a select on its operands (`pick`), never a branch,
// which would split the warp.  Every product is the field context's
// canonical product and every sum its canonical add or subtract, on the
// same values as formulas.cuh, so the outputs are group_op_plain's bits.
// Both halves end holding the three output coordinates (on G2, each
// thread its coefficient of them), and each stores half of every
// coordinate's limbs.  (rcb_dbl on a G1 pair, 4 products a level as 2
// and 2, and the Jacobian add and madd on a G1 pair, 12 and 10 product
// slots a thread for 23 and 18 products with dbl-2009-l beside them, ran
// slower on an H100 than one thread an element: those ops keep that.)
//
// The plain emulation of this schedule, thread by thread, is
// curves/group_ops.py's group_op_split_plain.
#pragma once

#include "formulas.cuh"
#include "fp2_pair.cuh"

namespace lff {

// which half of its element this thread is
template <class F>
__device__ __forceinline__ bool half_of() {
  return ((threadIdx.x / F::kThreads) & 1u) != 0;
}

// the other half's a: the thread F::kThreads lanes away, within the
// element's group of 2 F::kThreads lanes
template <class F, int N>
__device__ __forceinline__ Fe<N> half_swap(const Fe<N>& a) {
  constexpr unsigned kGroup = 2 * F::kThreads;
  const unsigned m = ((1u << kGroup) - 1u) << ((threadIdx.x & 31u) &
                                               ~(kGroup - 1u));
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; k++)
    r.v[k] = __shfl_xor_sync(m, a.v[k], F::kThreads);
  return r;
}

// x on the first half, y on the second
template <int N>
__device__ __forceinline__ Fe<N> pick(bool c1, const Fe<N>& x,
                                      const Fe<N>& y) {
  return select(c1, y, x);
}

// rcb_add's products on two halves.  Half 0 | half 1:
//   level 1: X1 X2 = t0 | Z1 Z2 = t2;  Y1 Y2 = t1 | (Y1+Z1)(Y2+Z2);
//            (X1+Y1)(X2+Y2) | (X1+Z1)(X2+Z2)
//   between: t3 | t5 = (the third) - ...;  b3 t2 | b3 t5;
//            Z3 = t1 + b3 t2 | t1 + t2;  t1 - b3 t2 | t4
//   level 2: with (p, q, r, s) = (t3, t1 - b3 t2, Z3, 3 t0) |
//            (t4, b3 t5, 3 t0, Z3): p q, q r, s p, that is
//            t3 t1 | t4 Y3,  t1 Z3 | Y3 t0,  t0 t3 | Z3 t4
//   out:     X3 = A - B, Y3 = C + D, Z3 = E + F on both
// ld(j): coordinate j of (X1, Y1, Z1, X2, Y2, Z2)
template <class F, class Load>
__device__ __forceinline__ Pt<F> split_add(const F& f, bool c1,
                                           const Load& ld) {
  using E = typename F::E;
  const auto swap = [](const E& a) { return half_swap<F>(a); };
  // operands: a = X | Z of each point, then Y, then X
  const E a1 = ld(c1 ? 2 : 0), a2 = ld(c1 ? 5 : 3);
  const E y1 = ld(1), y2 = ld(4);
  const E m1 = f.mul(a1, a2);
  const E m2 = f.mul(select(c1, f.add(y1, a1), y1),
                     select(c1, f.add(y2, a2), y2));
  const E x1 = ld(0), x2 = ld(3);
  const E m3 =
      f.mul(f.add(x1, pick(c1, y1, a1)), f.add(x2, pick(c1, y2, a2)));
  const E o1 = swap(m1), o2 = swap(m2);
  const E T0 = pick(c1, m1, o1), T2 = pick(c1, o1, m1);
  const E T1 = pick(c1, m2, o2);
  const E w = f.sub(m3, f.add(T0, pick(c1, T1, T2)));      // t3 | t5
  const E bb = f.mul_b3(pick(c1, T2, w));                  // b3 t2 | Y3
  const E zs = f.add(T1, pick(c1, bb, T2));                // Z3 | t1 + t2
  const E q0 = f.sub(pick(c1, T1, m2), pick(c1, bb, zs));  // t1 | t4
  const E tn = f.add(f.dbl(T0), T0);                       // 3 t0
  const E zo = swap(zs);                                   // . | Z3
  const E p = pick(c1, w, q0), q = pick(c1, q0, bb);
  const E r = pick(c1, zs, tn), s = pick(c1, tn, zo);
  const E pq = f.mul(p, q), qr = f.mul(q, r), sp = f.mul(s, p);
  const E pqo = swap(pq), qro = swap(qr), spo = swap(sp);
  return Pt<F>{f.sub(pick(c1, pq, pqo), pick(c1, pqo, pq)), f.add(qr, qro),
               f.add(sp, spo)};
}

// rcb_madd's products on two halves, Q = (x2, y2) affine.  Half 0 | 1:
//   level 1: X1 x2 = t0 | Z1 x2;  Y1 y2 = t1 | Z1 y2;
//            (x2+y2)(X1+Y1) on both
//   between: t3 | t4 = Z1 x2 + X1;  b3 Z1 | Y3 = b3 t4;
//            Z3 = t1 + b3 Z1 | t5 = Z1 y2 + Y1;  t1 - b3 Z1 | .;  3 t0
//   level 2: rcb_add's, with t5 in t4's place
// ld(j): coordinate j of (X1, Y1, Z1, x2, y2)
template <class F, class Load>
__device__ __forceinline__ Pt<F> split_madd(const F& f, bool c1,
                                            const Load& ld) {
  using E = typename F::E;
  const auto swap = [](const E& a) { return half_swap<F>(a); };
  const E z1 = ld(2), qx = ld(3), qy = ld(4);
  const E x1 = ld(0), y1 = ld(1);
  const E m1 = f.mul(pick(c1, x1, z1), qx);
  const E m2 = f.mul(pick(c1, y1, z1), qy);
  const E m3 = f.mul(f.add(qx, qy), f.add(x1, y1));
  const E u = f.add(m1, x1);                               // . | t4
  const E bz = f.mul_b3(pick(c1, z1, u));                  // b3 Z1 | Y3
  const E zs = f.add(m2, pick(c1, bz, y1));                // Z3 | t5
  const E q0 = f.sub(m2, bz);                              // t1 | .
  const E w = f.sub(m3, f.add(m1, m2));                    // t3 | .
  const E tn = f.add(f.dbl(m1), m1);                       // 3 t0 | .
  const E tno = swap(tn), zso = swap(zs);
  const E p = pick(c1, w, zs), q = pick(c1, q0, bz);
  const E r = pick(c1, zs, tno), s = pick(c1, tn, zso);
  const E pq = f.mul(p, q), qr = f.mul(q, r), sp = f.mul(s, p);
  const E pqo = swap(pq), qro = swap(qr), spo = swap(sp);
  return Pt<F>{f.sub(pick(c1, pq, pqo), pick(c1, pqo, pq)), f.add(qr, qro),
               f.add(sp, spo)};
}

}  // namespace lff
