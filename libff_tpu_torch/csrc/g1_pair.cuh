// g1_pair.cuh -- K3's complete projective G1 additions (RCB15 padd and
// pmadd) on two threads an element, split by products: their body in
// K3's 12-limb G1 branch (group_ops.cu at LFF_N32 = 12).
//
// One thread a 12-limb element keeps both points (72 registers), up to
// six 12-limb temporaries and a CIOS accumulator live: 242-253 registers
// for the one-thread add and madd, so 8 warps an SM or fewer hide the
// products' carry chains.  Here the two threads of a pair (lanes 2i,
// 2i + 1) run each level's independent products side by side, three a
// thread for rcb_add (6 and 6) and rcb_madd (5 and 6, one slot repeated),
// and each thread keeps only what its own products need: 128 registers,
// 16 warps an SM.  The two threads run one instruction stream: every
// choice by thread is a select on its operands (`pick`), never a branch,
// which would split the warp.  Values cross between the two by
// __shfl_xor_sync, 12 words a value, within the pair.  Every product is
// fp.cuh's canonical CIOS product and every sum its canonical add or
// subtract, on the same values as formulas.cuh, so the outputs are
// group_op_plain's bits.  Both threads end holding the three output
// coordinates, and each stores half of every coordinate's limbs.
// (rcb_dbl on a pair, 4 products a level as 2 and 2, and the Jacobian
// add and madd on a pair, 12 and 10 product slots a thread for 23 and 18
// products with dbl-2009-l beside them, ran slower on an H100 than one
// thread an element: those ops keep that.)
//
// The plain emulation of this schedule, thread by thread, is
// curves/group_ops.py's group_op_g1_pair_plain.
#pragma once

#include "formulas.cuh"
#include "fp2_pair.cuh"

namespace lff {

// the pair's other thread's a
template <int N>
__device__ __forceinline__ Fe<N> pair_swap(const Fe<N>& a) {
  const unsigned m = pair_mask();
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.v[k] = __shfl_xor_sync(m, a.v[k], 1);
  return r;
}

// x on the pair's first thread, y on its second
template <int N>
__device__ __forceinline__ Fe<N> pick(bool c1, const Fe<N>& x,
                                      const Fe<N>& y) {
  return select(c1, y, x);
}

// rcb_add's products on a pair.  Thread 0 | thread 1:
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
__device__ __forceinline__ Pt<F> pair_add(const F& f, bool c1,
                                          const Load& ld) {
  using E = typename F::E;
  // operands: a = X | Z of each point, then Y, then X
  const E a1 = ld(c1 ? 2 : 0), a2 = ld(c1 ? 5 : 3);
  const E y1 = ld(1), y2 = ld(4);
  const E m1 = f.mul(a1, a2);
  const E m2 = f.mul(select(c1, f.add(y1, a1), y1),
                     select(c1, f.add(y2, a2), y2));
  const E x1 = ld(0), x2 = ld(3);
  const E m3 =
      f.mul(f.add(x1, pick(c1, y1, a1)), f.add(x2, pick(c1, y2, a2)));
  const E o1 = pair_swap(m1), o2 = pair_swap(m2);
  const E T0 = pick(c1, m1, o1), T2 = pick(c1, o1, m1);
  const E T1 = pick(c1, m2, o2);
  const E w = f.sub(m3, f.add(T0, pick(c1, T1, T2)));      // t3 | t5
  const E bb = f.mul_b3(pick(c1, T2, w));                  // b3 t2 | Y3
  const E zs = f.add(T1, pick(c1, bb, T2));                // Z3 | t1 + t2
  const E q0 = f.sub(pick(c1, T1, m2), pick(c1, bb, zs));  // t1 | t4
  const E tn = f.add(f.dbl(T0), T0);                       // 3 t0
  const E zo = pair_swap(zs);                              // . | Z3
  const E p = pick(c1, w, q0), q = pick(c1, q0, bb);
  const E r = pick(c1, zs, tn), s = pick(c1, tn, zo);
  const E pq = f.mul(p, q), qr = f.mul(q, r), sp = f.mul(s, p);
  const E pqo = pair_swap(pq), qro = pair_swap(qr), spo = pair_swap(sp);
  return Pt<F>{f.sub(pick(c1, pq, pqo), pick(c1, pqo, pq)), f.add(qr, qro),
               f.add(sp, spo)};
}

// rcb_madd's products on a pair, Q = (x2, y2) affine.  Thread 0 | 1:
//   level 1: X1 x2 = t0 | Z1 x2;  Y1 y2 = t1 | Z1 y2;
//            (x2+y2)(X1+Y1) on both
//   between: t3 | t4 = Z1 x2 + X1;  b3 Z1 | Y3 = b3 t4;
//            Z3 = t1 + b3 Z1 | t5 = Z1 y2 + Y1;  t1 - b3 Z1 | .;  3 t0
//   level 2: rcb_add's, with t5 in t4's place
// ld(j): coordinate j of (X1, Y1, Z1, x2, y2)
template <class F, class Load>
__device__ __forceinline__ Pt<F> pair_madd(const F& f, bool c1,
                                           const Load& ld) {
  using E = typename F::E;
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
  const E tno = pair_swap(tn), zso = pair_swap(zs);
  const E p = pick(c1, w, zs), q = pick(c1, q0, bz);
  const E r = pick(c1, zs, tno), s = pick(c1, tn, zso);
  const E pq = f.mul(p, q), qr = f.mul(q, r), sp = f.mul(s, p);
  const E pqo = pair_swap(pq), qro = pair_swap(qr), spo = pair_swap(sp);
  return Pt<F>{f.sub(pick(c1, pq, pqo), pick(c1, pqo, pq)), f.add(qr, qro),
               f.add(sp, spo)};
}

}  // namespace lff
