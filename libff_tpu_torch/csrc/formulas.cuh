// formulas.cuh -- the group formulas of libff_tpu/curves/formulas.py over
// a device field, in the same order of field operations, so the
// projective and Jacobian coordinates they give are the JAX package's bit
// for bit.
//
// The formulas are templated on a field context F that supplies the
// element type F::E, kThreads (the threads that hold an element: 1 here,
// 2 for fp2_pair.cuh's Fp2Pair), kG1 (true over Fp, false over Fq2: the
// kernels pick their G1 or G2 shape by it, not by the element's size,
// which a 12-limb Fp element shares with no branch of theirs) and
// add/sub/dbl/mul/sqr/mul_b3/zero/one/
// is_zero/select, plus load/store of one element of a limb-major array:
//
//   FpField<N, B3, M>  Fp of N 32-bit limbs over fp.cuh; b3 = 3b is a
//                compile-time constant multiplied in by mul_small's
//                addition chain: (8, 9) for alt_bn128 G1, (12, 12) for
//                BLS12-381 G1 (b = 4), (12, 3) for BLS12-377 G1 (b = 1).
//   Fp2Field<N, NR, M>  Fq2 over fp2.cuh (K4), N limbs a coefficient,
//                non-residue NR (-1: alt_bn128, BLS12-381; -5:
//                BLS12-377); b3 = 3b' of the twist is a general Fq2
//                element, a runtime argument in Montgomery form, and
//                mul_b3 is one Karatsuba product.  The JAX VM multiplies
//                by b3 coefficient-wise and the JAX kernel by Karatsuba;
//                the values are equal and canonical, so the bits are too.
//
// M (fp.cuh's Mul, CIOS by default) is the Montgomery product behind mul
// and sqr, MsmConfig.kmul's choice; every product gives the canonical
// residue, so the formulas' outputs do not depend on it.
#pragma once

#include "fp.cuh"
#include "fp2.cuh"

namespace lff {

template <int N, int B3, Mul M = Mul::Cios>
struct FpField {
  using E = Fe<N>;
  static constexpr int kThreads = 1;  // threads an element
  static constexpr bool kG1 = true;
  FieldParams<N> P;

  __device__ __forceinline__ E add(const E& a, const E& b) const {
    return lff::add(a, b, P);
  }
  __device__ __forceinline__ E sub(const E& a, const E& b) const {
    return lff::sub(a, b, P);
  }
  __device__ __forceinline__ E dbl(const E& a) const { return lff::dbl(a, P); }
  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    return lff::mont_mul<M>(a, b, P);
  }
  __device__ __forceinline__ E sqr(const E& a) const {
    return lff::mont_mul<M>(a, a, P);
  }
  __device__ __forceinline__ E mul_b3(const E& a) const {
    return mul_small<B3, N>(a, P);
  }
  __device__ __forceinline__ E zero() const { return lff::zero<N>(); }
  __device__ __forceinline__ E one() const { return lff::one<N>(P); }
  static __device__ __forceinline__ bool is_zero(const E& a) {
    return lff::is_zero(a);
  }
  static __device__ __forceinline__ E select(bool c, const E& a, const E& b) {
    return lff::select(c, a, b);
  }
  static __device__ __forceinline__ E load(const uint32_t* base,
                                           size_t stride, size_t e) {
    return lff::load<N>(base, stride, e);
  }
  static __device__ __forceinline__ void store(uint32_t* base, size_t stride,
                                               size_t e, const E& a) {
    lff::store<N>(base, stride, e, a);
  }
};

template <int N, int NR, Mul M = Mul::Cios>
struct Fp2Field {
  using E = Fe2<N>;
  static constexpr int kThreads = 1;
  static constexpr bool kG1 = false;
  FieldParams<N> P;
  Fe2<N> b3;  // 3b' in Montgomery form

  __device__ __forceinline__ E add(const E& a, const E& b) const {
    return lff::add(a, b, P);
  }
  __device__ __forceinline__ E sub(const E& a, const E& b) const {
    return lff::sub(a, b, P);
  }
  __device__ __forceinline__ E dbl(const E& a) const { return lff::dbl(a, P); }
  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    return lff::mul2<NR, M>(a, b, P);
  }
  __device__ __forceinline__ E sqr(const E& a) const {
    return lff::sqr2<NR, M>(a, P);
  }
  __device__ __forceinline__ E mul_b3(const E& a) const {
    return lff::mul2<NR, M>(a, b3, P);
  }
  __device__ __forceinline__ E zero() const {
    return E{lff::zero<N>(), lff::zero<N>()};
  }
  __device__ __forceinline__ E one() const {
    return E{lff::one<N>(P), lff::zero<N>()};
  }
  static __device__ __forceinline__ bool is_zero(const E& a) {
    return lff::is_zero(a);
  }
  static __device__ __forceinline__ E select(bool c, const E& a, const E& b) {
    return lff::select(c, a, b);
  }
  static __device__ __forceinline__ E load(const uint32_t* base,
                                           size_t stride, size_t e) {
    return load2<N>(base, stride, e);
  }
  static __device__ __forceinline__ void store(uint32_t* base, size_t stride,
                                               size_t e, const E& a) {
    store2(base, stride, e, a);
  }
};

template <class F>
struct Pt {
  typename F::E x, y, z;
};

// RCB15 Algorithm 7, complete projective addition (formulas.py:77-100).
template <class F>
__device__ __forceinline__ Pt<F> rcb_add(const F& f, const Pt<F>& p,
                                         const Pt<F>& q) {
  using E = typename F::E;
  E t0 = f.mul(p.x, q.x);
  E t1 = f.mul(p.y, q.y);
  E t2 = f.mul(p.z, q.z);
  E t3 = f.mul(f.add(p.x, p.y), f.add(q.x, q.y));
  t3 = f.sub(t3, f.add(t0, t1));
  E t4 = f.mul(f.add(p.y, p.z), f.add(q.y, q.z));
  t4 = f.sub(t4, f.add(t1, t2));
  E t5 = f.mul(f.add(p.x, p.z), f.add(q.x, q.z));
  t5 = f.sub(t5, f.add(t0, t2));
  t0 = f.add(f.dbl(t0), t0);
  t2 = f.mul_b3(t2);
  Pt<F> r;
  r.z = f.add(t1, t2);
  t1 = f.sub(t1, t2);
  r.y = f.mul_b3(t5);
  r.x = f.sub(f.mul(t3, t1), f.mul(t4, r.y));
  r.y = f.add(f.mul(t1, r.z), f.mul(r.y, t0));
  r.z = f.add(f.mul(r.z, t4), f.mul(t0, t3));
  return r;
}

// RCB15 Algorithm 8, complete mixed addition with a finite affine
// (x2, y2) (formulas.py:103-121).
template <class F>
__device__ __forceinline__ Pt<F> rcb_madd(const F& f, const Pt<F>& p,
                                          const typename F::E& x2,
                                          const typename F::E& y2) {
  using E = typename F::E;
  E t0 = f.mul(p.x, x2);
  E t1 = f.mul(p.y, y2);
  E t3 = f.mul(f.add(x2, y2), f.add(p.x, p.y));
  t3 = f.sub(t3, f.add(t0, t1));
  E t4 = f.add(f.mul(x2, p.z), p.x);
  E t5 = f.add(f.mul(y2, p.z), p.y);
  t0 = f.add(f.dbl(t0), t0);
  E t2 = f.mul_b3(p.z);
  Pt<F> r;
  r.z = f.add(t1, t2);
  t1 = f.sub(t1, t2);
  r.y = f.mul_b3(t4);
  r.x = f.sub(f.mul(t3, t1), f.mul(t5, r.y));
  r.y = f.add(f.mul(t1, r.z), f.mul(r.y, t0));
  r.z = f.add(f.mul(r.z, t5), f.mul(t0, t3));
  return r;
}

// RCB15 Algorithm 9, complete doubling (formulas.py:124-138).
template <class F>
__device__ __forceinline__ Pt<F> rcb_dbl(const F& f, const Pt<F>& p) {
  using E = typename F::E;
  E t0 = f.sqr(p.y);
  Pt<F> r;
  r.z = f.dbl(f.dbl(f.dbl(t0)));
  E t1 = f.mul(p.y, p.z);
  E t2 = f.mul_b3(f.sqr(p.z));
  r.x = f.mul(t2, r.z);
  r.y = f.add(t0, t2);
  r.z = f.mul(t1, r.z);
  t1 = f.dbl(t2);
  t2 = f.add(t1, t2);
  t0 = f.sub(t0, t2);
  r.y = f.add(f.mul(t0, r.y), r.x);
  r.x = f.dbl(f.mul(t0, f.mul(p.x, p.y)));
  return r;
}

// dbl-2009-l for a = 0 (formulas.py:19-36); Z = 0 in gives Z = 0 out.
template <class F>
__device__ __forceinline__ Pt<F> jac_dbl(const F& f, const Pt<F>& p) {
  using E = typename F::E;
  const E A = f.sqr(p.x);
  const E B = f.sqr(p.y);
  const E C = f.sqr(B);
  const E t = f.sub(f.sqr(f.add(p.x, B)), f.add(A, C));
  const E D = f.dbl(t);
  const E Ee = f.add(f.dbl(A), A);
  const E FF = f.sqr(Ee);
  Pt<F> r;
  r.x = f.sub(FF, f.dbl(D));
  const E c8 = f.dbl(f.dbl(f.dbl(C)));
  r.y = f.sub(f.mul(Ee, f.sub(D, r.x)), c8);
  r.z = f.dbl(f.mul(p.y, p.z));
  return r;
}

// add-2007-bl candidate (formulas.py:39-57); h == 0 flags equal x, r == 0
// equal y, resolved by the caller's masks.
template <class F>
__device__ __forceinline__ Pt<F> jac_add_raw(const F& f, const Pt<F>& p,
                                             const Pt<F>& q,
                                             typename F::E& h,
                                             typename F::E& rr) {
  using E = typename F::E;
  const E z1z1 = f.sqr(p.z);
  const E z2z2 = f.sqr(q.z);
  const E u1 = f.mul(p.x, z2z2);
  const E u2 = f.mul(q.x, z1z1);
  const E s1 = f.mul(p.y, f.mul(q.z, z2z2));
  const E s2 = f.mul(q.y, f.mul(p.z, z1z1));
  h = f.sub(u2, u1);
  rr = f.dbl(f.sub(s2, s1));
  const E i = f.sqr(f.dbl(h));
  const E j = f.mul(h, i);
  const E v = f.mul(u1, i);
  Pt<F> r;
  r.x = f.sub(f.sub(f.sqr(rr), j), f.dbl(v));
  r.y = f.sub(f.mul(rr, f.sub(v, r.x)), f.dbl(f.mul(s1, j)));
  r.z = f.mul(f.sub(f.sqr(f.add(p.z, q.z)), f.add(z1z1, z2z2)), h);
  return r;
}

// madd-2007-bl candidate with an affine (x2, y2) (formulas.py:60-74).
template <class F>
__device__ __forceinline__ Pt<F> jac_madd_raw(const F& f, const Pt<F>& p,
                                              const typename F::E& x2,
                                              const typename F::E& y2,
                                              typename F::E& h,
                                              typename F::E& rr) {
  using E = typename F::E;
  const E z1z1 = f.sqr(p.z);
  const E u2 = f.mul(x2, z1z1);
  const E s2 = f.mul(y2, f.mul(p.z, z1z1));
  h = f.sub(u2, p.x);
  const E hh = f.sqr(h);
  const E i = f.dbl(f.dbl(hh));
  const E j = f.mul(h, i);
  rr = f.dbl(f.sub(s2, p.y));
  const E v = f.mul(p.x, i);
  Pt<F> r;
  r.x = f.sub(f.sub(f.sqr(rr), j), f.dbl(v));
  r.y = f.sub(f.mul(rr, f.sub(v, r.x)), f.dbl(f.mul(p.y, j)));
  r.z = f.sub(f.sqr(f.add(p.z, h)), f.add(z1z1, hh));
  return r;
}

template <class F>
__device__ __forceinline__ Pt<F> select(bool c, const Pt<F>& a,
                                        const Pt<F>& b) {
  return Pt<F>{F::select(c, a.x, b.x), F::select(c, a.y, b.y),
               F::select(c, a.z, b.z)};
}

}  // namespace lff
