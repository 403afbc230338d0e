// formulas.cuh -- the group formulas of libff_tpu/curves/formulas.py for
// the device field of fp.cuh, in the same order of field operations, so
// the projective and Jacobian coordinates they give are the JAX
// package's bit for bit.  B3 = 3*b is a compile-time constant (9 for
// alt_bn128 G1), multiplied in by mul_small's addition chain.
#pragma once

#include "fp.cuh"

namespace lff {

template <int N>
struct Pt {
  Fe<N> x, y, z;
};

// RCB15 Algorithm 7, complete projective addition (formulas.py:77-100).
template <int B3, int N>
__device__ __forceinline__ Pt<N> rcb_add(const Pt<N>& p, const Pt<N>& q,
                                         const FieldParams<N>& P) {
  Fe<N> t0 = mul(p.x, q.x, P);
  Fe<N> t1 = mul(p.y, q.y, P);
  Fe<N> t2 = mul(p.z, q.z, P);
  Fe<N> t3 = mul(add(p.x, p.y, P), add(q.x, q.y, P), P);
  t3 = sub(t3, add(t0, t1, P), P);
  Fe<N> t4 = mul(add(p.y, p.z, P), add(q.y, q.z, P), P);
  t4 = sub(t4, add(t1, t2, P), P);
  Fe<N> t5 = mul(add(p.x, p.z, P), add(q.x, q.z, P), P);
  t5 = sub(t5, add(t0, t2, P), P);
  t0 = add(dbl(t0, P), t0, P);
  t2 = mul_small<B3>(t2, P);
  Pt<N> r;
  r.z = add(t1, t2, P);
  t1 = sub(t1, t2, P);
  r.y = mul_small<B3>(t5, P);
  r.x = sub(mul(t3, t1, P), mul(t4, r.y, P), P);
  r.y = add(mul(t1, r.z, P), mul(r.y, t0, P), P);
  r.z = add(mul(r.z, t4, P), mul(t0, t3, P), P);
  return r;
}

// RCB15 Algorithm 8, complete mixed addition with a finite affine
// (x2, y2) (formulas.py:103-121).
template <int B3, int N>
__device__ __forceinline__ Pt<N> rcb_madd(const Pt<N>& p, const Fe<N>& x2,
                                          const Fe<N>& y2,
                                          const FieldParams<N>& P) {
  Fe<N> t0 = mul(p.x, x2, P);
  Fe<N> t1 = mul(p.y, y2, P);
  Fe<N> t3 = mul(add(x2, y2, P), add(p.x, p.y, P), P);
  t3 = sub(t3, add(t0, t1, P), P);
  Fe<N> t4 = add(mul(x2, p.z, P), p.x, P);
  Fe<N> t5 = add(mul(y2, p.z, P), p.y, P);
  t0 = add(dbl(t0, P), t0, P);
  Fe<N> t2 = mul_small<B3>(p.z, P);
  Pt<N> r;
  r.z = add(t1, t2, P);
  t1 = sub(t1, t2, P);
  r.y = mul_small<B3>(t4, P);
  r.x = sub(mul(t3, t1, P), mul(t5, r.y, P), P);
  r.y = add(mul(t1, r.z, P), mul(r.y, t0, P), P);
  r.z = add(mul(r.z, t5, P), mul(t0, t3, P), P);
  return r;
}

// RCB15 Algorithm 9, complete doubling (formulas.py:124-138).
template <int B3, int N>
__device__ __forceinline__ Pt<N> rcb_dbl(const Pt<N>& p,
                                         const FieldParams<N>& P) {
  Fe<N> t0 = sqr(p.y, P);
  Pt<N> r;
  r.z = dbl(dbl(dbl(t0, P), P), P);
  Fe<N> t1 = mul(p.y, p.z, P);
  Fe<N> t2 = mul_small<B3>(sqr(p.z, P), P);
  r.x = mul(t2, r.z, P);
  r.y = add(t0, t2, P);
  r.z = mul(t1, r.z, P);
  t1 = dbl(t2, P);
  t2 = add(t1, t2, P);
  t0 = sub(t0, t2, P);
  r.y = add(mul(t0, r.y, P), r.x, P);
  r.x = dbl(mul(t0, mul(p.x, p.y, P), P), P);
  return r;
}

// dbl-2009-l for a = 0 (formulas.py:19-36); Z = 0 in gives Z = 0 out.
template <int N>
__device__ __forceinline__ Pt<N> jac_dbl(const Pt<N>& p,
                                         const FieldParams<N>& P) {
  const Fe<N> A = sqr(p.x, P);
  const Fe<N> B = sqr(p.y, P);
  const Fe<N> C = sqr(B, P);
  const Fe<N> t = sub(sqr(add(p.x, B, P), P), add(A, C, P), P);
  const Fe<N> D = dbl(t, P);
  const Fe<N> E = add(dbl(A, P), A, P);
  const Fe<N> FF = sqr(E, P);
  Pt<N> r;
  r.x = sub(FF, dbl(D, P), P);
  const Fe<N> c8 = dbl(dbl(dbl(C, P), P), P);
  r.y = sub(mul(E, sub(D, r.x, P), P), c8, P);
  r.z = dbl(mul(p.y, p.z, P), P);
  return r;
}

// add-2007-bl candidate (formulas.py:39-57); h == 0 flags equal x, r == 0
// equal y, resolved by the caller's masks.
template <int N>
__device__ __forceinline__ Pt<N> jac_add_raw(const Pt<N>& p, const Pt<N>& q,
                                             Fe<N>& h, Fe<N>& rr,
                                             const FieldParams<N>& P) {
  const Fe<N> z1z1 = sqr(p.z, P);
  const Fe<N> z2z2 = sqr(q.z, P);
  const Fe<N> u1 = mul(p.x, z2z2, P);
  const Fe<N> u2 = mul(q.x, z1z1, P);
  const Fe<N> s1 = mul(p.y, mul(q.z, z2z2, P), P);
  const Fe<N> s2 = mul(q.y, mul(p.z, z1z1, P), P);
  h = sub(u2, u1, P);
  rr = dbl(sub(s2, s1, P), P);
  const Fe<N> i = sqr(dbl(h, P), P);
  const Fe<N> j = mul(h, i, P);
  const Fe<N> v = mul(u1, i, P);
  Pt<N> r;
  r.x = sub(sub(sqr(rr, P), j, P), dbl(v, P), P);
  r.y = sub(mul(rr, sub(v, r.x, P), P), dbl(mul(s1, j, P), P), P);
  r.z = mul(sub(sqr(add(p.z, q.z, P), P), add(z1z1, z2z2, P), P), h, P);
  return r;
}

// madd-2007-bl candidate with an affine (x2, y2) (formulas.py:60-74).
template <int N>
__device__ __forceinline__ Pt<N> jac_madd_raw(const Pt<N>& p, const Fe<N>& x2,
                                              const Fe<N>& y2, Fe<N>& h,
                                              Fe<N>& rr,
                                              const FieldParams<N>& P) {
  const Fe<N> z1z1 = sqr(p.z, P);
  const Fe<N> u2 = mul(x2, z1z1, P);
  const Fe<N> s2 = mul(y2, mul(p.z, z1z1, P), P);
  h = sub(u2, p.x, P);
  const Fe<N> hh = sqr(h, P);
  const Fe<N> i = dbl(dbl(hh, P), P);
  const Fe<N> j = mul(h, i, P);
  rr = dbl(sub(s2, p.y, P), P);
  const Fe<N> v = mul(p.x, i, P);
  Pt<N> r;
  r.x = sub(sub(sqr(rr, P), j, P), dbl(v, P), P);
  r.y = sub(mul(rr, sub(v, r.x, P), P), dbl(mul(p.y, j, P), P), P);
  r.z = sub(sqr(add(p.z, h, P), P), add(z1z1, hh, P), P);
  return r;
}

template <int N>
__device__ __forceinline__ Pt<N> select(bool c, const Pt<N>& a,
                                        const Pt<N>& b) {
  return Pt<N>{select(c, a.x, b.x), select(c, a.y, b.y), select(c, a.z, b.z)};
}

}  // namespace lff
