// fp2.cuh -- the in-kernel Fq2 layer (kernel K4 of the port).
//
// Replaces libff_tpu/msm/pallas_insert.py:133 _KernelField2, the Fq2 =
// Fq[U]/(U^2 - nr) adapter the Pallas kernels use for G2: Karatsuba
// multiplication and complex squaring (fp2.tcc:101-151) over the base
// field's unrolled CIOS product, and the product by the twist's b3, which
// the TPU kernel receives as an input registered in const_overrides.  Here
// b3 is a runtime Fe2 in the field context (Fp2Field in formulas.cuh).
//
// alt_bn128's non-residue is nr = p - 1, so "times nr" is a negation and
// the layer is written for it; the wrappers refuse any other nr on the
// card.  With nr = -1 the JAX formulas reduce to
//   mul:  c0 = v0 + nr*v1          = v0 - v1,
//         c1 = (a0+a1)(b0+b1) - v0 - v1,
//   sqr:  c0 = (a0+a1)(a0+nr*a1) - v - nr*v = (a0+a1)(a0-a1),
//         c1 = 2v,                           v = a0*a1,
// the same values in the same field; every result is the canonical
// residue, which is unique, so the bits equal the JAX kernel's.
//
// Element layout in device memory: an Fq2 array is (2, 8, n) limb-major,
// component c's limb i in row c*8 + i -- the TPU kernel's K = k*n rows.
//
// Cost: three base products (792 IMADs over CIOS or SOS, 816 over SOS2)
// for a mul and two (528, 544) for a sqr.  Inside K2 and K3 the
// multiplies bound it; elementwise (K4e) the 192 bytes an element moves
// do.
#pragma once

#include "fp.cuh"

namespace lff {

struct Fe2 {
  Fe<8> c0, c1;
};

__device__ __forceinline__ Fe2 load2(const uint32_t* base, size_t stride,
                                     size_t e) {
  return Fe2{load<8>(base, stride, e), load<8>(base + 8 * stride, stride, e)};
}

__device__ __forceinline__ void store2(uint32_t* base, size_t stride,
                                       size_t e, const Fe2& a) {
  store<8>(base, stride, e, a.c0);
  store<8>(base + 8 * stride, stride, e, a.c1);
}

__device__ __forceinline__ Fe2 add(const Fe2& a, const Fe2& b,
                                   const FieldParams<8>& P) {
  return Fe2{add(a.c0, b.c0, P), add(a.c1, b.c1, P)};
}

__device__ __forceinline__ Fe2 sub(const Fe2& a, const Fe2& b,
                                   const FieldParams<8>& P) {
  return Fe2{sub(a.c0, b.c0, P), sub(a.c1, b.c1, P)};
}

__device__ __forceinline__ Fe2 dbl(const Fe2& a, const FieldParams<8>& P) {
  return Fe2{dbl(a.c0, P), dbl(a.c1, P)};
}

// Karatsuba (tower.py:250-261); the sums a0 + a1, b0 + b1 are reduced.
// M is the base product (fp.cuh's Mul), as _KernelField2(F2, kmul) takes
// it (pallas_insert.py:139-160).
template <Mul M = Mul::Cios>
__device__ __forceinline__ Fe2 mul(const Fe2& a, const Fe2& b,
                                   const FieldParams<8>& P) {
  const Fe<8> v0 = mont_mul<M>(a.c0, b.c0, P);
  const Fe<8> v1 = mont_mul<M>(a.c1, b.c1, P);
  const Fe<8> t = mont_mul<M>(add(a.c0, a.c1, P), add(b.c0, b.c1, P), P);
  return Fe2{sub(v0, v1, P), sub(sub(t, v0, P), v1, P)};
}

// complex squaring (tower.py:276-285) with nr = -1
template <Mul M = Mul::Cios>
__device__ __forceinline__ Fe2 sqr(const Fe2& a, const FieldParams<8>& P) {
  const Fe<8> v = mont_mul<M>(a.c0, a.c1, P);
  return Fe2{mont_mul<M>(add(a.c0, a.c1, P), sub(a.c0, a.c1, P), P),
             dbl(v, P)};
}

__device__ __forceinline__ Fe2 select(bool c, const Fe2& a, const Fe2& b) {
  return Fe2{select(c, a.c0, b.c0), select(c, a.c1, b.c1)};
}

__device__ __forceinline__ bool is_zero(const Fe2& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}

}  // namespace lff
