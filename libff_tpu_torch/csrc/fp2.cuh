// fp2.cuh -- the in-kernel Fq2 layer (kernel K4 of the port).
//
// Replaces libff_tpu/msm/pallas_insert.py:133 _KernelField2, the Fq2 =
// Fq[U]/(U^2 - nr) adapter the Pallas kernels use for G2: Karatsuba
// multiplication and complex squaring (fp2.tcc:101-151) over the base
// field's unrolled CIOS product, and the product by the twist's b3, which
// the TPU kernel receives as an input registered in const_overrides.  Here
// b3 is a runtime Fe2 in the field context (Fp2Field in formulas.cuh).
//
// The element is two Fe<N>, N = 8 (alt_bn128) or 12 (BLS12-381 and
// BLS12-377); the non-residue is a compile-time NR: -1 (alt_bn128,
// BLS12-381; nr = p - 1) or -5 (BLS12-377; nr = p - 5).  Times nr is
// mul_small<-NR>'s addition chain and a negation, folded into the
// subtraction that consumes it (add_nr: a + nr b = a - |nr| b).  The JAX
// formulas (tower.py:250-285):
//   mul:  c0 = v0 + nr*v1,  c1 = (a0+a1)(b0+b1) - v0 - v1,
//   sqr:  c0 = (a0+a1)(a0+nr*a1) - v - nr*v,  c1 = 2v,  v = a0*a1,
// which for nr = -1 is c0 = (a0+a1)(a0-a1), the form kept there.  Every
// result is the canonical residue, which is unique, so the bits equal the
// JAX kernel's for any nr.
//
// Element layout in device memory: an Fq2 array is (2, N, n) limb-major,
// component c's limb i in row c*N + i -- the TPU kernel's K = k*n rows.
//
// Cost: three base products (792 IMADs over CIOS or SOS, 816 over SOS2,
// at 8 limbs; 1,764 over the 12-limb CIOS) for a mul and two for a sqr.
// Inside K2 and K3 the multiplies bound it; elementwise (K4e) at 8 limbs
// the 192 bytes an element moves do.
#pragma once

#include "fp.cuh"

namespace lff {

template <int N>
struct Fe2 {
  Fe<N> c0, c1;
};

template <int N>
__device__ __forceinline__ Fe2<N> load2(const uint32_t* base, size_t stride,
                                        size_t e) {
  return Fe2<N>{load<N>(base, stride, e),
                load<N>(base + N * stride, stride, e)};
}

template <int N>
__device__ __forceinline__ void store2(uint32_t* base, size_t stride,
                                       size_t e, const Fe2<N>& a) {
  store<N>(base, stride, e, a.c0);
  store<N>(base + N * stride, stride, e, a.c1);
}

template <int N>
__device__ __forceinline__ Fe2<N> add(const Fe2<N>& a, const Fe2<N>& b,
                                      const FieldParams<N>& P) {
  return Fe2<N>{add(a.c0, b.c0, P), add(a.c1, b.c1, P)};
}

template <int N>
__device__ __forceinline__ Fe2<N> sub(const Fe2<N>& a, const Fe2<N>& b,
                                      const FieldParams<N>& P) {
  return Fe2<N>{sub(a.c0, b.c0, P), sub(a.c1, b.c1, P)};
}

template <int N>
__device__ __forceinline__ Fe2<N> dbl(const Fe2<N>& a,
                                      const FieldParams<N>& P) {
  return Fe2<N>{dbl(a.c0, P), dbl(a.c1, P)};
}

// a + nr*b for the non-residue NR < 0: a - |NR| b (for NR = -1, a - b)
template <int NR, int N>
__device__ __forceinline__ Fe<N> add_nr(const Fe<N>& a, const Fe<N>& b,
                                        const FieldParams<N>& P) {
  static_assert(NR == -1 || NR == -5, "the kernels take nr = -1 or -5");
  return sub(a, mul_small<-NR, N>(b, P), P);
}

// nr*b, canonical
template <int NR, int N>
__device__ __forceinline__ Fe<N> mul_nr(const Fe<N>& b,
                                        const FieldParams<N>& P) {
  return add_nr<NR>(zero<N>(), b, P);
}

// mul2: Karatsuba (tower.py:250-261; fp.cuh's mul and sqr are the base
// field's); the sums a0 + a1, b0 + b1 are reduced.  M is the base product
// (fp.cuh's Mul), as _KernelField2(F2, kmul) takes it
// (pallas_insert.py:139-160).
template <int NR, Mul M = Mul::Cios, int N>
__device__ __forceinline__ Fe2<N> mul2(const Fe2<N>& a, const Fe2<N>& b,
                                       const FieldParams<N>& P) {
  const Fe<N> v0 = mont_mul<M>(a.c0, b.c0, P);
  const Fe<N> v1 = mont_mul<M>(a.c1, b.c1, P);
  const Fe<N> t = mont_mul<M>(add(a.c0, a.c1, P), add(b.c0, b.c1, P), P);
  return Fe2<N>{add_nr<NR>(v0, v1, P), sub(sub(t, v0, P), v1, P)};
}

// sqr2: complex squaring (tower.py:276-285); with nr = -1 the first
// product is (a0+a1)(a0-a1) and v - v drops out
template <int NR, Mul M = Mul::Cios, int N>
__device__ __forceinline__ Fe2<N> sqr2(const Fe2<N>& a,
                                       const FieldParams<N>& P) {
  const Fe<N> v = mont_mul<M>(a.c0, a.c1, P);
  const Fe<N> t = mont_mul<M>(add(a.c0, a.c1, P), add_nr<NR>(a.c0, a.c1, P),
                              P);
  if constexpr (NR == -1) {
    return Fe2<N>{t, dbl(v, P)};
  } else {
    return Fe2<N>{sub(t, add_nr<NR>(v, v, P), P), dbl(v, P)};
  }
}

template <int N>
__device__ __forceinline__ Fe2<N> select(bool c, const Fe2<N>& a,
                                         const Fe2<N>& b) {
  return Fe2<N>{select(c, a.c0, b.c0), select(c, a.c1, b.c1)};
}

template <int N>
__device__ __forceinline__ bool is_zero(const Fe2<N>& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}

// The Fq2 constant of a C entry's 2N Montgomery limbs (c0's, then c1's)
template <int N>
inline Fe2<N> fe2_from(const uint32_t* limbs) {
  Fe2<N> r;
  for (int i = 0; i < N; i++) {
    r.c0.v[i] = limbs[i];
    r.c1.v[i] = limbs[N + i];
  }
  return r;
}

}  // namespace lff
