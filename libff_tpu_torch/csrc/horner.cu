// horner.cu -- kernel K3's scan entry: the Horner phase of the signed
// Pippenger MSM, sum_w 2^(c w) T_w over the W window totals, in one
// launch, on G1 (Fp) and G2 (Fq2).
//
// Replaces the per-step launches of K3 (libff_tpu/curves/pallas_ops.py:66
// _op_kernel) that libff_tpu/msm/pippenger.py:419-433 makes: a
// jax.lax.scan of c (W - 1) masked pdbl steps over the W totals, then
// proj_sum_tree.  Window w takes part while step k < c w, so it is doubled
// exactly c w times: here window w's warp loops c w times with no select.
// The closing tree keeps proj_sum_tree's pairing (pad to a power of two M
// with the identity (0, 1, 0), add slot i to slot i + M/2, halve), so the
// projective output is the same bits.  Every formula is formulas.cuh's RCB15
// (rcb_dbl, rcb_add) with the same field values, each a canonical residue
// over fp.cuh's CIOS product (K3 runs CIOS only, as the JAX package).
//
// What bounds it on an H100: latency.  The phase is one chain of c (W - 1)
// dependent doublings and log2 M adds; its products number a few thousand,
// microseconds of the card's multiply rate.  The design shortens the chain:
//   - one warp per window, one window a block, so the windows spread over
//     the SMs instead of sharing one SM's issue slots (32 windows on one
//     SM would issue-bind it: a warp's product keeps a scheduler busy
//     about half of its latency);
//   - inside a formula, the base products that do not depend on each other
//     run on separate lanes: a doubling is two levels of 4 products on G1
//     (y^2, yz, z^2, xy; then t2 rz, t1 rz, t0 ry, t0 xy) and three on G2
//     (10 base products of the Karatsuba and complex-square layer of
//     fp2.cuh, 3 for b3 z^2, 12); an add two levels of 6 on G1, three of
//     18, 6 and 18 on G2.  Lane j takes its operands from shared memory,
//     runs one Montgomery product and writes it back; every lane then does
//     the formula's additions itself (they are cheap, and a value every
//     lane holds needs no second exchange);
//   - the sum tree runs by arrival: a window's block, when done, publishes
//     its point and counts itself in at its pair; the second of a pair adds
//     the two (lower slot first, as proj_sum_tree does) and goes on to the
//     next level, the first leaves.  No block waits for another, so the
//     launch needs no co-residency, and the last add writes the result.
//     A pair whose upper slot is padding adds the identity itself, as the
//     padded tree does.
#include "fp2.cuh"

using namespace lff;

namespace {

// base products of one level: an Fq2 add's six Karatsuba products
constexpr int kMaxLevel = 18;

// one window's exchange: the level's operands and its products, 32 bytes
// an element
struct Slots {
  uint4 a[kMaxLevel][2], b[kMaxLevel][2], r[kMaxLevel][2];
};

__device__ __forceinline__ void put(uint4* s, const Fe<8>& x) {
  s[0] = make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
  s[1] = make_uint4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

__device__ __forceinline__ Fe<8> get(const uint4* s) {
  const uint4 lo = s[0], hi = s[1];
  return Fe<8>{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void operands(Slots& s, int j, const Fe<8>& x,
                                         const Fe<8>& y) {
  put(s.a[j], x);
  put(s.b[j], y);
}

// The level's n base products: every lane has written the same operands;
// lane j < n multiplies pair j, and after the second barrier every lane
// reads every product.
__device__ __forceinline__ void level(Slots& s, int n,
                                      const FieldParams<8>& P) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  if (lane < n) put(s.r[lane], mul(get(s.a[lane]), get(s.b[lane]), P));
  __syncwarp();
}

// A field's products as base products: kMul a product, kSqr a square,
// written at slot j and read back from the products at j.
template <class E>
struct Ops;

template <>
struct Ops<Fe<8>> {
  static constexpr int kMul = 1, kSqr = 1;
  static __device__ __forceinline__ void mul(Slots& s, int j, const Fe<8>& x,
                                             const Fe<8>& y,
                                             const FieldParams<8>&) {
    operands(s, j, x, y);
  }
  static __device__ __forceinline__ void sqr(Slots& s, int j, const Fe<8>& x,
                                             const FieldParams<8>&) {
    operands(s, j, x, x);
  }
  static __device__ __forceinline__ Fe<8> mul_out(const Slots& s, int j,
                                                  const FieldParams<8>&) {
    return get(s.r[j]);
  }
  static __device__ __forceinline__ Fe<8> sqr_out(const Slots& s, int j,
                                                  const FieldParams<8>&) {
    return get(s.r[j]);
  }
  static __device__ __forceinline__ Fe<8> one(const FieldParams<8>& P) {
    return lff::one<8>(P);
  }
};

// Fq2 (nr = p - 1): fp2.cuh's Karatsuba product (v0, v1, (a0+a1)(b0+b1))
// and complex square (a0 a1, (a0+a1)(a0-a1)), recombined as there
template <>
struct Ops<Fe2> {
  static constexpr int kMul = 3, kSqr = 2;
  static __device__ __forceinline__ void mul(Slots& s, int j, const Fe2& x,
                                             const Fe2& y,
                                             const FieldParams<8>& P) {
    operands(s, j, x.c0, y.c0);
    operands(s, j + 1, x.c1, y.c1);
    operands(s, j + 2, add(x.c0, x.c1, P), add(y.c0, y.c1, P));
  }
  static __device__ __forceinline__ void sqr(Slots& s, int j, const Fe2& x,
                                             const FieldParams<8>& P) {
    operands(s, j, x.c0, x.c1);
    operands(s, j + 1, add(x.c0, x.c1, P), sub(x.c0, x.c1, P));
  }
  static __device__ __forceinline__ Fe2 mul_out(const Slots& s, int j,
                                                const FieldParams<8>& P) {
    const Fe<8> v0 = get(s.r[j]), v1 = get(s.r[j + 1]);
    return Fe2{sub(v0, v1, P), sub(sub(get(s.r[j + 2]), v0, P), v1, P)};
  }
  static __device__ __forceinline__ Fe2 sqr_out(const Slots& s, int j,
                                                const FieldParams<8>& P) {
    return Fe2{get(s.r[j + 1]), dbl(get(s.r[j]), P)};
  }
  static __device__ __forceinline__ Fe2 one(const FieldParams<8>& P) {
    return Fe2{lff::one<8>(P), zero<8>()};
  }
};

template <class E>
struct Pt {
  E x, y, z;
};

// b3 times a (and times b): G1's b3 = 9 by fp.cuh's addition chain, G2's
// the twist's Fq2 constant, one level of Karatsuba products
__device__ __forceinline__ void times_b3(Slots&, const Fe<8>& a,
                                         const Fe<8>& b, Fe<8>& ra,
                                         Fe<8>& rb, int both,
                                         const FieldParams<8>& P,
                                         const Fe2&) {
  ra = mul_small<9, 8>(a, P);
  if (both) rb = mul_small<9, 8>(b, P);
}

__device__ __forceinline__ void times_b3(Slots& s, const Fe2& a,
                                         const Fe2& b, Fe2& ra, Fe2& rb,
                                         int both, const FieldParams<8>& P,
                                         const Fe2& b3) {
  Ops<Fe2>::mul(s, 0, a, b3, P);
  if (both) Ops<Fe2>::mul(s, 3, b, b3, P);
  level(s, both ? 6 : 3, P);
  ra = Ops<Fe2>::mul_out(s, 0, P);
  if (both) rb = Ops<Fe2>::mul_out(s, 3, P);
}

// rcb_dbl (formulas.cuh; formulas.py:124-138) with its products by level
template <class E>
__device__ __forceinline__ Pt<E> scan_dbl(Slots& s, const Pt<E>& p,
                                          const FieldParams<8>& P,
                                          const Fe2& b3) {
  using O = Ops<E>;
  constexpr int M = O::kMul, S = O::kSqr;
  O::sqr(s, 0, p.y, P);                    // t0 = y^2
  O::mul(s, S, p.y, p.z, P);               // t1 = y z
  O::sqr(s, S + M, p.z, P);                // z^2
  O::mul(s, 2 * S + M, p.x, p.y, P);       // x y
  level(s, 2 * S + 2 * M, P);
  E t0 = O::sqr_out(s, 0, P);
  const E t1 = O::mul_out(s, S, P), zz = O::sqr_out(s, S + M, P);
  const E xy = O::mul_out(s, 2 * S + M, P);
  const E rz = dbl(dbl(dbl(t0, P), P), P);
  E t2;
  times_b3(s, zz, zz, t2, t2, 0, P, b3);
  const E ry = add(t0, t2, P);
  t0 = sub(t0, add(dbl(t2, P), t2, P), P);
  O::mul(s, 0, t2, rz, P);                 // x3 = t2 z3
  O::mul(s, M, t1, rz, P);                 // z3 = t1 z3
  O::mul(s, 2 * M, t0, ry, P);
  O::mul(s, 3 * M, t0, xy, P);
  level(s, 4 * M, P);
  Pt<E> r;
  r.z = O::mul_out(s, M, P);
  r.y = add(O::mul_out(s, 2 * M, P), O::mul_out(s, 0, P), P);
  r.x = dbl(O::mul_out(s, 3 * M, P), P);
  return r;
}

// rcb_add (formulas.cuh; formulas.py:77-100) with its products by level
template <class E>
__device__ __forceinline__ Pt<E> scan_add(Slots& s, const Pt<E>& p,
                                          const Pt<E>& q,
                                          const FieldParams<8>& P,
                                          const Fe2& b3) {
  using O = Ops<E>;
  constexpr int M = O::kMul;
  O::mul(s, 0, p.x, q.x, P);
  O::mul(s, M, p.y, q.y, P);
  O::mul(s, 2 * M, p.z, q.z, P);
  O::mul(s, 3 * M, add(p.x, p.y, P), add(q.x, q.y, P), P);
  O::mul(s, 4 * M, add(p.y, p.z, P), add(q.y, q.z, P), P);
  O::mul(s, 5 * M, add(p.x, p.z, P), add(q.x, q.z, P), P);
  level(s, 6 * M, P);
  E t0 = O::mul_out(s, 0, P), t1 = O::mul_out(s, M, P);
  E t2 = O::mul_out(s, 2 * M, P);
  const E t3 = sub(O::mul_out(s, 3 * M, P), add(t0, t1, P), P);
  const E t4 = sub(O::mul_out(s, 4 * M, P), add(t1, t2, P), P);
  const E t5 = sub(O::mul_out(s, 5 * M, P), add(t0, t2, P), P);
  t0 = add(dbl(t0, P), t0, P);
  E ry;
  times_b3(s, t2, t5, t2, ry, 1, P, b3);
  const E rz = add(t1, t2, P);
  t1 = sub(t1, t2, P);
  O::mul(s, 0, t3, t1, P);
  O::mul(s, M, t4, ry, P);
  O::mul(s, 2 * M, t1, rz, P);
  O::mul(s, 3 * M, ry, t0, P);
  O::mul(s, 4 * M, rz, t4, P);
  O::mul(s, 5 * M, t0, t3, P);
  level(s, 6 * M, P);
  Pt<E> r;
  r.x = sub(O::mul_out(s, 0, P), O::mul_out(s, M, P), P);
  r.y = add(O::mul_out(s, 2 * M, P), O::mul_out(s, 3 * M, P), P);
  r.z = add(O::mul_out(s, 4 * M, P), O::mul_out(s, 5 * M, P), P);
  return r;
}

// A point of limb-major (k, 8, n) coordinate arrays: coefficient c's limb
// i at base[(c * 8 + i) * n + e].  ld.global.cg where another block wrote
// it in this launch: L2, never a stale L1 line.
template <bool kCg>
__device__ __forceinline__ Fe<8> load_el(const uint32_t* base, long long n,
                                         long long e) {
  Fe<8> r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = kCg ? __ldcg(base + i * n + e)
                                           : base[i * n + e];
  return r;
}

template <bool kCg>
__device__ __forceinline__ void load_as(Fe<8>& r, const uint32_t* base,
                                        long long n, long long e) {
  r = load_el<kCg>(base, n, e);
}

template <bool kCg>
__device__ __forceinline__ void load_as(Fe2& r, const uint32_t* base,
                                        long long n, long long e) {
  r.c0 = load_el<kCg>(base, n, e);
  r.c1 = load_el<kCg>(base + 8 * n, n, e);
}

__device__ __forceinline__ void store_as(uint32_t* base, long long n,
                                         long long e, const Fe<8>& a) {
  store<8>(base, n, e, a);
}

__device__ __forceinline__ void store_as(uint32_t* base, long long n,
                                         long long e, const Fe2& a) {
  store2(base, n, e, a);
}

struct ScanArgs {
  const uint32_t* in[3];  // the totals' X, Y, Z, each (k, 8, W)
  uint32_t* slot[3];      // the tree's published points, each (k, 8, M)
  uint32_t* out[3];       // the sum, each (k, 8, 1)
  int* arrivals;          // (M,) zeros: pair i of half h counts at h + i
  int W, M, c;
};

template <class E, bool kCg>
__device__ __forceinline__ Pt<E> load_pt(const uint32_t* const* base,
                                         long long n, long long e) {
  Pt<E> p;
  load_as<kCg>(p.x, base[0], n, e);
  load_as<kCg>(p.y, base[1], n, e);
  load_as<kCg>(p.z, base[2], n, e);
  return p;
}

// lane 0 writes the point every lane holds
template <class E>
__device__ __forceinline__ void store_pt(uint32_t* const* base, long long n,
                                         long long e, const Pt<E>& p) {
  if ((threadIdx.x & 31) == 0) {
    store_as(base[0], n, e, p.x);
    store_as(base[1], n, e, p.y);
    store_as(base[2], n, e, p.z);
  }
}

// One warp a block, block w the window w.
template <class E>
__global__ void __launch_bounds__(32) horner_kernel(ScanArgs A,
                                                    FieldParams<8> P,
                                                    Fe2 b3) {
  __shared__ Slots s;
  const int w = blockIdx.x;
  Pt<E> q = load_pt<E, false>(A.in, A.W, w);
  const int steps = A.c * w;
#pragma unroll 1
  for (int k = 0; k < steps; k++) q = scan_dbl(s, q, P, b3);
  int j = w;
#pragma unroll 1
  for (int h = A.M >> 1; h >= 1; h >>= 1) {
    const int i = j & (h - 1);             // the pair (i, i + h)
    if (j == i && i + h >= A.W) {
      // the upper slot is padding, the identity exactly (sums of identity
      // pads stay (0, 1, 0) bit for bit)
      const Pt<E> id{E{}, Ops<E>::one(P), E{}};
      q = scan_add(s, q, id, P, b3);
      continue;
    }
    store_pt(A.slot, A.M, j, q);
    int first = 0;
    if ((threadIdx.x & 31) == 0) {
      __threadfence();                     // the point before the count
      first = atomicAdd(A.arrivals + h + i, 1) == 0;
    }
    first = __shfl_sync(0xFFFFFFFFu, first, 0);
    if (first) return;
    __threadfence();
    const Pt<E> o = load_pt<E, true>(A.slot, A.M, j ^ h);
    q = j == i ? scan_add(s, q, o, P, b3) : scan_add(s, o, q, P, b3);
    j = i;
  }
  store_pt(A.out, 1, 0, q);
}

}  // namespace

// The scan over W totals (limb-major (k, 8, W) each) into out, with c
// doublings a window step.  slot: (k, 8, M) scratch for each coordinate,
// M the tree's width (1 for W = 1, else the power of two >= W, at least
// 2); arrivals: (M,) int32 zeros.  k = 1: b3 must be 9 (alt_bn128 G1);
// k = 2: b3_mont holds the Fq2 constant's 16 Montgomery limbs (c0, c1).
extern "C" int horner_scan(void* const* in, void* const* slot,
                           void* const* out, void* arrivals, int W, int M,
                           int c, int n32, int k, int b3,
                           const uint32_t* b3_mont, const uint32_t* p,
                           const uint32_t* one_mont, uint32_t inv,
                           int device, void* stream) {
  if (n32 != 8 || W < 1 || c < 0 || M < W || (M & (M - 1)) ||
      (W > 1 && M >= 2 * W) || (W == 1 && M != 1))
    return (int)cudaErrorInvalidValue;
  if (!(k == 1 && b3 == 9) && !(k == 2 && b3_mont != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ScanArgs A{};
  for (int i = 0; i < 3; i++) {
    A.in[i] = (const uint32_t*)in[i];
    A.slot[i] = (uint32_t*)slot[i];
    A.out[i] = (uint32_t*)out[i];
  }
  A.arrivals = (int*)arrivals;
  A.W = W;
  A.M = M;
  A.c = c;
  const FieldParams<8> P = field_params(p, one_mont, inv);
  Fe2 b3c{};
  if (k == 2) {
    for (int i = 0; i < 8; i++) {
      b3c.c0.v[i] = b3_mont[i];
      b3c.c1.v[i] = b3_mont[8 + i];
    }
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    horner_kernel<Fe<8>><<<W, 32, 0, s>>>(A, P, b3c);
  else
    horner_kernel<Fe2><<<W, 32, 0, s>>>(A, P, b3c);
  return (int)cudaGetLastError();
}
