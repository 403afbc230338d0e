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
//     18, 6 and 18 on G2;
//   - on G1 (lane_dbl, lane_add) each product's operands go to its lane by
//     __shfl_sync, in registers, and the additions between two levels run
//     on the lanes that consume them, each lane its own chain at once (the
//     doubling's 8 t0 on lanes 0-1 while lanes 2-3 make b3 z^2 and t0 -
//     3 t2 from it): between a doubling's two levels a lane waits for
//     four to six additions, not the whole formula's;
//   - at 12 limbs every G1 product is chain_mul.cuh's two-accumulator
//     product, whose two carry chains a row run side by side (0.93 against
//     CIOS's 1.28 us a lone product on an H100, K7b lone n12);
//   - on G2 lane j takes its operands from shared memory, runs one
//     Montgomery product and writes it back, and every lane does the
//     formula's additions itself; at 12 limbs that product too is
//     chain_mul.cuh's two-accumulator one;
//   - the sum tree runs by arrival: a window's block, when done, publishes
//     its point and counts itself in at its pair; the second of a pair adds
//     the two (lower slot first, as proj_sum_tree does) and goes on to the
//     next level, the first leaves.  No block waits for another, so the
//     launch needs no co-residency, and the last add writes the result.
//     A pair whose upper slot is padding adds the identity itself, as the
//     padded tree does.
//
// Widths: this file builds the 8-limb library (alt_bn128 G1, and G2 with
// nr = -1); horner_n12.cu builds it again at LFF_N32 = 12, its own
// translation unit: the G1 branch over 12-limb Fp with b3 = 12
// (BLS12-381) or 3 (BLS12-377), and the G2 branch over their Fq2 with nr
// = -1 (BLS12-381) or -5 (BLS12-377), b3 a runtime Fq2 constant.
// horner_n24.cu builds the G1 branch at LFF_N32 = 24 over CIOS (BW6-761:
// its G1 with b3 = -3 and its G2 over Fq with b3 = 12; chain_mul.cuh's
// product is written for 12 limbs), with no G2 branch (no Fq2 there).
#include "chain_mul.cuh"
#include "fp2.cuh"

// the limb count of the library's field (8 unless a width's own source
// sets it before including this file)
#ifndef LFF_N32
#define LFF_N32 8
#endif

using namespace lff;

namespace {

constexpr int N = LFF_N32;

template <class E>
struct Pt {
  E x, y, z;
};

// -- G2's body: a level's base products through shared memory --------------

// 16-byte words of a base-field element
constexpr int kQuads = N / 4;

// base products of one level: an Fq2 add's six Karatsuba products
constexpr int kMaxLevel = 18;

// one window's exchange: the level's operands and its products, 4 N
// bytes an element
struct Slots {
  uint4 a[kMaxLevel][kQuads], b[kMaxLevel][kQuads], r[kMaxLevel][kQuads];
};

__device__ __forceinline__ void put(uint4* s, const Fe<N>& x) {
#pragma unroll
  for (int q = 0; q < kQuads; q++)
    s[q] = make_uint4(x.v[4 * q], x.v[4 * q + 1], x.v[4 * q + 2],
                      x.v[4 * q + 3]);
}

__device__ __forceinline__ Fe<N> get(const uint4* s) {
  Fe<N> x;
#pragma unroll
  for (int q = 0; q < kQuads; q++) {
    const uint4 w = s[q];
    x.v[4 * q] = w.x;
    x.v[4 * q + 1] = w.y;
    x.v[4 * q + 2] = w.z;
    x.v[4 * q + 3] = w.w;
  }
  return x;
}

__device__ __forceinline__ void operands(Slots& s, int j, const Fe<N>& x,
                                         const Fe<N>& y) {
  put(s.a[j], x);
  put(s.b[j], y);
}

// The scan's product at this width: chain_mul.cuh's two-accumulator
// product at 12 limbs, fp.cuh's CIOS at 8 and 24
__device__ __forceinline__ Fe<N> scan_mul(const Fe<N>& a, const Fe<N>& b,
                                          const FieldParams<N>& P) {
#if LFF_N32 == 12
  return mul_eo(a, b, P);
#else
  return mul(a, b, P);
#endif
}

// The level's n base products: every lane has written the same operands;
// lane j < n multiplies pair j, and after the second barrier every lane
// reads every product.
__device__ __forceinline__ void level(Slots& s, int n,
                                      const FieldParams<N>& P) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  if (lane < n) put(s.r[lane], scan_mul(get(s.a[lane]), get(s.b[lane]), P));
  __syncwarp();
}

using E2 = Fe2<N>;

// Fq2 over Fq[u]/(u^2 - nr), nr = NR: fp2.cuh's Karatsuba product (v0,
// v1, (a0+a1)(b0+b1)) and complex square (a0 a1, (a0+a1)(a0+nr a1)),
// written at slot j and recombined as there from the products at j
template <int NR>
struct Ops {
  using E = E2;
  static constexpr int kMul = 3, kSqr = 2;
  static __device__ __forceinline__ void mul(Slots& s, int j, const E& x,
                                             const E& y,
                                             const FieldParams<N>& P) {
    operands(s, j, x.c0, y.c0);
    operands(s, j + 1, x.c1, y.c1);
    operands(s, j + 2, add(x.c0, x.c1, P), add(y.c0, y.c1, P));
  }
  static __device__ __forceinline__ void sqr(Slots& s, int j, const E& x,
                                             const FieldParams<N>& P) {
    operands(s, j, x.c0, x.c1);
    operands(s, j + 1, add(x.c0, x.c1, P), add_nr<NR>(x.c0, x.c1, P));
  }
  static __device__ __forceinline__ E mul_out(const Slots& s, int j,
                                              const FieldParams<N>& P) {
    const Fe<N> v0 = get(s.r[j]), v1 = get(s.r[j + 1]);
    return E{add_nr<NR>(v0, v1, P), sub(sub(get(s.r[j + 2]), v0, P), v1, P)};
  }
  // c0 = t - v - nr v (t with nr = -1), c1 = 2v
  static __device__ __forceinline__ E sqr_out(const Slots& s, int j,
                                              const FieldParams<N>& P) {
    const Fe<N> v = get(s.r[j]), t = get(s.r[j + 1]);
    if constexpr (NR == -1) {
      return E{t, dbl(v, P)};
    } else {
      return E{sub(t, add_nr<NR>(v, v, P), P), dbl(v, P)};
    }
  }
};

// b3 times a (and times b): the twist's Fq2 constant, one level of
// Karatsuba products
template <class O>
__device__ __forceinline__ void times_b3(Slots& s, const E2& a,
                                         const E2& b, E2& ra, E2& rb,
                                         int both, const FieldParams<N>& P,
                                         const E2& b3) {
  O::mul(s, 0, a, b3, P);
  if (both) O::mul(s, 3, b, b3, P);
  level(s, both ? 6 : 3, P);
  ra = O::mul_out(s, 0, P);
  if (both) rb = O::mul_out(s, 3, P);
}

// rcb_dbl (formulas.cuh; formulas.py:124-138) with its products by level
template <class O>
__device__ __forceinline__ Pt<E2> scan_dbl(Slots& s, const Pt<E2>& p,
                                           const FieldParams<N>& P,
                                           const E2& b3) {
  using E = E2;
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
  times_b3<O>(s, zz, zz, t2, t2, 0, P, b3);
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
template <class O>
__device__ __forceinline__ Pt<E2> scan_add(Slots& s, const Pt<E2>& p,
                                           const Pt<E2>& q,
                                           const FieldParams<N>& P,
                                           const E2& b3) {
  using E = E2;
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
  times_b3<O>(s, t2, t5, t2, ry, 1, P, b3);
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

// A point of limb-major (k, N, n) coordinate arrays: coefficient c's limb
// i at base[(c * N + i) * n + e].  ld.global.cg where another block wrote
// it in this launch: L2, never a stale L1 line.
template <bool kCg>
__device__ __forceinline__ Fe<N> load_el(const uint32_t* base, long long n,
                                         long long e) {
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; i++) r.v[i] = kCg ? __ldcg(base + i * n + e)
                                           : base[i * n + e];
  return r;
}

template <bool kCg>
__device__ __forceinline__ void load_as(Fe<N>& r, const uint32_t* base,
                                        long long n, long long e) {
  r = load_el<kCg>(base, n, e);
}

__device__ __forceinline__ void store_as(uint32_t* base, long long n,
                                         long long e, const Fe<N>& a) {
  store<N>(base, n, e, a);
}

template <bool kCg>
__device__ __forceinline__ void load_as(E2& r, const uint32_t* base,
                                        long long n, long long e) {
  r.c0 = load_el<kCg>(base, n, e);
  r.c1 = load_el<kCg>(base + N * n, n, e);
}

__device__ __forceinline__ void store_as(uint32_t* base, long long n,
                                         long long e, const E2& a) {
  store2(base, n, e, a);
}

struct ScanArgs {
  const uint32_t* in[3];  // the totals' X, Y, Z, each (k, N, W)
  uint32_t* slot[3];      // the tree's published points, each (k, N, M)
  uint32_t* out[3];       // the sum, each (k, N, 1)
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

// -- G1's lane body: each product's operands handed to its lane ------------

// lane src's a, on every lane
__device__ __forceinline__ Fe<N> from_lane(const Fe<N>& a, int src) {
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.v[k] = __shfl_sync(0xFFFFFFFFu, a.v[k], src);
  return r;
}

// rcb_dbl on the lanes of a warp, every lane holding q and ending with
// the double.  Level 1: lane 0 y^2 = t0, lane 1 y z = t1, lane 2 z^2,
// lane 3 (and up) x y.  Between: t0 and z^2 go to every lane; lanes 0, 1
// make 8 t0 while lanes 2, 3 make b3 z^2 = t2 by one addition chain
// (2u, then 4 t0 | 3 z^2, then 8 t0 | 6 z^2, ...); lanes 2, 3 then t0 - 3
// t2 and t0 + t2.  Level 2: lane 0 t2 (8 t0) = x3, lane 1 t1 (8 t0) =
// z3, lane 2 (t0 - 3 t2)(t0 + t2) = A, lane 3 (t0 - 3 t2) x y = B; every
// lane then takes them and forms (2 B, A + x3, z3).  A negative b3 (-3:
// BW6-761's G1) negates the chain's 3 z^2, as mul_small does.
template <int B3>
__device__ __forceinline__ Pt<Fe<N>> lane_dbl(const Pt<Fe<N>>& q, int j,
                                              const FieldParams<N>& P) {
  using E = Fe<N>;
  const E o1 = select(j >= 3, q.x, select(j == 2, q.z, q.y));
  const E o2 = select(j == 1 || j == 2, q.z, q.y);
  const E m = scan_mul(o1, o2, P);
  const E t0 = from_lane(m, 0), zz = from_lane(m, 2);
  const bool lo = j < 2;
  const E v1 = dbl(select(lo, t0, zz), P);
  E rz, t2;
  if constexpr (B3 == 9) {
    const E v3 = dbl(add(v1, v1, P), P);                   // 8 t0 | 8 zz
    rz = v3;
    t2 = add(v3, zz, P);
  } else {
    static_assert(B3 == 12 || B3 == 3 || B3 == -3, "b3 is 9, 12, 3 or -3");
    const E v2 = add(v1, select(lo, v1, zz), P);           // 4 t0 | 3 zz
    rz = dbl(v2, P);                                       // 8 t0 | 6 zz
    if constexpr (B3 == 12) {
      t2 = dbl(rz, P);
    } else if constexpr (B3 == 3) {
      t2 = v2;
    } else {
      t2 = neg(v2, P);
    }
  }
  const E t2l = from_lane(t2, 2);                          // lane 0's t2
  const E t0m = sub(t0, add(dbl(t2, P), t2, P), P);
  const E ry = add(t0, t2, P);
  const E p1 = select(j == 0, t2l, select(j == 1, m, t0m));
  const E p2 = select(lo, rz, select(j == 2, ry, m));
  const E r = scan_mul(p1, p2, P);
  const E x3 = from_lane(r, 0), z3 = from_lane(r, 1);
  const E a = from_lane(r, 2), b = from_lane(r, 3);
  return Pt<E>{dbl(b, P), add(a, x3, P), z3};
}

// lane j's pick of six values, the sixth for lanes 5 and up
__device__ __forceinline__ Fe<N> of6(int j, const Fe<N>& v0, const Fe<N>& v1,
                                     const Fe<N>& v2, const Fe<N>& v3,
                                     const Fe<N>& v4, const Fe<N>& v5) {
  return select(j < 3, select(j == 0, v0, select(j == 1, v1, v2)),
                select(j == 3, v3, select(j == 4, v4, v5)));
}

// rcb_add on the lanes of a warp, every lane holding p and q and ending
// with the sum: each level's six products on lanes 0-5, each product's
// result to every lane, the additions on every lane.
template <int B3>
__device__ __forceinline__ Pt<Fe<N>> lane_add(const Pt<Fe<N>>& p,
                                              const Pt<Fe<N>>& q, int j,
                                              const FieldParams<N>& P) {
  using E = Fe<N>;
  const E a = of6(j, p.x, p.y, p.z, add(p.x, p.y, P), add(p.y, p.z, P),
                  add(p.x, p.z, P));
  const E b = of6(j, q.x, q.y, q.z, add(q.x, q.y, P), add(q.y, q.z, P),
                  add(q.x, q.z, P));
  const E m = scan_mul(a, b, P);
  const E t0 = from_lane(m, 0), t1 = from_lane(m, 1), t2 = from_lane(m, 2);
  const E t3 = sub(from_lane(m, 3), add(t0, t1, P), P);
  const E t4 = sub(from_lane(m, 4), add(t1, t2, P), P);
  const E t5 = sub(from_lane(m, 5), add(t0, t2, P), P);
  const E t0n = add(dbl(t0, P), t0, P);
  const E bt2 = mul_small<B3, N>(t2, P);
  const E z3 = add(t1, bt2, P), t1n = sub(t1, bt2, P);
  const E y3 = mul_small<B3, N>(t5, P);
  const E r = scan_mul(of6(j, t3, t4, t1n, y3, z3, t0n),
                       of6(j, t1n, y3, z3, t0n, t4, t3), P);
  return Pt<E>{sub(from_lane(r, 0), from_lane(r, 1), P),
               add(from_lane(r, 2), from_lane(r, 3), P),
               add(from_lane(r, 4), from_lane(r, 5), P)};
}

// -- the scan ----------------------------------------------------------------

// G2's steps over nr = NR: a level's products through shared memory
template <int NR>
struct SlotSteps {
  using E = E2;
  Slots& s;
  const FieldParams<N>& P;
  const E2& b3;
  __device__ __forceinline__ Pt<E> dbl(const Pt<E>& q) const {
    return scan_dbl<Ops<NR>>(s, q, P, b3);
  }
  __device__ __forceinline__ Pt<E> add(const Pt<E>& p, const Pt<E>& q) const {
    return scan_add<Ops<NR>>(s, p, q, P, b3);
  }
  __device__ __forceinline__ Pt<E> identity() const {
    return Pt<E>{E{}, E2{lff::one<N>(P), zero<N>()}, E{}};
  }
};

// G1's steps: the lane body
template <int B3>
struct LaneSteps {
  using E = Fe<N>;
  int j;
  const FieldParams<N>& P;
  __device__ __forceinline__ Pt<E> dbl(const Pt<E>& q) const {
    return lane_dbl<B3>(q, j, P);
  }
  __device__ __forceinline__ Pt<E> add(const Pt<E>& p, const Pt<E>& q) const {
    return lane_add<B3>(p, q, j, P);
  }
  __device__ __forceinline__ Pt<E> identity() const {
    return Pt<E>{E{}, lff::one<N>(P), E{}};
  }
};

// Window w's warp: c w doublings, then the sum tree by arrival
template <class Steps>
__device__ __forceinline__ void scan_window(const ScanArgs& A,
                                            const Steps& st) {
  using E = typename Steps::E;
  const int w = blockIdx.x;
  Pt<E> q = load_pt<E, false>(A.in, A.W, w);
  const int steps = A.c * w;
#pragma unroll 1
  for (int k = 0; k < steps; k++) q = st.dbl(q);
  int j = w;
#pragma unroll 1
  for (int h = A.M >> 1; h >= 1; h >>= 1) {
    const int i = j & (h - 1);             // the pair (i, i + h)
    if (j == i && i + h >= A.W) {
      // the upper slot is padding, the identity exactly (sums of identity
      // pads stay (0, 1, 0) bit for bit)
      q = st.add(q, st.identity());
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
    q = j == i ? st.add(q, o) : st.add(o, q);
    j = i;
  }
  store_pt(A.out, 1, 0, q);
}

// One warp a block, block w the window w: G1 at b3 = B3 on the lane
// body, G2 (b3 its Fq2 constant) on the shared-memory one.
template <int B3>
__global__ void __launch_bounds__(32) horner_kernel(ScanArgs A,
                                                    FieldParams<N> P) {
  scan_window(A, LaneSteps<B3>{(int)(threadIdx.x & 31), P});
}

template <int NR>
__global__ void __launch_bounds__(32) horner_g2_kernel(ScanArgs A,
                                                       FieldParams<N> P,
                                                       E2 b3) {
  __shared__ Slots s;
  scan_window(A, SlotSteps<NR>{s, P, b3});
}

}  // namespace

// The scan over W totals (limb-major (k, N, W) each) into out, with c
// doublings a window step.  slot: (k, N, M) scratch for each coordinate,
// M the tree's width (1 for W = 1, else the power of two >= W, at least
// 2); arrivals: (M,) int32 zeros.  n32 must be the library's width N.
// k = 1: b3 must be 9 at 8 limbs (alt_bn128 G1), 12 (BLS12-381 G1) or 3
// (BLS12-377 G1) at 12, -3 (BW6-761 G1) or 12 (BW6-761 G2) at 24.  k = 2
// (not at 24): b3 is the Fq2's non-residue nr, -1 at 8
// limbs (alt_bn128 G2), -1 (BLS12-381 G2) or -5 (BLS12-377 G2) at 12, and
// b3_mont holds the Fq2 constant's 2N Montgomery limbs (c0, c1).
extern "C" int horner_scan(void* const* in, void* const* slot,
                           void* const* out, void* arrivals, int W, int M,
                           int c, int n32, int k, int b3,
                           const uint32_t* b3_mont, const uint32_t* p,
                           const uint32_t* one_mont, uint32_t inv,
                           int device, void* stream) {
  if (n32 != N || W < 1 || c < 0 || M < W || (M & (M - 1)) ||
      (W > 1 && M >= 2 * W) || (W == 1 && M != 1))
    return (int)cudaErrorInvalidValue;
  const bool g1 = k == 1 && (N == 8    ? b3 == 9
                             : N == 12 ? b3 == 12 || b3 == 3
                                       : b3 == -3 || b3 == 12);
  const bool g2 = k == 2 && N != 24 && b3_mont != nullptr &&
                  (b3 == -1 || (N == 12 && b3 == -5));
  if (!g1 && !g2) return (int)cudaErrorInvalidValue;
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
  const FieldParams<N> P = field_params<N>(p, one_mont, inv);
  const cudaStream_t s = (cudaStream_t)stream;
#if LFF_N32 != 24
  if (k == 2) {
    const E2 b3c = fe2_from<N>(b3_mont);
    if (b3 == -1) {
      horner_g2_kernel<-1><<<W, 32, 0, s>>>(A, P, b3c);
    } else {
#if LFF_N32 == 12
      horner_g2_kernel<-5><<<W, 32, 0, s>>>(A, P, b3c);
#endif
    }
    return (int)cudaGetLastError();
  }
#endif
#if LFF_N32 == 8
  horner_kernel<9><<<W, 32, 0, s>>>(A, P);
#elif LFF_N32 == 12
  if (b3 == 12)
    horner_kernel<12><<<W, 32, 0, s>>>(A, P);
  else
    horner_kernel<3><<<W, 32, 0, s>>>(A, P);
#elif LFF_N32 == 24
  if (b3 == 12)
    horner_kernel<12><<<W, 32, 0, s>>>(A, P);
  else
    horner_kernel<-3><<<W, 32, 0, s>>>(A, P);
#else
#error "horner.cu is built for 8, 12 or 24 limbs"
#endif
  return (int)cudaGetLastError();
}
