// group_ops.cu -- kernel K3: one batched group formula, one thread per
// element on G1, two per element on G2 (at 12 limbs padd and pmadd two
// on G1 and four on G2, split by products).
//
// Replaces libff_tpu/curves/pallas_ops.py:66 _op_kernel (entry point
// group_op_pallas, :160), both branches: k = 1 (G1 over Fp, b3 = 9) and
// k = 2 (G2 over Fq2, b3 the twist's general Fq2 constant, passed in).
// Ops: padd, pmadd, pdbl (complete RCB15 projective) and add, madd, dbl
// (Jacobian EFD, with the masks of pallas_ops.py:102-140 for P = 0,
// Q = 0, P = Q and P = -Q).  The TPU kernel needs N to be a multiple of
// one (8, 128) tile; here any N runs and the last block masks the ragged
// edge.
//
// Bound on an H100: integer multiply issue (a G1 padd is 12 Montgomery
// products, 3,168 IMADs, against 6 x 32 bytes in and 3 x 32 bytes out; a
// G2 padd 42 base products, 11,088 IMADs, against twice the bytes).  The
// design keeps the whole formula in registers: each coordinate is read
// once and written once, limb-major ((8, n) for Fp, (2, 8, n) for Fq2), so
// every limb load of a warp is one 128-byte transaction.
//
// Widths: this file builds the 8-limb library (alt_bn128: G1 with b3 = 9,
// G2 with nr = -1); group_ops_n12.cu builds it again with LFF_N32 = 12,
// the G1 branch over 12-limb Fp (BLS12-381 with b3 = 12, BLS12-377 with
// b3 = 3), and group_ops_g2_n12.cu and group_ops_g2_nr5_n12.cu the G2
// branch over their Fq2 (BLS12-381's, nr = -1, and BLS12-377's, nr = -5;
// b3 a runtime Fq2 constant either way), each its own translation unit,
// so nvcc compiles them in parallel (LFF_K3_BRANCHES).  At 12 limbs a
// padd is 12 products of 588 IMADs (7,056) against 6 x 48 bytes in and 3
// x 48 out, a G2 padd 42 (24,696) against twice the bytes: still the
// multiplies.  group_ops_n24.cu builds the Fp branch at LFF_N32 = 24
// (BW6-761's G1, b3 = -3, and its G2 over Fq, b3 = 12) on the one-thread
// body: a padd is 12 products of 2,328 IMADs (27,936) against 6 x 96
// bytes in and 3 x 96 out.  A 24-limb element is 24 registers, so a
// formula's live values exceed the 255 a thread has and spill (ptxas's
// figures are in the build log); fp.cuh's 24-limb product is one
// __noinline__ function, which each kernel calls.
//
// G2 runs its formulas over fp2_pair.cuh's Fp2Pair: the two threads of a
// pair each hold one coefficient of every Fq2 value and swap operands by
// shuffle, so a thread keeps half of a G2 formula's values.  With one
// thread a G2 element (fp2.cuh's Fp2Field, as K2 and K5 run) rcb_add
// needs 255 registers and spills, which leaves 8 warps an SM to hide the
// products' carry chains.  A pair's lanes are adjacent, so a warp's limb
// loads are two 64-byte runs, one a coefficient.
//
// At 12 limbs padd and pmadd run split by products (split_ops.cuh), for
// the ops whose bit is set in LFF_K3_PAIR_OPS_G1_N12 (G1: two threads an
// element, a value a thread) and LFF_K3_QUAD_OPS_G2_N12 (G2: four
// threads an element, a value a pair).  On G2 a pair element's thread
// keeps 12-word coefficients of both points and the formula's
// temporaries in the whole 255 registers, so only 2 blocks of 128 fit an
// SM (8 warps); the quad splits each level's Fq2 products between its
// two pairs, each pair holding what its own products need, and runs
// LFF_K3_MIN_BLOCKS_G2_N12_QUAD = 4 blocks an SM (128 registers, 16-112
// bytes of spills; at 3, 168 registers, and at 5, 96, it ran 25% and
// 50% slower on an H100, PERF.md).  The other ops keep the one-thread
// (G1) or pair (G2) body.

// padd reads its inputs where they lie: element e is row e / cols,
// column e % cols, at row * rstride + column from each input's first
// word, its limbs lstride apart (an Fq2 coefficient 8 limbs on), one
// layout for every input.  So the reduce's lane halving (and its sum
// tree) passes the two halves of its buckets as they are, with no copy.
// That form is padd's own instantiation (kRows): every op on flat inputs
// keeps the one-row kernel, element e at e with limbs n apart, whose
// registers and spills the row arithmetic would raise (G2's padd spills
// at 128 registers).  The outputs are flat.
#include "formulas.cuh"
#include "fp2_pair.cuh"
#include "split_ops.cuh"

// __launch_bounds__'s blocks an SM for the G2 kernels (128 threads a
// block): the projective ops (padd, pmadd, pdbl) and the Jacobian ones
// (add, madd, dbl), chosen with tune_group_ops at 8 limbs
#ifndef LFF_K3_MIN_BLOCKS_G2_PROJ
#define LFF_K3_MIN_BLOCKS_G2_PROJ 4
#endif
#ifndef LFF_K3_MIN_BLOCKS_G2_JAC
#define LFF_K3_MIN_BLOCKS_G2_JAC 3
#endif
// G1 at 12 limbs: the ops (bit op of enum Op: 1 padd, 2 pmadd) that run
// the pair body, its blocks an SM, and the one-thread body's (0: no
// minimum, ptxas's choice), chosen with tune_group_ops
#ifndef LFF_K3_PAIR_OPS_G1_N12
#define LFF_K3_PAIR_OPS_G1_N12 3
#endif
#ifndef LFF_K3_MIN_BLOCKS_G1_N12_PAIR
#define LFF_K3_MIN_BLOCKS_G1_N12_PAIR 4
#endif
#ifndef LFF_K3_MIN_BLOCKS_G1_N12
#define LFF_K3_MIN_BLOCKS_G1_N12 0
#endif
// G2 at 12 limbs: the ops (bits as above) that run the quad body, and
// its blocks an SM, chosen with tune_group_ops
#ifndef LFF_K3_QUAD_OPS_G2_N12
#define LFF_K3_QUAD_OPS_G2_N12 3
#endif
#ifndef LFF_K3_MIN_BLOCKS_G2_N12_QUAD
#define LFF_K3_MIN_BLOCKS_G2_N12_QUAD 4
#endif
// the limb count of the library's field (8 unless a width's own source
// sets it before including this file)
#ifndef LFF_N32
#define LFF_N32 8
#endif
// the branches the library holds, bits of 1 (G1), 2 (G2 with nr = -1)
// and 4 (G2 with nr = -5, 12 limbs only): every one by default; the
// 12-limb sources split them (group_ops_n12.cu G1, group_ops_g2_n12.cu
// and group_ops_g2_nr5_n12.cu G2 for each nr): in one translation unit
// the 12-limb kernels kept nvcc busy four minutes
#ifndef LFF_K3_BRANCHES
#define LFF_K3_BRANCHES 7
#endif

using namespace lff;

namespace {

enum Op { kPadd = 0, kPmadd = 1, kPdbl = 2, kAdd = 3, kMadd = 4, kDbl = 5 };

struct OpArgs {
  const uint32_t* in[6];  // coordinates, each (N, ...) or (2, 8, ...)
  const int32_t* mask;    // (n,) q_inf for pmadd/madd, else unused
  uint32_t* out[3];       // each (N, n) or (2, 8, n)
  long long n;
  long long lstride;      // words between an input's limbs
  long long rstride;      // words between an input's rows
  long long cols;         // elements a row (n: a flat array)
};

// element e's coordinate in input i: a loader of the body's inputs, in
// rows (kRows) or flat
template <class F, bool kRows>
struct InputAt {
  const OpArgs& A;
  long long at;  // element e's word in every input
  __device__ __forceinline__ InputAt(const OpArgs& A, long long e)
      : A(A), at(e) {
    if constexpr (kRows) {
      const long long row = e / A.cols;
      at = row * A.rstride + (e - row * A.cols);
    }
  }
  __device__ __forceinline__ typename F::E operator()(int i) const {
    return F::load(A.in[i], kRows ? A.lstride : A.n, at);
  }
};

// op OP on element e, over field context f
template <class F, int OP, bool kRows>
__device__ __forceinline__ void group_op_body(const OpArgs& A, const F& f,
                                              long long e) {
  using E = typename F::E;
  const long long n = A.n;
  const InputAt<F, kRows> ld(A, e);
  const Pt<F> p{ld(0), ld(1), ld(2)};
  Pt<F> r;
  if constexpr (OP == kPdbl) {
    r = rcb_dbl(f, p);
  } else if constexpr (OP == kDbl) {
    r = jac_dbl(f, p);
  } else if constexpr (OP == kPadd) {
    const Pt<F> q{ld(3), ld(4), ld(5)};
    r = rcb_add(f, p, q);
  } else if constexpr (OP == kPmadd) {
    const E qx = ld(3), qy = ld(4);
    r = select(A.mask[e] != 0, p, rcb_madd(f, p, qx, qy));
  } else {
    // Jacobian add / madd with the special cases of pallas_ops.py:102-140
    E h, rr;
    Pt<F> q;
    bool q_zero;
    if constexpr (OP == kAdd) {
      q = Pt<F>{ld(3), ld(4), ld(5)};
      r = jac_add_raw(f, p, q, h, rr);
      q_zero = F::is_zero(q.z);
    } else {
      // affine Q as Jacobian (x, y, 1); its infinity lanes are overridden
      // by the q_zero select below
      q = Pt<F>{ld(3), ld(4), f.one()};
      r = jac_madd_raw(f, p, q.x, q.y, h, rr);
      q_zero = A.mask[e] != 0;
    }
    const Pt<F> d = jac_dbl(f, p);
    const bool p_zero = F::is_zero(p.z);
    const bool h_zero = F::is_zero(h), r_zero = F::is_zero(rr);
    const bool both_live = (OP == kMadd) ? !p_zero : (!p_zero && !q_zero);
    r = select(h_zero && r_zero && both_live, d, r);
    r = select(h_zero && !r_zero && both_live,
               Pt<F>{f.zero(), f.one(), f.zero()}, r);
    r = select(p_zero, q, r);
    r = select(q_zero, p, r);
  }
  F::store(A.out[0], n, e, r.x);
  F::store(A.out[1], n, e, r.y);
  F::store(A.out[2], n, e, r.z);
}

// G1: one thread an element; at 12 limbs LFF_K3_MIN_BLOCKS_G1_N12
// blocks an SM where it is set
#if LFF_N32 == 12 && LFF_K3_MIN_BLOCKS_G1_N12 > 0
#define LFF_K3_G1_BOUNDS __launch_bounds__(128, LFF_K3_MIN_BLOCKS_G1_N12)
#else
#define LFF_K3_G1_BOUNDS __launch_bounds__(128)
#endif
template <class F, int OP, bool kRows>
__global__ void LFF_K3_G1_BOUNDS
    group_op_kernel(const __grid_constant__ OpArgs A, F f) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= A.n) return;
  group_op_body<F, OP, kRows>(A, f, e);
}

// the split body (split_ops.cuh): two halves of 2 F::kThreads threads an
// element (G1 a pair, G2 a quad), each thread storing half of its
// coefficient of every output coordinate's limbs
template <class F, int OP, bool kRows>
__global__ void __launch_bounds__(128, F::kG1
                                           ? LFF_K3_MIN_BLOCKS_G1_N12_PAIR
                                           : LFF_K3_MIN_BLOCKS_G2_N12_QUAD)
    group_op_split_kernel(const __grid_constant__ OpArgs A, F f) {
  constexpr int N = sizeof(typename F::E) / 4;  // limbs a coefficient
  constexpr int kGroup = 2 * F::kThreads;       // threads an element
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long e = t / kGroup;
  if (e >= A.n) return;
  const bool c1 = half_of<F>();
  const InputAt<F, kRows> ld(A, e);
  Pt<F> r;
  if constexpr (OP == kPadd) {
    r = split_add(f, c1, ld);
  } else {
    static_assert(OP == kPmadd, "the split body runs padd and pmadd");
    r = split_madd(f, c1, ld);
    if (A.mask[e] != 0) r = Pt<F>{ld(0), ld(1), ld(2)};
  }
  // limb k0 + k of the thread's coefficient by selects on fixed limbs: an
  // index into r that varies by thread would put r in local memory
  const long long k0 =
      (F::kThreads == 2 ? (threadIdx.x & 1u) * N : 0) + (c1 ? N / 2 : 0);
#pragma unroll
  for (int k = 0; k < N / 2; k++) {
    const long long at = (k0 + k) * A.n + e;
    A.out[0][at] = c1 ? r.x.v[N / 2 + k] : r.x.v[k];
    A.out[1][at] = c1 ? r.y.v[N / 2 + k] : r.y.v[k];
    A.out[2][at] = c1 ? r.z.v[N / 2 + k] : r.z.v[k];
  }
}

// G2: two threads an element (a pair leaves together: same e).  At 12
// limbs a thread's 12-word coefficients need ptxas's whole 255 registers
// (its spills are in the build log), so no minimum of blocks an SM: two
// blocks of 128 fit at 255 anyway.
#if LFF_N32 == 12
#define LFF_K3_G2_PROJ 1
#define LFF_K3_G2_JAC 1
#else
#define LFF_K3_G2_PROJ LFF_K3_MIN_BLOCKS_G2_PROJ
#define LFF_K3_G2_JAC LFF_K3_MIN_BLOCKS_G2_JAC
#endif
template <class F, int OP, bool kRows>
__global__ void __launch_bounds__(128, (OP <= kPdbl ? LFF_K3_G2_PROJ
                                                    : LFF_K3_G2_JAC))
    group_op_g2_kernel(const __grid_constant__ OpArgs A, F f) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long e = t >> 1;
  if (e >= A.n) return;
  group_op_body<F, OP, kRows>(A, f, e);
}

// whether op OP of field context F runs the split body: padd and pmadd
// at 12 limbs, by the G1 and G2 bits
template <class F, int OP>
constexpr bool split_body() {
  constexpr int ops = F::kG1 ? LFF_K3_PAIR_OPS_G1_N12
                             : F::kThreads == 2 ? LFF_K3_QUAD_OPS_G2_N12 : 0;
  return sizeof(typename F::E) == 48 && OP <= kPmadd && ((ops >> OP) & 1);
}

template <class F, int OP, bool kRows>
void launch_one(const OpArgs& A, const F& f, cudaStream_t s) {
  constexpr int threads = 128;
  if constexpr (split_body<F, OP>()) {
    const long long all = 2 * F::kThreads * A.n;
    const int blocks = (int)((all + threads - 1) / threads);
    group_op_split_kernel<F, OP, kRows><<<blocks, threads, 0, s>>>(A, f);
  } else if constexpr (F::kG1) {
    const int blocks = (int)((A.n + threads - 1) / threads);
    group_op_kernel<F, OP, kRows><<<blocks, threads, 0, s>>>(A, f);
  } else {
    const int blocks = (int)((2 * A.n + threads - 1) / threads);
    group_op_g2_kernel<F, OP, kRows><<<blocks, threads, 0, s>>>(A, f);
  }
}

// rows for padd only; every other op takes flat inputs (one row of n,
// limbs n apart)
template <class F>
int launch_op(int op, const OpArgs& A, const F& f, cudaStream_t s) {
  if (A.cols < A.n || A.lstride != A.n) {
    if (op != kPadd) return (int)cudaErrorInvalidValue;
    launch_one<F, kPadd, true>(A, f, s);
    return (int)cudaGetLastError();
  }
  switch (op) {
    case kPadd: launch_one<F, kPadd, false>(A, f, s); break;
    case kPmadd: launch_one<F, kPmadd, false>(A, f, s); break;
    case kPdbl: launch_one<F, kPdbl, false>(A, f, s); break;
    case kAdd: launch_one<F, kAdd, false>(A, f, s); break;
    case kMadd: launch_one<F, kMadd, false>(A, f, s); break;
    case kDbl: launch_one<F, kDbl, false>(A, f, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// n32 must be the library's width N.  k = 1: b3 must be 9 at 8 limbs
// (alt_bn128 G1), 12 (BLS12-381 G1) or 3 (BLS12-377 G1) at 12, -3
// (BW6-761 G1) or 12 (BW6-761 G2) at 24, and b3_mont is unused.  k = 2:
// b3 is the Fq2's non-residue nr, -1 at 8 limbs (alt_bn128 G2), -1
// (BLS12-381 G2) or -5 (BLS12-377 G2) at 12, and b3_mont holds the 2N
// Montgomery limbs of the Fq2 constant b3 (c0 then c1).  Every
// input (its limb 0 of element 0 at in[i]) has its limbs lstride words
// apart and its rows of `cols` elements rstride words apart; any op but
// padd needs them flat (cols = lstride = n).
extern "C" int group_op_at(int op, void* const* in, long long lstride,
                           long long rstride, long long cols,
                           const void* mask, void* const* out, long long n,
                           int n32, int k, int b3, const uint32_t* b3_mont,
                           const uint32_t* p, const uint32_t* one_mont,
                           uint32_t inv, int device, void* stream) {
  constexpr int N = LFF_N32;
  if (n32 != N || n < 0 || (n > 0 && cols < 1))
    return (int)cudaErrorInvalidValue;
  constexpr int kBranches = LFF_K3_BRANCHES;
  const bool g1 = (kBranches & 1) && k == 1 &&
                  (N == 8    ? b3 == 9
                   : N == 12 ? b3 == 12 || b3 == 3
                             : b3 == -3 || b3 == 12);
  const bool g2 = k == 2 && b3_mont != nullptr &&
                  (((kBranches & 2) && b3 == -1) ||
                   ((kBranches & 4) && N == 12 && b3 == -5));
  if (!g1 && !g2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  OpArgs A{};
  for (int i = 0; i < 6; i++) A.in[i] = (const uint32_t*)in[i];
  A.lstride = lstride;
  A.rstride = rstride;
  A.cols = cols;
  A.mask = (const int32_t*)mask;
  for (int i = 0; i < 3; i++) A.out[i] = (uint32_t*)out[i];
  A.n = n;
  const FieldParams<N> P = field_params<N>(p, one_mont, inv);
  const cudaStream_t s = (cudaStream_t)stream;
#if LFF_N32 == 8
  if (k == 1) return launch_op(op, A, FpField<8, 9>{P}, s);
  return launch_op(op, A, fp2_pair<8, -1>(P, b3_mont), s);
#elif LFF_N32 == 12
#if LFF_K3_BRANCHES & 2
  if (k == 2 && b3 == -1)
    return launch_op(op, A, fp2_pair<12, -1>(P, b3_mont), s);
#endif
#if LFF_K3_BRANCHES & 4
  if (k == 2) return launch_op(op, A, fp2_pair<12, -5>(P, b3_mont), s);
#endif
#if LFF_K3_BRANCHES & 1
  if (b3 == 12) return launch_op(op, A, FpField<12, 12>{P}, s);
  return launch_op(op, A, FpField<12, 3>{P}, s);
#endif
  return (int)cudaErrorInvalidValue;
#elif LFF_N32 == 24
  if (k != 1) return (int)cudaErrorInvalidValue;
  if (b3 == 12) return launch_op(op, A, FpField<24, 12>{P}, s);
  return launch_op(op, A, FpField<24, -3>{P}, s);
#else
#error "group_ops.cu is built for 8, 12 or 24 limbs"
#endif
}
