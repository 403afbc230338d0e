// group_ops.cu -- kernel K3: one batched group formula, one thread per
// element.
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
// G2 padd 42 base products, 11,088 IMADs, against twice the bytes).  The design keeps
// the whole formula in registers: each coordinate is read once and
// written once, limb-major ((8, n) for Fp, (2, 8, n) for Fq2), so every
// limb load of a warp is one 128-byte transaction.
#include "formulas.cuh"

using namespace lff;

namespace {

enum Op { kPadd = 0, kPmadd = 1, kPdbl = 2, kAdd = 3, kMadd = 4, kDbl = 5 };

struct OpArgs {
  const uint32_t* in[6];  // coordinates, each (8, n) or (2, 8, n)
  const int32_t* mask;    // (n,) q_inf for pmadd/madd, else unused
  uint32_t* out[3];
  long long n;
};

template <class F, int OP>
__global__ void __launch_bounds__(128) group_op_kernel(OpArgs A, F f) {
  using E = typename F::E;
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= A.n) return;
  const long long n = A.n;
  const Pt<F> p{F::load(A.in[0], n, e), F::load(A.in[1], n, e),
                F::load(A.in[2], n, e)};
  Pt<F> r;
  if constexpr (OP == kPdbl) {
    r = rcb_dbl(f, p);
  } else if constexpr (OP == kDbl) {
    r = jac_dbl(f, p);
  } else if constexpr (OP == kPadd) {
    const Pt<F> q{F::load(A.in[3], n, e), F::load(A.in[4], n, e),
                  F::load(A.in[5], n, e)};
    r = rcb_add(f, p, q);
  } else if constexpr (OP == kPmadd) {
    const E qx = F::load(A.in[3], n, e), qy = F::load(A.in[4], n, e);
    r = select(A.mask[e] != 0, p, rcb_madd(f, p, qx, qy));
  } else {
    // Jacobian add / madd with the special cases of pallas_ops.py:102-140
    E h, rr;
    Pt<F> q;
    bool q_zero;
    if constexpr (OP == kAdd) {
      q = Pt<F>{F::load(A.in[3], n, e), F::load(A.in[4], n, e),
                F::load(A.in[5], n, e)};
      r = jac_add_raw(f, p, q, h, rr);
      q_zero = F::is_zero(q.z);
    } else {
      // affine Q as Jacobian (x, y, 1); its infinity lanes are overridden
      // by the q_zero select below
      q = Pt<F>{F::load(A.in[3], n, e), F::load(A.in[4], n, e), f.one()};
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

template <class F>
int launch_op(int op, const OpArgs& A, const F& f, int blocks, int threads,
              cudaStream_t s) {
  switch (op) {
    case kPadd: group_op_kernel<F, kPadd><<<blocks, threads, 0, s>>>(A, f); break;
    case kPmadd: group_op_kernel<F, kPmadd><<<blocks, threads, 0, s>>>(A, f); break;
    case kPdbl: group_op_kernel<F, kPdbl><<<blocks, threads, 0, s>>>(A, f); break;
    case kAdd: group_op_kernel<F, kAdd><<<blocks, threads, 0, s>>>(A, f); break;
    case kMadd: group_op_kernel<F, kMadd><<<blocks, threads, 0, s>>>(A, f); break;
    case kDbl: group_op_kernel<F, kDbl><<<blocks, threads, 0, s>>>(A, f); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// k = 1: b3 must be 9 (alt_bn128 G1) and b3_mont is unused; k = 2: b3_mont
// holds the 16 Montgomery limbs of the Fq2 constant b3 (c0 then c1).
extern "C" int group_op(int op, void* const* in, const void* mask,
                        void* const* out, long long n, int n32, int k,
                        int b3, const uint32_t* b3_mont, const uint32_t* p,
                        const uint32_t* one_mont, uint32_t inv, int device,
                        void* stream) {
  if (n32 != 8 || n < 0) return (int)cudaErrorInvalidValue;
  if (!(k == 1 && b3 == 9) && !(k == 2 && b3_mont != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  OpArgs A{};
  for (int i = 0; i < 6; i++) A.in[i] = (const uint32_t*)in[i];
  A.mask = (const int32_t*)mask;
  for (int i = 0; i < 3; i++) A.out[i] = (uint32_t*)out[i];
  A.n = n;
  const FieldParams<8> P = field_params(p, one_mont, inv);
  const int threads = 128;
  const int blocks = (int)((n + threads - 1) / threads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 1) return launch_op(op, A, FpField<9>{P}, blocks, threads, s);
  Fp2Field<> f{P, {}};
  for (int i = 0; i < 8; i++) {
    f.b3.c0.v[i] = b3_mont[i];
    f.b3.c1.v[i] = b3_mont[8 + i];
  }
  return launch_op(op, A, f, blocks, threads, s);
}
