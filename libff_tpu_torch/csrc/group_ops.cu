// group_ops.cu -- kernel K3: one batched group formula, one thread per
// element.
//
// Replaces libff_tpu/curves/pallas_ops.py:66 _op_kernel (entry point
// group_op_pallas, :160).  Ops: padd, pmadd, pdbl (complete RCB15
// projective) and add, madd, dbl (Jacobian EFD, with the masks of
// pallas_ops.py:102-140 for P = 0, Q = 0, P = Q and P = -Q).  The TPU
// kernel needs N to be a multiple of one (8, 128) tile; here any N runs
// and the last block masks the ragged edge.
//
// Bound on an H100: integer multiply issue (a padd is 12 Montgomery
// products, ~1,600 IMADs, against 9 x 32 bytes in and 3 x 32 bytes out).
// The design keeps the whole formula in registers: each coordinate is
// read once and written once, limb-major so every limb load of a warp is
// one 128-byte transaction.
#include "formulas.cuh"

using namespace lff;

namespace {

enum Op { kPadd = 0, kPmadd = 1, kPdbl = 2, kAdd = 3, kMadd = 4, kDbl = 5 };

struct OpArgs {
  const uint32_t* in[6];  // coordinates, each (8, n)
  const int32_t* mask;    // (n,) q_inf for pmadd/madd, else unused
  uint32_t* out[3];
  long long n;
};

template <int OP, int B3>
__global__ void __launch_bounds__(128)
    group_op_kernel(OpArgs A, FieldParams<8> P) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= A.n) return;
  const long long n = A.n;
  const Pt<8> p{load<8>(A.in[0], n, e), load<8>(A.in[1], n, e),
                load<8>(A.in[2], n, e)};
  Pt<8> r;
  if constexpr (OP == kPdbl) {
    r = rcb_dbl<B3>(p, P);
  } else if constexpr (OP == kDbl) {
    r = jac_dbl(p, P);
  } else if constexpr (OP == kPadd) {
    const Pt<8> q{load<8>(A.in[3], n, e), load<8>(A.in[4], n, e),
                  load<8>(A.in[5], n, e)};
    r = rcb_add<B3>(p, q, P);
  } else if constexpr (OP == kPmadd) {
    const Fe<8> qx = load<8>(A.in[3], n, e), qy = load<8>(A.in[4], n, e);
    r = select(A.mask[e] != 0, p, rcb_madd<B3>(p, qx, qy, P));
  } else {
    // Jacobian add / madd with the special cases of pallas_ops.py:102-140
    Fe<8> h, rr;
    Pt<8> q;
    bool q_zero;
    if constexpr (OP == kAdd) {
      q = Pt<8>{load<8>(A.in[3], n, e), load<8>(A.in[4], n, e),
                load<8>(A.in[5], n, e)};
      r = jac_add_raw(p, q, h, rr, P);
      q_zero = is_zero(q.z);
    } else {
      // affine Q as Jacobian (x, y, 1); its infinity lanes are overridden
      // by the q_zero select below
      q = Pt<8>{load<8>(A.in[3], n, e), load<8>(A.in[4], n, e), one(P)};
      r = jac_madd_raw(p, q.x, q.y, h, rr, P);
      q_zero = A.mask[e] != 0;
    }
    const Pt<8> d = jac_dbl(p, P);
    const bool p_zero = is_zero(p.z);
    const bool h_zero = is_zero(h), r_zero = is_zero(rr);
    const bool both_live = (OP == kMadd) ? !p_zero : (!p_zero && !q_zero);
    r = select(h_zero && r_zero && both_live, d, r);
    r = select(h_zero && !r_zero && both_live,
               Pt<8>{zero<8>(), one(P), zero<8>()}, r);
    r = select(p_zero, q, r);
    r = select(q_zero, p, r);
  }
  store<8>(A.out[0], n, e, r.x);
  store<8>(A.out[1], n, e, r.y);
  store<8>(A.out[2], n, e, r.z);
}

template <int B3>
int launch_b3(int op, const OpArgs& A, const FieldParams<8>& P, int blocks,
              int threads, cudaStream_t s) {
  switch (op) {
    case kPadd: group_op_kernel<kPadd, B3><<<blocks, threads, 0, s>>>(A, P); break;
    case kPmadd: group_op_kernel<kPmadd, B3><<<blocks, threads, 0, s>>>(A, P); break;
    case kPdbl: group_op_kernel<kPdbl, B3><<<blocks, threads, 0, s>>>(A, P); break;
    case kAdd: group_op_kernel<kAdd, B3><<<blocks, threads, 0, s>>>(A, P); break;
    case kMadd: group_op_kernel<kMadd, B3><<<blocks, threads, 0, s>>>(A, P); break;
    case kDbl: group_op_kernel<kDbl, B3><<<blocks, threads, 0, s>>>(A, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int group_op(int op, void* const* in, const void* mask,
                        void* const* out, long long n, int n32, int b3,
                        const uint32_t* p, const uint32_t* one_mont,
                        uint32_t inv, int device, void* stream) {
  if (n32 != 8 || n < 0 || b3 != 9) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  OpArgs A{};
  for (int i = 0; i < 6; i++) A.in[i] = (const uint32_t*)in[i];
  A.mask = (const int32_t*)mask;
  for (int i = 0; i < 3; i++) A.out[i] = (uint32_t*)out[i];
  A.n = n;
  FieldParams<8> P{};
  for (int k = 0; k < 8; k++) {
    P.p[k] = p[k];
    P.one[k] = one_mont[k];
  }
  P.inv = inv;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  return launch_b3<9>(op, A, P, (int)blocks, threads, (cudaStream_t)stream);
}
