// insert.cu -- kernel K2 over the CIOS product (insert.cuh), and kernel
// K6, the v1 insert.
//
// K6 replaces libff_tpu/msm/pallas_insert.py:35 _insert_kernel (entry
// point insert_pallas, :198), the v1 insert, G1 only.  It computes the
// same function as K2's G1 branch on the same (n, W, B, L) bucket layout;
// what tells v1 from v3 on the TPU is the VMEM tile shape ((n, B, L)
// against (rows, B, Ls, 128)), which has no Hopper counterpart.  So its
// entry point insert_v1 launches K2's G1 kernel, under its own name and
// launch count.
#include "insert.cuh"

LFF_INSERT_ENTRY(lff::Mul::Cios)

// K6, the v1 insert: G1 only (b3 must be 9), raw buckets (8, W, B, L).
extern "C" int insert_v1(const void* d, const void* px, const void* py,
                         const void* pneg, const void* pinf, void* bx,
                         void* by, void* bz, int W, int T, int L, int B,
                         int n32, int b3, const uint32_t* p,
                         const uint32_t* one_mont, uint32_t inv, int device,
                         void* stream) {
  if (n32 != 8 || b3 != 9 || W < 0 || T < 0 || L < 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  return lff::insert_launch(d, px, py, pneg, pinf, bx, by, bz, W, T, L, B,
                            nullptr, lff::Rows{},
                            lff::FpField<9>{lff::field_params(p, one_mont,
                                                              inv)},
                            (cudaStream_t)stream);
}
