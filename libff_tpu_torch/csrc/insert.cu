// insert.cu -- kernel K2 over the CIOS product (insert.cuh) with its sort
// launch, and kernel K6, the v1 insert.
//
// K6 replaces libff_tpu/msm/pallas_insert.py:35 _insert_kernel (entry
// point insert_pallas, :198), the v1 insert, G1 only.  It computes the
// same function as K2's G1 branch on the same (n, W, B, L) bucket layout;
// what tells v1 from v3 on the TPU is the VMEM tile shape ((n, B, L)
// against (rows, B, Ls, 128)), which has no Hopper counterpart.  So its
// entry point insert_v1 launches K2's G1 chain kernel after the same
// sort, under its own name and launch count.
#include "insert.cuh"

LFF_INSERT_ENTRY(lff::Mul::Cios)

// K2's sort (insert.cuh bucket_lists_kernel), the same for every product
// and group: d (W, T, L) int32 and pinf (T, L) bool in; off (W, L, B + 1)
// int32 and ent (W, L, T), int32 if wide else int16, out.
extern "C" int bucket_lists(const void* d, const void* pinf, void* off,
                            void* ent, int wide, int W, int T, int L, int B,
                            int device, void* stream) {
  return lff::bucket_lists_entry(d, pinf, off, ent, wide, W, T, L, B, device,
                                 stream);
}

// K6, the v1 insert: G1 only (b3 must be 9), raw buckets (8, W, B, L),
// from the sort's lists, the point records and the lane-major scratch as
// K2 takes them.
extern "C" int insert_v1(const void* off, const void* ent, int wide,
                         const void* rec, void* const* lane, void* bx,
                         void* by, void* bz, int W, int T, int L, int B,
                         int n32, int b3, const uint32_t* p,
                         const uint32_t* one_mont, uint32_t inv, int device,
                         void* stream) {
  if (n32 != 8 || b3 != 9 || W < 0 || T < 0 || L < 0 || B <= 0 ||
      (wide != 0 && wide != 1) || lane == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  if (bx == nullptr || by == nullptr || bz == nullptr)
    return (int)cudaErrorInvalidValue;
  return lff::chain_launch(
      off, ent, wide, rec, lane, bx, by, bz, W, T, L, B,
      lff::FpField<8, 9>{lff::field_params(p, one_mont, inv)},
      (cudaStream_t)stream);
}
