// insert.cu -- kernel K2 over the CIOS product (insert.cuh) with its sort
// launch, and kernel K6, the v1 insert, at 8 limbs (insert_n12.cu builds
// K2 and K6 at 12).
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

// K2's sort (insert.cuh bucket_lists_kernel), the same for every product,
// group and width: d (W, T, L) int32 and pinf (T, L) bool (one byte each)
// in; off (W, L, B + 1) int32 and ent (W, L, T), int32 if wide else int16
// (which needs T <= 16384), out.
extern "C" int bucket_lists(const void* d, const void* pinf, void* off,
                            void* ent, int wide, int W, int T, int L, int B,
                            int device, void* stream) {
  if (W < 0 || T < 0 || L < 0 || B <= 0 || (wide != 0 && wide != 1) ||
      (!wide && T > 16384))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return wide ? lff::sort_launch<int32_t>(d, pinf, off, ent, W, T, L, B, s)
              : lff::sort_launch<int16_t>(d, pinf, off, ent, W, T, L, B, s);
}

// K6, the v1 insert: G1 only (b3 must be 9), CIOS, raw buckets (8, W, B,
// L), from the sort's lists, the point records and the lane-major scratch
// as K2 takes them (insert.cuh insert_v1_entry).
LFF_INSERT_V1_ENTRY
