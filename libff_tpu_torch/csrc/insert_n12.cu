// insert_n12.cu -- kernel K2 over 12-limb Fp: the G1 insert of BLS12-381
// (b3 = 12) and BLS12-377 (b3 = 3), CIOS, raw buckets, its own
// translation unit and library.  Same C entry point and arguments as
// insert.cu's `insert`, which refuses any n32 but 12, any branch but G1,
// any product but CIOS and the fused merge.  The chain kernel is
// insert.cuh's chain_kernel over FpField<12, b3>: a bucket is 36 words
// (48 in the lane-major arrays, each coordinate padded to whole
// sectors), a point record 36, with the 12-limb kEntries and blocks an
// SM.
// K2's sort (insert.cu bucket_lists) does not depend on the width and is
// launched from insert.cu's library.
#include "insert.cuh"

extern "C" int insert(int kmul, const void* off, const void* ent, int wide,
                      const void* rec, void* const* lane, void* bx, void* by,
                      void* bz, int W, int T, int L, int B, int n32, int k,
                      int b3, const uint32_t* b3_mont, const uint32_t* p,
                      const uint32_t* one_mont, uint32_t inv, void* const* m,
                      void* far, int device, void* stream) {
  (void)b3_mont;
  (void)far;
  if (kmul != (int)lff::Mul::Cios || n32 != 12 || W < 0 || T < 0 || L < 0 ||
      B <= 0 || (wide != 0 && wide != 1) || lane == nullptr || k != 1 ||
      (b3 != 12 && b3 != 3) || m != nullptr || bx == nullptr ||
      by == nullptr || bz == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)W * L == 0) return 0;
  const lff::FieldParams<12> P = lff::field_params<12>(p, one_mont, inv);
  const cudaStream_t s = (cudaStream_t)stream;
  if (b3 == 12)
    return lff::chain_launch(off, ent, wide, rec, lane, bx, by, bz, W, T, L,
                             B, lff::FpField<12, 12>{P}, s);
  return lff::chain_launch(off, ent, wide, rec, lane, bx, by, bz, W, T, L, B,
                           lff::FpField<12, 3>{P}, s);
}
