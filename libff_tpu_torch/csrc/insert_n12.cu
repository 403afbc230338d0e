// insert_n12.cu -- kernel K2 over 12-limb Fp: the G1 insert of BLS12-381
// (b3 = 12) and BLS12-377 (b3 = 3), CIOS, raw buckets
// (insert.cuh insert_entry_n12), its own translation unit and library.
// Same C entry point and arguments as insert.cu's `insert`, which refuses
// any n32 but 12, any branch but G1, any product but CIOS and the fused
// merge.  K2's sort (insert.cu bucket_lists) does not depend on the width
// and is launched from insert.cu's library.
#include "insert.cuh"

extern "C" int insert(int kmul, const void* off, const void* ent, int wide,
                      const void* rec, void* const* lane, void* bx, void* by,
                      void* bz, int W, int T, int L, int B, int n32, int k,
                      int b3, const uint32_t* b3_mont, const uint32_t* p,
                      const uint32_t* one_mont, uint32_t inv, void* const* m,
                      void* far, int device, void* stream) {
  (void)b3_mont;
  (void)far;
  return lff::insert_entry_n12(kmul, off, ent, wide, rec, lane, bx, by, bz,
                               W, T, L, B, n32, k, b3, p, one_mont, inv, m,
                               device, stream);
}
