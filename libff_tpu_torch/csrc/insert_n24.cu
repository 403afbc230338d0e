// insert_n24.cu -- kernel K2, its fused merge K2m and kernel K6 over
// 24-limb Fp (BW6-761's 761-bit Fq), CIOS: the insert of its G1 (b3 = -3)
// and of its G2 over Fq (b3 = 12), both on the Fp branch; insert.cuh built
// at LFF_N32 = 24, its own translation unit and library
// (insert_sos_n24.cu and insert_sos2_n24.cu build K2 and K2m over the SOS
// products).  Same C entry points and arguments as insert.cu's `insert`
// and `insert_v1`, which refuse any n32 but 24.  The chain kernel is
// insert.cuh's chain_kernel over FpField<24, b3>: one thread a chain, a
// bucket 72 words (each coordinate 24, already whole sectors), a point
// record 72, with the width's own LFF_ENTRIES_G1_N24 and
// LFF_MIN_BLOCKS_G1_N24; K2m's tail is merge.cuh's tree over the same
// context on those lane-major buckets, at LFF_K5_MIN_BLOCKS_G1_N24.  K2's
// sort (insert.cu bucket_lists) does not depend on the width and is
// launched from insert.cu's library.
#define LFF_N32 24
#include "insert.cuh"

LFF_INSERT_ENTRY(lff::Mul::Cios)

// K6, the v1 insert: both groups (b3 -3 or 12; the reference's only gate
// is a prime field, pallas_insert.py:212, and BW6-761's G2 lies over
// Fq), CIOS, raw buckets (24, W, B, L), K2's 24-limb chain kernel and
// repack under K6's own entry.
LFF_INSERT_V1_ENTRY
