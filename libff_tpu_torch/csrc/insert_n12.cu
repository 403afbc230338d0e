// insert_n12.cu -- kernel K2, its fused merge K2m and kernel K6 over
// 12-limb Fp, CIOS: the G1 insert of BLS12-381 (b3 = 12) and BLS12-377
// (b3 = 3) and their G2 insert over Fq2 (nr = -1 and -5, b3 the twist's
// Fq2 constant); insert.cuh built at LFF_N32 = 12, its own translation
// unit and library (insert_sos_n12.cu and insert_sos2_n12.cu build K2 and
// K2m over the SOS products).  Same C entry points and arguments as
// insert.cu's `insert` and `insert_v1`, which refuse any n32 but 12.  The
// chain kernel is insert.cuh's chain_kernel over FpField<12, b3> (G1: a
// bucket is 36 words, 48 in the lane-major arrays, each coordinate padded
// to whole sectors, a point record 36, with the 12-limb kEntries and
// blocks an SM) or over fp2_pair.cuh's Fp2Pair<12, NR> (G2: two threads a
// chain, each holding one coefficient of the 72-word bucket and of the
// point, with the 12-limb G2 kEntries and blocks an SM); K2m's tail is
// merge.cuh's tree over the same contexts on those lane-major buckets
// (16 words a coordinate on G1, 24 on G2).  K2's sort (insert.cu
// bucket_lists) does not depend on the width and is launched from
// insert.cu's library.
#define LFF_N32 12
#include "insert.cuh"

LFF_INSERT_ENTRY(lff::Mul::Cios)

// K6, the v1 insert: G1 only (b3 12 or 3), CIOS, raw buckets (12, W, B,
// L), K2's 12-limb G1 chain kernel and repack under K6's own entry.
LFF_INSERT_V1_ENTRY
