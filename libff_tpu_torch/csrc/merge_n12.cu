// merge_n12.cu -- kernel K5, the lane merge of the MSM buckets, over
// 12-limb Fp and the CIOS product: BLS12-381 (G1 b3 = 12, G2 nr = -1) and
// BLS12-377 (G1 b3 = 3, G2 nr = -5), G2 on pairs of threads; merge.cuh
// built at LFF_N32 = 12, its own translation unit and library.  The
// kernel and its note are in merge.cuh.
#define LFF_N32 12
#include "merge.cuh"

LFF_MERGE_ENTRY(lff::Mul::Cios)
