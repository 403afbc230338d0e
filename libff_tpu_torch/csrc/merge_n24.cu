// merge_n24.cu -- kernel K5, the lane merge of the MSM buckets, over
// 24-limb Fp and the CIOS product: BW6-761's G1 (b3 = -3) and G2 over Fq
// (b3 = 12), both on the Fp branch, one thread an element; merge.cuh
// built at LFF_N32 = 24, its own translation unit and library.  The
// kernel and its note are in merge.cuh.
#define LFF_N32 24
#include "merge.cuh"

LFF_MERGE_ENTRY(lff::Mul::Cios)
