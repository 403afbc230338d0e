// merge.cu -- kernel K5, the lane merge of the MSM buckets, over the CIOS
// product; the kernel and its note are in merge.cuh.
#include "merge.cuh"

LFF_MERGE_ENTRY(lff::Mul::Cios)
