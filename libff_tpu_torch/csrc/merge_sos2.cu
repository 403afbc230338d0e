// merge_sos2.cu -- kernel K5 over fp.cuh's mul_sos2 (MsmConfig.kmul =
// "sos2"); the kernel and its note are in merge.cuh.
#include "merge.cuh"

LFF_MERGE_ENTRY(lff::Mul::Sos2)
