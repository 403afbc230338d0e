// merge_sos.cu -- kernel K5 over fp.cuh's mul_sos (MsmConfig.kmul =
// "sos"); the kernel and its note are in merge.cuh.
#include "merge.cuh"

LFF_MERGE_ENTRY(lff::Mul::Sos)
