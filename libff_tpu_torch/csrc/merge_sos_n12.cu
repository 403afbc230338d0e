// merge_sos_n12.cu -- kernel K5 over 12-limb Fp and fp.cuh's mul_sos
// (MsmConfig.kmul = "sos"; G2 on pairs, the pair's lazy sums reduced in
// that product's order): merge.cuh built at LFF_N32 = 12; the kernel and
// its note are in merge.cuh.
#define LFF_N32 12
#include "merge.cuh"

LFF_MERGE_ENTRY(lff::Mul::Sos)
