// merge_sos2_n24.cu -- kernel K5 over 24-limb Fp and fp.cuh's mul_sos2
// (MsmConfig.kmul = "sos2"): BW6-761's G1 (b3 = -3) and G2 over Fq (b3 =
// 12); merge.cuh built at LFF_N32 = 24; the kernel and its note are in
// merge.cuh.
#define LFF_N32 24
#include "merge.cuh"

LFF_MERGE_ENTRY(lff::Mul::Sos2)
