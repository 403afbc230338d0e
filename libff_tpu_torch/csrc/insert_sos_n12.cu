// insert_sos_n12.cu -- kernel K2 and its fused merge K2m over 12-limb Fp
// (BLS12-381 and BLS12-377, G1 and G2) and fp.cuh's mul_sos
// (MsmConfig.kmul = "sos"): insert.cuh built at LFF_N32 = 12 over that
// product; the kernel and its note are in insert.cuh, the 12-limb
// branches as in insert_n12.cu.
#define LFF_N32 12
#include "insert.cuh"

LFF_INSERT_ENTRY(lff::Mul::Sos)
