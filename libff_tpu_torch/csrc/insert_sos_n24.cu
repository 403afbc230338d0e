// insert_sos_n24.cu -- kernel K2 and its fused merge K2m over 24-limb Fp
// (BW6-761's G1, b3 = -3, and G2 over Fq, b3 = 12) and fp.cuh's mul_sos
// (MsmConfig.kmul = "sos"): insert.cuh built at LFF_N32 = 24 over that
// product; the kernel and its note are in insert.cuh, the 24-limb
// branches as in insert_n24.cu.
#define LFF_N32 24
#include "insert.cuh"

LFF_INSERT_ENTRY(lff::Mul::Sos)
