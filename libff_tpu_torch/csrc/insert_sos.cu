// insert_sos.cu -- kernel K2 and its fused merge K2m over fp.cuh's
// mul_sos (MsmConfig.kmul = "sos"); the kernel and its note are in
// insert.cuh.
#include "insert.cuh"

LFF_INSERT_ENTRY(lff::Mul::Sos)
