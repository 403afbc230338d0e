// group_ops_n12.cu -- kernel K3's G1 branch over 12-limb Fp (BLS12-381,
// b3 = 12; BLS12-377, b3 = 3): group_ops.cu built again at LFF_N32 = 12,
// its own translation unit and library, so that nvcc compiles the two
// widths in parallel.  Same entry point, group_op, which refuses any n32
// but 12 and any group but these G1s.
#define LFF_N32 12
#include "group_ops.cu"
