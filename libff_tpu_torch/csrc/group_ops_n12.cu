// group_ops_n12.cu -- kernel K3's G1 branch over 12-limb Fp (BLS12-381,
// b3 = 12; BLS12-377, b3 = 3): group_ops.cu built again at LFF_N32 = 12,
// its own translation unit and library, so that nvcc compiles the
// widths in parallel.  Same entry point, group_op_at, which refuses any
// n32 but 12 and any group but these G1s (their G2 is
// group_ops_g2_n12.cu's and group_ops_g2_nr5_n12.cu's).
#define LFF_N32 12
#define LFF_K3_BRANCHES 1
#include "group_ops.cu"
