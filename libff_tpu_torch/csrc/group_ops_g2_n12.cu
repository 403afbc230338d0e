// group_ops_g2_n12.cu -- kernel K3's G2 branch over 12-limb Fq2 with the
// non-residue nr = -1 (BLS12-381 G2), two threads an element
// (fp2_pair.cuh's Fp2Pair<12, -1>): group_ops.cu built at LFF_N32 = 12
// with this branch only, its own translation unit and library.  Same
// entry point, group_op_at, which refuses any other group.
#define LFF_N32 12
#define LFF_K3_BRANCHES 2
#include "group_ops.cu"
