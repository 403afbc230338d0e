// group_ops_g2_nr5_n12.cu -- kernel K3's G2 branch over 12-limb Fq2 with
// the non-residue nr = -5 (BLS12-377 G2), two threads an element
// (fp2_pair.cuh's Fp2Pair<12, -5>): group_ops.cu built at LFF_N32 = 12
// with this branch only, its own translation unit and library.  Same
// entry point, group_op_at, which refuses any other group.
#define LFF_N32 12
#define LFF_K3_BRANCHES 4
#include "group_ops.cu"
