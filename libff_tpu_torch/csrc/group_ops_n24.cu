// group_ops_n24.cu -- kernel K3 over 24-limb Fp (BW6-761's 761-bit Fq):
// its G1 (b3 = -3) and its G2, the M-twist over Fq itself (b3 = 12), both
// on the Fp branch: group_ops.cu built again at LFF_N32 = 24, its own
// translation unit and library.  Same entry point, group_op_at, which
// refuses any n32 but 24 and any other group.
#define LFF_N32 24
#define LFF_K3_BRANCHES 1
#include "group_ops.cu"
