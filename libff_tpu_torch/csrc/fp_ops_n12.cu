// fp_ops_n12.cu -- kernels K1e (add, sub, mul), K1e inv, K4e (Fq2 mul,
// sqr) and K4e inv over 12-limb Fp (BLS12-381's and BLS12-377's Fq, and
// their Fq2 with nr = -1 and -5): fp_ops.cu built again at LFF_N32 = 12,
// its own translation unit and library.  Same entry points, which refuse
// any n32 but 12.
#define LFF_N32 12
#include "fp_ops.cu"
