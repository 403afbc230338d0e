// fp_ops_n12.cu -- kernels K1e (add, sub, mul) and K1e inv over 12-limb
// Fp (BLS12-381's and BLS12-377's Fq): fp_ops.cu built again at
// LFF_N32 = 12, its own translation unit and library.  Same entry points
// fp_add, fp_sub, fp_mul and fp_inv, which refuse any n32 but 12; the Fq2
// entries are not built at this width.
#define LFF_N32 12
#include "fp_ops.cu"
