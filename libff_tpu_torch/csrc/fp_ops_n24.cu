// fp_ops_n24.cu -- kernels K1e (add, sub, mul) and K1e inv over 24-limb
// Fp (BW6-761's 761-bit Fq): fp_ops.cu built again at LFF_N32 = 24, its
// own translation unit and library.  Same entry points, which refuse any
// n32 but 24; the Fq2 entries (K4e, K4e inv) refuse every call, BW6-761
// having no Fq2.
#define LFF_N32 24
#include "fp_ops.cu"
