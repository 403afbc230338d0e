// horner_n12.cu -- kernel K3's scan entry, the Horner phase of the MSM,
// over 12-limb Fp: the G1 of BLS12-381 (b3 = 12) and of BLS12-377 (b3 =
// 3), and their G2 over Fq2 (nr = -1 and -5): horner.cu built again at
// LFF_N32 = 12, its own translation unit and library.  Same entry point,
// horner_scan, which refuses any n32 but 12 and any group but these.
#define LFF_N32 12
#include "horner.cu"
