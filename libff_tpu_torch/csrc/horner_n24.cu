// horner_n24.cu -- kernel K3's scan entry, the Horner phase of the MSM,
// over 24-limb Fp (BW6-761's 761-bit Fq): its G1 (b3 = -3) and its G2
// over Fq (b3 = 12), both on the G1 lane body over fp.cuh's CIOS
// product: horner.cu built again at LFF_N32 = 24, its own translation
// unit and library.  Same entry point, horner_scan, which refuses any n32
// but 24 and any other group.
#define LFF_N32 24
#include "horner.cu"
