// insert_n24.cu -- kernel K2 over 24-limb Fp (BW6-761's 761-bit Fq),
// CIOS: the insert of its G1 (b3 = -3) and of its G2 over Fq (b3 = 12),
// both on the Fp branch; insert.cuh built at LFF_N32 = 24, its own
// translation unit and library.  Same C entry point and arguments as
// insert.cu's `insert`, which refuses any n32 but 24, the fused merge
// (m not null: K2m is not built at this width, merge.cuh's kTreeBuilt)
// and every other product.  The chain kernel is insert.cuh's
// chain_kernel over FpField<24, b3>: one thread a chain, a bucket 72
// words (each coordinate 24, already whole sectors), a point record 72,
// with the width's own LFF_ENTRIES_G1_N24 and LFF_MIN_BLOCKS_G1_N24.
// K2's sort (insert.cu bucket_lists) does not depend on the width and is
// launched from insert.cu's library.  K5, K2m, K6 and the SOS products
// at this width wait for ROADMAP Queue 1 item 9e.
#define LFF_N32 24
#include "insert.cuh"

LFF_INSERT_ENTRY(lff::Mul::Cios)
