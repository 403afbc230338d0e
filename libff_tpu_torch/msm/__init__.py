"""Multi-scalar multiplication of the port (counterpart of libff_tpu/msm)."""
