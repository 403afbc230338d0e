"""Curve groups of the port (counterpart of libff_tpu/curves)."""
