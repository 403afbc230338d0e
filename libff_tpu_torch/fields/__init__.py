"""Prime fields of the port (counterpart of libff_tpu/fields)."""
