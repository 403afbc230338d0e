"""Exact host arithmetic of the port: copies of libff_tpu/host/{mont,field,
ec}.py, kept identical to them (tests/test_torch_copies.py)."""
