"""libff_tpu_torch: the PyTorch and CUDA port of libff_tpu for NVIDIA
Hopper.

The JAX package ``libff_tpu`` is the reference.  This package imports
torch and never jax, and nothing of the reference: it keeps its own
copies of the jax-free modules it needs (``host/{mont,field,ec}.py``,
``curves/{curvedef,formulas,alt_bn128}.py``).  The CUDA kernels in
``csrc/`` are built by ``_build`` at their first launch; importing the
package builds nothing.  Entry points put their tensors on the card
unless the caller names another device.
"""
