"""libff_tpu_torch: the PyTorch and CUDA port of libff_tpu for NVIDIA
Hopper.

The JAX package ``libff_tpu`` is the reference.  This package imports
torch and never jax; of the reference it uses only the jax-free host
modules (``libff_tpu.host.{mont,field,ec}``, ``libff_tpu.curves.curvedef``
with its curve data, ``libff_tpu.curves.formulas``).  The CUDA kernels in
``csrc/`` are built by ``_build`` at their first launch; importing the
package builds nothing.
"""
