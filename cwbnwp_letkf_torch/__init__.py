"""PyTorch port of the LETKF analysis engine, with CUDA kernels for Hopper.

Sits beside the JAX package (the reference it is held against) under the
same module paths and function names.  It imports torch, numpy and scipy,
never jax.  Importing the package applies the float32 matmul policy of
:mod:`.device`.
"""
from . import device  # noqa: F401
