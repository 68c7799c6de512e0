"""PyTorch/CUDA port of the CaMDN multi-tenant serving reproduction.

A second package beside the JAX reference ``repro``: the same module
layout and public signatures, with the Pallas TPU kernels replaced by
CUDA kernels written for Hopper (``kernels/``, sources in ``csrc/``).
It imports neither ``jax`` nor ``repro``; the framework-free scheduling
code (``core/``, ``sim/driver.py``) is a copy of the reference's.
"""
