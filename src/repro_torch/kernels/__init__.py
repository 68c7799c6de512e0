"""Hand-written Hopper kernels of the port (CUDA sources in ``csrc/``),
each beside its plain PyTorch version, and ``ops`` dispatching them from
KernelPlans."""
