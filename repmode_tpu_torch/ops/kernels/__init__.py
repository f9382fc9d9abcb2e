"""Hand-written CUDA kernels of the port: sources in ``csrc/``, built on first use."""
