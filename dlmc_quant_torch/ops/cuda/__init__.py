"""Hand-written CUDA kernels (built with nvcc at first use)."""
