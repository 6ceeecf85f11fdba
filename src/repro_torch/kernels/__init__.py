"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions."""
