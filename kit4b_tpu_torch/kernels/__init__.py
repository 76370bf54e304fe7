"""Hand-written CUDA kernels of the port, their builder and wrappers."""
