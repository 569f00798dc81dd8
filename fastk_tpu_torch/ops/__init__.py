"""Device ops of the port: torch ops, and the wrappers of the CUDA kernels."""
