"""Hand-written CUDA kernels of the port, their plain versions and the
helper that compiles and loads them."""
