"""Hand-written CUDA window kernels, their build, wrappers and plain versions."""
