"""The hand-written CUDA kernels, their plain versions and wrappers."""
