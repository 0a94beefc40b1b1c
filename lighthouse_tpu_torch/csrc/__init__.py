"""CUDA sources of the port's kernels (and their constants generator)."""
