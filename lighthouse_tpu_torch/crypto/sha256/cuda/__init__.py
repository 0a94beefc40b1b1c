"""The hash engine's CUDA kernels (``kernel.py``)."""
