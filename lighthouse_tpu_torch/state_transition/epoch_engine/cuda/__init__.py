"""The epoch engine's CUDA kernels (``kernel.py``, ``csrc/k_epoch.cu``)."""
