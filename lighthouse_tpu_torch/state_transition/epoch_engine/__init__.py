"""The epoch engine of the PyTorch/CUDA port: the batched swap-or-not
shuffle (``shuffle.py``) so far; its kernels wait for their own slice."""
