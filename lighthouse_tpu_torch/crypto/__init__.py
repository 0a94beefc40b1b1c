"""Cryptography of the PyTorch/CUDA port."""
