"""Device arithmetic of the port (counterpart of ``crypto/bls/tpu``): plain
PyTorch versions of every kernel plus the wrappers in ``staged`` that launch
the CUDA kernels of ``lighthouse_tpu_torch/csrc``."""
