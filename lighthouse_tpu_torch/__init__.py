"""PyTorch/CUDA port of lighthouse_tpu, for NVIDIA Hopper (H100).

Imports torch, numpy and the standard library only -- never jax and never
the lighthouse_tpu package.  Slice 1 covers batch BLS verification
(``crypto.bls.verify_signature_sets``) on four hand-written CUDA kernels
(``csrc/``), built with nvcc at first use (``runtime.build``).
"""
