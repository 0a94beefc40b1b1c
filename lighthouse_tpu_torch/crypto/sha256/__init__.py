"""Lane-parallel SHA-256 hash engine of the PyTorch/CUDA port — the
batched merkleization backend for SSZ state roots and the shuffle.

Counterpart of ``lighthouse_tpu/crypto/sha256``: four CUDA kernels
(``cuda/kernel.py``, ``csrc/k_sha256.cu``) run the message schedule and
compression over N independent messages, one thread a message; a facade
(``api.py``: cuda / hashlib behind ``configure()``) routes wide tree
levels to them and narrow ones to hashlib; ``grove.py`` merkleizes many
independent small trees as one batch.

Digests are bit-identical across backends: the engine changes latency,
never roots (``tests/test_torch_sha256.py``, ``tests/test_torch_ssz.py``).
"""
from .api import (
    backend_for,
    batch_threshold,
    configure,
    digest_many,
    engine_status,
    hash_pairs,
    reduce_levels,
    reset_engine,
    set_hash_backend,
)
from .grove import merkleize_grove

__all__ = [
    "backend_for", "batch_threshold", "configure", "digest_many",
    "engine_status", "hash_pairs", "merkleize_grove", "reduce_levels",
    "reset_engine", "set_hash_backend",
]
