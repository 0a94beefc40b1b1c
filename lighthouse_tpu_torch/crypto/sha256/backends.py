"""Hash-engine backends: hashlib (always) and cuda (the lane-parallel
kernels of ``cuda/kernel.py``).

Counterpart of ``lighthouse_tpu/crypto/sha256/backends.py``.  Each backend
answers the same two calls with bit-identical digests:

  * `hash_pairs(data)`  — n concatenated 64-byte messages -> n
    concatenated 32-byte digests (the merkleization inner loop),
  * `digest_many(msgs)` — arbitrary-length messages -> digests.

Routing and thresholds live in `api.py`; these classes are mechanism only.
The reference's native C++ hasher is not ported.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

from ...runtime.tensors import resolve_device
from . import padding
from .cuda import kernel


class HashlibBackend:
    """OpenSSL via hashlib, one call per message."""

    name = "hashlib"

    def hash_pairs(self, data) -> bytes:
        view = memoryview(data)
        n = len(view) // 64
        out = bytearray(32 * n)
        sha = hashlib.sha256
        for i in range(n):
            out[32 * i:32 * (i + 1)] = sha(view[64 * i:64 * (i + 1)]).digest()
        return bytes(out)

    def digest_many(self, msgs: Sequence[bytes]) -> List[bytes]:
        sha = hashlib.sha256
        return [sha(m).digest() for m in msgs]


class CudaBackend:
    """The lane-parallel kernels, on `device`: the card ("cuda", the
    default) or the CPU ("cpu": the plain versions, for tests).  A CUDA
    device without a card raises when a call needs it."""

    name = "cuda"

    #: Messages longer than this many padded blocks go to hashlib, as in
    #: the reference (the batched workloads, chunk leaves and shuffle
    #: seeds, are all 1-3 blocks).
    MAX_BLOCKS = 4

    def __init__(self, device="cuda"):
        self.device = device

    def resolve(self):
        return resolve_device(self.device, "sha256 cuda backend")

    def hash_pairs(self, data) -> bytes:
        return kernel.hash_pairs(data, self.resolve())

    def digest_many(self, msgs: Sequence[bytes]) -> List[bytes]:
        """Groups messages by padded block count (each group is one
        launch); the api layer only routes wide batches here."""
        device = self.resolve()
        sha = hashlib.sha256
        out: List[bytes] = [b""] * len(msgs)
        for m, idxs in padding.group_by_blocks(msgs):
            if m > self.MAX_BLOCKS:
                for i in idxs:
                    out[i] = sha(msgs[i]).digest()
                continue
            blocks = padding.msgs_to_blocks([msgs[i] for i in idxs])
            digests = kernel.digest_blocks(blocks, device)
            for j, i in enumerate(idxs):
                out[i] = digests[32 * j:32 * (j + 1)]
        return out

    def reduce_levels(self, buf, depth, zero_hashes, depth_limit,
                      min_pairs, stats=None):
        return kernel.reduce_levels(buf, depth, zero_hashes, depth_limit,
                                    min_pairs, self.resolve(), stats)
