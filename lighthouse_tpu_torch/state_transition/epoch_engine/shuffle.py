"""Batched swap-or-not shuffle: every position of every round in one
vectorized pass, with ALL pivot and source hashes computed up front
through the hash engine (`crypto/sha256/api.digest_many`) — one wide
batch of `rounds * ceil(n/256) + rounds` messages instead of a
hashlib call per chunk per round.

Bit-identical to `state_transition/shuffle.shuffle_indices` of the JAX
package (and so to the per-index `compute_shuffled_index`): same
pivot/flip/position arithmetic, same source-table indexing, same
involution ordering for `invert`.  A copy of
`lighthouse_tpu/state_transition/epoch_engine/shuffle.py`, bound to the
port's hash engine.
"""
from __future__ import annotations

from typing import List

import numpy as np


def batched_shuffle_indices(
    index_count: int,
    seed: bytes,
    rounds: int,
    invert: bool = False,
) -> np.ndarray:
    """out[i] = shuffled position of input index i, for all i at once;
    hashes ride the hash engine in one batch."""
    from ...crypto.sha256 import api as hash_api

    n = index_count
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    idx = np.arange(n, dtype=np.uint64)
    if rounds == 0 or n <= 1:
        return idx
    n_chunks = (n + 255) // 256
    msgs = [seed + bytes([r]) for r in range(rounds)]
    msgs += [
        seed + bytes([r]) + c.to_bytes(4, "little")
        for r in range(rounds) for c in range(n_chunks)
    ]
    digests = hash_api.digest_many(msgs)
    pivots = digests[:rounds]
    sources = digests[rounds:]
    schedule = range(rounds - 1, -1, -1) if invert else range(rounds)
    for r in schedule:
        pivot = int.from_bytes(pivots[r][:8], "little") % n
        flip = (np.uint64(pivot + n) - idx) % np.uint64(n)
        pos = np.maximum(idx, flip)
        table = np.frombuffer(
            b"".join(sources[r * n_chunks:(r + 1) * n_chunks]),
            dtype=np.uint8,
        )
        byte = table[(pos >> np.uint64(8)) * np.uint64(32)
                     + ((pos % np.uint64(256)) >> np.uint64(3))]
        bit = (byte >> (pos % np.uint64(8)).astype(np.uint8)) & 1
        idx = np.where(bit.astype(bool), flip, idx)
    return idx


#: Candidate-byte digests prefetched per hash-engine batch while
#: rejection-sampling the sync committee (each digest covers 32
#: candidates).
RANDOM_BYTE_BATCH = 64


def sample_sync_committee_indices(
    active: np.ndarray,
    effective_balance: np.ndarray,
    seed: bytes,
    committee_size: int,
    max_effective_balance: int,
    shuffle_rounds: int,
) -> List[int]:
    """The spec's sync-committee rejection sampler with the shuffle
    and the candidate random bytes batched through the hash engine.
    Bit-identical to the JAX package's
    `per_epoch.get_next_sync_committee_indices`:
    candidate i is `active[shuffled(i % n)]`, its random byte is
    `H(seed + u64le(i // 32))[i % 32]`."""
    from ...crypto.sha256 import api as hash_api

    n = len(active)
    perm = batched_shuffle_indices(n, seed, shuffle_rounds)
    indices: List[int] = []
    digests: List[bytes] = []
    i = 0
    while len(indices) < committee_size:
        chunk = i // 32
        if chunk >= len(digests):
            digests.extend(hash_api.digest_many([
                seed + j.to_bytes(8, "little")
                for j in range(len(digests),
                               len(digests) + RANDOM_BYTE_BATCH)
            ]))
        candidate = int(active[int(perm[i % n])])
        random_byte = digests[chunk][i % 32]
        if (int(effective_balance[candidate]) * 255
                >= max_effective_balance * random_byte):
            indices.append(candidate)
        i += 1
    return indices
