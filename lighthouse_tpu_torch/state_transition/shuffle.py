"""Swap-or-not shuffle — equivalent of `consensus/swap_or_not_shuffle`
(Lighthouse's consensus/swap_or_not_shuffle/src/{compute_shuffled_index,
shuffle_list}.rs); a copy of ``lighthouse_tpu/state_transition/
shuffle.py``, on hashlib.

Two entry points, mirroring the reference:
  * `compute_shuffled_index(i, n, seed, rounds)` — per-index O(rounds).
  * `shuffle_indices(n, seed, rounds)` — whole-list permutation with the
    reference's O(rounds * n/256) hash count, vectorized over numpy
    (the committee-cache builder's workhorse; shuffle_list.rs:79).

`invert=True` applies the inverse permutation (each round is an
involution, so the inverse is the same rounds in reverse order) — the
reference's `shuffle_list(forwards=false)`.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def compute_shuffled_index(
    index: int, index_count: int, seed: bytes, rounds: int
) -> int:
    """Spec `compute_shuffled_index`; reference
    compute_shuffled_index.rs:21."""
    assert 0 <= index < index_count
    if rounds == 0 or index_count <= 1:
        return index
    for r in range(rounds):
        pivot = int.from_bytes(
            _h(seed + bytes([r]))[:8], "little"
        ) % index_count
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = _h(
            seed + bytes([r]) + (position // 256).to_bytes(4, "little")
        )
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def shuffle_indices(
    index_count: int,
    seed: bytes,
    rounds: int,
    invert: bool = False,
) -> np.ndarray:
    """out[i] = shuffled position of input index i, for all i at once.

    Hash count matches the reference whole-list shuffle: one 8-byte pivot
    hash per round plus one 32-byte source hash per 256-position chunk per
    round; everything else is vectorized numpy."""
    n = index_count
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    idx = np.arange(n, dtype=np.uint64)
    if rounds == 0 or n <= 1:
        return idx
    schedule = range(rounds - 1, -1, -1) if invert else range(rounds)
    for r in schedule:
        rb = bytes([r])
        pivot = int.from_bytes(_h(seed + rb)[:8], "little") % n
        flip = (np.uint64(pivot + n) - idx) % np.uint64(n)
        pos = np.maximum(idx, flip)
        # One source hash per 256-position chunk covering [0, n).
        n_chunks = (n + 255) // 256
        digests = b"".join(
            _h(seed + rb + c.to_bytes(4, "little")) for c in range(n_chunks)
        )
        table = np.frombuffer(digests, dtype=np.uint8)
        byte = table[(pos >> np.uint64(8)) * np.uint64(32)
                     + ((pos % np.uint64(256)) >> np.uint64(3))]
        bit = (byte >> (pos % np.uint64(8)).astype(np.uint8)) & 1
        idx = np.where(bit.astype(bool), flip, idx)
    return idx


def shuffle_list(items, seed: bytes, rounds: int, invert: bool = False):
    """Shuffled copy of `items`: output[shuffled_index(i)] = items[i]."""
    perm = shuffle_indices(len(items), seed, rounds, invert=invert)
    out: list = [None] * len(items)
    for i, p in enumerate(perm):
        out[int(p)] = items[i]
    return out
