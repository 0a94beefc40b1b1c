"""Merkleization primitives for SSZ hash_tree_root.

Equivalent of `consensus/tree_hash` (Lighthouse's consensus/tree_hash/
src/{merkle_hasher,lib}.rs) and the zero-hash cache in `crypto/
eth2_hashing` (ZERO_HASHES); a copy of `lighthouse_tpu/ssz/hash.py` bound
to the port's hash engine.  Single hashes go through hashlib (OpenSSL);
whole tree LEVELS go through the hash engine (`crypto/sha256/api.py`),
which routes each level by width: the lane-parallel CUDA kernels for wide
levels under the cuda backend, hashlib otherwise.

Levels are carried as ONE contiguous buffer (bytearray in, bytes out
of the engine), not a Python list of 32-byte objects: the per-level
join/slice churn of the list representation cost more than the small
levels' hashing itself.  Under the cuda backend, `engine.reduce_levels`
additionally keeps consecutive wide levels resident on the card (no host
round trip between levels).
"""
from __future__ import annotations

import hashlib
from typing import List as PyList, Sequence, Union

from ..crypto.sha256 import api as _engine

BYTES_PER_CHUNK = 32
MAX_TREE_DEPTH = 64

ZERO_CHUNK = b"\x00" * BYTES_PER_CHUNK


def hash_bytes(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _build_zero_hashes() -> PyList[bytes]:
    out = [ZERO_CHUNK]
    for _ in range(MAX_TREE_DEPTH):
        out.append(hash_bytes(out[-1] + out[-1]))
    return out


#: ZERO_HASHES[i] = root of a depth-i tree of zero chunks.
ZERO_HASHES: PyList[bytes] = _build_zero_hashes()


def next_pow_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def merkleize(chunks: Union[Sequence[bytes], bytes, bytearray,
                            memoryview],
              limit: int | None = None) -> bytes:
    """Merkle root of 32-byte chunks, zero-padded (virtually) to `limit`
    leaves (or to the next power of two when limit is None).

    `chunks` may be a sequence of 32-byte values or one contiguous
    chunk-aligned buffer (the zero-copy path callers with packed
    encodings should prefer).  Matches the spec
    `merkleize(pack(...), limit)`; raises if the input exceeds the
    limit (the reference errors likewise at type level).
    """
    if isinstance(chunks, (bytes, bytearray, memoryview)):
        buf = bytearray(chunks)
        count = len(buf) // BYTES_PER_CHUNK
    else:
        count = len(chunks)
        buf = None
    if limit is None:
        width = next_pow_of_two(count)
    else:
        if count > limit:
            raise ValueError(f"{count} chunks exceed limit {limit}")
        width = next_pow_of_two(limit)
    depth = (width - 1).bit_length()
    if count == 0:
        return ZERO_HASHES[depth]
    if buf is None:
        buf = bytearray(b"".join(chunks))
    d = 0
    while d < depth:
        # Card-resident fast path: consecutive wide levels reduce on the
        # card in one engine call (no-op unless the cuda backend is
        # active and the level clears the batch threshold).
        buf, d = _engine.reduce_levels(buf, d, ZERO_HASHES, depth)
        if d >= depth:
            break
        if (len(buf) // BYTES_PER_CHUNK) % 2:
            buf = bytearray(buf)
            buf += ZERO_HASHES[d]
        buf = _engine.hash_pairs(buf)
        d += 1
    return bytes(buf[:BYTES_PER_CHUNK])


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_bytes(root + length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_bytes(root + selector.to_bytes(32, "little"))


def pack_bytes(data: bytes) -> PyList[bytes]:
    """Right-pad to a chunk multiple and split into 32-byte chunks."""
    if len(data) % BYTES_PER_CHUNK:
        data = data + b"\x00" * (BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK)
    return [data[i:i + BYTES_PER_CHUNK] for i in range(0, len(data), BYTES_PER_CHUNK)]


def pack_bytes_buf(data: bytes) -> bytes:
    """`pack_bytes` without the split: the chunk-aligned contiguous
    buffer form `merkleize` consumes directly."""
    if len(data) % BYTES_PER_CHUNK:
        return data + b"\x00" * (
            BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK
        )
    return data


def hash_tree_root(typ, value) -> bytes:
    """Convenience dispatcher: typ.hash_tree_root(value)."""
    return typ.hash_tree_root(value)
