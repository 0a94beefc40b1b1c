"""SHA-256 message padding + word marshalling (FIPS 180-4 §5.1.1).

Host-side preparation for the lane-parallel kernels: messages are padded
to 64-byte block multiples and presented as native-endian uint32 word
arrays (the kernels byte-swap on the card, one instruction a word).
Shared by `cuda/kernel.py`, the cuda backend's `digest_many`, and the
tests.  A copy of `lighthouse_tpu/crypto/sha256/padding.py`.
"""
from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

BLOCK_BYTES = 64
WORDS_PER_BLOCK = 16


def block_count(msg_len: int) -> int:
    """Blocks after mandatory padding: 1 bit + 64-bit length."""
    return (msg_len + 8) // BLOCK_BYTES + 1


def pad_message(msg: bytes) -> bytes:
    """`msg` padded to a block multiple per FIPS 180-4: 0x80, zeros,
    then the bit length as a 64-bit big-endian integer."""
    bit_len = len(msg) * 8
    padded = msg + b"\x80"
    padded += b"\x00" * ((-len(padded) - 8) % BLOCK_BYTES)
    return padded + struct.pack(">Q", bit_len)


def msgs_to_blocks(msgs: Sequence[bytes]) -> np.ndarray:
    """Pad equal-block-count messages into a (n, m, 16) native-LE
    uint32 array for the kernel (all messages MUST pad to the same
    number of blocks; `digest_many` groups by block count first)."""
    if not msgs:
        return np.zeros((0, 1, WORDS_PER_BLOCK), dtype=np.uint32)
    padded = [pad_message(m) for m in msgs]
    m = len(padded[0]) // BLOCK_BYTES
    if any(len(p) != m * BLOCK_BYTES for p in padded):
        raise ValueError("messages pad to differing block counts")
    buf = b"".join(padded)
    return np.frombuffer(buf, dtype="<u4").reshape(
        len(msgs), m, WORDS_PER_BLOCK
    )


def group_by_blocks(msgs: Sequence[bytes]) -> List[Tuple[int, List[int]]]:
    """Indices of `msgs` grouped by padded block count, insertion
    order preserved within a group: [(block_count, [indices]), ...]."""
    groups: dict = {}
    for i, m in enumerate(msgs):
        groups.setdefault(block_count(len(m)), []).append(i)
    return sorted(groups.items())


def pairs_to_words(data) -> np.ndarray:
    """A buffer of n concatenated 64-byte messages as an (n, 16)
    native-LE uint32 view (zero-copy when the buffer is aligned)."""
    arr = np.frombuffer(data, dtype="<u4") if not isinstance(
        data, np.ndarray
    ) else data.view(np.uint32)
    return arr.reshape(-1, WORDS_PER_BLOCK)
