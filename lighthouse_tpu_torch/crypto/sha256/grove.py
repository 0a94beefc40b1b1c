"""Grove mode: merkleize MANY independent small trees as one batch.

The motivating workload is `ElementRootMemo` misses in
`ssz/core.py::List._leaves`: the first re-root after a deep state
mutation (or an initial build) must compute tens of thousands of
Validator element roots, each a width-8 tree — 7 scalar hashes apiece.
Laid side by side, K same-width trees stay PAIR-ALIGNED at every
level, so the whole grove reduces as `depth` wide `hash_pairs` calls
(each routed through the engine's batch path) instead of `7·K` scalar
ones.  A copy of `lighthouse_tpu/crypto/sha256/grove.py`, bound to the
port's api.

Equality contract: for each tree, the returned root is bit-identical
to `ssz.hash.merkleize(chunks, limit)` — zero-subtree padding is
materialized (hashing a zero chunk yields exactly the virtual
`ZERO_HASHES` node the scalar path substitutes), which is cheap at
grove widths and keeps every tree's reduction uniform.
"""
from __future__ import annotations

from typing import List, Sequence

from . import api

_ZERO_CHUNK = b"\x00" * 32


def _next_pow_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def merkleize_grove(trees: Sequence[Sequence[bytes]],
                    limit: int | None = None) -> List[bytes]:
    """Roots of `trees` (each a sequence of 32-byte chunks), every one
    bit-identical to `merkleize(tree, limit)`.

    All trees must share one width: pass `limit` (as in `merkleize`),
    or leave it None when every tree has the same chunk count (the
    Container field-root case).  Raises ValueError on mixed widths —
    a grove is one batch, not a scheduling layer.
    """
    k = len(trees)
    if k == 0:
        return []
    counts = [len(t) for t in trees]
    if limit is None:
        width = _next_pow_of_two(counts[0])
        if any(_next_pow_of_two(c) != width for c in counts):
            raise ValueError(
                "grove trees have mixed widths; pass limit="
            )
    else:
        if any(c > limit for c in counts):
            raise ValueError("grove tree exceeds limit")
        width = _next_pow_of_two(limit)
    depth = (width - 1).bit_length()

    buf = bytearray(k * width * 32)
    for t_i, tree in enumerate(trees):
        base = t_i * width * 32
        for c_i, chunk in enumerate(tree):
            if len(chunk) != 32:
                raise ValueError("grove chunks must be 32 bytes")
            buf[base + 32 * c_i:base + 32 * (c_i + 1)] = chunk

    for _ in range(depth):
        buf = api.hash_pairs(buf)
    return [bytes(buf[32 * i:32 * (i + 1)]) for i in range(k)]
