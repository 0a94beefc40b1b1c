"""Incremental merkleization for large SSZ lists.

Equivalent of Lighthouse's consensus/cached_tree_hash/src/cache.rs:14
(`TreeHashCache`): the validators/balances lists dominate BeaconState
hashing (100k+ validators → ~200k hashes per full re-root), but blocks
touch only a handful of entries, so caching every tree layer and
re-hashing only dirty paths turns the per-block cost into
O(changes · depth).

Two pieces:
  * `CachedListRoot` — layer cache diffing consecutive leaf sets,
    attached per parameterized List class (consecutive BeaconStates in
    a chain hash through the same class with nearly identical leaves).
  * `ElementRootMemo` — bounded memo of composite element roots keyed by
    their SSZ encoding (a Validator re-encodes in ~100ns; re-merkleizing
    it costs ~15 hashes), the analogue of cache.rs's per-validator leaf
    caches.
"""
import threading
from collections import OrderedDict
from typing import List as PyList, Sequence

from ..crypto.sha256 import api as _engine
from .hash import ZERO_HASHES, hash_bytes


class CachedListRoot:
    def __init__(self, depth: int):
        self.depth = depth
        # layers[0] = leaves; layers[d] has ceil(n / 2^d) nodes; absent
        # indices are virtual ZERO_HASHES[d].
        self.layers: PyList[PyList[bytes]] = [[] for _ in range(depth + 1)]
        self.lock = threading.Lock()

    def root(self, leaves: Sequence[bytes]) -> bytes:
        with self.lock:
            return self._root_locked(list(leaves))

    @staticmethod
    def _rebuild_level(level, below, idxs, d) -> None:
        """Re-hash the dirty pairs of one level.  Wide cohorts (the
        initial build, a deep mutation, an epoch-boundary balance
        sweep) gather into one contiguous buffer and ride the hash
        engine's batch path; narrow ones stay scalar — the same
        threshold the engine applies to whole tree levels."""
        zero = ZERO_HASHES[d - 1]
        n_below = len(below)
        if len(idxs) >= _engine.batch_threshold():
            buf = bytearray(64 * len(idxs))
            for j, i in enumerate(idxs):
                buf[64 * j:64 * j + 32] = below[2 * i]
                buf[64 * j + 32:64 * j + 64] = (
                    below[2 * i + 1] if 2 * i + 1 < n_below else zero
                )
            digests = _engine.hash_pairs(buf)
            for j, i in enumerate(idxs):
                level[i] = digests[32 * j:32 * (j + 1)]
            return
        for i in idxs:
            left = below[2 * i]
            right = below[2 * i + 1] if 2 * i + 1 < n_below else zero
            level[i] = hash_bytes(left + right)

    def _root_locked(self, leaves: PyList[bytes]) -> bytes:
        old = self.layers[0]
        n_old, n_new = len(old), len(leaves)
        common = min(n_old, n_new)
        dirty = {i for i in range(common) if old[i] != leaves[i]}
        dirty.update(range(n_old, n_new))  # appended
        length_changed = n_old != n_new
        self.layers[0] = leaves
        prev_dirty = dirty
        n_prev = n_new
        for d in range(1, self.depth + 1):
            n_level = (n_prev + 1) // 2 if n_prev else 0
            level = self.layers[d]
            del level[n_level:]
            level.extend([b""] * (n_level - len(level)))
            cur_dirty = {i // 2 for i in prev_dirty}
            if length_changed and n_level:
                cur_dirty.add(n_level - 1)
            self._rebuild_level(
                level, self.layers[d - 1],
                [i for i in cur_dirty if i < n_level], d,
            )
            prev_dirty = cur_dirty
            n_prev = n_level
        if not leaves:
            return ZERO_HASHES[self.depth]
        return self.layers[self.depth][0]


class ElementRootMemo:
    """LRU memo keyed by full SSZ encodings, bounded by TOTAL BYTES
    (keys dominate: ~121 B per Validator encoding), not entry count —
    a count bound of 2^20 full encodings could pin hundreds of MB."""

    def __init__(self, max_bytes: int = 32 << 20):
        self.max_bytes = max_bytes
        self._memo: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._bytes = 0
        self.lock = threading.Lock()

    def get(self, key: bytes):
        """The memoized root, or None (and LRU-touch on hit) — the
        probe half of batched miss handling: `List._leaves` collects
        misses and grove-merkleizes them as one cohort."""
        with self.lock:
            root = self._memo.get(key)
            if root is not None:
                self._memo.move_to_end(key)
            return root

    def put(self, key: bytes, root: bytes) -> None:
        with self.lock:
            if key not in self._memo:
                self._memo[key] = root
                self._bytes += len(key) + 32
                while self._bytes > self.max_bytes and self._memo:
                    k, _ = self._memo.popitem(last=False)
                    self._bytes -= len(k) + 32

    def get_or_compute(self, key: bytes, compute) -> bytes:
        root = self.get(key)
        if root is not None:
            return root
        root = compute()
        self.put(key, root)
        return root
