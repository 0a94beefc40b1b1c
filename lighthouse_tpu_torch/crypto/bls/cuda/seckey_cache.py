"""Secret-key arena: the signer's secret scalars, resident on the card.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/seckey_cache.py``, with the
same semantics.  A slot's duty cohort is signed in one launch, so a duty
must not pay for uploading its key's 32 bytes every slot: validator keys
live as long as the process.  Each secret key is split once into scalar
words, keyed by the validator's compressed PUBKEY bytes (the secret never
serves as a dict key), into a growable host arena whose mirror on the card
syncs whole once, then dirty rows only.  A warm slot then gathers its rows
on the card: the secret words never cross to the device again, and never
come back to the host.

Layout:
  * row 0 (``ZERO_ROW``) is the zero scalar of padding lanes (the ladder
    takes nothing: an infinity signature);
  * rows 1.. hold 8 little-endian 32-bit words of the scalar (sk < r <
    2^255), word j = (sk >> 32 j) & 0xffffffff;
  * an LRU index (pubkey bytes -> row) of bounded ``capacity`` (default
    2^21 keys, 64 MiB: every mainnet validator resident).  A batch wider
    than the capacity is never served by evicting its own rows: it
    overshoots, then trims back stalest first, and the freed rows go to a
    free list for the next batch's misses.

The mirror on the card (``device_view``): a ``(rows, 8)`` int32 tensor on a
device, the host arena's rows as they are (the TPU package pads them to a
power of two, a shape rule of its compiler; the port does not).  The first
view, and the first after the host arena grew, uploads it whole; after that
the next view uploads only the rows written since, as one
``k_scatter_sk_rows`` launch.  ``pack_rows_device`` looks a batch up, syncs
and gathers its rows (``k_gather_sk_rows``) under one lock hold, so a
concurrent batch cannot recycle this batch's rows before its gather is
enqueued; stream order does the rest (one stream, as in ``.pubkey_cache``).

``device_sync_bytes`` / ``device_sync_rows`` / ``device_full_uploads`` count
what crossed from host to device (the TPU package's
``seckey_arena_sync_bytes`` metric; the port has no metrics registry): a
fully warm batch adds nothing.  Thread safety: one RLock around the index,
the arena and the mirrors.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from . import staged

#: The reserved padding row: the zero scalar signs everything to infinity.
ZERO_ROW = 0

#: 32-bit words of a scalar row (8 * 32 = 256 bits >= the 255 bits of r).
ROW_WORDS = staged.SK_WORDS

#: Bytes of one arena row crossing to the device.
ROW_SYNC_BYTES = ROW_WORDS * 4

DEFAULT_CAPACITY = 1 << 21


class _Mirror:
    """The arena on one device."""

    __slots__ = ("w", "rows", "dirty")

    def __init__(self, w: torch.Tensor, rows: int):
        self.w = w
        self.rows = rows
        self.dirty: set = set()


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host words -> int32 tensor on `device` (always a copy)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device, copy=True)


class SecretKeyCache:
    """Growable scalar-word arena + LRU row index for secret keys."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 initial_rows: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        rows = max(2, min(initial_rows, capacity + 1))
        self._w = np.zeros((rows, ROW_WORDS), np.uint32)
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self._free: list = []
        self._next_row = 1  # row 0 = zero scalar, never indexed or evicted
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._mirrors: dict = {}  # str(device) -> _Mirror
        self.device_sync_bytes = 0
        self.device_sync_rows = 0
        self.device_full_uploads = 0

    # -- arena management -----------------------------------------------------

    def _grow(self, need: int) -> None:
        rows = max(self._w.shape[0] * 2, need + 1)
        grown = np.zeros((rows, ROW_WORDS), np.uint32)
        grown[: self._w.shape[0]] = self._w
        self._w = grown

    def _alloc_row(self) -> int:
        # Never evict-and-reuse here: a batch wider than the capacity would
        # hand one row to two of its own lanes.  Allocation only overshoots;
        # rows_for trims back once the whole batch holds distinct rows.
        if self._free:
            return self._free.pop()
        row = self._next_row
        self._next_row += 1
        if row >= self._w.shape[0]:
            self._grow(row)
        return row

    @staticmethod
    def _words(k: int) -> np.ndarray:
        return np.array([(k >> (32 * j)) & 0xFFFFFFFF
                         for j in range(ROW_WORDS)], dtype=np.uint32)

    # -- lookup / insert ------------------------------------------------------

    def rows_for(self, entries: Sequence) -> np.ndarray:
        """(n,) int64 arena row per entry.  Entries are (pubkey_bytes,
        sk_int) pairs, or None for padding lanes (``ZERO_ROW``).  A miss is
        inserted and its row marked dirty for the next mirror sync."""
        n = len(entries)
        rows = np.zeros((n,), np.int64)
        with self._lock:
            touched: set = set()
            for i, entry in enumerate(entries):
                if entry is None:
                    continue
                key, k = entry
                row = self._index.get(key)
                if row is not None:
                    self._index.move_to_end(key)
                    self.hits += 1
                    rows[i] = row
                    continue
                self.misses += 1
                row = self._alloc_row()
                self._w[row] = self._words(int(k))
                self._index[key] = row
                touched.add(row)
                rows[i] = row
            for mir in self._mirrors.values():
                mir.dirty.update(touched)
            # A batch wider than the capacity overshoots: trim stalest
            # first.  Freed rows keep their words until the next insert,
            # and pack_rows_device holds the lock across both halves.
            while len(self._index) > self.capacity:
                _key, row = self._index.popitem(last=False)
                self._free.append(row)
                self.evictions += 1
        return rows

    # -- the mirror on the card ----------------------------------------------

    def device_view(self, device):
        """(arena, rows): the (rows, 8) int32 arena on `device`, synced to
        the host arena (a full upload when new or grown, else one scatter
        of the dirty rows; a fully warm view moves nothing)."""
        device = torch.device(device)
        key = str(device)
        with self._lock:
            rows = self._w.shape[0]
            mir = self._mirrors.get(key)
            if mir is None or mir.rows != rows:
                mir = _Mirror(_to_device(self._w, device), rows)
                self._mirrors[key] = mir
                self.device_full_uploads += 1
                self.device_sync_rows += rows
                self.device_sync_bytes += rows * ROW_SYNC_BYTES
            elif mir.dirty:
                idx = np.fromiter(sorted(mir.dirty), np.int64, len(mir.dirty))
                staged.k_scatter_sk_rows(
                    mir.w, torch.from_numpy(idx).to(device),
                    _to_device(self._w[idx], device))
                self.device_sync_rows += len(idx)
                self.device_sync_bytes += len(idx) * ROW_SYNC_BYTES
                mir.dirty.clear()
            return mir.w, rows

    def pack_rows_device(self, entries: Sequence, device):
        """Look the entries up, sync the mirror and gather their scalar
        words on `device`, under one lock hold -> (rows (n,) int64 host
        array, w (n, 8) int32 on `device`)."""
        with self._lock:
            rows = self.rows_for(entries)
            arena, _rows = self.device_view(device)
            w = staged.k_gather_sk_rows(
                arena, torch.from_numpy(rows).to(arena.device))
        return rows, w

    def sync_stats(self) -> dict:
        with self._lock:
            return {"device_sync_bytes": self.device_sync_bytes,
                    "device_sync_rows": self.device_sync_rows,
                    "device_full_uploads": self.device_full_uploads}

    def sync_bytes_since(self, prev: Optional[dict]) -> int:
        """Host-to-device arena bytes since a ``sync_stats()`` snapshot: 0
        on a fully warm dispatch."""
        with self._lock:
            total = self.device_sync_bytes
        if prev is not None:
            total -= prev.get("device_sync_bytes", 0)
        return total

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "entries": len(self._index),
                    "arena_rows": int(self._w.shape[0]),
                    "capacity": self.capacity,
                    "device_mirrors": len(self._mirrors),
                    **self.sync_stats()}


_CACHE: Optional[SecretKeyCache] = None
_CACHE_LOCK = threading.Lock()


def get_cache() -> SecretKeyCache:
    """The process-wide cache (built at first use)."""
    global _CACHE
    if _CACHE is None:
        with _CACHE_LOCK:
            if _CACHE is None:
                _CACHE = SecretKeyCache()
    return _CACHE


def reset_cache(capacity: Optional[int] = None,
                initial_rows: int = 1024) -> SecretKeyCache:
    """Swap in a fresh process-wide cache (tests; capacity experiments)."""
    global _CACHE
    with _CACHE_LOCK:
        _CACHE = SecretKeyCache(
            DEFAULT_CAPACITY if capacity is None else capacity, initial_rows)
    return _CACHE
