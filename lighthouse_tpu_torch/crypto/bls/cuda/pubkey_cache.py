"""Packed-pubkey cache: the G1 public-key arena and its mirror on the card.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/pubkey_cache.py``, with the
same semantics.  Validator keys are stable across epochs, so each key is
converted to Montgomery limbs once, keyed by its compressed bytes, into a
host arena; a batch then packs its keys as arena rows.

Layout:
  * row 0 is the infinity / padding row (x = y = 0, inf = True);
  * rows 1.. hold (x, y) canonical Montgomery limbs, ``(12,)`` uint32 each,
    appended on a miss (the misses of one batch are converted together);
  * an LRU index (compressed bytes -> row) of bounded ``capacity``; an
    evicted key's row is recycled, freed rows go to a free list, so the
    arena is bounded by the capacity (96 bytes a key: 192 MiB at the
    default 2^21, every mainnet validator resident).

The mirror on the card (``device_view``): the arena as ``(rows, 12)`` int32
x and y tensors on a device.  The first view, and the first after the host
arena grew, uploads it whole; after that every row written on the host
(cold inserts and recycled rows) is marked dirty and the next view uploads
only those, as one ``k_scatter_rows`` launch on the current stream.  A
batch then reads its keys with one ``k_gather_rows`` launch
(``pack_rows_device``), so a warm batch moves only its row indices.  The
scatter writes the mirror in place; stream order puts it after every gather
enqueued before it and before every gather enqueued after it, and the lock
is held from the row lookup to the gather's launch, so a concurrent batch
cannot recycle this batch's rows in between.  (One stream: a caller that
launches on another stream synchronises with this one itself; a mesh's
shards gather on their own streams, ordered after the sync and before the
next one by events.)  A mesh (``parallel/sharded_verify.py``) keeps one full
mirror on each distinct card it spans: the JAX arena is row-sharded over its
chips (tpu/pubkey_cache.py:249-300), but 2^21 rows are ~200 MB on an 80 GB
card, so the port replicates it.

``device_sync_rows`` / ``device_sync_bytes`` / ``device_full_uploads`` count
what crossed from host to device; a fully warm batch adds nothing.  Thread
safety: one RLock around the index, the arena and the mirrors.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from . import fp, staged

INFINITY_ROW = 0
DEFAULT_CAPACITY = 1 << 21
# Bytes of one arena row crossing to the device: an x and a y row.
ROW_SYNC_BYTES = 2 * fp.N_LIMBS * 4


class _Mirror:
    """The arena on one device."""

    __slots__ = ("x", "y", "rows", "dirty")

    def __init__(self, x: torch.Tensor, y: torch.Tensor, rows: int):
        self.x = x
        self.y = y
        self.rows = rows
        self.dirty: set = set()


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host array -> int32 tensor on `device` (always a copy)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device, copy=True)


class PackedPubkeyCache:
    """Growable (x, y) limb arena + LRU row index for G1 pubkeys."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 initial_rows: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        rows = max(2, min(initial_rows, capacity + 1))
        self._x = np.zeros((rows, fp.N_LIMBS), np.uint32)
        self._y = np.zeros((rows, fp.N_LIMBS), np.uint32)
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self._free: list = []
        self._next_row = 1  # row 0 = infinity, never indexed or evicted
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
        # Doubling, uncapped: one batch larger than `capacity` may need
        # extra rows for a moment (trimmed to the free list after insert).
        rows = max(self._x.shape[0] * 2, need + 1)
        grown_x = np.zeros((rows, fp.N_LIMBS), np.uint32)
        grown_y = np.zeros((rows, fp.N_LIMBS), np.uint32)
        grown_x[: self._x.shape[0]] = self._x
        grown_y[: self._y.shape[0]] = self._y
        self._x, self._y = grown_x, grown_y

    def _alloc_row(self) -> int:
        if self._free:
            return self._free.pop()
        if len(self._index) >= self.capacity:
            # LRU eviction: the stalest key's row is recycled in place.
            _key, row = self._index.popitem(last=False)
            self.evictions += 1
            return row
        row = self._next_row
        self._next_row += 1
        if row >= self._x.shape[0]:
            self._grow(row)
        return row

    # -- lookup / insert ------------------------------------------------------

    def rows_for(self, pubkeys: Sequence) -> np.ndarray:
        """(n,) int64 arena row per entry: entries are ``PublicKey``-shaped
        (``.point``, ``.to_bytes()``) or None for padding (row 0, as is an
        infinity key).  A key seen twice in one batch counts as a hit on
        its batch-mate; the misses are converted in one pass."""
        n = len(pubkeys)
        rows = np.zeros((n,), np.int64)
        with self._lock:
            miss_rows: "OrderedDict[bytes, int]" = OrderedDict()
            miss_vals: list = []
            for i, pk in enumerate(pubkeys):
                if pk is None:
                    continue
                pt = pk.point
                if pt.is_infinity():
                    continue
                key = pk.to_bytes()
                row = self._index.get(key)
                if row is not None:
                    self._index.move_to_end(key)
                    self.hits += 1
                    rows[i] = row
                    continue
                row = miss_rows.get(key)
                if row is None:
                    self.misses += 1
                    row = self._alloc_row()
                    miss_rows[key] = row
                    miss_vals.extend((pt.x.v, pt.y.v))
                else:
                    self.hits += 1
                rows[i] = row
            if miss_rows:
                limbs = fp.mont_ints_to_limbs(miss_vals).reshape(
                    len(miss_rows), 2, fp.N_LIMBS)
                idx = np.fromiter(miss_rows.values(), np.int64,
                                  len(miss_rows))
                self._x[idx] = limbs[:, 0]
                self._y[idx] = limbs[:, 1]
                self._index.update(miss_rows)
                for mir in self._mirrors.values():
                    mir.dirty.update(miss_rows.values())
                # A batch larger than the capacity overshoots (its inserts
                # land after the evictions): trim, stalest first.  Freed
                # rows stay valid until the next insert, so this batch's
                # gather (under the same lock) still reads them.
                while len(self._index) > self.capacity:
                    _key, row = self._index.popitem(last=False)
                    self._free.append(row)
                    self.evictions += 1
        return rows

    def gather(self, rows: np.ndarray):
        """(x, y, inf) host arrays for `rows`, the layout of
        ``curve.pack_g1_affine`` (uint32 limbs)."""
        with self._lock:
            x = self._x[rows]
            y = self._y[rows]
        return x, y, rows == INFINITY_ROW

    def pack_gathered(self, pubkeys: Sequence):
        """``rows_for`` + ``gather`` under one lock hold."""
        with self._lock:
            return self.gather(self.rows_for(pubkeys))

    # -- the mirror on the card ----------------------------------------------

    def device_view(self, device):
        """(arena_x, arena_y): the arena on `device`, synced to the host
        arena (a full upload when new or grown, else one scatter of the
        dirty rows)."""
        device = torch.device(device)
        key = str(device)
        with self._lock:
            rows = self._x.shape[0]
            mir = self._mirrors.get(key)
            if mir is None or mir.rows != rows:
                mir = _Mirror(_to_device(self._x, device),
                              _to_device(self._y, device), rows)
                self._mirrors[key] = mir
                self.device_full_uploads += 1
                self.device_sync_rows += rows
                self.device_sync_bytes += rows * ROW_SYNC_BYTES
            elif mir.dirty:
                idx = np.fromiter(sorted(mir.dirty), np.int64, len(mir.dirty))
                staged.k_scatter_rows(
                    mir.x, mir.y, torch.from_numpy(idx).to(device),
                    _to_device(self._x[idx], device),
                    _to_device(self._y[idx], device))
                self.device_sync_rows += len(idx)
                self.device_sync_bytes += len(idx) * ROW_SYNC_BYTES
                mir.dirty.clear()
            return mir.x, mir.y

    def pack_rows_device(self, pubkeys: Sequence, device):
        """Look the keys up, sync the mirror and gather their rows on
        `device`, under one lock hold -> (rows (n,) int64, x, y (n, 12)
        int32, inf (n,) bool), the last three on `device`.

        `device` may be a mesh (``parallel.sharded_verify.Mesh``): the keys
        are split into equal slices, one a shard; every distinct device of
        the mesh has its own full mirror (synced once), and each shard
        gathers its slice there, on its stream -> (rows (n,) int64 on the
        host, [(x, y, inf) per shard])."""
        if hasattr(device, "shards"):
            return self._pack_rows_mesh(pubkeys, device)
        with self._lock:
            rows = torch.from_numpy(self.rows_for(pubkeys)).to(device)
            ax, ay = self.device_view(device)
            x, y, inf = staged.k_gather_rows(ax, ay, rows)
        return rows, x, y, inf

    def _pack_rows_mesh(self, pubkeys: Sequence, mesh):
        from ....parallel.sharded_verify import begin, join, on

        n = len(pubkeys)
        if n % mesh.size:
            raise ValueError(f"{n} keys do not split over {mesh.size} shards")
        q = n // mesh.size
        with self._lock:
            rows = torch.from_numpy(self.rows_for(pubkeys))
            views = {}
            for dev in mesh.devices:
                if str(dev) not in views:
                    views[str(dev)] = self.device_view(dev)
            # the shards' gathers come after the syncs on the current stream
            begin(mesh)
            keys = []
            for shard in mesh.shards:
                ax, ay = views[str(shard.device)]
                with on(shard):
                    if shard.stream is not None:
                        ax.record_stream(shard.stream)
                        ay.record_stream(shard.stream)
                    r = rows[shard.index * q:(shard.index + 1) * q].to(
                        shard.device)
                    keys.append(staged.k_gather_rows(ax, ay, r))
            join(mesh)      # the next sync (a scatter) after these gathers
        return rows, keys

    def sync_stats(self) -> dict:
        with self._lock:
            return {"device_sync_bytes": self.device_sync_bytes,
                    "device_sync_rows": self.device_sync_rows,
                    "device_full_uploads": self.device_full_uploads}

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "entries": len(self._index),
                    "arena_rows": int(self._x.shape[0]),
                    "capacity": self.capacity,
                    "device_mirrors": len(self._mirrors),
                    **self.sync_stats()}

    def hit_rate_since(self, prev: Optional[dict]) -> Optional[float]:
        """Hit fraction of the lookups since a ``stats()`` snapshot (None
        when there were none)."""
        with self._lock:
            hits, misses = self.hits, self.misses
        prev = prev or {}
        hits -= prev.get("hits", 0)
        misses -= prev.get("misses", 0)
        total = hits + misses
        return None if total == 0 else hits / total


_CACHE: Optional[PackedPubkeyCache] = None
_CACHE_LOCK = threading.Lock()


def get_cache() -> PackedPubkeyCache:
    """The process-wide cache (built at first use)."""
    global _CACHE
    if _CACHE is None:
        with _CACHE_LOCK:
            if _CACHE is None:
                _CACHE = PackedPubkeyCache()
    return _CACHE
