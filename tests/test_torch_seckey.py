"""The port's secret-key arena (lighthouse_tpu_torch crypto/bls/cuda/
seckey_cache.py) and its row kernels' plain versions against the JAX
package: one seeded entry stream through both caches gives the same rows,
stats, free list, capacity trim and scalar words; the mirror syncs the same
bytes cold, dirty and warm; the plain scatter and gather equal JAX's jitted
_scatter_rows and signer.gather_rows (jnp.take); a JAX cache carried into
the port (convert.seckey_arena_from_jax) goes on alike.

Keys are random pubkey-sized identities and scalars below r from a numpy
seed; rows, words and counters compare exactly (tolerance 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls.tpu import seckey_cache as jsc
from lighthouse_tpu.crypto.bls.tpu import signer as jsigner
from lighthouse_tpu_torch.crypto.bls.constants import R
from lighthouse_tpu_torch.crypto.bls.cuda import convert, seckey_cache, staged
from lighthouse_tpu_torch.crypto.bls.cuda.seckey_cache import (
    ROW_SYNC_BYTES, ZERO_ROW, SecretKeyCache)

RNG = np.random.default_rng(0x5EC4E7)
ENTRIES = [(RNG.bytes(48), int.from_bytes(RNG.bytes(32), "big") % R)
           for _ in range(12)]

# batches of entry indices (None: padding): duplicates inside a batch, hits,
# a batch wider than the capacity of 4 (overshoot, then the stalest-first
# trim to the free list), then reuse of the freed rows
STREAM = [[0, 1, 1, None], [2, 0, 3], [4, 5], [0, 6, 7, 8, 9, 10],
          [11, 11], [1, None, 2]]


def _batch(ids):
    return [ENTRIES[i] if i is not None else None for i in ids]


def test_same_rows_stats_trim_and_words_as_jax():
    jcache = jsc.SecretKeyCache(capacity=4, initial_rows=2)
    cache = SecretKeyCache(capacity=4, initial_rows=2)
    assert ZERO_ROW == jsc.ZERO_ROW == 0
    reused = False
    for ids in STREAM:
        freed = set(cache._free)
        rows = cache.rows_for(_batch(ids))
        assert rows.tolist() == jcache.rows_for(_batch(ids)).tolist()
        assert cache.stats() == jcache.stats()
        assert cache._free == jcache._free
        assert cache._next_row == jcache._next_row
        assert list(cache._index.items()) == list(jcache._index.items())
        assert np.array_equal(cache._w, jcache._w)
        assert not cache._w[ZERO_ROW].any()
        reused |= bool(freed & set(rows.tolist()))
    assert cache.evictions > 0 and reused          # the trim and free list
    assert len(cache) == len(jcache) == 4
    k = ENTRIES[11][1]
    row = cache._index[ENTRIES[11][0]]
    assert sum(int(v) << (32 * j) for j, v in enumerate(cache._w[row])) == k


def test_mirror_syncs_the_same_bytes_as_jax_cold_dirty_warm():
    jcache = jsc.SecretKeyCache(capacity=2048)
    cache = SecretKeyCache(capacity=2048)
    steps = [ENTRIES[:3], ENTRIES[:3], ENTRIES[2:6],     # cold, warm, dirty
             [(i.to_bytes(48, "big"), i) for i in range(1, 1100)]]  # grows
    for entries in steps:
        cache.rows_for(entries)
        jcache.rows_for(entries)
        arena, rows = cache.device_view("cpu")
        jarena, jrows = jcache.device_view()
        assert cache.sync_stats() == jcache.sync_stats()
        assert rows == cache._w.shape[0] == jrows    # power-of-two rows
        assert np.array_equal(arena.numpy().view(np.uint32),
                              np.asarray(jarena))
    st = cache.sync_stats()
    assert st["device_full_uploads"] == 2             # first view, growth
    assert st["device_sync_rows"] == 1024 + 3 + 2048
    assert cache.sync_bytes_since(None) == st["device_sync_bytes"]
    warm = cache.sync_stats()
    cache.pack_rows_device(ENTRIES[:6], "cpu")
    assert cache.sync_bytes_since(warm) == 0


def test_mirror_rows_are_the_host_rows_without_padding():
    """The TPU package pads its mirror to a power of two (a shape rule of
    its compiler); the port mirrors the host rows as they are, so the
    full upload of a 3-row arena moves 3 rows there and 4 in JAX."""
    cache = SecretKeyCache(capacity=2, initial_rows=3)
    jcache = jsc.SecretKeyCache(capacity=2, initial_rows=3)
    assert cache.device_view("cpu")[1] == 3
    assert jcache.device_view()[1] == 4
    assert cache.sync_stats()["device_sync_bytes"] == 3 * ROW_SYNC_BYTES
    assert jcache.sync_stats()["device_sync_bytes"] == 4 * ROW_SYNC_BYTES


def test_pack_rows_device_gathers_the_scalar_words():
    cache = SecretKeyCache(capacity=8, initial_rows=4)
    entries = [ENTRIES[3], None, ENTRIES[5], ENTRIES[3]]
    rows, w = cache.pack_rows_device(entries, "cpu")
    assert rows.tolist() == [1, ZERO_ROW, 2, 1]
    want = np.stack([cache._words(e[1]) if e else np.zeros(8, np.uint32)
                     for e in entries])
    assert np.array_equal(w.numpy().view(np.uint32), want)
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 2


def test_plain_secret_scatter_and_gather_match_jax():
    rows, d = 64, 9
    arena = RNG.integers(0, 2**32, size=(rows, 8), dtype=np.uint64) \
        .astype(np.uint32)
    idx = RNG.permutation(rows)[:d].astype(np.int64)
    vals = RNG.integers(0, 2**32, size=(d, 8), dtype=np.uint64) \
        .astype(np.uint32)
    want = np.asarray(jsc._scatter_rows(jnp.asarray(arena), jnp.asarray(idx),
                                        jnp.asarray(vals)))
    t = torch.from_numpy(arena.view(np.int32).copy())
    out = staged.k_scatter_sk_rows(t, torch.from_numpy(idx),
                                   torch.from_numpy(vals.view(np.int32)))
    assert out is t and np.array_equal(t.numpy().view(np.uint32), want)
    sel = np.array([0, rows - 1, int(idx[2]), 0, 5], np.int64)
    got = staged.k_gather_sk_rows(t, torch.from_numpy(sel))
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(jsigner.gather_rows(jnp.asarray(want),
                                                         sel)))


@pytest.mark.parametrize("kernel", ["scatter", "gather"])
@pytest.mark.parametrize("row", [-1, 16])
def test_plain_secret_kernels_raise_on_rows_outside(kernel, row):
    """A row outside [0, rows), negative ones included (which torch
    indexing would wrap), raises as the kernels trap on it."""
    a = torch.zeros((16, 8), dtype=torch.int32)
    idx = torch.tensor([1, row], dtype=torch.int64)
    with pytest.raises(IndexError):
        if kernel == "scatter":
            staged.k_scatter_sk_rows(a, idx,
                                     torch.ones((2, 8), dtype=torch.int32))
        else:
            staged.k_gather_sk_rows(a, idx)
    assert not a.any()


def test_jax_cache_carried_into_the_port():
    jcache = jsc.SecretKeyCache(capacity=5, initial_rows=2)
    for ids in STREAM[:4]:
        jcache.rows_for(_batch(ids))
    cache = convert.seckey_arena_from_jax(jcache)
    assert cache.stats() == jcache.stats()
    assert list(cache._index.items()) == list(jcache._index.items())
    assert np.array_equal(cache._w, jcache._w)
    assert cache._w is not jcache._w
    for ids in STREAM[4:]:                      # and they go on alike
        assert cache.rows_for(_batch(ids)).tolist() == \
            jcache.rows_for(_batch(ids)).tolist()
    assert cache.stats() == jcache.stats()
    jcache._w = jcache._w[:, :4]
    with pytest.raises(ValueError, match="uint32"):
        convert.seckey_arena_from_jax(jcache)


def test_process_wide_cache():
    first = seckey_cache.reset_cache(capacity=3, initial_rows=2)
    assert seckey_cache.get_cache() is first and first.capacity == 3
    fresh = seckey_cache.reset_cache()
    assert fresh is not first
    assert fresh.capacity == seckey_cache.DEFAULT_CAPACITY == 1 << 21
