"""The port's packed-pubkey cache (lighthouse_tpu_torch crypto/bls/cuda/
pubkey_cache.py) and its arena kernels' plain versions against the JAX
package: the same key stream through both caches gives the same rows,
stats and gathered values (duplicates in a batch, LRU evictions, free-list
reuse); the plain scatter and gather against JAX's jitted _scatter_rows and
jnp.take; a JAX cache carried into the port (convert.pubkey_cache_from_jax);
and the mirror's sync rules on a CPU device.

Keys come from secret keys drawn with a numpy seed; limbs compare as
canonical integers, rows and counters exactly (tolerance 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu.crypto.bls.tpu import fp as jfp
from lighthouse_tpu.crypto.bls.tpu import pubkey_cache as jpc
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls.cuda import convert, fp, staged
from lighthouse_tpu_torch.crypto.bls.cuda.pubkey_cache import (
    ROW_SYNC_BYTES, PackedPubkeyCache)

RNG = np.random.default_rng(0xA2E4A)


@pytest.fixture(scope="module")
def keys():
    """12 keys as (JAX PublicKey, port PublicKey) of the same point."""
    g = cv.g1_generator()
    out = []
    for k in RNG.integers(1, 2**62, size=12):
        raw = cv.g1_compress(g.mul(int(k)))
        out.append((jbls.PublicKey.from_bytes(raw),
                    bls.PublicKey.from_bytes(raw)))
    return out


# batches of key indices (None: padding): duplicates inside a batch, hits,
# evictions at capacity 4, a batch larger than the capacity (trimmed to
# the free list), then reuse of the freed rows
STREAM = [[0, 1, 1, None], [2, 0, 3], [4, 5], [0, 6, 7, 8, 9, 10],
          [11, 11], [1, None, 2]]


def _ints(arr):
    return fp.unpack(torch.as_tensor(np.asarray(arr).view(np.int32)))


def _jints(arr):
    return [v * pow(jfp.R, -1, cv.P) % cv.P
            for v in jfp.unpack_ints(np.asarray(arr))]


def test_same_rows_stats_and_gathers_as_jax(keys):
    jcache = jpc.PackedPubkeyCache(capacity=4, initial_rows=2)
    cache = PackedPubkeyCache(capacity=4, initial_rows=2)
    reused = False
    for batch in STREAM:
        freed = set(cache._free)
        jrows = jcache.rows_for([keys[i][0] if i is not None else None
                                 for i in batch])
        rows = cache.rows_for([keys[i][1] if i is not None else None
                               for i in batch])
        assert rows.tolist() == jrows.tolist()
        assert cache.stats() == jcache.stats()
        assert cache._free == jcache._free
        reused |= bool(freed & set(rows.tolist()))
        x, y, inf = cache.gather(rows)
        jx, jy, jinf = jcache.gather(jrows)
        mont_inv = pow(fp.R, -1, cv.P)
        assert [v * mont_inv % cv.P for v in _ints(x)] == _jints(jx)
        assert [v * mont_inv % cv.P for v in _ints(y)] == _jints(jy)
        assert inf.tolist() == jinf.tolist()
    assert cache.evictions > 0 and reused          # LRU and free list
    assert cache.hit_rate_since(None) == jcache.hit_rate_since(None)


def test_gathered_rows_are_the_packed_points(keys):
    from lighthouse_tpu_torch.crypto.bls.cuda import curve

    cache = PackedPubkeyCache(capacity=8, initial_rows=4)
    pks = [keys[i][1] for i in (3, 1, 3)] + [None]
    x, y, inf = cache.pack_gathered(pks)
    px, py, pinf = curve.pack_g1_affine(
        [pk.point for pk in pks[:3]] + [cv.g1_infinity()])
    assert torch.equal(torch.as_tensor(x.astype(np.int64)), px)
    assert torch.equal(torch.as_tensor(y.astype(np.int64)), py)
    assert inf.tolist() == pinf.tolist()


def test_plain_scatter_and_gather_match_jax():
    rows, d = 64, 9
    arena = RNG.integers(0, 2**32, size=(2, rows, 12), dtype=np.uint64) \
        .astype(np.uint32)
    idx = RNG.permutation(rows)[:d].astype(np.int64)
    idx[-1] = idx[0]                                   # repeated row
    vals = RNG.integers(0, 2**32, size=(2, d, 12), dtype=np.uint64) \
        .astype(np.uint32)
    vals[:, -1] = vals[:, 0]
    want = [np.asarray(jpc._scatter_rows(jnp.asarray(arena[i]),
                                         jnp.asarray(idx),
                                         jnp.asarray(vals[i])))
            for i in range(2)]
    t = [torch.from_numpy(a.view(np.int32).copy()) for a in arena]
    staged.k_scatter_rows(*t, torch.from_numpy(idx),
                          *(torch.from_numpy(v.view(np.int32)) for v in vals))
    for got, w in zip(t, want):
        assert np.array_equal(got.numpy().view(np.uint32), w)
    sel = np.array([0, rows - 1, int(idx[2]), 0, 5], np.int64)
    x, y, inf = staged.k_gather_rows(*t, torch.from_numpy(sel))
    assert np.array_equal(x.numpy().view(np.uint32),
                          np.asarray(jnp.take(jnp.asarray(want[0]),
                                              jnp.asarray(sel), axis=0)))
    assert np.array_equal(y.numpy().view(np.uint32),
                          np.asarray(jnp.take(jnp.asarray(want[1]),
                                              jnp.asarray(sel), axis=0)))
    assert inf.tolist() == [True, False, False, True, False]


@pytest.mark.parametrize("kernel", ["scatter", "gather"])
@pytest.mark.parametrize("row", [-1, 16])
def test_plain_arena_kernels_raise_on_rows_outside(kernel, row):
    """A row outside [0, rows), negative ones included (which torch
    indexing would wrap), raises as the kernels trap on it."""
    ax = torch.zeros((16, 12), dtype=torch.int32)
    ay = torch.zeros_like(ax)
    idx = torch.tensor([1, row], dtype=torch.int64)
    v = torch.ones((2, 12), dtype=torch.int32)
    with pytest.raises(IndexError):
        if kernel == "scatter":
            staged.k_scatter_rows(ax, ay, idx, v, v)
        else:
            staged.k_gather_rows(ax, ay, idx)
    assert not ax.any() and not ay.any()


def test_jax_cache_carried_into_the_port(keys):
    jcache = jpc.PackedPubkeyCache(capacity=5, initial_rows=2)
    for batch in STREAM[:4]:
        jcache.rows_for([keys[i][0] if i is not None else None
                         for i in batch])
    cache = convert.pubkey_cache_from_jax(jcache)
    assert cache.stats() == jcache.stats()
    assert list(cache._index.items()) == list(jcache._index.items())
    every = np.arange(jcache._x.shape[0])
    x, y, inf = cache.gather(every)
    jx, jy, _ = jcache.gather(every)
    mont_inv = pow(fp.R, -1, cv.P)
    assert [v * mont_inv % cv.P for v in _ints(x)] == _jints(jx)
    assert [v * mont_inv % cv.P for v in _ints(y)] == _jints(jy)
    for batch in STREAM[4:]:                    # and they go on alike
        assert cache.rows_for(
            [keys[i][1] if i is not None else None for i in batch]
        ).tolist() == jcache.rows_for(
            [keys[i][0] if i is not None else None for i in batch]).tolist()
    assert cache.stats() == jcache.stats()


def test_mirror_syncs_dirty_rows_and_regrows(keys):
    cache = PackedPubkeyCache(capacity=16, initial_rows=4)
    pks = [k[1] for k in keys]
    rows, x, y, inf = cache.pack_rows_device(pks[:2] + [None], "cpu")
    first = cache.sync_stats()
    assert first == {"device_full_uploads": 1, "device_sync_rows": 4,
                     "device_sync_bytes": 4 * ROW_SYNC_BYTES}
    hx, hy, hinf = cache.gather(rows.numpy())
    assert np.array_equal(x.numpy().view(np.uint32), hx)
    assert inf.tolist() == [False, False, True]
    cache.pack_rows_device(pks[:2], "cpu")             # warm: no sync
    assert cache.sync_stats() == first
    rows, x, _, _ = cache.pack_rows_device(pks[1:3], "cpu")   # one cold key
    assert cache.sync_stats()["device_sync_rows"] == 4 + 1
    assert cache.sync_stats()["device_sync_bytes"] == 5 * ROW_SYNC_BYTES
    assert np.array_equal(x.numpy().view(np.uint32),
                          cache.gather(rows.numpy())[0])
    cache.pack_rows_device(pks[3:9], "cpu")            # grows: full upload
    st = cache.sync_stats()
    assert st["device_full_uploads"] == 2
    ax, ay = cache.device_view("cpu")
    assert ax.shape[0] == cache._x.shape[0] == 16
    assert np.array_equal(ax.numpy().view(np.uint32), cache._x)
    assert np.array_equal(ay.numpy().view(np.uint32), cache._y)
