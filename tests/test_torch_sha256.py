"""The port's hash engine against the JAX package's: the plain versions of
the four kernels against the JAX kernel functions (called eagerly, and
through hash_pairs_jax / digest_blocks_jax / reduce_levels_jax with their
executables swapped for the eager kernels, at the 64-lane bucket), padding,
reduce_levels, routing and the guards.  Same numpy-seeded inputs on both
sides; the tolerance is exact equality of bytes and integers."""
import hashlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.sha256 import kernel as jk
from lighthouse_tpu.crypto.sha256 import padding as jpad
from lighthouse_tpu_torch.crypto.sha256 import api, padding
from lighthouse_tpu_torch.crypto.sha256.cuda import kernel as hk
from lighthouse_tpu_torch.csrc import gen_consts
from lighthouse_tpu_torch.ssz.hash import ZERO_HASHES

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _engine():
    api.reset_engine()
    api.configure(device="cpu")
    yield
    api.reset_engine()


@pytest.fixture
def eager_jax(monkeypatch):
    """The JAX host entry points with their compiled executables replaced
    by the eager kernel functions (the lane buckets stay)."""
    monkeypatch.setattr(jk, "_pairs_exec", lambda bucket: jk.k_pairs)
    monkeypatch.setattr(jk, "_entry_exec", lambda bucket: jk.k_entry)
    monkeypatch.setattr(jk, "_level_exec", lambda bucket: jk.k_level)
    monkeypatch.setattr(jk, "_digest_exec", lambda bucket, m: jk.k_digest)


def _messages(rng, n, length=64):
    out = [bytes(length), b"\xff" * length]
    out += [bytes(rng.integers(0, 256, length, dtype=np.uint8))
            for _ in range(n - 2)]
    return out


def _torch_words(data: bytes, shape):
    return torch.from_numpy(np.frombuffer(data, "<i4").reshape(shape).copy())


def _state_bytes(state) -> bytes:
    """A (c, 8) natural-value state, from either package's layout, as the
    big-endian chunk bytes of its nodes."""
    a = np.asarray(state)
    return a.view(np.uint32).astype(">u4").tobytes()


def test_plain_k_pairs_matches_jax_and_hashlib():
    rng = np.random.default_rng(0x5A1)
    msgs = _messages(rng, 9)
    data = b"".join(msgs)
    words = jpad.pairs_to_words(data)
    want = b"".join(hashlib.sha256(m).digest() for m in msgs)
    assert np.asarray(jk.k_pairs(jnp.asarray(words))).tobytes() == want
    got = hk.k_pairs(_torch_words(data, (9, 16)))
    assert got.dtype == torch.int32 and got.shape == (9, 8)
    assert got.numpy().tobytes() == want


def test_plain_entry_and_level_chain_match_jax():
    """k_entry then two k_levels, compared as digest bytes at every stage
    boundary ((8, n) lanes-minor in JAX, (n, 8) rows here)."""
    rng = np.random.default_rng(0x5A2)
    data = b"".join(_messages(rng, 8))
    jx = jk.k_entry(jnp.asarray(jpad.pairs_to_words(data)))
    tx = hk.k_entry(_torch_words(data, (8, 16)))
    level = [hashlib.sha256(data[64 * i:64 * (i + 1)]).digest()
             for i in range(8)]
    for _ in range(3):
        assert _state_bytes(np.asarray(jx).T) == b"".join(level)
        assert _state_bytes(tx.numpy()) == b"".join(level)
        if len(level) == 1:
            break
        jx, tx = jk.k_level(jx), hk.k_level(tx)
        level = [hashlib.sha256(level[2 * j] + level[2 * j + 1]).digest()
                 for j in range(len(level) // 2)]


@pytest.mark.parametrize("m,length", [(1, 55), (2, 64), (3, 150), (4, 247)])
def test_plain_k_digest_matches_jax_and_hashlib(m, length):
    rng = np.random.default_rng(0x5A3 + m)
    msgs = _messages(rng, 5, length) + [
        bytes(rng.integers(0, 256, length - 4, dtype=np.uint8))]
    blocks = jpad.msgs_to_blocks(msgs)
    assert blocks.shape == (6, m, 16)
    want = b"".join(hashlib.sha256(x).digest() for x in msgs)
    assert np.asarray(jk.k_digest(jnp.asarray(blocks))).tobytes() == want
    got = hk.k_digest(_torch_words(blocks.tobytes(), blocks.shape))
    assert got.numpy().tobytes() == want


def test_host_entry_points_match_jax_at_the_64_lane_bucket(eager_jax):
    rng = np.random.default_rng(0x5A4)
    data = b"".join(_messages(rng, 7))
    assert hk.hash_pairs(data, CPU) == jk.hash_pairs_jax(data)
    msgs = _messages(rng, 5, 100)
    blocks = padding.msgs_to_blocks(msgs)
    assert hk.digest_blocks(blocks, CPU) == jk.digest_blocks_jax(blocks)


def test_padding_matches_the_jax_package():
    rng = np.random.default_rng(0x5A5)
    lengths = [0, 1, 55, 56, 63, 64, 65, 119, 120, 200]
    msgs = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in lengths]
    for x in msgs:
        assert padding.block_count(len(x)) == jpad.block_count(len(x))
        assert padding.pad_message(x) == jpad.pad_message(x)
    assert padding.group_by_blocks(msgs) == jpad.group_by_blocks(msgs)
    for _, idxs in padding.group_by_blocks(msgs):
        group = [msgs[i] for i in idxs]
        assert np.array_equal(padding.msgs_to_blocks(group),
                              jpad.msgs_to_blocks(group))
    data = b"".join(msgs[:2]) + bytes(64 * 3)
    data = data[:64 * (len(data) // 64)]
    assert np.array_equal(padding.pairs_to_words(data),
                          jpad.pairs_to_words(data))
    with pytest.raises(ValueError, match="differing block counts"):
        padding.msgs_to_blocks([b"", bytes(64)])


# (chunks, starting depth, depth limit, min pairs): odd levels at the entry
# and at several chained depths (2^k + 1 chunks), a min_pairs stop and a
# depth_limit stop.
REDUCE_CASES = [
    (33, 0, 7, 2),
    (65, 0, 8, 4),
    (100, 3, 12, 3),
    (129, 0, 2, 1),
    (64, 0, 10, 16),
    (9, 5, 9, 1),
]


@pytest.mark.parametrize("chunks,depth,limit,min_pairs", REDUCE_CASES)
def test_reduce_levels_matches_reduce_levels_jax(eager_jax, chunks, depth,
                                                 limit, min_pairs):
    rng = np.random.default_rng(chunks * 1000 + depth)
    buf = bytes(rng.integers(0, 256, 32 * chunks, dtype=np.uint8))
    want = jk.reduce_levels_jax(buf, depth, ZERO_HASHES, limit, min_pairs)
    stats = []
    got = hk.reduce_levels(bytearray(buf), depth, ZERO_HASHES, limit,
                           min_pairs, CPU, stats)
    assert got == want
    assert [r["backend"] for r in stats] == ["cuda"] * (got[1] - depth)
    assert stats[0]["pairs"] == (chunks + 1) // 2


def test_api_reduce_levels_noop_exits_return_the_input():
    buf = bytearray(bytes(range(32)) * 10)              # 5 pairs
    api.configure(threshold=8)
    assert api.reduce_levels(buf, 0, ZERO_HASHES, 4) == (buf, 0)
    api.configure(threshold=2)
    assert api.reduce_levels(buf, 4, ZERO_HASHES, 4) == (buf, 4)
    out, d = api.reduce_levels(buf, 0, ZERO_HASHES, 4)
    assert d >= 1 and len(out) < len(buf)


def test_routing_threshold_and_digest_counts():
    assert api.batch_threshold() == api.DEFAULT_THRESHOLD == 1024
    assert api.engine_status()["backend"] == "cuda"
    assert api.backend_for(1023) == "hashlib"
    assert api.backend_for(1024) == "cuda"
    api.configure(threshold=4)
    rng = np.random.default_rng(0x5A6)
    wide = bytes(rng.integers(0, 256, 64 * 5, dtype=np.uint8))
    narrow = wide[:64 * 3]
    want = b"".join(hashlib.sha256(wide[64 * i:64 * (i + 1)]).digest()
                    for i in range(5))
    assert api.hash_pairs(wide) == want
    assert api.hash_pairs(narrow) == want[:96]
    msgs = [bytes([i]) * i for i in range(6)] + [bytes(300)]
    assert api.digest_many(msgs) == [hashlib.sha256(x).digest()
                                     for x in msgs]
    st = api.engine_status()
    assert st["digests"] == {"cuda": 5 + 7, "hashlib": 3}
    assert st["widest"] == {"cuda": 7, "hashlib": 3}
    assert st["device"] == "cpu" and st["threshold"] == 4
    assert st["launches"] == {k: 0 for k in hk.KERNELS}   # plain, no card
    api.configure(backend="hashlib")
    assert api.backend_for(10 ** 6) == "hashlib"
    assert api.hash_pairs(wide) == want
    assert api.hash_pairs(b"") == b"" and api.digest_many([]) == []


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown hash backend"):
        api.configure(backend="jax")
    with pytest.raises(ValueError, match="unknown hash backend"):
        api.set_hash_backend("native")


def test_cuda_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api.configure(backend="cuda", threshold=2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.hash_pairs(bytes(64 * 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.digest_many([b"a", b"b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.reduce_levels(bytes(32 * 4), 0, ZERO_HASHES, 2)
    # narrow calls stay on hashlib and need no card
    assert api.hash_pairs(bytes(64)) == hashlib.sha256(bytes(64)).digest()


def _header_words(name: str) -> list:
    with open(gen_consts.HEADER.replace("bls12_381_consts.cuh",
                                        "sha256.cuh")) as f:
        text = f.read()
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
    return [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9a-f]+u", body)]


def test_device_constants_match_the_jax_package():
    assert _header_words("LH_SHA_K") == hk.SHA_K == [int(x) for x in jk.K]
    assert _header_words("LH_SHA_IV") == hk.SHA_IV == [int(x) for x in jk.IV]
    assert (_header_words("LH_SHA_PAD64_KW") == hk.PAD64_KW
            == [int(x) for x in jk.PAD64_KW])
