"""The port's batched swap-or-not shuffle and sync-committee sampler against
the JAX package's, with the port's hash engine on the "cuda" backend,
device="cpu" (the kernels' plain versions) and a low threshold.  Seeds and
balances come from numpy; the tolerance is exact equality of indices."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.sha256 import api as japi
from lighthouse_tpu.state_transition import shuffle as jshuffle
from lighthouse_tpu.state_transition.epoch_engine import shuffle as jeshuffle
from lighthouse_tpu_torch.crypto.sha256 import api
from lighthouse_tpu_torch.state_transition.epoch_engine import shuffle


@pytest.fixture(autouse=True)
def _engines():
    api.reset_engine()
    api.configure(backend="cuda", threshold=16, device="cpu")
    japi.reset_engine()
    japi.configure(backend="hashlib")
    yield
    api.reset_engine()
    japi.reset_engine()


@pytest.mark.parametrize("n,rounds", [
    (0, 10), (1, 10), (2, 10), (7, 10), (300, 10), (1000, 90), (513, 0)])
def test_batched_shuffle_matches_jax_forward_and_inverted(n, rounds):
    seed = bytes(np.random.default_rng(n + rounds).integers(
        0, 256, 32, dtype=np.uint8))
    fwd = shuffle.batched_shuffle_indices(n, seed, rounds)
    inv = shuffle.batched_shuffle_indices(n, seed, rounds, invert=True)
    assert np.array_equal(fwd, jshuffle.shuffle_indices(n, seed, rounds))
    assert np.array_equal(inv, jshuffle.shuffle_indices(n, seed, rounds,
                                                         invert=True))
    assert np.array_equal(inv[fwd], np.arange(n, dtype=np.uint64))
    for i in range(0, n, max(n // 5, 1)):
        assert int(fwd[i]) == jshuffle.compute_shuffled_index(
            i, n, seed, rounds)
    if n > 1 and rounds and rounds * ((n + 255) // 256 + 1) >= 16:
        assert api.engine_status()["digests"]["cuda"] > 0


def test_sync_committee_sample_matches_the_jax_epoch_engine():
    rng = np.random.default_rng(0x5C)
    n = 600
    active = np.sort(rng.choice(2 * n, n, replace=False)).astype(np.uint64)
    eff = (rng.integers(16, 33, 2 * n) * 10**9).astype(np.uint64)
    seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    args = (active, eff, seed, 32, 32 * 10**9, 10)
    got = shuffle.sample_sync_committee_indices(*args)
    assert got == jeshuffle.sample_sync_committee_indices(*args)
    assert len(got) == 32 and set(got) <= set(active.tolist())
    assert api.engine_status()["digests"]["cuda"] > 0
