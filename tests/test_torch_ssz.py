"""The port's SSZ (merkleize, grove, CachedListRoot, containers, a MINIMAL
Deneb state) against the JAX package's, on numpy-seeded inputs.  The port
runs its hash engine on the "cuda" backend with device="cpu" and a low
threshold, so wide levels take the kernels' plain versions; the JAX
package roots on hashlib.  State crosses between the packages as SSZ
bytes.  The tolerance is exact equality of bytes."""
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu import ssz as jssz
from lighthouse_tpu import types as jty
from lighthouse_tpu.crypto.sha256 import api as japi
from lighthouse_tpu.crypto.sha256 import merkleize_grove as jgrove
from lighthouse_tpu.ssz.cached_tree_hash import CachedListRoot as JCached
from lighthouse_tpu_torch import ssz, types as ty
from lighthouse_tpu_torch.crypto.sha256 import api, merkleize_grove
from lighthouse_tpu_torch.ssz import core
from lighthouse_tpu_torch.ssz.cached_tree_hash import (CachedListRoot,
                                                       ElementRootMemo)


@pytest.fixture(autouse=True)
def _engines():
    api.reset_engine()
    api.configure(backend="cuda", threshold=8, device="cpu")
    japi.reset_engine()
    japi.configure(backend="hashlib")
    yield
    api.reset_engine()
    japi.reset_engine()


def _chunks(rng, n):
    return [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]


@pytest.mark.parametrize("n,limit", [
    (0, None), (0, 64), (1, None), (3, None), (17, None), (33, 64),
    (100, None), (129, 1024), (257, None)])
def test_merkleize_list_and_buffer_forms_match_jax(n, limit):
    rng = np.random.default_rng(n * 7 + 1)
    chunks = _chunks(rng, n)
    want = jssz.merkleize(chunks, limit=limit)
    assert ssz.merkleize(chunks, limit=limit) == want
    assert ssz.merkleize(b"".join(chunks), limit=limit) == want
    assert ssz.merkleize(bytearray(b"".join(chunks)), limit=limit) == want
    if n >= 16:                  # a level of 8 pairs or more: the kernels
        assert api.engine_status()["digests"]["cuda"] > 0
    with pytest.raises(ValueError, match="exceed limit"):
        ssz.merkleize(chunks + [bytes(32)], limit=n)


def test_merkleize_grove_matches_jax():
    rng = np.random.default_rng(0x6201)
    trees = [_chunks(rng, 8) for _ in range(20)]
    assert merkleize_grove(trees) == jgrove(trees)
    ragged = [_chunks(rng, k) for k in (3, 5, 1, 8) * 4]
    assert merkleize_grove(ragged, limit=8) == jgrove(ragged, limit=8)
    assert merkleize_grove([]) == []
    with pytest.raises(ValueError, match="mixed widths"):
        merkleize_grove([_chunks(rng, 2), _chunks(rng, 5)])
    assert api.engine_status()["digests"]["cuda"] > 0


def test_cached_list_root_through_mutations_appends_and_a_shrink():
    rng = np.random.default_rng(0x6202)
    depth = 10
    mine, ref = CachedListRoot(depth), JCached(depth)
    leaves = _chunks(rng, 300)
    steps = []
    for _ in range(3):                       # mutations
        for i in rng.integers(0, len(leaves), 12):
            leaves[int(i)] = _chunks(rng, 1)[0]
        steps.append(list(leaves))
    leaves = leaves + _chunks(rng, 41)       # appends
    steps.append(list(leaves))
    leaves = leaves[:157]                    # a shrink
    steps.append(list(leaves))
    steps.append([])
    for step in steps:
        want = ref.root(step)
        assert mine.root(step) == want
        assert want == jssz.merkleize(step, limit=1 << depth)


def test_element_memo_keeps_the_reference_budget():
    memo = ElementRootMemo()
    assert memo.max_bytes == 32 << 20
    small = ElementRootMemo(max_bytes=3 * (8 + 32))
    for i in range(5):
        small.put(i.to_bytes(8, "little"), bytes([i]) * 32)
    assert small.get((0).to_bytes(8, "little")) is None
    assert small.get((4).to_bytes(8, "little")) == bytes([4]) * 32
    assert core.List.CACHE_THRESHOLD == 256
    assert core.List.GROVE_THRESHOLD == 64


def test_containers_encode_decode_and_root_like_jax():
    rng = np.random.default_rng(0x6203)
    jT, T = jty.SpecTypes(jty.MINIMAL), ty.SpecTypes(ty.MINIMAL)
    jv = jty.Validator(
        pubkey=bytes(rng.integers(0, 256, 48, dtype=np.uint8)),
        withdrawal_credentials=_chunks(rng, 1)[0], effective_balance=32 * 10**9,
        slashed=True, activation_eligibility_epoch=3, activation_epoch=9,
        exit_epoch=2**64 - 1, withdrawable_epoch=2**64 - 1)
    ja = jT.Attestation(
        aggregation_bits=[bool(b) for b in rng.integers(0, 2, 37)],
        data=jty.AttestationData(
            slot=77, index=2, beacon_block_root=_chunks(rng, 1)[0],
            source=jty.Checkpoint(epoch=4, root=_chunks(rng, 1)[0]),
            target=jty.Checkpoint(epoch=5, root=_chunks(rng, 1)[0])),
        signature=bytes(rng.integers(0, 256, 96, dtype=np.uint8)))
    for jtyp, typ, value in ((jty.Validator, ty.Validator, jv),
                             (jT.Attestation, T.Attestation, ja)):
        raw = jtyp.encode(value)
        mine = typ.decode(raw)
        assert typ.encode(mine) == raw
        assert typ.hash_tree_root(mine) == jtyp.hash_tree_root(value)
    with pytest.raises(ssz.DecodeError):
        ty.Validator.decode(b"\x00" * 120)


def _jax_state(n, rng):
    """A MINIMAL Deneb state of the JAX package with n validators; wide
    enough that CACHE_THRESHOLD (256) and GROVE_THRESHOLD (64) fire."""
    T = jty.SpecTypes(jty.MINIMAL)
    E = jty.MINIMAL
    vals = [jty.Validator(
        pubkey=bytes(rng.integers(0, 256, 48, dtype=np.uint8)),
        withdrawal_credentials=bytes(rng.integers(0, 256, 32,
                                                  dtype=np.uint8)),
        effective_balance=int(rng.integers(16, 33)) * 10**9,
        slashed=bool(rng.random() < 0.05),
        activation_eligibility_epoch=int(rng.integers(0, 10)),
        activation_epoch=int(rng.integers(0, 10)),
        exit_epoch=2**64 - 1, withdrawable_epoch=2**64 - 1)
        for _ in range(n)]
    roots = lambda k: [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
                       for _ in range(k)]
    return T.BeaconStateDeneb(
        genesis_time=1_600_000_000, slot=8 * 40 + 3,
        genesis_validators_root=roots(1)[0],
        block_roots=roots(E.slots_per_historical_root),
        state_roots=roots(E.slots_per_historical_root),
        randao_mixes=roots(E.epochs_per_historical_vector),
        validators=vals,
        balances=[int(x) for x in rng.integers(31 * 10**9, 33 * 10**9, n)],
        previous_epoch_participation=rng.integers(0, 8, n).tolist(),
        current_epoch_participation=rng.integers(0, 8, n).tolist(),
        inactivity_scores=rng.integers(0, 4, n).tolist(),
        historical_summaries=[jty.HistoricalSummary(
            block_summary_root=r, state_summary_root=r) for r in roots(3)])


def test_minimal_deneb_state_root_carried_across_by_ssz_bytes():
    rng = np.random.default_rng(0x6204)
    jstate = _jax_state(300, rng)
    jS = jty.SpecTypes(jty.MINIMAL).BeaconStateDeneb
    raw = jS.encode(jstate)
    spec = replace(ty.ChainSpec.minimal(), deneb_fork_epoch=0)
    state = ty.state_from_ssz_bytes(raw, ty.SpecTypes(ty.MINIMAL),
                                    ty.MINIMAL, spec)
    S = type(state)
    assert S.fork_name == "deneb" and S.encode(state) == raw
    want = jS.hash_tree_root(jstate)
    assert S.hash_tree_root(state) == want
    st = api.engine_status()
    assert st["digests"]["cuda"] > 0 and st["widest"]["hashlib"] < 8
    # the same mutation on both sides: balances, a validator, the mixes
    for s in (jstate, state):
        s.balances[17] += 5
        s.validators[250].slashed = True
        s.validators[250].exit_epoch = 50
        s.randao_mixes[3] = b"\x07" * 32
        s.slot += 1
    assert S.hash_tree_root(state) == jS.hash_tree_root(jstate) != want
    assert S.encode(state) == jS.encode(jstate)
