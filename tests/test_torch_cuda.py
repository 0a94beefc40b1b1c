"""The CUDA kernels against their plain versions on the card (skipped
without a CUDA device: a CUDA kernel has no CPU mode).  chip_smoke.py runs
the same comparisons with more edge cases and at the main path's shapes.

    python -m pytest --noconftest tests/test_torch_cuda.py   # with a card

(--noconftest: tests/conftest.py imports jax, which a card machine for the
port need not have.)
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2
from tests.test_torch_wire_vectors import (
    OFF_CURVE_X1, non_subgroup_signature)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def test_kernels_match_plain_on_the_card(card):
    rng = np.random.default_rng(0xCDA)
    n = 3
    msgs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
    words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)).to(card)
    before = staged.launch_counts()
    u = staged.k_xmd(words)
    assert torch.equal(u, staged.k_xmd_plain(words))
    h = staged.k_hash(u)
    for a, b in zip(h, staged.k_hash_plain(u)):
        assert torch.equal(a, b)
    sks = [int(x) for x in rng.integers(1, 2**60, size=n)]
    g1 = cv.g1_generator()
    pks = [g1.mul(k) for k in sks]
    sigs = [hr.hash_to_g2(m).mul(k) for m, k in zip(msgs, sks)]
    xp, yp, pi = curve.pack_g1_affine(pks)
    xs, ys, si = curve.pack_g2_affine(sigs)
    rand = torch.as_tensor(rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32)).to(card)
    args = [staged.to_i32(xp).to(card), staged.to_i32(yp).to(card),
            pi.to(card), staged.to_i32(xs).to(card),
            staged.to_i32(ys).to(card), si.to(card), rand]
    pts = staged.k_points(*args)
    for a, b in zip(pts, staged.k_points_plain(*args)):
        assert torch.equal(a, b)
    pair = (pts[0], pts[1], pts[2], h[0], h[1], h[2], pts[3], pts[4], pts[5])
    ok, gt = staged.k_pair(*pair)
    pok, pgt = staged.k_pair_plain(*pair)
    assert torch.equal(ok, pok) and torch.equal(gt, pgt)
    after = staged.launch_counts()
    assert all(after[k] == before[k] + 1
               for k in ("k_xmd", "k_hash", "k_points", "k_pair"))


def test_cuda_backend_verifies_on_the_card(card):
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend

    be = CudaBackend()
    sk = bls.SecretKey(4242)
    m = bytes(range(32))
    s = bls.SignatureSet(sk.sign(m), [sk.public_key()], m)
    assert be.verify_signature_sets([s]) is True
    bad = bls.SignatureSet(sk.sign(m[::-1]), [sk.public_key()], m)
    assert be.verify_signature_sets([bad]) is False


def test_decode_and_each_match_plain_on_the_card(card):
    from lighthouse_tpu_torch.crypto.bls.cuda.backend import (
        parse_g2_compressed_many)

    sks = [11, 12, 13]
    msgs = [bytes([i]) * 32 for i in range(3)]
    sigs = [hr.hash_to_g2(m).mul(k) for m, k in zip(msgs, sks)]
    raws = [cv.g2_compress(s) for s in sigs] + [
        cv.g2_compress(cv.g2_infinity()), OFF_CURVE_X1,
        non_subgroup_signature()]
    x, sign, inf = (t.to(card) for t in parse_g2_compressed_many(raws, 8))
    before = staged.launch_counts()
    out = staged.k_decode(x, sign, inf)
    ref = staged.k_decode_plain(x, sign, inf)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert not bool(out[3])
    good = staged.k_decode(x[:4].contiguous(), sign[:4].contiguous(),
                           inf[:4].contiguous())
    assert bool(good[3]) and torch.equal(
        staged.k_and(good[3], good[3]), good[3])
    assert not bool(staged.k_and(good[3], out[3]))
    empty = staged.k_decode(x[:0], sign[:0], inf[:0])   # no lane: no launch
    assert bool(empty[3]) and empty[0].shape == (0, 2, 12)

    xs, ys, si = good[0][:3], good[1][:3], good[2][:3]
    xp, yp, pi = curve.pack_g1_affine([cv.g1_generator().mul(k)
                                       for k in sks])
    xp, yp, pi = staged.to_i32(xp).to(card), staged.to_i32(yp).to(card), \
        pi.to(card)
    words = torch.as_tensor(h2.pack_msg_words(
        [msgs[0], msgs[0], msgs[2]]).view(np.int32)).to(card)
    hx, hy, hinf = staged.k_hash(staged.k_xmd(words))
    pi = pi.clone()
    pi[2] = True                                    # an infinity key
    args = (xp, yp, pi, xs.contiguous(), ys.contiguous(), si.contiguous(),
            hx, hy, hinf)
    ok = staged.k_each(*args)
    assert ok.tolist() == [True, False, False]      # valid, wrong message
    assert torch.equal(ok, staged.k_each_plain(*args))
    after = staged.launch_counts()
    assert after["k_decode"] == before["k_decode"] + 2
    assert after["k_and"] == before["k_and"] + 2
    assert after["k_each"] == before["k_each"] + 1


def test_arena_kernels_match_plain_on_the_card(card):
    g = torch.Generator().manual_seed(7)
    rows, d = 1000, 64
    ax = torch.randint(-2**31, 2**31 - 1, (rows, 12), generator=g,
                       dtype=torch.int32)
    ay = torch.randint(-2**31, 2**31 - 1, (rows, 12), generator=g,
                       dtype=torch.int32)
    ax[0] = 0
    ay[0] = 0
    idx = torch.randperm(rows - 1, generator=g)[:d].to(torch.int64) + 1
    idx[-1] = idx[0]                                # a repeated row
    vx = torch.randint(-2**31, 2**31 - 1, (d, 12), generator=g,
                       dtype=torch.int32)
    vy = torch.randint(-2**31, 2**31 - 1, (d, 12), generator=g,
                       dtype=torch.int32)
    vx[-1], vy[-1] = vx[0], vy[0]
    a = [t.to(card) for t in (ax, ay)]
    b = [t.to(card) for t in (ax, ay)]
    staged.k_scatter_rows(*a, idx.to(card), vx.to(card), vy.to(card))
    staged.k_scatter_rows_plain(*b, idx.to(card), vx.to(card), vy.to(card))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    sel = torch.tensor([0, rows - 1, 5, 0, int(idx[3])], dtype=torch.int64,
                       device=card)
    got = staged.k_gather_rows(*a, sel)
    for u, v in zip(got, staged.k_gather_rows_plain(*a, sel)):
        assert torch.equal(u, v)
    assert got[2].tolist() == [True, False, False, True, False]


# A row index outside the arena traps the kernel; the context is lost, so
# each case runs in a process of its own.
_BAD_ROW = """
import sys, torch
from lighthouse_tpu_torch.crypto.bls.cuda import staged
dev = torch.device("cuda")
ax = torch.zeros((8, 12), dtype=torch.int32, device=dev)
ay = torch.zeros_like(ax)
sk = torch.zeros((8, 8), dtype=torch.int32, device=dev)
idx = torch.tensor([1, {row}], dtype=torch.int64, device=dev)
try:
    if "{kernel}" == "scatter":
        v = torch.ones((2, 12), dtype=torch.int32, device=dev)
        staged.k_scatter_rows(ax, ay, idx, v, v)
    elif "{kernel}" == "gather":
        staged.k_gather_rows(ax, ay, idx)
    elif "{kernel}" == "sk_scatter":
        v = torch.ones((2, 8), dtype=torch.int32, device=dev)
        staged.k_scatter_sk_rows(sk, idx, v)
    else:
        staged.k_gather_sk_rows(sk, idx)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("kernel,row", [
    ("scatter", 8), ("gather", -1), ("sk_scatter", -1), ("sk_gather", 8)])
def test_arena_kernels_fail_on_rows_outside_the_arena(card, kernel, row):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _BAD_ROW.format(kernel=kernel, row=row)],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised:" in out.stdout


def test_wire_path_verifies_on_the_card(card):
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend

    be = CudaBackend()
    sks = [bls.SecretKey(900 + i) for i in range(3)]
    msgs = [bytes([7 * i + 1]) * 32 for i in range(3)]
    sets = [bls.SignatureSet(bls.LazySignature(sk.sign(m).to_bytes()),
                             [sk.public_key()], m)
            for sk, m in zip(sks, msgs)]
    assert be.verify_signature_sets(sets) is True
    bad = list(sets)
    bad[1] = bls.SignatureSet(bls.LazySignature(non_subgroup_signature()),
                              sets[1].pubkeys, sets[1].message)
    assert be.verify_signature_sets(bad) is False
    assert not any(s.signature.decoded() for s in bad)
    stats = be.pubkey_cache.sync_stats()
    assert be.verify_signature_sets(sets) is True    # warm: no sync
    assert be.pubkey_cache.sync_stats() == stats
    pts = [s.pubkeys[0].point for s in sets]
    sig_pts = [sk.sign(m).point for sk, m in zip(sks, msgs)]
    assert be._verify_many(pts, [msgs[0], msgs[0], msgs[2]], sig_pts) == [
        True, False, True]


def _sk_words(ks):
    return torch.tensor([[(k >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
                         for k in ks], dtype=torch.int64).to(torch.int32)


def _wire(planes):
    from lighthouse_tpu_torch.crypto.bls.sign_engine import compress_to_wire

    return [bytes(r) for r in compress_to_wire(*planes)]


def test_sign_kernels_match_plain_on_the_card(card):
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import signer

    ks = [1, R - 1, (1 << 254) + 99, 0]               # 0: a padding row
    msgs = [bytes([5 * i + 1]) * 32 for i in range(4)]
    w = _sk_words(ks).to(card)
    words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)).to(card)
    before = signer.launch_counts()
    out = signer.k_sign_root(w, words)
    for a, b in zip(out, signer.k_sign_root_plain(w, words)):
        assert torch.equal(a, b)
    want = [cv.g2_compress(hr.hash_to_g2(m).mul(k)) for m, k in
            zip(msgs[:3], ks[:3])] + [bytes([0xC0]) + bytes(95)]
    assert _wire(out) == want
    other = [b"", bytes(range(48))]
    u = staged.to_i32(h2.hash_to_field(other)).to(card)
    fout = signer.k_sign_field(w[:2].contiguous(), u)
    for a, b in zip(fout, signer.k_sign_field_plain(w[:2].contiguous(), u)):
        assert torch.equal(a, b)
    assert _wire(fout) == [cv.g2_compress(hr.hash_to_g2(m).mul(k))
                           for m, k in zip(other, ks[:2])]
    after = signer.launch_counts()
    assert after["k_sign_root"] == before["k_sign_root"] + 1
    assert after["k_sign_field"] == before["k_sign_field"] + 1


def test_sign_agg_matches_plain_on_the_card(card):
    from lighthouse_tpu_torch.crypto.bls.cuda import signer
    from lighthouse_tpu_torch.crypto.bls.sign_engine import parse_wire_planes

    sigs = [hr.hash_to_g2(bytes([i]) * 32).mul(300 + i) for i in range(3)]
    raw = [cv.g2_compress(p) for p in sigs]
    neg = cv.g2_compress(-sigs[1])
    rows = [[raw[0], raw[0], raw[1], raw[2]],      # a repeat doubles
            [raw[1], neg, raw[2], raw[0]],          # sigma + (-sigma)
            [OFF_CURVE_X1, raw[0], raw[1], raw[2]]]
    live = [[True, True, True, False], [True, True, False, False],
            [True, True, True, True]]
    x, sign, inf, ok = parse_wire_planes([r for row in rows for r in row])
    args = [torch.from_numpy(x.view(np.int32)).reshape(3, 4, 2, 12),
            torch.from_numpy(sign).reshape(3, 4),
            torch.from_numpy(inf).reshape(3, 4), torch.tensor(live)]
    args = [a.to(card) for a in args]
    before = signer.launch_counts()["k_sign_agg"]
    out = signer.k_sign_agg(*args)
    for a, b in zip(out, signer.k_sign_agg_plain(*args)):
        assert torch.equal(a, b)
    assert out[3].tolist() == [True, True, False]
    want = [cv.g2_compress(sigs[0] + sigs[0] + sigs[1]),
            cv.g2_compress(cv.g2_infinity())]
    assert _wire(out[:3])[:2] == want
    assert signer.launch_counts()["k_sign_agg"] == before + 1


def test_secret_arena_kernels_match_plain_on_the_card(card):
    g = torch.Generator().manual_seed(11)
    rows, d = 1000, 64
    a = torch.randint(-2**31, 2**31 - 1, (rows, 8), generator=g,
                      dtype=torch.int32)
    a[0] = 0
    idx = torch.randperm(rows - 1, generator=g)[:d].to(torch.int64) + 1
    v = torch.randint(-2**31, 2**31 - 1, (d, 8), generator=g,
                      dtype=torch.int32)
    kern, plain = a.to(card), a.to(card)
    before = staged.launch_counts()
    staged.k_scatter_sk_rows(kern, idx.to(card), v.to(card))
    staged.k_scatter_sk_rows_plain(plain, idx.to(card), v.to(card))
    assert torch.equal(kern, plain)
    sel = torch.tensor([0, rows - 1, int(idx[3]), 0], dtype=torch.int64,
                       device=card)
    got = staged.k_gather_sk_rows(kern, sel)
    assert torch.equal(got, staged.k_gather_sk_rows_plain(kern, sel))
    assert not got[0].any() and torch.equal(got[2], v[3].to(card))
    after = staged.launch_counts()
    assert after["k_scatter_sk_rows"] == before["k_scatter_sk_rows"] + 1
    assert after["k_gather_sk_rows"] == before["k_gather_sk_rows"] + 1


def test_sign_engine_on_the_card(card):
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import sign_engine as se
    from lighthouse_tpu_torch.crypto.bls.cuda import seckey_cache

    seckey_cache.reset_cache()
    se.reset_engine()
    se.configure(threshold=1)
    sks = [bls.SecretKey(0x5EE0 + 7 * i) for i in range(5)]
    msgs = [bytes([i]) * 32 for i in range(4)] + [b"a message, not a root"]
    entries = [(sk, m, sk.public_key().to_bytes())
               for sk, m in zip(sks, msgs)]
    want = [sk.sign(m).to_bytes() for sk, m in zip(sks, msgs)]
    assert se.sign_batch(entries) == want
    assert se.last_call()["backend"] == "cuda"
    assert se.sign_batch(entries) == want
    assert se.last_call()["sync_bytes"] == 0            # warm
    groups = [want[:3], [want[3], want[3]], want[4:]]
    assert se.aggregate_batch(groups) == [
        bls.AggregateSignature.from_signatures(
            [bls.Signature.from_bytes(s) for s in g]).to_bytes()
        for g in groups]
    with pytest.raises(bls.BlsError):
        se.aggregate_batch([[want[0], OFF_CURVE_X1]])
    se.reset_engine()


def test_hash_kernels_match_plain_and_hashlib_on_the_card(card):
    import hashlib

    from lighthouse_tpu_torch.crypto.sha256 import padding
    from lighthouse_tpu_torch.crypto.sha256.cuda import kernel as hk
    from lighthouse_tpu_torch.ssz.hash import ZERO_HASHES

    rng = np.random.default_rng(0x5A7)
    msgs = [bytes(64), b"\xff" * 64] + [
        bytes(rng.integers(0, 256, 64, dtype=np.uint8)) for _ in range(5)]
    words = torch.from_numpy(np.frombuffer(b"".join(msgs), "<i4")
                             .reshape(7, 16).copy()).to(card)
    before = hk.launch_counts()
    pairs, entry = hk.k_pairs(words), hk.k_entry(words)
    assert torch.equal(pairs, hk.k_pairs_plain(words))
    assert torch.equal(entry, hk.k_entry_plain(words))
    want = b"".join(hashlib.sha256(m).digest() for m in msgs)
    assert pairs.cpu().numpy().tobytes() == want
    zero = hk.k_entry(torch.zeros(4, 16, dtype=torch.int32, device=card))
    level = hk.k_level(zero)
    assert torch.equal(level, hk.k_level_plain(zero))
    nat = level.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
    assert nat == ZERO_HASHES[2] * 2
    for m, length in ((1, 40), (2, 100), (3, 150), (4, 240)):
        batch = [bytes(rng.integers(0, 256, length, dtype=np.uint8))
                 for _ in range(5)]
        blocks = padding.msgs_to_blocks(batch)
        assert blocks.shape[1] == m
        b = torch.from_numpy(blocks.view(np.int32).copy()).to(card)
        got = hk.k_digest(b)
        assert torch.equal(got, hk.k_digest_plain(b))
        assert got.cpu().numpy().tobytes() == b"".join(
            hashlib.sha256(x).digest() for x in batch)
    after = hk.launch_counts()
    assert after == {"k_pairs": before["k_pairs"] + 1,
                     "k_entry": before["k_entry"] + 2,
                     "k_level": before["k_level"] + 1,
                     "k_digest": before["k_digest"] + 4}


def test_hash_engine_state_root_on_the_card(card):
    from lighthouse_tpu_torch import types as ty
    from lighthouse_tpu_torch.crypto.sha256 import api

    T = ty.SpecTypes(ty.MINIMAL)
    vals = [ty.Validator(pubkey=i.to_bytes(48, "big"),
                         effective_balance=32 * 10**9) for i in range(300)]
    roots, launches = {}, None
    for backend in ("cuda", "hashlib"):        # cuda first: cold caches
        api.reset_engine()
        api.configure(backend=backend, threshold=8)
        s = T.BeaconStateDeneb(validators=[v.copy() for v in vals],
                               balances=list(range(300)))
        roots[backend] = T.BeaconStateDeneb.hash_tree_root(s)
        launches = launches or api.engine_status()["launches"]
    api.reset_engine()
    assert roots["cuda"] == roots["hashlib"]
    assert launches["k_entry"] > 0 and launches["k_pairs"] > 0


def test_epoch_kernels_match_plain_on_the_card(card):
    from chip_smoke import _epoch_args, epoch_edge_lanes, u64_err
    from lighthouse_tpu_torch.state_transition.epoch_engine.cuda import (
        kernel as ek)

    planes, scalar_sets = epoch_edge_lanes()
    rng = np.random.default_rng(0xE9C)
    wide = {k: np.concatenate([v] * 4096) for k, v in planes.items()}
    wide["bal"] = wide["bal"] + rng.integers(0, 10 ** 9, len(wide["bal"]),
                                             dtype=np.uint64)
    before = ek.launch_counts()
    for lanes in (planes, wide):
        for scal in scalar_sets:
            sums, state = _epoch_args(lanes, scal, card)
            assert u64_err([ek.k_sums(*sums)], [ek.k_sums_plain(*sums)]) == 0
            assert u64_err(ek.k_state(*state), ek.k_state_plain(*state)) == 0
    torch.cuda.synchronize()
    after = ek.launch_counts()
    assert after == {"k_sums": before["k_sums"] + 4,
                     "k_state": before["k_state"] + 4}


def test_epoch_engine_on_the_card(card):
    from chip_smoke import minimal_sync_state
    from lighthouse_tpu_torch import types as ty
    from lighthouse_tpu_torch.crypto.sha256 import api as hapi
    from lighthouse_tpu_torch.state_transition import per_epoch
    from lighthouse_tpu_torch.state_transition.epoch_engine import api

    T, state = minimal_sync_state(11)
    state.slot -= ty.MINIMAL.slots_per_epoch        # no committee rotation
    scalar = state.copy()
    E, spec = ty.MINIMAL, ty.ChainSpec.minimal()
    try:
        hapi.reset_engine()
        hapi.configure(threshold=8)
        api.reset_engine()
        api.configure(threshold=1)
        per_epoch.process_epoch(state, T, E, spec)
        assert api.engine_status()["answered"]["cuda"] == 1
        root = type(state).hash_tree_root(state)
        api.configure(backend="python")
        hapi.configure(backend="hashlib")
        per_epoch.process_epoch(scalar, T, E, spec)
        assert type(scalar).hash_tree_root(scalar) == root
        assert type(state).encode(state) == type(scalar).encode(scalar)
    finally:
        hapi.reset_engine()
        api.reset_engine()


def test_blob_eval_matches_plain_on_the_card(card):
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.kzg import reference as ref
    from lighthouse_tpu_torch.crypto.kzg.cuda import kernel as kk

    rng = np.random.default_rng(0xB10B)
    before = kk.launch_counts()["k_blob_eval"]
    launches = 0
    for b, n in ((3, 8), (1, 1), (2, 2), (2, 4096)):
        words = rng.integers(0, 1 << 32, size=(b, n, 8), dtype=np.uint64)
        words[..., 7] %= R >> 224                     # canonical: < r
        polys = [[int(sum(int(w) << (32 * k) for k, w in enumerate(e)))
                  for e in blob] for blob in words]
        roots = ref.roots_of_unity(n)
        zs = [int(rng.integers(0, 1 << 62)), roots[-1]] + [0] * (b - 2)
        zs = zs[:b]
        poly = torch.as_tensor(words.astype(np.uint32).view(np.int32)).to(card)
        z = torch.as_tensor(kk.fr.ints_to_limbs(zs).view(np.int32)).to(card)
        w, inv_n = kk.domain(n, card)
        y = kk.k_blob_eval(poly, z, w, inv_n)
        assert torch.equal(y, kk.k_blob_eval_plain(poly, z, w, inv_n))
        launches += 1
        got = kk.fr.unpack(y.cpu())
        assert got == [ref.evaluate_polynomial(p, v)
                       for p, v in zip(polys, zs)]
    torch.cuda.synchronize()
    assert kk.launch_counts()["k_blob_eval"] == before + launches


def test_kzg_verify_on_the_card(card):
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.kzg import setup as kset

    kzg.reset_engine()
    try:
        blobs = [kset.make_blob(64, b"card-%d" % i) for i in range(2)]
        cs = [kzg.blob_to_kzg_commitment(b) for b in blobs]
        ps = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]
        assert kzg.verify_blob_kzg_proof_batch(blobs, cs, ps) is True
        assert kzg.last_call()["backend"] == "cuda"
        assert kzg.verify_blob_kzg_proof_batch(blobs, cs, ps[::-1]) is False
    finally:
        kzg.reset_engine()


def test_mesh_kernels_match_plain_on_the_card(card):
    """k_subgroup (a non-subgroup signature, an infinity key, a lane off),
    k_decode_g1 (both signs, infinity), k_pair_partial / k_pair_combine
    (closing lane on and off) and k_ring_mul / k_ring_sum against their
    plain versions, each counter +1 a launch."""
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk

    rng = np.random.default_rng(0x3E5)
    n = 3
    msgs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
    sks = [int(x) for x in rng.integers(1, 2**60, size=n)]
    g1 = cv.g1_generator()
    pks = [g1.mul(k) for k in sks]
    sigs = [hr.hash_to_g2(m).mul(k) for m, k in zip(msgs, sks)]
    before = staged.launch_counts()
    xp, yp, pi = curve.pack_g1_affine(pks[:2] + [cv.g1_infinity()])
    xs, ys, si = curve.pack_g2_affine(
        sigs[:2] + [cv.g2_decompress(non_subgroup_signature(),
                                     subgroup_check=False)])
    act = torch.tensor([True, True, True], device=card)
    sub_in = (staged.to_i32(xp).to(card), staged.to_i32(yp).to(card),
              pi.to(card), act, staged.to_i32(xs).to(card),
              staged.to_i32(ys).to(card), si.to(card), act)
    got = staged.k_subgroup(*sub_in)
    want = staged.k_subgroup_plain(*sub_in)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].tolist() == [True] * 5 + [False] and not bool(got[1])
    planes = [t.to(card) for t in bk.parse_g1_compressed_many(
        [cv.g1_compress(p) for p in (pks[0], -pks[0], cv.g1_infinity())])]
    for check in (False, True):
        dec = staged.k_decode_g1(*planes, check=check)
        ref = staged.k_decode_g1_plain(*planes, check=check)
        assert all(torch.equal(a, b) for a, b in zip(dec, ref))
        assert bool(dec[3].all())
    words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)).to(card)
    h = staged.k_hash(staged.k_xmd(words))
    rand = torch.as_tensor(bk.random_weights(n, n).view(np.int32)).to(card)
    xp, yp, pi = curve.pack_g1_affine(pks)
    xs, ys, si = curve.pack_g2_affine(sigs)
    pts = staged.k_points(staged.to_i32(xp).to(card),
                          staged.to_i32(yp).to(card), pi.to(card),
                          staged.to_i32(xs).to(card),
                          staged.to_i32(ys).to(card), si.to(card), rand)
    lanes = (pts[0], pts[1], pts[2], *h)
    p_on = staged.k_pair_partial(*lanes, *pts[3:], closing=True)
    p_off = staged.k_pair_partial(*lanes)
    assert torch.equal(p_on, staged.k_pair_partial_plain(
        *lanes, *pts[3:], closing=True))
    assert torch.equal(p_off, staged.k_pair_partial_plain(*lanes))
    parts = torch.stack([p_on, p_off])
    ok, gt = staged.k_pair_combine(parts)
    pok, pgt = staged.k_pair_combine_plain(parts)
    assert torch.equal(ok, pok) and torch.equal(gt, pgt)
    ok1, gt1 = staged.k_pair_combine(p_on[None])
    kok, kgt = staged.k_pair(*lanes, *pts[3:])
    assert bool(ok1) and torch.equal(ok1, kok) and torch.equal(gt1, kgt)
    assert torch.equal(staged.k_ring_mul(p_on, p_off),
                       staged.k_ring_mul_plain(p_on, p_off))
    rx = torch.stack([pts[3], pts[3]])
    ry = torch.stack([pts[4], pts[4]])
    ri = torch.cat([pts[5], pts[5]])
    got = staged.k_ring_sum(rx, ry, ri)
    assert all(torch.equal(a, b)
               for a, b in zip(got, staged.k_ring_sum_plain(rx, ry, ri)))
    after = staged.launch_counts()
    assert after["k_subgroup"] == before["k_subgroup"] + 1
    assert after["k_decode_g1"] == before["k_decode_g1"] + 2
    assert after["k_pair_partial"] == before["k_pair_partial"] + 2
    assert after["k_pair_combine"] == before["k_pair_combine"] + 2
    assert after["k_ring_mul"] == before["k_ring_mul"] + 1
    assert after["k_ring_sum"] == before["k_ring_sum"] + 1


def test_mesh_verify_on_the_card(card):
    """The backend over a 2-shard mesh on the card (two streams): a valid
    batch True, with two signatures swapped across the shard boundary
    False, as wire bytes; the sharded and ring steps on decoded inputs."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend
    from lighthouse_tpu_torch.parallel import sharded_verify as sv

    mesh = sv.make_mesh([card, card])
    be = CudaBackend(name="cuda-mesh-test", mesh=mesh, mesh_min_sets=1)
    rng = np.random.default_rng(0x3E6)
    sets = []
    for k in rng.integers(1, 2**60, size=4):
        sk = bls.SecretKey(int(k))
        m = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        sets.append(bls.SignatureSet(
            bls.LazySignature(sk.sign(m).to_bytes()), [sk.public_key()], m))
    sv.reset_mesh_stats()
    assert be.verify_signature_sets(sets) is True
    bad = list(sets)
    bad[1], bad[2] = (
        bls.SignatureSet(sets[2].signature, sets[1].pubkeys, sets[1].message),
        bls.SignatureSet(sets[1].signature, sets[2].pubkeys, sets[2].message))
    assert be.verify_signature_sets(bad) is False
    stats = sv.mesh_stats()
    assert stats["dispatches"] == 2 and not any(stats["degradations"].values())
    assert not any(s.signature.decoded() for s in sets)


@pytest.fixture(scope="module")
def pair_base():
    """Eight (pubkey k g1, message point H) pairs with their signatures
    k H: the lanes of the pairing tests repeat them."""
    rng = np.random.default_rng(0x9A8)
    ks = [int(k) for k in rng.integers(1, 2**60, 8)]
    pks = [cv.g1_generator().mul(k) for k in ks]
    hs = [hr.hash_to_g2(bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
          for _ in range(8)]
    return pks, hs, [h.mul(k) for h, k in zip(hs, ks)]


def pair_lanes(base, n, mode, dev):
    """n lanes cycling over the base pairs and the closing sum S of their
    signatures (a valid batch); mode "mixed" sets infinity flags on some
    pubkeys and message points, "allinf" on every pubkey and on S."""
    pks, hs, sigs = base
    idx = [i % len(pks) for i in range(n)]
    xp, yp, _ = curve.pack_g1_affine([pks[j] for j in idx])
    xq, yq, _ = curve.pack_g2_affine([hs[j] for j in idx])
    winf = torch.zeros(n, dtype=torch.bool)
    hinf = torch.zeros(n, dtype=torch.bool)
    if mode == "mixed":
        winf[torch.arange(n) % 5 == 2] = True
        hinf[torch.arange(n) % 7 == 3] = True
    elif mode == "allinf":
        winf[:] = True
    s = cv.g2_infinity()
    for j, c in enumerate(np.bincount(idx, minlength=len(pks))):
        if c:
            s = s + sigs[j].mul(int(c))
    sx, sy, sinf = curve.pack_g2_affine([s])
    if mode == "allinf":
        sinf[:] = True
    to = staged.to_i32
    return tuple(t.to(dev) for t in (to(xp), to(yp), winf, to(xq), to(yq),
                                     hinf, to(sx)[0], to(sy)[0], sinf))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 65, 1025])
def test_pairing_kernels_match_plain_at_layout_edges(card, pair_base, n):
    """k_pair, k_pair_partial (closing on and off) and k_pair_combine (1, 2
    and 4 partials) word for word against their plain versions at the lane
    counts of the cooperative kernels' edges (a warp's 32 lanes, the 65 of
    the 64-set batch, 1,025), valid, with mixed and with all-infinity
    lanes; each wrapper counts one launch a call."""
    before = staged.launch_counts()
    parts, calls = [], {"k_pair": 0, "k_pair_partial": 0, "k_pair_combine": 0}
    for mode in ("valid", "mixed", "allinf"):
        a = pair_lanes(pair_base, n, mode, card)
        ok, gt = staged.k_pair(*a)
        pok, pgt = staged.k_pair_plain(*a)
        assert torch.equal(ok, pok) and torch.equal(gt, pgt), mode
        holes = bool(a[2].any() or a[5].any())
        assert bool(ok) == (mode == "allinf" or not holes), mode
        calls["k_pair"] += 1
        for closing in (True, False):
            extra = a[6:] if closing else ()
            p = staged.k_pair_partial(*a[:6], *extra, closing=closing)
            assert torch.equal(p, staged.k_pair_partial_plain(
                *a[:6], *extra, closing=closing)), (mode, closing)
            calls["k_pair_partial"] += 1
            parts.append(p)
    for s in (1, 2, 4):
        stack = torch.stack(parts[:s])
        got, want = staged.k_pair_combine(stack), staged.k_pair_combine_plain(
            stack)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        calls["k_pair_combine"] += 1
    after = staged.launch_counts()
    assert all(after[k] == before[k] + v for k, v in calls.items())
