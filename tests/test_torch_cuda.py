"""The four CUDA kernels against their plain versions on the card (skipped
without a CUDA device: a CUDA kernel has no CPU mode).  chip_smoke.py runs
the same comparisons at the main path's shapes.

    python -m pytest --noconftest tests/test_torch_cuda.py   # with a card

(--noconftest: tests/conftest.py imports jax, which a card machine for the
port need not have.)
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2


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
    assert all(after[k] == before[k] + 1 for k in after)


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
