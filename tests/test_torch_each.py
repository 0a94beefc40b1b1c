"""Per-set verification in the port (k_each's plain version, through
CudaBackend._verify_many and verify on device="cpu") against the JAX
package's "python" backend, set by set: a valid set, a wrong message and a
signature of another key; infinity keys and signatures fail.  Inputs come
from a numpy seed; verdicts compare exactly."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls.hash_to_curve_ref import hash_to_g2
from lighthouse_tpu_torch.crypto.bls.cuda import staged
from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend

RNG = np.random.default_rng(0xEAC4)


@pytest.fixture(scope="module")
def port():
    return CudaBackend(name="cuda-each-cpu", device="cpu")


@pytest.fixture(scope="module")
def cases():
    """(pubkey bytes, message, signature bytes) x 3, signed with numpy-drawn
    keys: valid, wrong message, another key's signature."""
    sks = [int(k) for k in RNG.integers(1, 2**62, size=2)]
    msgs = [bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in range(2)]
    pk = jbls.SecretKey(sks[0]).public_key().to_bytes()
    sig0 = jbls.SecretKey(sks[0]).sign(msgs[0]).to_bytes()
    sig1 = jbls.SecretKey(sks[1]).sign(msgs[0]).to_bytes()
    return [(pk, msgs[0], sig0), (pk, msgs[1], sig0), (pk, msgs[0], sig1)]


def test_verify_many_matches_python_backend(port, cases):
    want = [jbls.PythonBackend().verify(
        jbls.PublicKey.from_bytes(pk), m, jbls.Signature.from_bytes(s))
        for pk, m, s in cases]
    assert want == [True, False, False]
    got = port._verify_many(
        [bls.PublicKey.from_bytes(pk).point for pk, _, _ in cases],
        [m for _, m, _ in cases],
        [bls.Signature.from_bytes(s).point for _, _, s in cases])
    assert got == want


def test_k_each_masks_infinity(port, cases):
    """An infinity key with an infinity signature and H (both pairs of the
    lane neutral, the product 1), and a valid key and H with an infinity
    signature, fail: the per-lane mask, not the pairing, decides."""
    pk, m, s = cases[0]
    xp, yp, pi = port._g1([cv.g1_infinity(),
                           bls.PublicKey.from_bytes(pk).point])
    xs, ys, si = port._g2([cv.g2_infinity()] * 2)
    hx, hy, hinf = port._g2([cv.g2_infinity(), hash_to_g2(m)])
    assert staged.k_each(xp, yp, pi, xs, ys, si, hx, hy,
                         hinf).tolist() == [False, False]
    assert staged.k_each(*(t[:0] for t in (xp, yp, pi, xs, ys, si, hx, hy,
                                           hinf))).tolist() == []


def test_signature_verify_goes_through_k_each(port, cases, monkeypatch):
    seen = []
    real = staged.k_each

    def spy(*args):
        seen.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(staged, "k_each", spy)
    monkeypatch.setattr(api, "_ACTIVE", port)
    pk, m, s = cases[0]
    assert bls.Signature.from_bytes(s).verify(
        bls.PublicKey.from_bytes(pk), m) is True
    assert seen == [1]
