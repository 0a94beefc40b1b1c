"""The slice as a whole: the port's verify_signature_sets (CudaBackend on
device="cpu", the kernels' plain versions) against the JAX package's
verify_signature_sets on its "python" backend, on the same keys, messages
and signatures: a 4-key multi set beside a single set, and the fail-closed
edges; the padding lanes the backend appends; the wire path (signatures
as undecoded LazySignature bytes, decoded by k_decode's plain version) and
its routing; and the 4-key fast_aggregate_verify vector of
tests/vectors/bls.json (whose outcome tests/test_conformance.py holds the
"python" backend to).  A valid single-key batch and a tampered one are the
batch_verify vectors (test_torch_vectors.py); the slow tier adds own-key
single-key batches, valid and with two signatures swapped."""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu.crypto.bls.constants import R
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls.cuda import staged
from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend
from tests.test_torch_wire_vectors import non_subgroup_signature

RNG = np.random.default_rng(0x5E75)


@pytest.fixture(scope="module")
def port():
    be = CudaBackend(name="cuda-cpu", device="cpu")
    bls.register_backend(be)
    bls.set_backend("cuda-cpu")
    return be


def keypairs(n):
    sks = [int(x) for x in RNG.integers(1, 2**62, size=n)]
    return [(jbls.SecretKey(k), bls.SecretKey(k)) for k in sks]


def both_sets(specs):
    """specs: [(list of (jax_sk, port_sk), msg)] -> (jax sets, port sets);
    the signature is the aggregate of the keys' signatures on msg, signed
    once with the sum of the secret keys (the same point), bytes shared."""
    jsets, psets = [], []
    for keys, msg in specs:
        total = sum(jk.k for jk, _ in keys) % R
        raw = jbls.SecretKey(total).sign(msg).to_bytes()
        jsets.append(jbls.SignatureSet(
            jbls.Signature.from_bytes(raw),
            [jbls.PublicKey.from_bytes(jk.public_key().to_bytes())
             for jk, _ in keys], msg))
        psets.append(bls.SignatureSet(
            bls.Signature.from_bytes(raw),
            [bls.PublicKey.from_bytes(pk.public_key().to_bytes())
             for _, pk in keys], msg))
    return jsets, psets


def jax_verdict(sets):
    prev = jbls.get_backend().name
    jbls.set_backend("python")
    try:
        return jbls.verify_signature_sets(sets)
    finally:
        jbls.set_backend(prev)


@pytest.fixture(scope="module")
def single_sets():
    kps = keypairs(3)
    msgs = [bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in kps]
    return both_sets([([kp], m) for kp, m in zip(kps, msgs)])


@pytest.mark.slow
def test_valid_single_key_batch(port, single_sets):
    jsets, psets = single_sets
    assert jax_verdict(jsets) is True
    assert bls.verify_signature_sets(psets) is True


@pytest.mark.slow
def test_swapped_signatures_fail(port, single_sets):
    jsets, psets = single_sets

    def swap(sets, cls):
        out = list(sets)
        out[0] = cls(sets[1].signature, sets[0].pubkeys, sets[0].message)
        out[1] = cls(sets[0].signature, sets[1].pubkeys, sets[1].message)
        return out

    assert jax_verdict(swap(jsets, jbls.SignatureSet)) is False
    fut = bls.verify_signature_sets_async(swap(psets, bls.SignatureSet))
    assert fut.result() is False and fut.result() is False


def test_multi_key_set_beside_single_sets(port):
    kps = keypairs(5)
    m0, m1 = (bytes(RNG.integers(0, 256, 32, dtype=np.uint8))
              for _ in range(2))
    jsets, psets = both_sets([(kps[:4], m0), ([kps[4]], m1)])
    assert jax_verdict(jsets) is True
    assert bls.verify_signature_sets(psets) is True


def test_dispatch_pads_with_infinity_and_zero_weights(port, monkeypatch):
    """With m > n lanes the backend appends infinity keys and signatures,
    zero weights and, for multi-key sets, empty key rows; the kernels'
    plain versions give such lanes the neutral pair (test_torch_curve,
    test_torch_pairing)."""
    seen = {}

    def grab(name):
        def pipeline(*args):
            seen[name] = args
            return torch.ones(1, dtype=torch.bool)
        return pipeline

    monkeypatch.setattr(staged, "verify_batch_staged_roots", grab("single"))
    monkeypatch.setattr(staged, "verify_batch_multi_staged", grab("multi"))
    sk, sk2 = bls.SecretKey(7), bls.SecretKey(8)
    m = bytes(32)
    sig = sk.sign(m)
    port._dispatch_single([sk.public_key()], [sig.point], [m], m=3)
    _, _, pi, _, _, si, words, rand = seen["single"]
    assert pi.tolist() == [False, True, True]
    assert si.tolist() == [False, True, True]
    assert tuple(words.shape) == (3, 8)
    assert int(rand[1:].abs().sum()) == 0 and int(rand[0, 0]) & 1 == 1
    multi = bls.SignatureSet(sig, [sk.public_key(), sk2.public_key()], m)
    port._dispatch_multi([multi], 2, m=3)
    _, _, ipk, mask, _, _, si, u, rand = seen["multi"]
    assert mask.tolist() == [[True, True], [False, False], [False, False]]
    assert ipk.tolist() == [[False, False], [True, True], [True, True]]
    assert si.tolist() == [False, True, True]
    assert u.shape[0] == 3
    assert int(rand[1:].abs().sum()) == 0 and int(rand[0, 0]) & 1 == 1


def test_fast_aggregate_verify_vector(port):
    with open(os.path.join(os.path.dirname(__file__), "vectors",
                           "bls.json")) as f:
        fav = json.load(f)["fast_aggregate_verify"]
    raw_sig = bytes.fromhex(fav["aggregate"])
    msg = bytes.fromhex(fav["message"])
    raw_pks = [bytes.fromhex(h) for h in fav["pubkeys"]]
    agg = bls.AggregateSignature.from_bytes(raw_sig)
    got = agg.fast_aggregate_verify(
        msg, [bls.PublicKey.from_bytes(b) for b in raw_pks])
    assert got is fav["valid"]


def test_edge_cases_fail_closed(port):
    sk = bls.SecretKey(99)
    m = bytes(32)
    psets = [bls.SignatureSet(sk.sign(m), [sk.public_key()], m)] * 2
    assert bls.verify_signature_sets([]) is False
    inf = bls.SignatureSet(bls.Signature.infinity(), psets[0].pubkeys,
                           psets[0].message)
    assert bls.verify_signature_sets([inf, psets[1]]) is False
    assert port.fast_aggregate_verify(psets[0].signature, psets[0].message,
                                      []) is False
    assert port.aggregate_verify(bls.Signature.infinity(), [b"x"],
                                 psets[0].pubkeys) is False
    with pytest.raises(bls.BlsError):
        bls.SignatureSet(psets[0].signature, [], psets[0].message)
    with pytest.raises(bls.BlsError):
        bls.PublicKey.from_bytes(bls.INFINITY_PUBLIC_KEY)


def _lazy(sets, mod=bls):
    """The sets with their signatures as undecoded wire bytes (``mod``: the
    port's or the JAX package's api)."""
    return [mod.SignatureSet(mod.LazySignature(s.signature.to_bytes()),
                             s.pubkeys, s.message) for s in sets]


@pytest.fixture(scope="module")
def wire_sets():
    kps = keypairs(2)
    msgs = [bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in kps]
    return both_sets([([kp], m) for kp, m in zip(kps, msgs)])


def test_wire_path_verifies_lazy_sets(port, wire_sets):
    """Undecoded wire signatures: True for valid sets, False with the
    non-subgroup signature of bls_adversarial.json, as the JAX package's
    "python" backend says, and no signature is decoded on the host."""
    jsets, psets = _lazy(wire_sets[0], jbls), _lazy(wire_sets[1])
    assert jax_verdict(jsets) is True
    assert bls.verify_signature_sets(psets) is True
    bad_raw = non_subgroup_signature()
    jbad = list(jsets)
    jbad[1] = jbls.SignatureSet(jbls.LazySignature(bad_raw),
                                jbad[1].pubkeys, jbad[1].message)
    pbad = list(psets)
    pbad[1] = bls.SignatureSet(bls.LazySignature(bad_raw), pbad[1].pubkeys,
                               pbad[1].message)
    assert jax_verdict(jbad) is False
    assert bls.verify_signature_sets(pbad) is False
    assert not any(s.signature.decoded() for s in psets + pbad)


def test_wire_routes(port, wire_sets, monkeypatch):
    """Which pipeline a batch takes, with the pipelines stubbed: all lazy
    roots take the wire path without decoding; an infinity flag or
    malformed bytes are False before any kernel; a mixed batch, or lazy
    signatures over messages that are not roots, decode on the host."""
    calls = []

    def grab(name):
        def pipeline(*args):
            calls.append((name, args))
            return torch.ones(1, dtype=torch.bool)
        return pipeline

    for name in ("verify_batch_wire_roots", "verify_batch_staged_roots",
                 "verify_batch_staged"):
        monkeypatch.setattr(staged, name, grab(name))
    _, psets = wire_sets
    lazy = _lazy(psets)
    assert bls.verify_signature_sets(lazy) is True
    (name, args), = calls
    assert name == "verify_batch_wire_roots"
    x, sign, inf = args[3:6]
    assert tuple(x.shape) == (2, 2, 12) and inf.tolist() == [False, False]
    assert not any(s.signature.decoded() for s in lazy)

    calls.clear()
    flagged = bls.SignatureSet(bls.LazySignature(bls.INFINITY_SIGNATURE),
                               lazy[0].pubkeys, lazy[0].message)
    assert bls.verify_signature_sets([lazy[1], flagged]) is False
    malformed = bls.SignatureSet(bls.LazySignature(bytes(96)),
                                 lazy[0].pubkeys, lazy[0].message)
    assert bls.verify_signature_sets([lazy[1], malformed]) is False
    assert calls == []

    mixed = [_lazy(psets)[0], psets[1]]
    assert bls.verify_signature_sets(mixed) is True
    assert calls[-1][0] == "verify_batch_staged_roots"
    assert mixed[0].signature.decoded()
    odd = [bls.SignatureSet(bls.LazySignature(s.signature.to_bytes()),
                            s.pubkeys, s.message + b"!") for s in psets]
    assert bls.verify_signature_sets(odd) is True
    assert calls[-1][0] == "verify_batch_staged"
    assert all(s.signature.decoded() for s in odd)
