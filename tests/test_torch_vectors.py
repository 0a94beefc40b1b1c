"""The port against the repo's BLS vectors on the CPU (CudaBackend on
device="cpu"): the batch_verify cases of tests/vectors/bls.json (a valid
batch of four single-key sets and a tampered batch of two) give the
vectors' outcome, which tests/test_conformance.py holds the JAX package's
"python" backend to;
signing and key derivation (host code) match the vectors.  The slow tier
replays aggregate_verify and every case of bls_adversarial.json (each
verify of the plain versions costs seconds on one core).
fast_aggregate_verify is in test_torch_verify.py."""
import json
import os

import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend

VEC = os.path.join(os.path.dirname(__file__), "vectors")
with open(os.path.join(VEC, "bls.json")) as f:
    DOC = json.load(f)
with open(os.path.join(VEC, "bls_adversarial.json")) as f:
    ADV = {c["name"]: c for c in json.load(f)["cases"]}


@pytest.fixture(scope="module")
def port():
    be = CudaBackend(name="cuda-cpu", device="cpu")
    bls.register_backend(be)
    bls.set_backend("cuda-cpu")
    return be


def sets_of(raw):
    return [bls.SignatureSet(
        bls.Signature.from_bytes(bytes.fromhex(s["signature"])),
        [bls.PublicKey.from_bytes(bytes.fromhex(h)) for h in s["pubkeys"]],
        bytes.fromhex(s["message"])) for s in raw]


@pytest.mark.parametrize("idx", range(len(DOC["batch_verify"])))
def test_bls_json_batch_verify(port, idx):
    case = DOC["batch_verify"][idx]
    assert bls.verify_signature_sets(sets_of(case["sets"])) is case["valid"]


def test_bls_json_sign_and_keys():
    for s in DOC["sign"]:
        sk = bls.SecretKey.from_bytes(bytes.fromhex(s["sk"]))
        assert sk.public_key().to_bytes().hex() == s["pubkey"]
        assert sk.sign(bytes.fromhex(s["message"])).to_bytes().hex() == \
            s["signature"]


@pytest.mark.slow
def test_bls_json_aggregate_verify(port):
    av = DOC["aggregate_verify"]
    agg = bls.AggregateSignature.from_bytes(bytes.fromhex(av["aggregate"]))
    pks = [bls.PublicKey.from_bytes(bytes.fromhex(h)) for h in av["pubkeys"]]
    assert agg.aggregate_verify([bytes.fromhex(m) for m in av["messages"]],
                                pks) is av["valid"]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(ADV))
def test_bls_adversarial(port, name):
    """Outcomes as tests/test_bls_adversarial.py reads them: BlsError at
    deserialization for invalid_pubkey / invalid_signature."""
    case = ADV[name]
    expect = case["expect"]
    try:
        sets = sets_of(case["sets"])
    except bls.BlsError as e:
        kind = "invalid_pubkey" if "public key" in str(e) else \
            "invalid_signature"
        assert expect == kind, name
        return
    assert expect not in ("invalid_pubkey", "invalid_signature"), name
    assert bls.verify_signature_sets(sets) is (expect == "valid"), name
