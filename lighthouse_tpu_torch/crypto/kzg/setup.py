"""Trusted setup of the port's KZG path.

Counterpart of ``lighthouse_tpu/crypto/kzg/setup.py``.

Verification only needs ``[tau]_2`` (one G2 point); commitment/proof
*generation* — used by tests, the bench, and the adversarial simulator —
additionally needs the setup secret ``tau`` itself.  Production ceremonies
never reveal ``tau``, so the embedded dev setup (deterministically derived,
secret known) is explicitly a development artifact: the loader refuses to
generate proofs from a setup that carries no dev secret.

A setup file is JSON:

    {"g2_monomial_1": "<96-byte hex of [tau]_2>", "dev_tau": "<hex, optional>"}

Unlike the reference, the port reads no environment variable: a setup
file is loaded only from the path passed to ``load_trusted_setup``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Optional

from ..bls.constants import R
from ..bls import curve_ref
from . import reference

_DEV_SEED = b"lighthouse-tpu kzg dev trusted setup v1"


@dataclass(frozen=True)
class TrustedSetup:
    """Minimal KZG setup: ``[tau]_2`` plus (dev only) the secret itself."""
    g2_monomial_1: bytes            # compressed 96-byte [tau]_2
    dev_tau: Optional[int] = None   # known only for the embedded dev setup

    def tau_g2(self) -> curve_ref.Point:
        return curve_ref.g2_decompress(self.g2_monomial_1)

    def require_dev_tau(self) -> int:
        if self.dev_tau is None:
            raise ValueError(
                "setup has no dev secret: commitment/proof generation needs "
                "the embedded dev setup (production setups can only verify)")
        return self.dev_tau


def dev_setup() -> TrustedSetup:
    """The embedded development setup (deterministic, secret known)."""
    tau = int.from_bytes(hashlib.sha256(_DEV_SEED).digest(), "big") % R
    tau_g2 = curve_ref.g2_generator().mul(tau)
    return TrustedSetup(g2_monomial_1=curve_ref.g2_compress(tau_g2), dev_tau=tau)


def load_trusted_setup(path: Optional[str] = None) -> TrustedSetup:
    """Load the setup file at ``path``; without one, the embedded dev
    setup."""
    if not path:
        return dev_setup()
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    g2_hex = doc["g2_monomial_1"]
    g2_bytes = bytes.fromhex(g2_hex[2:] if g2_hex.startswith("0x") else g2_hex)
    if len(g2_bytes) != 96:
        raise ValueError(f"g2_monomial_1 must be 96 bytes, got {len(g2_bytes)}")
    curve_ref.g2_decompress(g2_bytes)  # validate eagerly
    dev_tau = None
    if "dev_tau" in doc and doc["dev_tau"] is not None:
        raw = doc["dev_tau"]
        dev_tau = int(raw, 16) if isinstance(raw, str) else int(raw)
        dev_tau %= R
    return TrustedSetup(g2_monomial_1=g2_bytes, dev_tau=dev_tau)


def dump_trusted_setup(setup: TrustedSetup, path: str) -> None:
    doc = {"g2_monomial_1": "0x" + setup.g2_monomial_1.hex()}
    if setup.dev_tau is not None:
        doc["dev_tau"] = hex(setup.dev_tau)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


# -- dev-side commitment / proof generation -----------------------------------

def blob_to_commitment(blob: bytes, setup: TrustedSetup) -> bytes:
    """Commit to a blob: ``C = [p(tau)]_1`` via the known dev secret."""
    tau = setup.require_dev_tau()
    evals = reference.blob_to_field_elements(bytes(blob))
    p_tau = reference.evaluate_polynomial(evals, tau)
    return curve_ref.g1_compress(curve_ref.g1_generator().mul(p_tau))


def compute_blob_proof(blob: bytes, commitment: bytes,
                       setup: TrustedSetup) -> bytes:
    """Opening proof at the blob's Fiat-Shamir challenge point.

    ``pi = [(p(tau) - y) / (tau - z)]_1`` with ``z`` the challenge and
    ``y = p(z)``.
    """
    tau = setup.require_dev_tau()
    blob = bytes(blob)
    evals = reference.blob_to_field_elements(blob)
    z = reference.compute_challenge(blob, bytes(commitment))
    y = reference.evaluate_polynomial(evals, z)
    p_tau = reference.evaluate_polynomial(evals, tau)
    if tau == z:  # degenerate: challenge hit the secret (never in practice)
        raise ValueError("challenge equals the setup secret")
    q = (p_tau - y) % R * pow((tau - z) % R, R - 2, R) % R
    return curve_ref.g1_compress(curve_ref.g1_generator().mul(q))


def make_blob(n_elements: int, seed: bytes) -> bytes:
    """Deterministic canonical blob for tests/sim: each element is a
    seed-derived SHA-256 output reduced into Fr."""
    out = bytearray()
    for i in range(n_elements):
        v = int.from_bytes(
            hashlib.sha256(seed + i.to_bytes(8, "big")).digest(), "big") % R
        out += v.to_bytes(32, "big")
    return bytes(out)
