"""Pure-Python KZG blob-verification oracle over BLS12-381.

Counterpart of ``lighthouse_tpu/crypto/kzg/reference.py``, with the same
behaviour.  It is the ``"python"`` backend of the KZG facade and the oracle
of the card path (``cuda/kernel.py``): every intermediate the card path
produces (Fiat-Shamir challenges, barycentric evaluations, final verdict)
must equal the values computed here.

Blobs are sequences of 32-byte big-endian scalars in the BLS12-381 *scalar*
field Fr (order ``R``), interpreted as a polynomial in evaluation form over
the size-N subgroup of roots of unity (natural order ``w^0 .. w^{N-1}``).
Verification is the standard KZG opening check

    e(C - [y]_1, G2) * e(-pi, [tau - z]_2) == 1

batched across blobs with a Fiat-Shamir random linear combination so the
whole batch costs two pairings.  The pairing leg here runs on the
pure-Python ``pairing_ref`` oracle (exact, host-side); the facade's
``"cuda"`` backend runs it on the card's ``k_pair``.

Determinism: no wall-clock, no global randomness — all "randomness" is
Fiat-Shamir derived through the port's SHA-256 hash engine (one message
stays on hashlib, under the engine's threshold).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..bls.constants import R
from ..bls import curve_ref, pairing_ref
from ..sha256 import api as hash_api

# -- field / domain constants -------------------------------------------------

BYTES_PER_FIELD_ELEMENT = 32

#: Generator of the multiplicative group Fr^* (conventional for BLS12-381).
PRIMITIVE_ROOT = 7

#: Fiat-Shamir domain separators (16 bytes, mirrors the consensus-spec style).
FS_BLOB_DOMAIN = b"LHTPU_KZG_FSBLOB"
FS_BATCH_DOMAIN = b"LHTPU_KZG_FSBATC"

_ROOTS_CACHE: dict = {}


def roots_of_unity(n: int) -> List[int]:
    """The size-``n`` subgroup of Fr in natural order ``w^0 .. w^{n-1}``."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"domain size must be a power of two, got {n}")
    cached = _ROOTS_CACHE.get(n)
    if cached is not None:
        return cached
    w = pow(PRIMITIVE_ROOT, (R - 1) // n, R)
    if n > 1 and pow(w, n // 2, R) == 1:
        raise ValueError(f"no primitive root of order {n}")
    roots = [1] * n
    for i in range(1, n):
        roots[i] = roots[i - 1] * w % R
    _ROOTS_CACHE[n] = roots
    return roots


# -- blob marshalling ---------------------------------------------------------

def blob_to_field_elements(blob: bytes) -> List[int]:
    """Split a blob into canonical Fr scalars; reject non-canonical chunks."""
    if len(blob) % BYTES_PER_FIELD_ELEMENT:
        raise ValueError(f"blob length {len(blob)} not a multiple of 32")
    n = len(blob) // BYTES_PER_FIELD_ELEMENT
    if n == 0 or n & (n - 1):
        raise ValueError(f"blob must hold a power-of-two element count, got {n}")
    out = []
    for i in range(n):
        v = int.from_bytes(blob[32 * i:32 * i + 32], "big")
        if v >= R:
            raise ValueError(f"blob element {i} is not a canonical scalar")
        out.append(v)
    return out


# -- Fiat-Shamir --------------------------------------------------------------

def hash_to_fr(data: bytes) -> int:
    """One engine-routed SHA-256 digest reduced into Fr."""
    digest = hash_api.digest_many([data])[0]
    return int.from_bytes(digest, "big") % R


def compute_challenge(blob: bytes, commitment: bytes) -> int:
    """Per-blob Fiat-Shamir evaluation point ``z``."""
    n = len(blob) // BYTES_PER_FIELD_ELEMENT
    transcript = FS_BLOB_DOMAIN + n.to_bytes(8, "big") + blob + commitment
    return hash_to_fr(transcript)


def batch_rlc_powers(commitments: Sequence[bytes],
                     zs: Sequence[int],
                     ys: Sequence[int],
                     proofs: Sequence[bytes]) -> List[int]:
    """Powers ``rho^0 .. rho^{k-1}`` of the batch linear-combination scalar,
    bound to every commitment/challenge/evaluation/proof in the batch."""
    parts = [FS_BATCH_DOMAIN, len(commitments).to_bytes(8, "big")]
    for c, z, y, pi in zip(commitments, zs, ys, proofs):
        parts.append(bytes(c))
        parts.append(z.to_bytes(32, "big"))
        parts.append(y.to_bytes(32, "big"))
        parts.append(bytes(pi))
    rho = hash_to_fr(b"".join(parts))
    powers = [1] * len(commitments)
    for i in range(1, len(commitments)):
        powers[i] = powers[i - 1] * rho % R
    return powers


# -- polynomial evaluation ----------------------------------------------------

def evaluate_polynomial(evals: Sequence[int], z: int) -> int:
    """Barycentric evaluation of a polynomial given in evaluation form.

    ``p(z) = (z^N - 1)/N * sum_i evals[i] * w_i / (z - w_i)`` with the exact
    domain-point guard ``p(w_i) = evals[i]``.
    """
    n = len(evals)
    roots = roots_of_unity(n)
    z %= R
    for i, w in enumerate(roots):
        if z == w:
            return evals[i] % R
    total = 0
    for fi, w in zip(evals, roots):
        total = (total + fi * w % R * pow(z - w, R - 2, R)) % R
    zn = pow(z, n, R)
    return total * (zn - 1) % R * pow(n, R - 2, R) % R


# -- point parsing ------------------------------------------------------------

def parse_g1(data: bytes) -> Optional[curve_ref.Point]:
    """Decompress a 48-byte G1 point; ``None`` on invalid encoding."""
    try:
        return curve_ref.g1_decompress(bytes(data))
    except Exception:  # noqa: BLE001 — any malformed encoding is a verdict, not a crash
        return None


# -- verification -------------------------------------------------------------

def _batch_pairing_inputs(commitment_pts: Sequence[curve_ref.Point],
                          zs: Sequence[int],
                          ys: Sequence[int],
                          proof_pts: Sequence[curve_ref.Point],
                          rlc: Sequence[int],
                          ) -> Tuple[curve_ref.Point, curve_ref.Point]:
    """Fold the batch into the two G1 legs of the 2-pairing check.

    Returns ``(lhs, proof_acc)`` with the verdict being

        e(lhs, G2) * e(-proof_acc, [tau]_2) == 1

    where ``lhs = sum rho^i * (C_i - [y_i]_1 + z_i * pi_i)`` and
    ``proof_acc = sum rho^i * pi_i``.
    """
    g1 = curve_ref.g1_generator()
    lhs = curve_ref.g1_infinity()
    proof_acc = curve_ref.g1_infinity()
    for c, z, y, pi, rho in zip(commitment_pts, zs, ys, proof_pts, rlc):
        term = c + (-(g1.mul(y))) + pi.mul(z)
        lhs = lhs + term.mul(rho)
        proof_acc = proof_acc + pi.mul(rho)
    return lhs, proof_acc


def batch_pairing_verdict(commitment_pts: Sequence[curve_ref.Point],
                          zs: Sequence[int],
                          ys: Sequence[int],
                          proof_pts: Sequence[curve_ref.Point],
                          rlc: Sequence[int],
                          tau_g2: curve_ref.Point) -> bool:
    """Host (pure-Python) 2-pairing batch check — shared by both engine hops."""
    lhs, proof_acc = _batch_pairing_inputs(commitment_pts, zs, ys, proof_pts, rlc)
    g2 = curve_ref.g2_generator()
    return pairing_ref.multi_pairing_is_one([(lhs, g2), (-proof_acc, tau_g2)])


def verify_blob_kzg_proof_batch(blobs: Sequence[bytes],
                                commitments: Sequence[bytes],
                                proofs: Sequence[bytes],
                                tau_g2: curve_ref.Point) -> bool:
    """Full pure-Python batch verification (the oracle / terminal hop).

    Malformed inputs (bad lengths, non-canonical scalars, invalid point
    encodings) yield a ``False`` verdict rather than an exception.
    """
    if not (len(blobs) == len(commitments) == len(proofs)):
        return False
    if not blobs:
        return True
    try:
        polys = [blob_to_field_elements(bytes(b)) for b in blobs]
    except ValueError:
        return False
    commitment_pts = [parse_g1(c) for c in commitments]
    proof_pts = [parse_g1(p) for p in proofs]
    if any(p is None for p in commitment_pts) or any(p is None for p in proof_pts):
        return False
    zs = [compute_challenge(bytes(b), bytes(c)) for b, c in zip(blobs, commitments)]
    ys = [evaluate_polynomial(poly, z) for poly, z in zip(polys, zs)]
    rlc = batch_rlc_powers([bytes(c) for c in commitments], zs, ys,
                           [bytes(p) for p in proofs])
    return batch_pairing_verdict(commitment_pts, zs, ys, proof_pts, rlc, tau_g2)
