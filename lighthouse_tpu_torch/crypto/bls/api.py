"""Public BLS API of the PyTorch/CUDA port: the counterpart of
``lighthouse_tpu/crypto/bls/api.py`` with the same names and byte formats
(48-byte G1 public keys, 96-byte G2 signatures, ZCash compression).

Keys and signatures are decompressed and subgroup-checked on the host when
they are deserialized (``from_bytes``), as in the JAX package, except a
``LazySignature``: it keeps the 96 wire bytes, and the backend decodes and
checks a batch of them on the card (``k_decode``).  Verification runs on
the registered backend, by default ``"cuda"`` (``CudaBackend`` on the card).
There is no supervisor and no fallback: a backend that cannot run raises.
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional, Sequence

from . import curve_ref as cv
from .constants import R
from .curve_ref import Point
from .hash_to_curve_ref import hash_to_g2

PUBLIC_KEY_BYTES_LEN = 48
SIGNATURE_BYTES_LEN = 96
SECRET_KEY_BYTES_LEN = 32

INFINITY_PUBLIC_KEY = bytes([0xC0]) + b"\x00" * 47
INFINITY_SIGNATURE = bytes([0xC0]) + b"\x00" * 95


class BlsError(Exception):
    pass


class BackendFault(RuntimeError):
    """A device fault the mesh ladder could not absorb: the mesh step and
    its single-device retry both failed (``site`` names the step, ``cause``
    is the retry's exception).  The reference raises it for its supervisor
    (crypto/bls/supervisor.py); the port has no supervisor, so the caller
    sees it."""

    def __init__(self, site: str, cause: BaseException):
        super().__init__(f"{site}: {cause!r}")
        self.site = site
        self.cause = cause


class PublicKey:
    """A decompressed, subgroup-checked G1 public key."""
    __slots__ = ("point", "_bytes")

    def __init__(self, point: Point, raw: Optional[bytes] = None):
        self.point = point
        self._bytes = raw

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        pt = cv.g1_decompress(data)
        if pt is None or pt.is_infinity():
            raise BlsError(f"invalid public key: {data.hex()}")
        return cls(pt, bytes(data))

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = cv.g1_compress(self.point)
        return self._bytes

    def __eq__(self, o):
        if not isinstance(o, PublicKey):
            return NotImplemented
        return self.to_bytes() == o.to_bytes()

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"PublicKey(0x{self.to_bytes().hex()})"


class Signature:
    """A G2 signature, decompressed and subgroup-checked by ``from_bytes``."""
    __slots__ = ("point", "_bytes")

    def __init__(self, point: Optional[Point], raw: Optional[bytes] = None):
        self.point = point
        self._bytes = raw

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        pt = cv.g2_decompress(data)
        if pt is None:
            raise BlsError(f"invalid signature: {data.hex()}")
        return cls(pt, bytes(data))

    @classmethod
    def infinity(cls) -> "Signature":
        return cls(cv.g2_infinity(), INFINITY_SIGNATURE)

    def is_infinity(self) -> bool:
        return self.point is not None and self.point.is_infinity()

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = cv.g2_compress(self.point)
        return self._bytes

    def verify(self, pubkey: PublicKey, msg: bytes) -> bool:
        return get_backend().verify(pubkey, msg, self)

    def __eq__(self, o):
        if not isinstance(o, Signature):
            return NotImplemented
        return self.to_bytes() == o.to_bytes()

    def __repr__(self):
        return f"Signature(0x{self.to_bytes().hex()})"


class LazySignature(Signature):
    """Wire signature bytes whose decompression and subgroup check are
    deferred to verification (the reference stores signature bytes raw and
    validates them at verify time).  ``CudaBackend`` decodes a batch of
    them on the card (``k_decode``) without touching ``.point``; reading
    ``.point`` decodes on the host and raises ``BlsError`` on bad bytes,
    as ``Signature.from_bytes`` does."""

    __slots__ = ("_point",)

    def __init__(self, raw: bytes):
        if len(raw) != SIGNATURE_BYTES_LEN:
            raise BlsError(f"invalid signature length {len(raw)}")
        self._point = None
        self._bytes = bytes(raw)

    @property
    def point(self):
        if self._point is None:
            pt = cv.g2_decompress(self._bytes)
            if pt is None:
                raise BlsError(f"invalid signature: {self._bytes.hex()}")
            self._point = pt
        return self._point

    def decoded(self) -> bool:
        return self._point is not None

    def infinity_flagged(self) -> bool:
        return bool(self._bytes[0] & 0x40)


class AggregateSignature(Signature):
    @classmethod
    def from_signatures(cls, sigs: Sequence[Signature]) -> "AggregateSignature":
        acc = cv.g2_infinity()
        for s in sigs:
            acc = acc + s.point
        return cls(acc)

    def add_assign(self, sig: Signature) -> None:
        self.point = self.point + sig.point
        self._bytes = None

    def fast_aggregate_verify(self, msg: bytes,
                              pubkeys: Sequence[PublicKey]) -> bool:
        return get_backend().fast_aggregate_verify(self, msg, pubkeys)

    def aggregate_verify(self, msgs: Sequence[bytes],
                         pubkeys: Sequence[PublicKey]) -> bool:
        return get_backend().aggregate_verify(self, msgs, pubkeys)


class AggregatePublicKey:
    __slots__ = ("point",)

    def __init__(self, point: Point):
        self.point = point

    @classmethod
    def aggregate(cls, pubkeys: Sequence[PublicKey]) -> "AggregatePublicKey":
        acc = cv.g1_infinity()
        for pk in pubkeys:
            acc = acc + pk.point
        return cls(acc)


class SecretKey:
    __slots__ = ("k",)

    def __init__(self, k: int):
        if not 0 < k < R:
            raise BlsError("secret key out of range")
        self.k = k

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != SECRET_KEY_BYTES_LEN:
            raise BlsError("bad secret key length")
        return cls(int.from_bytes(data, "big"))

    @classmethod
    def random(cls) -> "SecretKey":
        return cls(secrets.randbelow(R - 1) + 1)

    def to_bytes(self) -> bytes:
        return self.k.to_bytes(32, "big")

    def public_key(self) -> PublicKey:
        return PublicKey(cv.g1_generator().mul(self.k))

    def sign(self, msg: bytes) -> Signature:
        """One signature on the host (hash_to_curve_ref), as in the JAX
        api; a duty cohort is signed on the card by
        ``sign_engine.sign_batch``, byte for byte the same."""
        return Signature(hash_to_g2(msg).mul(self.k))


@dataclass
class Keypair:
    sk: SecretKey
    pk: PublicKey

    @classmethod
    def random(cls) -> "Keypair":
        sk = SecretKey.random()
        return cls(sk, sk.public_key())


class SignatureSet:
    """Does ``signature`` sign ``message`` under the aggregate of
    ``pubkeys``?"""
    __slots__ = ("signature", "pubkeys", "message")

    def __init__(self, signature: Signature, pubkeys: Sequence[PublicKey],
                 message: bytes):
        if not pubkeys:
            raise BlsError("signature set with no pubkeys")
        self.signature = signature
        self.pubkeys = list(pubkeys)
        self.message = bytes(message)

    @classmethod
    def single_pubkey(cls, signature, pubkey, message):
        return cls(signature, [pubkey], message)

    @classmethod
    def multiple_pubkeys(cls, signature, pubkeys, message):
        return cls(signature, pubkeys, message)

    def verify(self) -> bool:
        return verify_signature_sets([self])


def verify_signature_sets(sets: Sequence[SignatureSet]) -> bool:
    """Batch verification with 64-bit random weights:
    prod_i e([r_i] P_i, H(m_i)) * e(-g1, sum_i [r_i] sig_i) == 1."""
    return get_backend().verify_signature_sets(sets)


def verify_signature_sets_async(sets: Sequence[SignatureSet]):
    """Dispatch now, verdict at ``.result()`` (a ``VerifyFuture``)."""
    return get_backend().verify_signature_sets_async(sets)


# --- Backend registry -----------------------------------------------------------

_BACKENDS: dict = {}
_ACTIVE = None


def register_backend(backend) -> None:
    _BACKENDS[backend.name] = backend


def _resolve_backend(name: str):
    if name not in _BACKENDS:
        if name != "cuda":
            raise BlsError(f"unknown BLS backend {name!r}")
        from .cuda.backend import CudaBackend

        register_backend(CudaBackend())   # raises without a CUDA device
    return _BACKENDS[name]


def set_backend(name: str):
    global _ACTIVE
    _ACTIVE = _resolve_backend(name)
    return _ACTIVE


def get_backend():
    if _ACTIVE is None:
        set_backend("cuda")
    return _ACTIVE
