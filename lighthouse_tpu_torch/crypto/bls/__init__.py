"""BLS12-381 for the PyTorch/CUDA port: the public surface of
``lighthouse_tpu.crypto.bls``, verified on the card by the CUDA kernels of
``.cuda.staged``."""
from .api import (
    AggregatePublicKey,
    AggregateSignature,
    BackendFault,
    BlsError,
    INFINITY_PUBLIC_KEY,
    INFINITY_SIGNATURE,
    Keypair,
    LazySignature,
    PUBLIC_KEY_BYTES_LEN,
    PublicKey,
    SECRET_KEY_BYTES_LEN,
    SIGNATURE_BYTES_LEN,
    SecretKey,
    Signature,
    SignatureSet,
    get_backend,
    register_backend,
    set_backend,
    verify_signature_sets,
    verify_signature_sets_async,
)
from .constants import DST
from .cuda.backend import CudaBackend, VerifyFuture

__all__ = [
    "AggregatePublicKey", "AggregateSignature", "BackendFault", "BlsError", "CudaBackend",
    "DST", "INFINITY_PUBLIC_KEY", "INFINITY_SIGNATURE", "Keypair",
    "LazySignature", "PUBLIC_KEY_BYTES_LEN", "PublicKey",
    "SECRET_KEY_BYTES_LEN", "SIGNATURE_BYTES_LEN", "SecretKey", "Signature",
    "SignatureSet", "VerifyFuture", "get_backend", "register_backend",
    "set_backend", "verify_signature_sets", "verify_signature_sets_async",
]
