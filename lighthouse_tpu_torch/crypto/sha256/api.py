"""Hash-engine facade of the PyTorch/CUDA port: backend choice, the size
threshold, the device, and counts of what answered.

Counterpart of ``lighthouse_tpu/crypto/sha256/api.py``, with the same
calls and return types:

  * ``configure(backend=..., threshold=..., device=...)``: backend
    ``"cuda"`` (the default: the kernels of ``cuda/kernel.py``) or
    ``"hashlib"``.  Levels and batches under ``threshold`` pairs
    (``DEFAULT_THRESHOLD`` = 1024) stay on hashlib by design, as in the
    reference: a launch and its copies cost more than a narrow level is
    worth.  SSZ calls cannot pass a device, so ``device`` is chosen here:
    ``"cuda"`` (the default) runs the kernels, ``"cpu"`` their plain
    versions (tests).
  * ``engine_status()`` counts digests by answering backend, the widest
    call each backend answered, the kernels' launches and the bytes copied
    to the card and back.
  * ``reduce_levels`` keeps consecutive wide levels on the card and fills
    the caller's ``stats`` with one ``{"pairs", "backend", "ms"}`` row a
    level.

Deliberate differences from the reference: the default backend is
``"cuda"`` (the reference's ``"auto"`` resolves to its native C++ hasher
or hashlib); there is no native hasher, no degradation chain, no breaker
and no fault-injection site.  A kernel fault, or a ``"cuda"`` call without
a card, raises, as the port's verify and sign paths do.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

from .backends import CudaBackend, HashlibBackend
from .cuda import kernel

DEFAULT_THRESHOLD = 1024
BACKENDS = ("cuda", "hashlib")

_LOCK = threading.Lock()
_BACKENDS = {"cuda": CudaBackend(), "hashlib": HashlibBackend()}
_STATE = {"requested": "cuda", "threshold": DEFAULT_THRESHOLD}
_DIGESTS = {name: 0 for name in BACKENDS}
_WIDEST = {name: 0 for name in BACKENDS}   # the widest call each answered


def set_hash_backend(name: str) -> None:
    """Select the engine backend: cuda | hashlib."""
    if name not in BACKENDS:
        raise ValueError(f"unknown hash backend {name!r}")
    with _LOCK:
        _STATE["requested"] = name


def batch_threshold() -> int:
    return _STATE["threshold"]


def backend_for(n_pairs: int) -> str:
    """The backend a call of `n_pairs` pairs (or messages) routes to."""
    with _LOCK:
        wide = n_pairs >= _STATE["threshold"]
        return "cuda" if _STATE["requested"] == "cuda" and wide else "hashlib"


def configure(backend: Optional[str] = None,
              threshold: Optional[int] = None,
              device=None) -> None:
    if backend is not None:
        set_hash_backend(backend)
    with _LOCK:
        if threshold is not None:
            _STATE["threshold"] = int(threshold)
        if device is not None:
            _BACKENDS["cuda"].device = device


def reset_engine() -> None:
    """Back to the defaults, with the counts cleared (tests)."""
    configure("cuda", DEFAULT_THRESHOLD, "cuda")
    with _LOCK:
        for name in BACKENDS:
            _DIGESTS[name] = _WIDEST[name] = 0
    kernel.reset_launches()
    kernel.reset_transfer()


def engine_status() -> dict:
    with _LOCK:
        return {
            "backend": _STATE["requested"],
            "threshold": _STATE["threshold"],
            "device": str(_BACKENDS["cuda"].device),
            "digests": dict(_DIGESTS),
            "widest": dict(_WIDEST),
            "launches": kernel.launch_counts(),
            "transfer": kernel.transfer_counts(),
        }


def _count(name: str, n: int, width: int) -> None:
    with _LOCK:
        _DIGESTS[name] += n
        _WIDEST[name] = max(_WIDEST[name], width)


def hash_pairs(data) -> bytes:
    """n concatenated 64-byte messages -> n concatenated 32-byte digests,
    routed by size."""
    n = len(data) // 64
    if n == 0:
        return b""
    name = backend_for(n)
    out = _BACKENDS[name].hash_pairs(data)
    _count(name, n, n)
    return out


def digest_many(msgs: Sequence[bytes]) -> List[bytes]:
    """Digests of arbitrary-length messages; wide batches ride the
    lane-parallel kernel, narrow ones stay on hashlib."""
    if not msgs:
        return []
    name = backend_for(len(msgs))
    out = _BACKENDS[name].digest_many(msgs)
    _count(name, len(msgs), len(msgs))
    return out


def reduce_levels(buf, depth: int, zero_hashes, depth_limit: int,
                  stats: Optional[list] = None) -> Tuple[bytes, int]:
    """Card-resident multi-level reduction: when the cuda backend takes a
    level of this width, hash successive levels on the card without host
    round trips, stopping below the threshold (or at `depth_limit`).
    Returns (level bytes, reached depth); the input comes back unchanged
    when the first level is narrow or `depth >= depth_limit`."""
    n_pairs = (len(buf) // 32 + 1) // 2
    if backend_for(n_pairs) != "cuda" or depth >= depth_limit:
        return buf, depth  # unchanged: no copy on the common no-op exit
    out, new_depth = _BACKENDS["cuda"].reduce_levels(
        buf, depth, zero_hashes, depth_limit, _STATE["threshold"], stats)
    hashed = len(buf) // 32 - len(out) // 32
    if hashed > 0:
        _count("cuda", hashed, n_pairs)
    return out, new_depth
