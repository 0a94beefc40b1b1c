"""Sign engine of the PyTorch/CUDA port: a slot's whole duty cohort signed
in one launch on the card, and the aggregate-and-proof sums of many
committees in another.

Counterpart of ``lighthouse_tpu/crypto/bls/sign_engine.py``, byte for byte
in what it returns:

  * ``configure(backend=..., threshold=...)``: backend ``"cuda"`` (the
    default: the kernels of ``.cuda.signer``) or ``"python"`` (host
    ``SecretKey.sign``, per key); cohorts under ``threshold`` duties
    (``DEFAULT_THRESHOLD`` = 4) take the host path, as the reference routes
    them.  ``last_call()["backend"]`` says which path answered.
  * The kernels run on the card unless the caller passes ``device="cpu"``
    (their plain versions, for the tests); a ``"cuda"`` call without a card
    raises.
  * There is no fault hop: where the reference re-signs a failed device
    batch per key on the host, the port raises.  A signature that the wire
    parse or ``k_sign_agg`` rejects makes ``aggregate_batch`` raise
    ``BlsError``, which is what the reference's chain ends in for such
    input (``Signature.from_bytes``).  An on-curve signature outside G2 is
    summed, as the reference's device kernel does (its host path raises).
  * The reference gates its device path off under the ``fake_crypto`` BLS
    backend; the port has no ``fake_crypto`` backend, so no gate.

Per-call record (``last_call()``): backend, n, per-stage seconds (pack:
arena rows, messages and planes to the device; dispatch: the kernel and
the readback of its planes; compress: wire bytes) and the secret-arena
bytes synced to the device (0 on a warm cohort).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import curve_ref as cv
from .api import AggregateSignature, BlsError, Signature
from .cuda import fp, seckey_cache, signer, staged
from .cuda import hash_to_g2 as h2

DEFAULT_THRESHOLD = 4
BACKENDS = ("cuda", "python")

#: (secret key, message bytes, compressed pubkey bytes): the pubkey is the
#: arena identity under which the scalar lives on the card.
SignEntry = Tuple[object, bytes, bytes]

_LOCK = threading.Lock()
_STATE = {"requested": "cuda", "threshold": DEFAULT_THRESHOLD}
_LAST_CALL: dict = {}


def configure(backend: Optional[str] = None,
              threshold: Optional[int] = None) -> None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown sign backend {backend!r}")
    with _LOCK:
        if backend is not None:
            _STATE["requested"] = backend
        if threshold is not None:
            _STATE["threshold"] = int(threshold)


def reset_engine() -> None:
    """Back to the defaults, and no last call (tests)."""
    global _LAST_CALL
    configure("cuda", DEFAULT_THRESHOLD)
    _LAST_CALL = {}


def engine_status() -> dict:
    with _LOCK:
        return dict(_STATE)


def last_call() -> dict:
    return dict(_LAST_CALL)


def backend_for(n: int) -> str:
    """The backend an n-duty cohort routes to."""
    with _LOCK:
        big = n >= _STATE["threshold"]
        return "cuda" if _STATE["requested"] == "cuda" and big else "python"


# --- Host wire assembly ----------------------------------------------------------


def compress_to_wire(x_plain, sign, inf) -> np.ndarray:
    """Compression planes (canonical plain x limbs (n, 2, 12), lex sign,
    infinity) -> (n, 96) uint8 wire rows, byte-identical to
    ``curve_ref.g2_compress``: c1 || c0 big-endian with the 0x80 | 0x20 sign
    flags, or the canonical 0xC0 infinity encoding."""
    if isinstance(x_plain, torch.Tensor):
        x_plain, sign, inf = (t.cpu().numpy() for t in (x_plain, sign, inf))
    x = np.asarray(x_plain)
    if x.dtype == np.int32:                    # the kernels' bit patterns
        x = x.view(np.uint32)
    x = np.ascontiguousarray(x, dtype="<u4")
    s = np.asarray(sign).astype(bool)
    i = np.asarray(inf).astype(bool)
    # 12 little-endian words are the 48 little-endian bytes of the value
    be = x.view(np.uint8).reshape(*x.shape[:-1], 48)[..., ::-1]
    out = np.concatenate([be[..., 1, :], be[..., 0, :]], axis=-1)
    out[..., 0] |= np.where(s, np.uint8(0xA0), np.uint8(0x80))
    out[i] = 0
    out[i, 0] = 0xC0
    return out


def parse_wire_planes(sigs) -> tuple:
    """96-byte compressed signatures -> the planes ``k_sign_agg`` takes:
    x (n, 2, 12) uint32 canonical plain limbs, sign (n,), inf (n,) and ok
    (n,).  A row that fails the flag / range rules of
    ``curve_ref.g2_parse_compressed`` comes back ok = False with an
    infinity placeholder."""
    n = len(sigs)
    vals = [0] * (2 * n)
    sign = np.zeros((n,), bool)
    inf = np.zeros((n,), bool)
    ok = np.zeros((n,), bool)
    for idx, raw in enumerate(sigs):
        parsed = cv.g2_parse_compressed(bytes(raw))
        if parsed is None:
            inf[idx] = True
            continue
        vals[2 * idx], vals[2 * idx + 1], sign[idx], inf[idx] = parsed
        ok[idx] = True
    limbs = fp.ints_to_limbs(vals).reshape(n, 2, fp.N_LIMBS)
    return limbs, sign, inf, ok


# --- Batched signing -------------------------------------------------------------


def _record(backend: str, n: int, stages: dict, sync_bytes: int,
            device=None) -> None:
    global _LAST_CALL
    _LAST_CALL = {"backend": backend, "n": n, "stages": stages,
                  "sync_bytes": sync_bytes,
                  "device": None if device is None else str(device)}


def _sign_batch_cuda(entries: Sequence[SignEntry], dev, stages) -> list:
    """One launch for the 32-byte signing roots (XMD on the card) and one
    for every other length (host hash_to_field), the order kept."""
    out: List[Optional[bytes]] = [None] * len(entries)
    roots = [i for i, e in enumerate(entries) if len(e[1]) == 32]
    other = [i for i, e in enumerate(entries) if len(e[1]) != 32]
    cache = seckey_cache.get_cache()
    for kernel, idx in ((signer.k_sign_root, roots),
                        (signer.k_sign_field, other)):
        if not idx:
            continue
        t0 = time.perf_counter()
        _rows, w = cache.pack_rows_device(
            [(entries[i][2], entries[i][0].k) for i in idx], dev)
        msgs = [entries[i][1] for i in idx]
        if kernel is signer.k_sign_root:
            data = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32))
        else:
            data = staged.to_i32(h2.hash_to_field(msgs))
        data = data.to(dev)
        t1 = time.perf_counter()
        planes = [t.cpu().numpy() for t in kernel(w, data)]
        t2 = time.perf_counter()
        wire = compress_to_wire(*planes)
        for lane, i in enumerate(idx):
            out[i] = bytes(wire[lane])
        t3 = time.perf_counter()
        stages["pack"] += t1 - t0
        stages["dispatch"] += t2 - t1
        stages["compress"] += t3 - t2
    return out


def sign_batch(entries: Sequence[SignEntry], device=None) -> List[bytes]:
    """Sign a duty cohort: (secret key, message, pubkey bytes) entries ->
    96-byte signatures, in order, byte-identical to ``sk.sign(msg)``.  One
    launch per message kind on ``device`` (the card by default), or the
    host path for a small cohort or the ``"python"`` backend."""
    if not entries:
        return []
    n = len(entries)
    if backend_for(n) == "python":
        t0 = time.perf_counter()
        out = [sk.sign(msg).to_bytes() for sk, msg, _pk in entries]
        _record("python", n, {"total": time.perf_counter() - t0}, 0)
        return out
    dev = staged.resolve_device(device, "sign engine")
    cache = seckey_cache.get_cache()
    before = cache.sync_stats()
    stages = {"pack": 0.0, "dispatch": 0.0, "compress": 0.0}
    out = _sign_batch_cuda(entries, dev, stages)
    _record("cuda", n, stages, cache.sync_bytes_since(before), dev)
    return out


# --- Batched aggregation (the aggregate-and-proof sums) ----------------------------


def _aggregate_batch_cuda(groups, dev, stages) -> list:
    t0 = time.perf_counter()
    m, k = len(groups), max(len(g) for g in groups)
    flat = [bytes(s) for g in groups for s in g]
    limbs, sgn, inf, ok = parse_wire_planes(flat)
    if not ok.all():
        raise BlsError("aggregate batch: invalid signature encoding")
    x = np.zeros((m, k, 2, fp.N_LIMBS), np.uint32)
    s = np.zeros((m, k), bool)
    i = np.zeros((m, k), bool)
    mask = np.zeros((m, k), bool)
    pos = 0
    for row, g in enumerate(groups):
        w = len(g)
        x[row, :w] = limbs[pos:pos + w]
        s[row, :w] = sgn[pos:pos + w]
        i[row, :w] = inf[pos:pos + w]
        mask[row, :w] = True
        pos += w
    args = [torch.from_numpy(x.view(np.int32))] + [
        torch.from_numpy(a) for a in (s, i, mask)]
    args = [a.to(dev) for a in args]
    t1 = time.perf_counter()
    ax, asgn, ainf, aok = (t.cpu().numpy() for t in signer.k_sign_agg(*args))
    t2 = time.perf_counter()
    if not aok.all():
        raise BlsError("aggregate batch: a signature is not on the curve")
    wire = compress_to_wire(ax, asgn, ainf)
    stages["pack"] += t1 - t0
    stages["dispatch"] += t2 - t1
    stages["compress"] += time.perf_counter() - t2
    return [bytes(wire[row]) for row in range(m)]


def aggregate_batch(groups: Sequence[Sequence[bytes]],
                    device=None) -> List[bytes]:
    """m groups of compressed signatures -> m aggregate signatures, one
    ``k_sign_agg`` launch over (m, k) row planes; byte-identical to
    ``AggregateSignature.from_signatures``, which answers instead for a
    batch under the threshold, the ``"python"`` backend or a batch with an
    empty group (whose aggregate is the infinity signature), as the
    reference routes them."""
    if not groups:
        return []
    total = sum(len(g) for g in groups)
    if min(len(g) for g in groups) == 0 or backend_for(total) == "python":
        t0 = time.perf_counter()
        out = [AggregateSignature.from_signatures(
            [Signature.from_bytes(bytes(sig)) for sig in g]).to_bytes()
            for g in groups]
        _record("python", total, {"total": time.perf_counter() - t0}, 0)
        return out
    dev = staged.resolve_device(device, "sign engine")
    stages = {"pack": 0.0, "dispatch": 0.0, "compress": 0.0}
    out = _aggregate_batch_cuda(groups, dev, stages)
    _record("cuda", total, stages, 0, dev)
    return out
