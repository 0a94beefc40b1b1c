"""KZG blob-sidecar verification of the PyTorch/CUDA port.

Counterpart of ``lighthouse_tpu/crypto/kzg/__init__.py``, with the same
verdicts.  ``verify_blob_kzg_proof_batch`` verifies B sidecars (blob,
commitment, proof) in one call: per-blob Fiat-Shamir challenges on the
host (through the port's hash engine), the barycentric evaluations on the
card (``cuda/kernel.py``, kernel ``k_blob_eval``), and the batch folded by
a Fiat-Shamir random linear combination into one 2-pairing check on the
card's ``k_pair`` (``crypto/bls/cuda/staged.py``).

  * ``configure(backend=..., threshold=..., device=...)``: backend
    ``"cuda"`` (the default) or ``"python"`` (``reference.
    verify_blob_kzg_proof_batch``, all on the host).  A batch under
    ``threshold`` blobs (``DEFAULT_THRESHOLD`` = 2) takes the python path,
    as the reference routes it, and so does a ragged batch (blobs of
    different lengths have no one kernel shape).  ``device``: ``"cuda"``
    (the default) runs the kernels, ``"cpu"`` their plain versions
    (tests); a ``"cuda"`` call without a card raises.
  * Malformed input (length mismatch, a blob whose length is not a
    power-of-two count of 32-byte elements, a non-canonical element, a bad
    G1 encoding) is the verdict ``False`` with ``last_call()["backend"] ==
    "validate"``, never a fault.  The empty batch is ``True``.
  * ``last_call()``: backend, n, stage rows (``challenge`` / ``eval`` /
    ``pairing`` on the cuda path) and the verdict.

Deliberate differences from the reference: there is no breaker, exec
cache, fault-injection site, environment variable, metrics registry or
``fake_crypto`` gate (the port has no ``fake_crypto`` BLS backend).  The
pairing leg always runs on the card under ``"cuda"``, where the
reference's ``LIGHTHOUSE_TPU_KZG_PAIRING`` chose between its host oracle
and its device program (both give the same verdict).  A fault raises
instead of falling back to python.  Validation stops at the first bad G1
encoding (the reference decodes them all; the verdict is the same), and
the setup's [tau]_2 is decompressed once per setup.  The trusted setup is
the embedded dev setup unless ``set_setup`` installs another
(``setup.load_trusted_setup`` takes a path; no environment variable is
read).
"""
from __future__ import annotations

import functools
import threading
from typing import Optional, Sequence

import torch

from ...runtime.stages import StageTimer
from ...runtime.tensors import resolve_device, to_i32
from ..bls import curve_ref
from ..bls.cuda import curve, fp, staged
from . import reference
from . import setup as setup_mod
from .cuda import kernel

DEFAULT_THRESHOLD = 2
BACKENDS = ("cuda", "python")

_LOCK = threading.Lock()
_STATE = {"backend": "cuda", "threshold": DEFAULT_THRESHOLD,
          "device": "cuda"}
_ANSWERED = {"cuda": 0, "python": 0, "validate": 0}
_LAST_CALL: dict = {}
_SETUP: Optional[setup_mod.TrustedSetup] = None


def get_setup() -> setup_mod.TrustedSetup:
    """The active trusted setup (the dev setup unless one was set)."""
    global _SETUP
    if _SETUP is None:
        _SETUP = setup_mod.load_trusted_setup()
    return _SETUP


def set_setup(setup: Optional[setup_mod.TrustedSetup]) -> None:
    """Install (or with None: drop, back to the dev setup) the setup."""
    global _SETUP
    _SETUP = setup


def configure(backend: Optional[str] = None,
              threshold: Optional[int] = None,
              device=None) -> None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown kzg backend {backend!r}")
    with _LOCK:
        if backend is not None:
            _STATE["backend"] = backend
        if threshold is not None:
            _STATE["threshold"] = int(threshold)
        if device is not None:
            _STATE["device"] = str(torch.device(device))


def reset_engine() -> None:
    """Back to the defaults, with the counts, the last call and the setup
    cleared (tests)."""
    global _LAST_CALL, _SETUP
    configure("cuda", DEFAULT_THRESHOLD, "cuda")
    with _LOCK:
        for k in _ANSWERED:
            _ANSWERED[k] = 0
    _LAST_CALL = {}
    _SETUP = None


def engine_status() -> dict:
    with _LOCK:
        return dict(_STATE, answered=dict(_ANSWERED),
                    launches=kernel.launch_counts())


def last_call() -> dict:
    return dict(_LAST_CALL)


def backend_for(n: int) -> str:
    """The backend a well-formed batch of n equal-length blobs routes to."""
    with _LOCK:
        big = n >= _STATE["threshold"]
        return "cuda" if _STATE["backend"] == "cuda" and big else "python"


def blob_to_kzg_commitment(blob: bytes) -> bytes:
    """``[p(tau)]_1`` through the dev setup's secret."""
    return setup_mod.blob_to_commitment(blob, get_setup())


def compute_blob_kzg_proof(blob: bytes, commitment: bytes) -> bytes:
    return setup_mod.compute_blob_proof(blob, commitment, get_setup())


def _record(backend: str, n: int, verdict: bool, stages=()) -> bool:
    global _LAST_CALL
    with _LOCK:
        _ANSWERED[backend] += 1
    _LAST_CALL = {"backend": backend, "n": n, "stages": list(stages),
                  "verdict": verdict}
    return verdict


def _element_count(blob: bytes) -> int:
    """The blob's element count, or 0 when it is not a power-of-two count
    of 32-byte elements."""
    size = len(blob)
    n = size // reference.BYTES_PER_FIELD_ELEMENT
    if size % reference.BYTES_PER_FIELD_ELEMENT or n == 0 or n & (n - 1):
        return 0
    return n


def pairing_args(lhs, proof_acc, tau_g2, device) -> tuple:
    """The k_pair arguments of e(lhs, g2) * e(-proof_acc, [tau]_2) == 1:
    the two pairs are its lanes and its fixed (-g1, S) lane is switched off
    (sinf).  An infinity G1 point goes in as an inactive lane (f = 1 =
    e(O, Q))."""
    wx, wy, winf = curve.pack_g1_affine([lhs, -proof_acc], device)
    hx, hy, hinf = curve.pack_g2_affine([curve_ref.g2_generator(), tau_g2],
                                        device)
    off = torch.zeros((2, fp.N_LIMBS), dtype=torch.int32, device=device)
    return (to_i32(wx), to_i32(wy), winf, to_i32(hx), to_i32(hy), hinf, off,
            off, torch.ones((1,), dtype=torch.bool, device=device))


@functools.lru_cache(maxsize=4)
def _tau_g2(setup: setup_mod.TrustedSetup):
    """The setup's [tau]_2, decompressed (and subgroup-checked) once."""
    return setup.tau_g2()


def _verify_cuda(words, blobs, commitments, proofs, commitment_pts,
                 proof_pts, device, timer) -> bool:
    with timer.stage("challenge"):
        zs = [reference.compute_challenge(bytes(b), bytes(c))
              for b, c in zip(blobs, commitments)]
    with timer.stage("eval"):
        ys = kernel.eval_blobs(words, zs, device=device)
    with timer.stage("pairing"):
        rlc = reference.batch_rlc_powers(
            [bytes(c) for c in commitments], zs, ys,
            [bytes(p) for p in proofs])
        lhs, proof_acc = reference._batch_pairing_inputs(
            commitment_pts, zs, ys, proof_pts, rlc)
        ok, _gt = staged.k_pair(*pairing_args(
            lhs, proof_acc, _tau_g2(get_setup()), device))
    return bool(ok.item())


def verify_blob_kzg_proof_batch(blobs: Sequence[bytes],
                                commitments: Sequence[bytes],
                                proofs: Sequence[bytes]) -> bool:
    """Verify a batch of blob sidecars; the same verdict on every
    backend."""
    n = len(blobs)
    if not (n == len(commitments) == len(proofs)):
        return _record("validate", n, False)
    if n == 0:
        return True
    counts = [_element_count(bytes(b)) for b in blobs]
    if not all(counts):
        return _record("validate", n, False)
    ragged = len(set(counts)) > 1
    if ragged:
        canonical = all(kernel.blob_words([b])[1][0] for b in blobs)
        words = None
    else:
        words, ok = kernel.blob_words(blobs)
        canonical = bool(ok.all())
    if not canonical:
        return _record("validate", n, False)
    points = []
    for enc in (*commitments, *proofs):      # stop at the first bad one
        points.append(reference.parse_g1(enc))
        if points[-1] is None:
            return _record("validate", n, False)
    commitment_pts, proof_pts = points[:n], points[n:]

    if ragged or backend_for(n) == "python":
        verdict = reference.verify_blob_kzg_proof_batch(
            blobs, commitments, proofs, _tau_g2(get_setup()))
        return _record("python", n, verdict)
    device = resolve_device(_STATE["device"], "kzg verify")
    timer = StageTimer()
    verdict = _verify_cuda(words, blobs, commitments, proofs, commitment_pts,
                           proof_pts, device, timer)
    return _record("cuda", n, verdict, timer.rows())


__all__ = [
    "BACKENDS", "DEFAULT_THRESHOLD", "backend_for", "blob_to_kzg_commitment",
    "compute_blob_kzg_proof", "configure", "engine_status", "get_setup",
    "last_call", "reset_engine", "set_setup", "verify_blob_kzg_proof_batch",
]
