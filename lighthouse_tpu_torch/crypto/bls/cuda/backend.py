"""CUDA BLS backend: the counterpart of ``lighthouse_tpu/crypto/bls/tpu/
backend.py`` for the registry in ``..api``.

Host work: marshalling already-decompressed, subgroup-checked points (the
api layer does that at deserialization) into limb tensors, the random
weights, padding, and the early returns of the reference (empty batch,
infinity signature, a set without keys).  Device work: the four kernels of
``.staged``.  Runs on ``device`` ("cuda" by default); the CPU only when the
caller asks for it (``CudaBackend(device="cpu")``, the plain versions).
Without a CUDA device a CUDA backend refuses to start: there is no
fallback.

Weights: (m, 2) uint32 little-endian words from ``secrets``, ``rand[:n, 0]
|= 1`` (nonzero 64-bit weights), zero for padding lanes.  A batch is not
padded; ``_dispatch_single``/``_dispatch_multi`` take a padded lane count
``m``, and padding lanes carry infinity points and zero weights, so any
``m >= n`` gives the same verdict.
"""
from __future__ import annotations

import secrets

import numpy as np
import torch

from .. import curve_ref as cv
from . import curve, hash_to_g2 as h2, staged


def draw_raw_weights(m: int) -> np.ndarray:
    return np.frombuffer(secrets.token_bytes(4 * 2 * m),
                         np.uint32).reshape(m, 2).copy()


def random_weights(m: int, n: int) -> np.ndarray:
    """(m, 2) uint32 words: nonzero 64-bit weights for the first n lanes,
    zero after (reference blst.rs:54-67)."""
    rand = np.zeros((m, 2), np.uint32)
    rand[:n] = draw_raw_weights(m)[:n]
    rand[:n, 0] |= 1
    return rand


class VerifyFuture:
    """A verdict whose device work is in flight: ``result()`` waits for it
    (once) and returns the bool."""

    __slots__ = ("_fetch", "_value")

    def __init__(self, fetch):
        self._fetch = fetch
        self._value = None

    @classmethod
    def resolved(cls, value: bool) -> "VerifyFuture":
        fut = cls(None)
        fut._value = bool(value)
        return fut

    def result(self) -> bool:
        if self._value is None:
            self._value = bool(self._fetch())
            self._fetch = None
        return self._value


class CudaBackend:
    """Batch verification on the four CUDA kernels."""

    def __init__(self, name: str = "cuda", device=None):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaBackend: no CUDA device (pass device='cpu' to run the "
                "plain versions on the CPU)")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"CudaBackend: unsupported device {dev}")
        self.name = name
        self.device = dev

    # -- marshalling ---------------------------------------------------------

    def _t(self, limbs: torch.Tensor) -> torch.Tensor:
        """Host int64 limbs -> int32 limb tensor on the device."""
        return staged.to_i32(limbs).to(self.device)

    def _g1(self, points):
        x, y, inf = curve.pack_g1_affine(points)
        return self._t(x), self._t(y), inf.to(self.device)

    def _g2(self, points):
        x, y, inf = curve.pack_g2_affine(points)
        return self._t(x), self._t(y), inf.to(self.device)

    def _weights(self, m: int, n: int) -> torch.Tensor:
        w = random_weights(m, n).view(np.int32)
        return torch.as_tensor(w).to(self.device)

    # -- dispatch ------------------------------------------------------------

    def _dispatch_single(self, g1_pts, g2_pts, msgs, rand=None, m=None):
        n = len(g1_pts)
        m = n if m is None else m
        xp, yp, pi = self._g1(list(g1_pts) + [cv.g1_infinity()] * (m - n))
        xs, ys, si = self._g2(list(g2_pts) + [cv.g2_infinity()] * (m - n))
        msgs = list(msgs) + [b"\x00" * 32] * (m - n)
        if rand is None:
            rand = self._weights(m, n)
        if all(len(msg) == 32 for msg in msgs):
            # signing roots: SHA-256 XMD on the card (k_xmd)
            words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32))
            return staged.verify_batch_staged_roots(
                xp, yp, pi, xs, ys, si, words.to(self.device), rand)
        u = self._t(h2.hash_to_field(msgs))
        return staged.verify_batch_staged(xp, yp, pi, xs, ys, si, u, rand)

    def _dispatch_multi(self, sets, max_k: int, m=None):
        n = len(sets)
        m = n if m is None else m
        k = max_k
        mask = np.zeros((m, k), bool)
        flat = []
        for i in range(m):
            pks = [pk.point for pk in sets[i].pubkeys] if i < n else []
            mask[i, :len(pks)] = True
            flat.extend(pks + [cv.g1_infinity()] * (k - len(pks)))
        x, y, inf = curve.pack_g1_affine(flat)
        xpk = self._t(x.reshape(m, k, -1))
        ypk = self._t(y.reshape(m, k, -1))
        ipk = inf.reshape(m, k).to(self.device)
        g2_pts = [s.signature.point for s in sets]
        xs, ys, si = self._g2(g2_pts + [cv.g2_infinity()] * (m - n))
        msgs = [s.message for s in sets] + [b""] * (m - n)
        u = self._t(h2.hash_to_field(msgs))
        return staged.verify_batch_multi_staged(
            xpk, ypk, ipk, torch.as_tensor(mask).to(self.device), xs, ys, si,
            u, self._weights(m, n))

    # -- the public surface --------------------------------------------------

    def verify_signature_sets_async(self, sets) -> VerifyFuture:
        """Pack and dispatch now (the kernels run asynchronously), verdict
        at ``result()``."""
        if not sets:
            return VerifyFuture.resolved(False)
        for s in sets:
            sig = s.signature.point
            if sig is None or sig.is_infinity():
                return VerifyFuture.resolved(False)
            if not s.pubkeys:
                return VerifyFuture.resolved(False)
        max_k = max(len(s.pubkeys) for s in sets)
        if max_k == 1:
            ok = self._dispatch_single(
                [s.pubkeys[0].point for s in sets],
                [s.signature.point for s in sets],
                [s.message for s in sets])
        else:
            ok = self._dispatch_multi(sets, max_k)
        return VerifyFuture(lambda: bool(ok.item()))

    def verify_signature_sets(self, sets) -> bool:
        return self.verify_signature_sets_async(sets).result()

    def verify(self, pubkey, msg: bytes, sig) -> bool:
        """A batch of one."""
        from ..api import SignatureSet

        return self.verify_signature_sets([SignatureSet(sig, [pubkey], msg)])

    def fast_aggregate_verify(self, sig, msg: bytes, pubkeys) -> bool:
        """All keys sign one message (the 512-key sync aggregate)."""
        from ..api import SignatureSet

        if not pubkeys:
            return False
        if sig.point is None or sig.point.is_infinity():
            return False
        return self.verify_signature_sets(
            [SignatureSet(sig, list(pubkeys), msg)])

    def aggregate_verify(self, sig, msgs, pubkeys) -> bool:
        """prod_i e(P_i, H(m_i)) == e(g1, sig) with unit weights: the
        signature rides lane 0, the other lanes carry infinity signatures."""
        if not pubkeys or len(msgs) != len(pubkeys):
            return False
        if sig.point is None or sig.point.is_infinity():
            return False
        n = len(pubkeys)
        ones = np.zeros((n, 2), np.uint32)
        ones[:, 0] = 1
        rand = torch.as_tensor(ones.view(np.int32)).to(self.device)
        ok = self._dispatch_single(
            [pk.point for pk in pubkeys],
            [sig.point] + [cv.g2_infinity()] * (n - 1), list(msgs), rand=rand)
        return bool(ok.item())
