"""CUDA BLS backend: the counterpart of ``lighthouse_tpu/crypto/bls/tpu/
backend.py`` for the registry in ``..api``.

Host work: the wire parse of ``LazySignature`` bytes (flags and the limbs
of x), marshalling decoded signatures into limb tensors, pubkey rows from
the packed-pubkey cache (``.pubkey_cache``: each key is converted once and
lives on the card; a batch gathers its rows there), the random weights, and
the early returns of the reference (empty batch, infinity signature, a set
without keys).  Device work: the kernels of ``.staged``.

Routes of ``verify_signature_sets``:
  * wire: one key a set, every message a 32-byte root and every signature
    an undecoded ``LazySignature`` -> parse, k_decode, k_xmd, k_hash,
    k_points, k_pair, k_and, one readback; ``.point`` is never read, and a
    malformed encoding is a False verdict;
  * single key: decoded signatures (a lazy one is decoded on the host by
    ``.point``), k_xmd for 32-byte roots or host XMD, then k_hash,
    k_points, k_pair;
  * multi key: (n, k) key rows under a mask, k_points' mask variant.
``verify`` and ``_verify_many`` run per-set verdicts through k_each.

Runs on ``device`` ("cuda" by default); the CPU only when the caller asks
for it (``CudaBackend(device="cpu")``, the plain versions).  Without a CUDA
device a CUDA backend refuses to start: there is no fallback.

Weights: (m, 2) uint32 little-endian words from ``secrets``, ``rand[:n, 0]
|= 1`` (nonzero 64-bit weights), zero for padding lanes.  A batch is not
padded; the ``_dispatch_*`` methods take a padded lane count ``m``, and
padding lanes carry infinity points and zero weights, so any ``m >= n``
gives the same verdict.
"""
from __future__ import annotations

import secrets

import numpy as np
import torch

from .. import curve_ref as cv
from . import curve, fp, hash_to_g2 as h2, pubkey_cache, staged


def parse_g2_compressed_many(raws, m: int = None):
    """Wire signatures -> (x (m, 2, 12) int32 canonical PLAIN limbs, sign
    (m,), inf (m,)), CPU tensors, lanes past ``len(raws)`` infinity.  The
    flag and range rules are ``curve_ref.g2_parse_compressed``; the limbs
    of every finite x are split in one pass.  Raises ``BlsError`` on a
    malformed encoding.  Counterpart of tpu/backend.py
    _parse_g2_compressed_many."""
    from ..api import BlsError

    m = len(raws) if m is None else m
    x = np.zeros((m, 2, fp.N_LIMBS), np.uint32)
    sign = np.zeros((m,), bool)
    inf = np.ones((m,), bool)
    vals, idx = [], []
    for i, raw in enumerate(raws):
        parsed = cv.g2_parse_compressed(raw)
        if parsed is None:
            raise BlsError(
                f"invalid signature encoding: {bytes(raw[:4]).hex()}...")
        c0, c1, sign[i], inf[i] = parsed
        if not inf[i]:
            vals.extend((c0, c1))
            idx.append(i)
    if idx:
        x[idx] = fp.ints_to_limbs(vals).reshape(len(idx), 2, fp.N_LIMBS)
    return (torch.from_numpy(x.view(np.int32)), torch.from_numpy(sign),
            torch.from_numpy(inf))


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


def _undecoded(sig) -> bool:
    from ..api import LazySignature

    return isinstance(sig, LazySignature) and not sig.decoded()


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
    """BLS verification on the CUDA kernels."""

    def __init__(self, name: str = "cuda", device=None):
        self.name = name
        self.device = staged.resolve_device(device, "CudaBackend")

    @property
    def pubkey_cache(self) -> pubkey_cache.PackedPubkeyCache:
        """The process-wide packed-pubkey cache."""
        return pubkey_cache.get_cache()

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

    def _keys(self, pubkeys):
        """PublicKeys (None: padding) -> x, y, inf gathered on the device
        from the arena."""
        _rows, x, y, inf = self.pubkey_cache.pack_rows_device(
            pubkeys, self.device)
        return x, y, inf

    def _weights(self, m: int, n: int) -> torch.Tensor:
        w = random_weights(m, n).view(np.int32)
        return torch.as_tensor(w).to(self.device)

    def _words(self, msgs, m: int) -> torch.Tensor:
        """32-byte roots padded with zero roots -> (m, 8) int32 words."""
        msgs = list(msgs) + [b"\x00" * 32] * (m - len(msgs))
        return torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)).to(
            self.device)

    def _hash(self, msgs):
        """H(m) affine on the device: k_xmd for 32-byte roots, host XMD
        otherwise, then k_hash."""
        if all(len(msg) == 32 for msg in msgs):
            return staged.k_hash(staged.k_xmd(self._words(msgs, len(msgs))))
        return staged.k_hash(self._t(h2.hash_to_field(msgs)))

    # -- dispatch ------------------------------------------------------------

    def _dispatch_single(self, pubkeys, g2_pts, msgs, rand=None, m=None):
        """One key a set, decoded signatures -> the verdict tensor (1,)."""
        n = len(pubkeys)
        m = n if m is None else m
        xp, yp, pi = self._keys(list(pubkeys) + [None] * (m - n))
        xs, ys, si = self._g2(list(g2_pts) + [cv.g2_infinity()] * (m - n))
        if rand is None:
            rand = self._weights(m, n)
        if all(len(msg) == 32 for msg in msgs):
            # signing roots: SHA-256 XMD on the card (k_xmd)
            return staged.verify_batch_staged_roots(
                xp, yp, pi, xs, ys, si, self._words(msgs, m), rand)
        u = self._t(h2.hash_to_field(list(msgs) + [b""] * (m - n)))
        return staged.verify_batch_staged(xp, yp, pi, xs, ys, si, u, rand)

    def _dispatch_wire(self, sets, m=None):
        """One key a set, 32-byte roots, undecoded wire signatures: the
        signatures are decoded and subgroup-checked on the card (k_decode),
        and its verdict is ANDed with the pairing's there (k_and).  Raises
        ``BlsError`` on a malformed encoding (the caller's False)."""
        n = len(sets)
        m = n if m is None else m
        x, sign, inf = parse_g2_compressed_many(
            [s.signature.to_bytes() for s in sets], m)
        xp, yp, pi = self._keys([s.pubkeys[0] for s in sets]
                                + [None] * (m - n))
        return staged.verify_batch_wire_roots(
            xp, yp, pi, x.to(self.device), sign.to(self.device),
            inf.to(self.device), self._words([s.message for s in sets], m),
            self._weights(m, n))

    def _dispatch_multi(self, sets, max_k: int, m=None):
        n = len(sets)
        m = n if m is None else m
        k = max_k
        mask = np.zeros((m, k), bool)
        flat = []
        for i in range(m):
            pks = list(sets[i].pubkeys) if i < n else []
            mask[i, :len(pks)] = True
            flat.extend(pks + [None] * (k - len(pks)))
        x, y, inf = self._keys(flat)
        L = fp.N_LIMBS
        g2_pts = [s.signature.point for s in sets]
        xs, ys, si = self._g2(g2_pts + [cv.g2_infinity()] * (m - n))
        msgs = [s.message for s in sets] + [b""] * (m - n)
        u = self._t(h2.hash_to_field(msgs))
        return staged.verify_batch_multi_staged(
            x.view(m, k, L), y.view(m, k, L), inf.view(m, k),
            torch.as_tensor(mask).to(self.device), xs, ys, si, u,
            self._weights(m, n))

    def _verify_many(self, g1_pts, msgs, g2_pts) -> list:
        """Per-set verdicts e(P_i, H(m_i)) e(-g1, sig_i) == 1 (infinity
        fails) for affine points, one k_each call and one readback."""
        if not g1_pts:
            return []
        xp, yp, pi = self._g1(g1_pts)
        xs, ys, si = self._g2(g2_pts)
        hx, hy, hinf = self._hash(msgs)
        return staged.k_each(xp, yp, pi, xs, ys, si, hx, hy, hinf).tolist()

    # -- the public surface --------------------------------------------------

    def verify_signature_sets_async(self, sets) -> VerifyFuture:
        """Pack and dispatch now (the kernels run asynchronously), verdict
        at ``result()``."""
        from ..api import BlsError

        if not sets:
            return VerifyFuture.resolved(False)
        for s in sets:
            sig = s.signature
            if _undecoded(sig):
                # wire bytes: only the infinity flag is read here, the
                # rest is decoded on the card (or by .point off the wire
                # route)
                if sig.infinity_flagged():
                    return VerifyFuture.resolved(False)
            elif sig.point is None or sig.point.is_infinity():
                return VerifyFuture.resolved(False)
            if not s.pubkeys:
                return VerifyFuture.resolved(False)
        max_k = max(len(s.pubkeys) for s in sets)
        try:
            if max_k > 1:
                ok = self._dispatch_multi(sets, max_k)
            elif all(len(s.message) == 32 and _undecoded(s.signature)
                     for s in sets):
                ok = self._dispatch_wire(sets)
            else:
                ok = self._dispatch_single(
                    [s.pubkeys[0] for s in sets],
                    [s.signature.point for s in sets],
                    [s.message for s in sets])
        except BlsError:
            # a lazy signature with bad bytes: a verdict, not an error
            return VerifyFuture.resolved(False)
        return VerifyFuture(lambda: bool(ok.item()))

    def verify_signature_sets(self, sets) -> bool:
        return self.verify_signature_sets_async(sets).result()

    def verify(self, pubkey, msg: bytes, sig) -> bool:
        """One set through k_each."""
        return self._verify_many([pubkey.point], [msg], [sig.point])[0]

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
            list(pubkeys), [sig.point] + [cv.g2_infinity()] * (n - 1),
            list(msgs), rand=rand)
        return bool(ok.item())
