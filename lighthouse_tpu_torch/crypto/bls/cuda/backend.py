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
  * multi key: (n, k) key rows under a mask, k_points' mask variant;
  * mesh (``parallel/sharded_verify.py``): a batch of at least
    ``mesh_min_sets`` sets (64) when the backend has a mesh -- its own
    (``CudaBackend(mesh=make_mesh([...]))``), or by default one over every
    visible card when there is more than one (``mesh=False`` pins the
    single-device route) -- is padded to a multiple of the shards and runs
    the sharded programs: ``firehose_fn`` (wire or decoded signatures x
    32-byte roots on k_xmd or host ``hash_to_field`` limbs) and
    ``multi_fn``.  A mesh fault retries the batch on the single-device
    route; a fault there raises ``BackendFault`` (tpu/backend.py:598-612,
    :689-711, :810-820).
``verify`` and ``_verify_many`` run per-set verdicts through k_each;
``aggregate_verify`` runs the monolithic ``verify.verify_batch_kernel`` with
unit weights.

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
from .verify import verify_batch_kernel
from ....parallel import sharded_verify as sv


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


def parse_g1_compressed_many(raws, m: int = None):
    """Compressed G1 points (48 bytes, ZCash flags) -> (x (m, 12) int32
    canonical PLAIN limbs, sign (m,), inf (m,)), CPU tensors, lanes past
    ``len(raws)`` infinity: the planes ``staged.k_decode_g1`` takes.  The
    flag and range rules are ``curve_ref.g1_decompress``'s; raises
    ``BlsError`` on a malformed encoding."""
    from ..api import BlsError

    m = len(raws) if m is None else m
    x = np.zeros((m, fp.N_LIMBS), np.uint32)
    sign = np.zeros((m,), bool)
    inf = np.ones((m,), bool)
    vals, idx = [], []
    for i, raw in enumerate(raws):
        flags = raw[0] if len(raw) == 48 else 0
        bad = not flags & 0x80
        if not bad and flags & 0x40:
            bad = bool(flags & 0x3F or any(raw[1:]))
        elif not bad:
            v = int.from_bytes(bytes([flags & 0x1F]) + bytes(raw[1:]), "big")
            bad = v >= cv.P
            sign[i], inf[i] = bool(flags & 0x20), False
            vals.append(v)
            idx.append(i)
        if bad:
            raise BlsError(f"invalid G1 encoding: {bytes(raw[:4]).hex()}...")
    if idx:
        x[idx] = fp.ints_to_limbs(vals)
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
    """BLS verification on the CUDA kernels.  ``mesh``: None (a mesh over
    every visible card when there is more than one), False (the
    single-device route only) or a ``parallel.sharded_verify.Mesh``."""

    def __init__(self, name: str = "cuda", device=None, mesh=None,
                 mesh_min_sets: int = sv.DEFAULT_MESH_MIN_SETS):
        self.name = name
        self.device = staged.resolve_device(device, "CudaBackend")
        if not (mesh is None or mesh is False or isinstance(mesh, sv.Mesh)):
            raise TypeError(f"mesh: None, False or a Mesh, not {mesh!r}")
        self.mesh = mesh
        self.mesh_min_sets = mesh_min_sets

    def _mesh_for(self, n_sets: int):
        """The mesh a batch of ``n_sets`` runs on, or None."""
        if self.mesh is False:
            return None
        if self.mesh is None and self.device.type != "cuda":
            return None
        return sv.mesh_wanted(n_sets, self.mesh or None, self.mesh_min_sets)

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

    def _u(self, msgs):
        """hash_to_field limbs on the device: k_xmd for 32-byte roots, host
        XMD otherwise."""
        if all(len(msg) == 32 for msg in msgs):
            return staged.k_xmd(self._words(msgs, len(msgs)))
        return self._t(h2.hash_to_field(msgs))

    def _hash(self, msgs):
        """H(m) affine on the device: ``_u``, then k_hash."""
        return staged.k_hash(self._u(msgs))

    # -- dispatch ------------------------------------------------------------

    def _dispatch_single(self, pubkeys, g2_pts, msgs, m=None):
        """One key a set, decoded signatures -> the verdict tensor (1,)."""
        n = len(pubkeys)
        m = n if m is None else m
        xp, yp, pi = self._keys(list(pubkeys) + [None] * (m - n))
        xs, ys, si = self._g2(list(g2_pts) + [cv.g2_infinity()] * (m - n))
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

    def _dispatch_device(self, sets, max_k: int):
        """The single-device route of a batch -> its verdict tensor."""
        if max_k > 1:
            return self._dispatch_multi(sets, max_k)
        if all(len(s.message) == 32 and _undecoded(s.signature)
               for s in sets):
            return self._dispatch_wire(sets)
        return self._dispatch_single([s.pubkeys[0] for s in sets],
                                     [s.signature.point for s in sets],
                                     [s.message for s in sets])

    def _dispatch_mesh(self, sets, mesh):
        """One key a set over the mesh: the shards' keys gathered from the
        arena on their cards, signatures as wire planes (every one an
        undecoded ``LazySignature``: k_decode on the shards) or affine,
        messages as root words (all 32 bytes: k_xmd on the shards) or host
        ``hash_to_field`` limbs -> the ladder's ``VerifyFuture``.  A
        malformed wire encoding raises ``BlsError`` here (the caller's
        False)."""
        n = len(sets)
        m = sv.pad_lanes(n, mesh)
        msgs = [s.message for s in sets]
        lazy = all(_undecoded(s.signature) for s in sets)
        device_xmd = sv.device_xmd_ok(msgs)
        if lazy:
            sig_in = parse_g2_compressed_many(
                [s.signature.to_bytes() for s in sets], m)
        else:
            xs, ys, si = curve.pack_g2_affine(
                [s.signature.point for s in sets]
                + [cv.g2_infinity()] * (m - n))
            sig_in = (staged.to_i32(xs), staged.to_i32(ys), si)
        if device_xmd:
            msg_in = torch.as_tensor(h2.pack_msg_words(
                msgs + [b"\x00" * 32] * (m - n)).view(np.int32))
        else:
            msg_in = staged.to_i32(h2.hash_to_field(msgs + [b""] * (m - n)))
        rand = torch.as_tensor(random_weights(m, n).view(np.int32))

        def dispatch():
            _rows, keys = self.pubkey_cache.pack_rows_device(
                [s.pubkeys[0] for s in sets] + [None] * (m - n), mesh)
            run = sv.firehose_fn(mesh, wire=lazy, device_xmd=device_xmd)
            return run(keys, *sig_in, msg_in, rand)

        return sv.ladder(mesh, m // mesh.size, dispatch,
                         lambda: self._dispatch_device(sets, 1))

    def _dispatch_multi_mesh(self, sets, max_k: int, mesh):
        """Multi-key sets over the mesh: the (m, k) key planes gathered
        from the arena a shard, summed a set on the card (``multi_fn``)."""
        n, k = len(sets), max_k
        m = sv.pad_lanes(n, mesh)
        mask = np.zeros((m, k), bool)
        flat = []
        for i in range(m):
            pks = list(sets[i].pubkeys) if i < n else []
            mask[i, :len(pks)] = True
            flat.extend(pks + [None] * (k - len(pks)))
        xs, ys, si = curve.pack_g2_affine(
            [s.signature.point for s in sets] + [cv.g2_infinity()] * (m - n))
        u = staged.to_i32(h2.hash_to_field(
            [s.message for s in sets] + [b""] * (m - n)))
        rand = torch.as_tensor(random_weights(m, n).view(np.int32))
        L, q = fp.N_LIMBS, m // mesh.size

        def dispatch():
            _rows, flat_keys = self.pubkey_cache.pack_rows_device(flat, mesh)
            keys = [(x.view(q, k, L), y.view(q, k, L), inf.view(q, k))
                    for x, y, inf in flat_keys]
            return sv.multi_fn(mesh)(keys, torch.as_tensor(mask),
                                     staged.to_i32(xs), staged.to_i32(ys),
                                     si, u, rand)

        return sv.ladder(mesh, m // mesh.size, dispatch,
                         lambda: self._dispatch_device(sets, max_k))

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
        mesh = self._mesh_for(len(sets))
        try:
            if mesh is not None:
                return (self._dispatch_multi_mesh(sets, max_k, mesh)
                        if max_k > 1 else self._dispatch_mesh(sets, mesh))
            ok = self._dispatch_device(sets, max_k)
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
        """prod_i e(P_i, H(m_i)) == e(g1, sig) with unit weights through the
        monolithic kernel sequence (tpu/backend.py:280-301, subgroup checks
        off): the signature rides lane 0, the other lanes carry infinity
        signatures."""
        if not pubkeys or len(msgs) != len(pubkeys):
            return False
        if sig.point is None or sig.point.is_infinity():
            return False
        n = len(pubkeys)
        ones = np.zeros((n, 2), np.uint32)
        ones[:, 0] = 1
        rand = torch.as_tensor(ones.view(np.int32)).to(self.device)
        xp, yp, pi = self._keys(list(pubkeys))
        xs, ys, si = self._g2([sig.point] + [cv.g2_infinity()] * (n - 1))
        ok = verify_batch_kernel(xp, yp, pi, xs, ys, si, self._u(msgs), rand)
        return bool(ok.item())
