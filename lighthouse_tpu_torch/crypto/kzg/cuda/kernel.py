"""The KZG path's kernel on the card, its plain PyTorch version, and the
host entry that drives it.

Counterpart of ``lighthouse_tpu/crypto/kzg/kernels.py``:

  k_blob_eval  B blobs of N canonical elements and their challenges z
               -> p(z) for each blob (barycentric evaluation over the
               size-N domain of roots of unity, with the exact guard
               p(w^i) = p_i)

Layout: Fr words travel as ``int32`` tensors holding the uint32 limbs
(``(..., 8)``, little-endian, canonical).  The blob elements and the
challenges are PLAIN (the kernel moves them into Montgomery form on the
card); the domain table w^0 .. w^(N-1) and N^-1 are Montgomery and are
kept per (N, device) by ``domain``.  The output is canonical plain.

The wrapper checks device, dtype, shape and contiguity, launches the
kernel (``csrc/k_kzg.cu``) for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it runs the plain version
(``k_blob_eval_plain``, also callable on CUDA tensors to compare).  A
failed build or launch raises.  Unlike the reference there is no exec
cache, no source fingerprint and no ``clear_cache``: the build keys on the
sources (``runtime/build.py``), and the domain tables are a few KB.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ....runtime.tensors import (check, empty, on_cpu, resolve_device,
                                 to_i32, to_i64)
from .. import reference
from . import fr

L = fr.N_LIMBS


# --- k_blob_eval -------------------------------------------------------------


def k_blob_eval_plain(poly: torch.Tensor, z: torch.Tensor,
                      roots: torch.Tensor, inv_n: torch.Tensor):
    """The same function vectorised over (B, N): one product-tree
    inversion of all B x N denominators."""
    n = poly.shape[1]
    p = fr.to_mont(to_i64(poly))
    zm = fr.to_mont(to_i64(z))
    w = to_i64(roots)
    d = fr.sub(zm[:, None], w[None])
    hit = fr.is_zero(d)                                   # (B, N)
    dinv = fr.inv_many(d)                                 # hits -> 0
    terms = fr.mont_mul(fr.mont_mul(p, w[None]), dinv)
    while terms.shape[1] > 1:                             # N is a power of 2
        terms = fr.add(terms[:, 0::2], terms[:, 1::2])
    zn = zm
    for _ in range(n.bit_length() - 1):
        zn = fr.sqr(zn)
    num = fr.sub(zn, fr.one(zn.shape[:-1], zn.device))
    y = fr.from_mont(fr.mont_mul(fr.mont_mul(terms[:, 0], num),
                                 to_i64(inv_n)))
    # at most one element can hit, so the masked sum is that element
    y_hit = (to_i64(poly) * hit.unsqueeze(-1)).sum(1)
    return to_i32(fr.select(hit.any(1), y_hit, y))


def k_blob_eval(poly: torch.Tensor, z: torch.Tensor, roots: torch.Tensor,
                inv_n: torch.Tensor) -> torch.Tensor:
    """poly (B, N, 8) plain, z (B, 8) plain, roots (N, 8) Montgomery,
    inv_n (8,) Montgomery -> (B, 8) canonical plain p(z).  N is a power of
    two.  Replaces lighthouse_tpu/crypto/kzg/kernels.py:76 k_blob_eval."""
    if not isinstance(poly, torch.Tensor) or poly.dim() != 3:
        raise ValueError("k_blob_eval poly: expected a (B, N, 8) tensor")
    b, n, device = poly.shape[0], poly.shape[1], poly.device
    check("k_blob_eval poly", poly, (b, n, L), torch.int32, device)
    check("k_blob_eval z", z, (b, L), torch.int32, device)
    check("k_blob_eval roots", roots, (n, L), torch.int32, device)
    check("k_blob_eval inv_n", inv_n, (L,), torch.int32, device)
    if n == 0 or n & (n - 1):
        raise ValueError(f"k_blob_eval: N = {n} is not a power of two")
    if on_cpu(device):
        return k_blob_eval_plain(poly, z, roots, inv_n)
    from ....runtime import build

    scratch = empty((b, n, L), torch.int32, device)
    y = empty((b, L), torch.int32, device)
    if b:
        build.call("k_kzg", "k_blob_eval_launch", poly, z, roots, inv_n, b,
                   n, n.bit_length() - 1, scratch, y)
        k_blob_eval.launches += 1
    return y


k_blob_eval.launches = 0

KERNELS = {"k_blob_eval": k_blob_eval}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# --- Host side ---------------------------------------------------------------

_R_BYTES = np.frombuffer(reference.R.to_bytes(32, "big"), np.uint8)
_DOMAINS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def domain(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(roots (n, 8), N^-1 (8,)) int32 Montgomery words on `device`."""
    device = torch.device(device)
    key = (n, device)
    if key not in _DOMAINS:
        roots = fr.mont_ints_to_limbs(reference.roots_of_unity(n))
        inv_n = fr.mont_ints_to_limbs([pow(n, reference.R - 2, reference.R)])
        _DOMAINS[key] = (torch.from_numpy(roots.view(np.int32)).to(device),
                         torch.from_numpy(inv_n[0].view(np.int32)).to(device))
    return _DOMAINS[key]


def blob_words(blobs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Equal-length blobs -> ((B, N, 8) uint32 little-endian words of each
    32-byte big-endian element, (B,) bool: every element of the blob is
    canonical, < r).  numpy throughout: no Python loop over elements."""
    raw = np.frombuffer(b"".join(bytes(b) for b in blobs), np.uint8)
    be = raw.reshape(len(blobs), -1, reference.BYTES_PER_FIELD_ELEMENT)
    # lexicographic compare of the big-endian bytes with r's
    diff = be != _R_BYTES
    first = diff.argmax(-1)
    above = np.take_along_axis(be, first[..., None], -1)[..., 0] \
        > _R_BYTES[first]
    canonical = diff.any(-1) & ~above
    words = np.ascontiguousarray(be[..., ::-1]).view("<u4")
    return words.astype(np.uint32), canonical.all(-1)


def ints_to_words(polys: Sequence[Sequence[int]]) -> np.ndarray:
    """Equal-length lists of canonical ints -> (B, N, 8) uint32 words."""
    b, n = len(polys), len(polys[0]) if polys else 0
    flat = [v for p in polys for v in p]
    return fr.ints_to_limbs(flat).reshape(b, n, L)


def eval_blobs(words, zs: Sequence[int], device=None) -> List[int]:
    """Evaluate B blobs, given as (B, N, 8) uint32 words of canonical
    elements (``blob_words``), at their challenges on `device` (the card
    unless the caller asks for the CPU); returns canonical ints, equal to
    ``reference.evaluate_polynomial`` per blob."""
    device = resolve_device(device, "kzg eval_blobs")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    b = words.shape[0]
    if b == 0:
        return []
    n = words.shape[1]
    roots, inv_n = domain(n, device)
    poly = torch.from_numpy(words.view(np.int32)).to(device)
    z = torch.from_numpy(fr.ints_to_limbs([v % reference.R for v in zs])
                         .view(np.int32)).to(device)
    return fr.unpack(k_blob_eval(poly, z, roots, inv_n).cpu())
