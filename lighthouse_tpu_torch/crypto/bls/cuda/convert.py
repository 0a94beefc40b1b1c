"""Move state between the JAX package's limb arrays and the port's tensors.

The JAX package (``lighthouse_tpu/crypto/bls/tpu``) keeps an Fp element as
30 little-endian 13-bit limbs in uint32 (possibly loose: a limb may exceed
13 bits and the value may exceed p), Montgomery form with R = 2^390 or plain
as the stage says.  The port keeps 12 little-endian 32-bit limbs, canonical
(< p), Montgomery form with R = 2^384, as int32 bit patterns at the kernel
wrappers.  The rules are re-implemented here from those layouts; nothing of
the JAX package is imported.

Covered: packed affine G1/G2 points (``curve.pack_g1_affine`` /
``pack_g2_affine`` there: x, y Montgomery plus an infinity mask),
hash-to-field limbs (``hash_to_g2.hash_to_field``: plain), the inputs of
``staged.k_decode`` (canonical plain x limbs of wire signatures, sign and
infinity bits), pubkey-arena rows (``pubkey_cache``: x, y Montgomery rows,
row 0 = the infinity lane), a whole ``PackedPubkeyCache`` (arena, LRU
index, free list, counters) and a whole ``SecretKeyCache`` (its scalar
words have the same layout in both packages).  Weight words (n, 2) uint32 pass through
unchanged (``weights_from_jax``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import P
from ..constants import R as R_ORDER
from . import fp
from .staged import to_i32

JAX_LIMB_BITS = 13
JAX_N_LIMBS = 30
JAX_R = 1 << (JAX_LIMB_BITS * JAX_N_LIMBS)      # 2^390
_JAX_MASK = (1 << JAX_LIMB_BITS) - 1
_FROM_JAX_MONT = pow(JAX_R, -1, P) * fp.R % P  # 2^-390 * 2^384 mod p
_TO_JAX_MONT = pow(fp.R, -1, P) * JAX_R % P


def jax_limbs_to_ints(arr, width: int = JAX_N_LIMBS) -> list:
    """(..., width) 13-bit limbs (loose allowed) -> flat list of ints."""
    a = np.asarray(arr, dtype=np.uint64).reshape(-1, width)
    return [sum(int(x) << (JAX_LIMB_BITS * i) for i, x in enumerate(row))
            for row in a]


def ints_to_jax_limbs(vals, width: int = JAX_N_LIMBS) -> np.ndarray:
    """ints in [0, 2^(13 width)) -> (n, width) uint32 canonical 13-bit
    limbs."""
    return np.array([[(v >> (JAX_LIMB_BITS * i)) & _JAX_MASK
                      for i in range(width)] for v in vals],
                    dtype=np.uint32).reshape(len(vals), width)


def fp_from_jax(arr, mont: bool = True, device="cpu") -> torch.Tensor:
    """JAX Fp limbs (..., 30) -> port limbs (..., 12) int32.  With ``mont``
    the input is Montgomery (R = 2^390) and so is the output (R = 2^384);
    otherwise both are plain."""
    arr = np.asarray(arr)
    scale = _FROM_JAX_MONT if mont else 1
    vals = [v % P * scale % P for v in jax_limbs_to_ints(arr)]
    out = fp.pack(vals, device)
    return to_i32(out.reshape(*arr.shape[:-1], fp.N_LIMBS))


def fp_to_jax(t: torch.Tensor, mont: bool = True) -> np.ndarray:
    """Port limbs (..., 12) -> JAX canonical limbs (..., 30) uint32."""
    scale = _TO_JAX_MONT if mont else 1
    vals = [v * scale % P for v in fp.unpack(t.cpu())]
    return ints_to_jax_limbs(vals).reshape(*t.shape[:-1], JAX_N_LIMBS)


def g1_affine_from_jax(x, y, inf, device="cpu"):
    """(x, y, inf) of ``pack_g1_affine``: (n, 30), (n, 30), (n,) ->
    (n, 12), (n, 12) int32 and (n,) bool."""
    return (fp_from_jax(x, True, device), fp_from_jax(y, True, device),
            torch.as_tensor(np.array(inf, dtype=bool), device=device))


def g2_affine_from_jax(x, y, inf, device="cpu"):
    """(x, y, inf) of ``pack_g2_affine``: (n, 2, 30) ... -> (n, 2, 12)."""
    return g1_affine_from_jax(x, y, inf, device)


def u_from_jax(u_plain, device="cpu") -> torch.Tensor:
    """``hash_to_field`` limbs (n, 2, 2, 30), plain -> (n, 2, 2, 12)."""
    return fp_from_jax(u_plain, False, device)


def arena_rows_from_jax(x_rows, y_rows, device="cpu"):
    """Pubkey-arena rows (rows, 30) x and y, Montgomery -> the port's (x, y,
    inf); the all-zero row (row 0, the padding lane) is infinity."""
    x_rows, y_rows = np.asarray(x_rows), np.asarray(y_rows)
    inf = ~(x_rows.any(axis=-1) | y_rows.any(axis=-1))
    return g1_affine_from_jax(x_rows, y_rows, inf, device)


def decode_inputs_from_jax(x_limbs, sign, inf, device="cpu"):
    """``staged.k_decode`` inputs there -- x (m, 2, 30) canonical plain
    limbs, sign and inf (m,) -- -> the port's x (m, 2, 12) int32, sign and
    inf (m,) bool."""
    return (fp_from_jax(x_limbs, False, device),
            torch.as_tensor(np.array(sign, dtype=bool), device=device),
            torch.as_tensor(np.array(inf, dtype=bool), device=device))


def pubkey_cache_from_jax(jcache):
    """A JAX ``PackedPubkeyCache`` -> a port ``PackedPubkeyCache`` holding
    the same keys in the same rows (same LRU order, free list, next row and
    hit / miss / eviction counts), the arena's limbs converted; no device
    mirror (the first ``device_view`` uploads it)."""
    from .pubkey_cache import PackedPubkeyCache

    rows = jcache._x.shape[0]
    cache = PackedPubkeyCache(jcache.capacity, initial_rows=rows)
    for attr, arr in (("_x", jcache._x), ("_y", jcache._y)):
        setattr(cache, attr, fp_from_jax(arr).numpy().view(np.uint32))
    cache._index = type(jcache._index)(jcache._index)
    cache._free = list(jcache._free)
    cache._next_row = jcache._next_row
    cache.hits, cache.misses = jcache.hits, jcache.misses
    cache.evictions = jcache.evictions
    return cache


def seckey_arena_from_jax(jcache):
    """A JAX ``SecretKeyCache`` -> a port ``SecretKeyCache`` holding the
    same keys in the same rows (same LRU order, free list, next row and
    hit / miss / eviction counts).  The words are the same layout in both
    packages, (rows, 8) little-endian uint32 words of each scalar, so they
    are checked and copied as they are; no device mirror (the first
    ``device_view`` uploads the arena)."""
    from .seckey_cache import ROW_WORDS, SecretKeyCache

    words = np.asarray(jcache._w)
    if words.dtype != np.uint32 or words.ndim != 2 or \
            words.shape[1] != ROW_WORDS:
        raise ValueError(f"secret arena: {words.dtype} {words.shape}, "
                         f"expected uint32 (rows, {ROW_WORDS})")
    if words[0].any():
        raise ValueError("secret arena: row 0 is not the zero scalar")
    cache = SecretKeyCache(jcache.capacity, initial_rows=words.shape[0])
    cache._w = words.copy()
    cache._index = type(jcache._index)(jcache._index)
    cache._free = list(jcache._free)
    cache._next_row = jcache._next_row
    cache.hits, cache.misses = jcache.hits, jcache.misses
    cache.evictions = jcache.evictions
    return cache


def weights_from_jax(rand, device="cpu") -> torch.Tensor:
    """(n, 2) uint32 weight words -> int32 bit patterns, unchanged."""
    return torch.as_tensor(np.ascontiguousarray(rand, dtype=np.uint32)
                           .view(np.int32), device=device)


# --- The KZG path's scalar field ---------------------------------------------

JAX_FR_LIMBS = 20
JAX_FR_RADIX = 1 << (JAX_LIMB_BITS * JAX_FR_LIMBS)   # 2^260


def fr_from_jax(arr, mont: bool = True, device="cpu") -> torch.Tensor:
    """JAX Fr limbs (..., 20) -> port limbs (..., 8) int32, canonical.
    With ``mont`` the input is Montgomery (R = 2^260) and so is the output
    (R = 2^256); otherwise both are plain."""
    from ...kzg.cuda import fr

    arr = np.asarray(arr)
    vals = [v % R_ORDER for v in jax_limbs_to_ints(arr, JAX_FR_LIMBS)]
    if mont:
        vals = [v * pow(JAX_FR_RADIX, -1, R_ORDER) * fr.RADIX % R_ORDER
                for v in vals]
    out = fr.pack(vals, device)
    return to_i32(out.reshape(*arr.shape[:-1], fr.N_LIMBS))


def fr_to_jax(t: torch.Tensor, mont: bool = True) -> np.ndarray:
    """Port Fr limbs (..., 8) -> JAX canonical limbs (..., 20) uint32."""
    from ...kzg.cuda import fr

    vals = fr.unpack(t.cpu())
    if mont:
        vals = [v * fr.INV_RADIX * JAX_FR_RADIX % R_ORDER for v in vals]
    return ints_to_jax_limbs(vals, JAX_FR_LIMBS).reshape(
        *t.shape[:-1], JAX_FR_LIMBS)


def setup_from_jax(jsetup):
    """A JAX KZG ``TrustedSetup`` -> the port's (same [tau]_2 bytes, same
    dev secret)."""
    from ...kzg.setup import TrustedSetup

    return TrustedSetup(g2_monomial_1=bytes(jsetup.g2_monomial_1),
                        dev_tau=jsetup.dev_tau)
