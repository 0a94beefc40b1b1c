"""BLS12-381 scalar field Fr on 8 x 32-bit limbs: plain PyTorch versions.

Counterpart of ``lighthouse_tpu/crypto/kzg/fr.py``.  An element is a tensor
``(..., 8)`` of little-endian 32-bit limbs held in ``int64``, Montgomery
form with R = 2^256, and fully reduced (< r) after every op.  The CUDA
kernel (``csrc/fr.cuh``) uses the same limbs as ``uint32``, so a kernel's
output and its plain version compare limb for limb.

None of the TPU representation survives: 13-bit limbs, the 2^260 radix and
the lazy "loose < 34 r" bounds exist there because the TPU has no 64-bit
integer datapath.  r < 2^255 leaves 2^256 / r ~ 2.2 of headroom, too little
for lazy bounds, and none are needed: every op here ends canonical.

The products share the digit-split Montgomery product and the carry passes
of the base field (``crypto/bls/cuda/fp.py``): the limbs split into 16-bit
digits (one limb = 2 digits, 16 digits in all, as fp's 24-bit ones), a
digit product is < 2^33 and a column of 16 stays far below 2^53.  With
canonical inputs a * b < r^2 < 0.46 R r, so each product comes out < 1.46 r
and one conditional subtraction makes it canonical.  Because 4 r^2 > R r, a
chain of products cannot stay unreduced between steps as fp's ``pow`` does:
``pow`` reduces after every product.

Every function broadcasts over leading dimensions.
"""
from __future__ import annotations

import numpy as np
import torch

from ...bls.constants import R as R_ORDER
from ...bls.cuda import fp
from ...bls.cuda.fp import carry_exact, pick_reduced

N_LIMBS = 8
LIMB_BITS = 32
MASK = (1 << LIMB_BITS) - 1
R_BITS = 256
RADIX = 1 << R_BITS                 # Montgomery radix
RADIX_MOD_R = RADIX % R_ORDER
RADIX2_MOD_R = RADIX * RADIX % R_ORDER
INV_RADIX = pow(RADIX, -1, R_ORDER)

_DIGIT_BITS = 16
_N_DIGITS = 2 * N_LIMBS
_DMASK = (1 << _DIGIT_BITS) - 1
_NPRIME = (-pow(R_ORDER, -1, RADIX)) % RADIX

DTYPE = torch.int64

# --- Host packing ------------------------------------------------------------


def int_to_limbs(v: int) -> list:
    assert 0 <= v < RADIX
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)]


def limbs_to_int(limbs) -> int:
    return sum(int(x) << (LIMB_BITS * i) for i, x in enumerate(limbs))


def ints_to_limbs(vals) -> np.ndarray:
    """ints in [0, 2^256) -> (len, 8) uint32 limbs in one pass."""
    raw = b"".join(int(v).to_bytes(4 * N_LIMBS, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32).reshape(
        len(vals), N_LIMBS)


def mont_ints_to_limbs(vals) -> np.ndarray:
    """ints -> (len, 8) uint32 Montgomery limbs of each value mod r."""
    return ints_to_limbs([v % R_ORDER * RADIX_MOD_R % R_ORDER for v in vals])


def pack(vals, device="cpu") -> torch.Tensor:
    """ints -> (len, 8) int64 limbs of each value mod r."""
    limbs = ints_to_limbs([v % R_ORDER for v in vals]).astype(np.int64)
    return torch.from_numpy(limbs).to(device)


def pack_mont(vals, device="cpu") -> torch.Tensor:
    return pack([v % R_ORDER * RADIX_MOD_R for v in vals], device)


def unpack(t: torch.Tensor) -> list:
    """(..., 8) limbs (any integer dtype holding 32-bit values) -> flat
    list of ints."""
    rows = (t.to(torch.int64) & MASK).reshape(-1, N_LIMBS).tolist()
    return [limbs_to_int(r) for r in rows]


def unpack_mont(t: torch.Tensor) -> list:
    return [v * INV_RADIX % R_ORDER for v in unpack(t)]


def const(v: int, device) -> torch.Tensor:
    """One element (8,) with the limbs of v on `device`."""
    return torch.tensor(int_to_limbs(v), dtype=DTYPE, device=device)


_CONSTS: dict = {}


def _c(name: str, device) -> torch.Tensor:
    key = (name, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        digits = lambda v: torch.tensor(  # noqa: E731
            [(v >> (_DIGIT_BITS * i)) & _DMASK for i in range(_N_DIGITS)],
            dtype=DTYPE, device=device)
        t = {
            "r": lambda: const(R_ORDER, device),
            "r16": lambda: digits(R_ORDER),
            "nr16": lambda: digits(_NPRIME),
            "one": lambda: const(RADIX_MOD_R, device),
            "r2": lambda: const(RADIX2_MOD_R, device),
            "carry_w": lambda: torch.tensor(
                [2.0 ** (_DIGIT_BITS * j - R_BITS) for j in range(_N_DIGITS)],
                dtype=torch.float64, device=device),
        }[name]()
        _CONSTS[key] = t
    return t


# --- Limb <-> digit conversion ----------------------------------------------


def _to_digits(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) 32-bit limbs -> (..., 16) 16-bit digits."""
    return torch.stack([a & _DMASK, a >> _DIGIT_BITS], dim=-1).flatten(-2)


def _from_digits(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) normalized 16-bit digits -> (..., 8) 32-bit limbs."""
    return x[..., 0::2] | (x[..., 1::2] << _DIGIT_BITS)


def _mont_canonical_digits(ad: torch.Tensor, bd: torch.Tensor):
    """Montgomery product of two canonical elements in digit form ->
    canonical normalized digits."""
    d = ad.device
    hi = fp.mont_digits(ad, bd, _c("r16", d), _c("nr16", d), _c("carry_w", d),
                        _DIGIT_BITS)
    return pick_reduced(hi, hi - _c("r16", d), _DIGIT_BITS, start=3)


# --- Field ops ---------------------------------------------------------------


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod r for canonical a, b; the output is canonical."""
    a, b = torch.broadcast_tensors(a, b)
    ad, bd = _to_digits(torch.stack([a, b]))
    return _from_digits(_mont_canonical_digits(ad, bd))


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    return pick_reduced(s, s - _c("r", s.device), LIMB_BITS)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    st = carry_exact(torch.stack([d, d + _c("r", d.device)]), LIMB_BITS)
    neg_ = (st[0][..., -1] < 0).unsqueeze(-1)
    return torch.where(neg_, st[1], st[0])


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """mask ? a : b, mask over the batch dims."""
    return torch.where(mask.unsqueeze(-1), a, b)


def one(shape, device) -> torch.Tensor:
    """1 in Montgomery form, broadcast to shape."""
    return _c("one", device).expand(*shape, N_LIMBS).clone()


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical plain -> Montgomery."""
    return mont_mul(a, _c("r2", a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    o = torch.zeros_like(a)
    o[..., 0] = 1
    return mont_mul(a, o)


def pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent e >= 0: 4-bit fixed windows, MSB first,
    in digit form, reduced after every product."""
    if e == 0:
        return one(a.shape[:-1], a.device)
    ad = _to_digits(a)
    table = [None, ad]
    for _ in range(14):
        table.append(_mont_canonical_digits(table[-1], ad))
    digits = []
    while e:
        digits.append(e & 15)
        e >>= 4
    out = table[digits[-1]]
    for d in reversed(digits[:-1]):
        for _ in range(4):
            out = _mont_canonical_digits(out, out)
        if d:
            out = _mont_canonical_digits(out, table[d])
    return _from_digits(out)


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(r-2): Fermat inversion; inv(0) = 0."""
    return pow(a, R_ORDER - 2)


def inv_many(a: torch.Tensor) -> torch.Tensor:
    """Batched inversion over all leading dims by a product tree: three
    products an element and one Fermat inversion of the root.  inv(0) = 0
    lane by lane (a zero lane enters the tree as one)."""
    shape = a.shape[:-1]
    flat = a.reshape(-1, N_LIMBS)
    n = flat.shape[0]
    if n == 0:
        return a.clone()
    zero = is_zero(flat)
    flat = select(zero, one((n,), a.device), flat)
    levels = [flat]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        if cur.shape[0] % 2:
            cur = torch.cat([cur, one((1,), a.device)])
        levels[-1] = cur
        levels.append(mont_mul(cur[0::2], cur[1::2]))
    inv_cur = inv(levels[-1])
    for lvl in reversed(levels[:-1]):
        # the inverse of a pair's product times one of the pair is the
        # inverse of the other (a padding entry above is dropped)
        pairs = inv_cur[:lvl.shape[0] // 2].repeat_interleave(2, dim=0)
        swapped = lvl.reshape(-1, 2, N_LIMBS).flip(1).reshape(-1, N_LIMBS)
        inv_cur = mont_mul(pairs, swapped)
    out = select(zero, torch.zeros_like(flat), inv_cur[:n])
    return out.reshape(*shape, N_LIMBS)
