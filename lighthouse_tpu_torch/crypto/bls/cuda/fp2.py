"""Fp2 = Fp[u] / (u^2 + 1): plain PyTorch versions.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/fp2.py``.  Layout
``(..., 2, 12)``: axis -2 holds (c0, c1), Montgomery limbs (see .fp), fully
reduced.  Every op broadcasts over leading dims, so a caller that stacks K
independent Fp2 products along a batch axis pays for one ``fp.mont_mul``
call, not K.  The plain versions count calls, not products: a product is
schoolbook (four Fp products, one mont_mul call and one add_or_sub), where
the CUDA header uses Karatsuba (three products).
"""
from __future__ import annotations

import builtins

import torch

from ..constants import P
from . import fp

_INV2_MONT = builtins.pow(2, P - 2, P) * fp.R_MOD_P % P  # 1/2, Montgomery


def make(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    return torch.stack([c0, c1], dim=-2)


def c0(x):
    return x[..., 0, :]


def c1(x):
    return x[..., 1, :]


def pack_mont(pairs, device="cpu") -> torch.Tensor:
    """[(c0, c1)] ints -> (n, 2, 12) Montgomery limbs."""
    flat = [v for pr in pairs for v in pr]
    return fp.pack_mont(flat, device).reshape(len(pairs), 2, fp.N_LIMBS)


def unpack_mont(x: torch.Tensor) -> list:
    v = fp.unpack_mont(x)
    return [(v[i], v[i + 1]) for i in range(0, len(v), 2)]


def const_mont(pair, device) -> torch.Tensor:
    return pack_mont([(pair[0] % P, pair[1] % P)], device)[0]


add = fp.add
sub = fp.sub
neg = fp.neg


def select(mask, x, y):
    return torch.where(mask[..., None, None], x, y)


def is_zero(x):
    return (x == 0).all(-1).all(-1)


def eq(x, y):
    return (x == y).all(-1).all(-1)


def zeros(shape, device):
    return torch.zeros(*shape, 2, fp.N_LIMBS, dtype=fp.DTYPE, device=device)


def one(shape, device):
    return make(fp.one(shape, device), fp.zeros(shape, device))


def conj(x):
    return make(c0(x), fp.neg(c1(x)))


_MINUS_PLUS = torch.tensor([True, False])


def _minus_plus(device):
    return _MINUS_PLUS.to(device)


def mul_by_xi(x):
    """x * (1 + u) = (c0 - c1) + (c0 + c1) u."""
    a, b = c0(x), c1(x)
    return fp.add_or_sub(torch.stack([a, a], dim=-2),
                         torch.stack([b, b], dim=-2), _minus_plus(x.device))


def mul(x, y):
    """Schoolbook: four Fp products in one stacked mont_mul, then
    (a0 b0 - a1 b1, a0 b1 + a1 b0) in one add_or_sub."""
    x, y = torch.broadcast_tensors(x, y)
    a0, a1, b0, b1 = c0(x), c1(x), c0(y), c1(y)
    t = fp.mont_mul(torch.stack([a0, a0, a1, a1], dim=-2),
                    torch.stack([b0, b1, b1, b0], dim=-2))
    return fp.add_or_sub(t[..., 0:2, :], t[..., 2:4, :],
                         _minus_plus(x.device))


def sqr(x):
    """(a0^2 - a1^2) + 2 a0 a1 u."""
    a0, a1 = c0(x), c1(x)
    t = fp.mont_mul(torch.stack([a0, a0, a1, a0], dim=-2),
                    torch.stack([a0, a1, a1, a1], dim=-2))
    return fp.add_or_sub(t[..., 0:2, :], t[..., 2:4, :],
                         _minus_plus(x.device))


def mul_fp(x, s):
    """Fp2 times an Fp scalar s (..., 12)."""
    return fp.mont_mul(x, s.unsqueeze(-2))


def inv(x):
    """1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); inv(0) = 0."""
    sq = fp.mont_mul(x, x)
    ninv = fp.inv(fp.add(sq[..., 0, :], sq[..., 1, :]))
    t = fp.mont_mul(x, ninv.unsqueeze(-2))
    return make(t[..., 0, :], fp.neg(t[..., 1, :]))


def sqrt(a):
    """Square root by the norm trick (the same algorithm as the TPU
    package's ``fp2.sqrt``, so both return the same root).

    For p = 3 (mod 4): n = a0^2 + a1^2, s = sqrt(n), d1 = (a0 + s)/2; one of
    d1 and d1 - s is a square, chosen by chi(d1) from t = d1^((p-3)/4).
    Returns ``(root, ok)``; ok re-squares the root against a."""
    device = a.device
    a0, a1 = c0(a), c1(a)
    sq = fp.mont_mul(a, a)
    n = fp.add(sq[..., 0, :], sq[..., 1, :])
    tn = fp.pow(n, (P - 3) // 4)
    s = fp.mont_mul(tn, n)
    inv2 = fp.const(_INV2_MONT, device)
    h = fp.mont_mul(torch.stack([fp.add_lazy(a0, s), a1], dim=-2),
                    inv2)
    d1, a1h = h[..., 0, :], h[..., 1, :]
    tds = fp.pow(torch.stack([d1, s], dim=-2), (P - 3) // 4)
    td, ts = tds[..., 0, :], tds[..., 1, :]
    c = fp.mont_mul(td, d1)
    q = fp.mont_mul(torch.stack([c, ts, a1h], dim=-2),
                    torch.stack([td, s, td], dim=-2))
    chi, ws, a1h_td = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    good = fp.eq(chi, fp.one(chi.shape[:-1], device))
    x0 = fp.select(good, c, a1h_td)
    x1 = fp.select(good, a1h_td, fp.neg(c))
    corner = fp.is_zero(d1)
    x0 = fp.select(corner, torch.zeros_like(x0), x0)
    x1 = fp.select(corner, ws, x1)
    root = make(x0, x1)
    return root, eq(sqr(root), a)


def sgn0_plain(x_plain):
    """RFC 9380 sgn0 (m = 2) of a canonical NON-Montgomery element."""
    a, b = c0(x_plain), c1(x_plain)
    zero0 = (a == 0).all(-1)
    return ((a[..., 0] & 1) == 1) | (zero0 & ((b[..., 0] & 1) == 1))
