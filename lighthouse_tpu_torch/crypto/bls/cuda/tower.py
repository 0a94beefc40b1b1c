"""Fp6 / Fp12 tower: plain PyTorch versions.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/tower.py``, on the tower of
``..fields_ref`` (so coefficients compare with ``pairing_ref`` directly):

    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u     layout (..., 3, 2, 12)
    Fp12 = Fp6[w] / (w^2 - v)                   layout (..., 2, 3, 2, 12)

Each op gathers its independent products into one stacked ``fp.mont_mul``
call and its additions into one ``fp.linear``; the CUDA header computes
the same values one product at a time (Karatsuba).
"""
from __future__ import annotations

import torch

from ..constants import P
from . import fp, fp2

# --- Fp6 ----------------------------------------------------------------------


def f6(b0, b1, b2):
    return torch.stack([b0, b1, b2], dim=-3)


def f6_b(x, j):
    return x[..., j, :, :]


def f6_zeros(shape, device):
    return torch.zeros(*shape, 3, 2, fp.N_LIMBS, dtype=fp.DTYPE,
                       device=device)


def f6_mul_by_v(x):
    """(b0 + b1 v + b2 v^2) v = xi b2 + b0 v + b1 v^2."""
    return f6(fp2.mul_by_xi(f6_b(x, 2)), f6_b(x, 0), f6_b(x, 1))


def f6_mul(x, y):
    """Karatsuba-3: six Fp2 products in one stacked fp2.mul."""
    x, y = torch.broadcast_tensors(x, y)
    a0, a1, a2 = f6_b(x, 0), f6_b(x, 1), f6_b(x, 2)
    b0, b1, b2 = f6_b(y, 0), f6_b(y, 1), f6_b(y, 2)
    sums = fp2.add(torch.stack([a1, a0, a0, b1, b0, b0], dim=-3),
                   torch.stack([a2, a1, a2, b2, b1, b2], dim=-3))
    lhs = torch.cat([x, sums[..., 0:3, :, :]], dim=-3)
    rhs = torch.cat([y, sums[..., 3:6, :, :]], dim=-3)
    t = fp2.mul(lhs, rhs)
    t0, t1, t2 = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    # c0 = xi(u12 - t1 - t2) + t0; c1 = u01 - t0 - t1 + xi t2;
    # c2 = u02 - t0 - t2 + t1
    d = fp2.sub(fp2.sub(t[..., 3:6, :, :], torch.stack([t1, t0, t0], dim=-3)),
                torch.stack([t2, t1, t2], dim=-3))
    xi = fp2.mul_by_xi(torch.stack([f6_b(d, 0), t2], dim=-3))
    return fp2.add(torch.stack([xi[..., 0, :, :], f6_b(d, 1), f6_b(d, 2)],
                               dim=-3),
                   torch.stack([t0, xi[..., 1, :, :], t1], dim=-3))


def f6_inv(x):
    a0, a1, a2 = f6_b(x, 0), f6_b(x, 1), f6_b(x, 2)
    p = fp2.mul(torch.stack([a0, a1, a2, a1, a0, a0], dim=-3),
                torch.stack([a0, a1, a2, a2, a1, a2], dim=-3))
    s0, s1, s2 = p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :]
    a12, a01, a02 = p[..., 3, :, :], p[..., 4, :, :], p[..., 5, :, :]
    xi = fp2.mul_by_xi(torch.stack([a12, s2], dim=-3))
    t = fp2.sub(torch.stack([s0, xi[..., 1, :, :], s1], dim=-3),
                torch.stack([xi[..., 0, :, :], a01, a02], dim=-3))
    t0, t1, t2 = f6_b(t, 0), f6_b(t, 1), f6_b(t, 2)
    q = fp2.mul(torch.stack([a0, a2, a1], dim=-3), t)
    d = fp2.add(q[..., 0, :, :],
                fp2.mul_by_xi(fp2.add(q[..., 1, :, :], q[..., 2, :, :])))
    di = fp2.inv(d)
    return fp2.mul(t, di.unsqueeze(-3))


# --- Fp12 ---------------------------------------------------------------------


def f12(c0, c1):
    return torch.stack([c0, c1], dim=-4)


def c0(x):
    return x[..., 0, :, :, :]


def c1(x):
    return x[..., 1, :, :, :]


def zeros(shape, device):
    return torch.zeros(*shape, 2, 3, 2, fp.N_LIMBS, dtype=fp.DTYPE,
                       device=device)


def one(shape, device):
    z = zeros(shape, device)
    z[..., 0, 0, 0, :] = fp.one(shape, device)
    return z


# Fp12 products in the w-power basis: coefficient i = 2j + c of w^i sits at
# (c, j) of the (2, 3, 2) layout, w^6 = xi.  A product of Fp12 elements is
# the 4 raw Fp products of every pair of Fp2 coefficients (one stacked
# mont_mul) and one fp.linear that folds them into the 12 outputs (Fp2
# products a0 b0 - a1 b1, a0 b1 + a1 b0; a factor xi where i + k >= 6).

_TABLES: dict = {}


def _flat(i: int, comp: int) -> int:
    return (i % 2) * 6 + (i // 2) * 2 + comp


def _product_table(x_ws, y_ws, device):
    key = (tuple(x_ws), tuple(y_ws), device)
    if key not in _TABLES:
        lhs, rhs = [], []
        rows = [dict() for _ in range(12)]

        def acc(row, terms):
            for t, c in terms.items():
                row[t] = row.get(t, 0) + c

        for i in x_ws:
            for k in y_ws:
                b = len(lhs)
                for ca, cb in ((0, 0), (1, 1), (0, 1), (1, 0)):
                    lhs.append(_flat(i, ca))
                    rhs.append(_flat(k, cb))
                r0 = {b: 1, b + 1: -1}
                r1 = {b + 2: 1, b + 3: 1}
                m = i + k
                if m >= 6:                       # w^6 = xi = 1 + u
                    m -= 6
                    r0, r1 = ({**r0, b + 2: -1, b + 3: -1},
                              {**r0, b + 2: 1, b + 3: 1})
                acc(rows[_flat(m, 0)], r0)
                acc(rows[_flat(m, 1)], r1)
        rows = [{t: c for t, c in r.items() if c} for r in rows]
        _TABLES[key] = (torch.tensor(lhs, device=device),
                        torch.tensor(rhs, device=device), rows)
    return _TABLES[key]


def _mul_w(x, y, y_ws):
    """x * y where y's nonzero w-coefficients are y_ws."""
    x, y = torch.broadcast_tensors(x, y)
    lhs_i, rhs_i, rows = _product_table(range(6), y_ws, x.device)
    xf = x.reshape(*x.shape[:-4], 12, fp.N_LIMBS)
    yf = y.reshape(*y.shape[:-4], 12, fp.N_LIMBS)
    prods = fp.mont_mul(xf.index_select(-2, lhs_i), yf.index_select(-2, rhs_i))
    return fp.linear(prods, rows).reshape(x.shape)


def mul(x, y):
    """Fp12 product: 144 Fp products in one mont_mul, one fp.linear."""
    return _mul_w(x, y, range(6))


def sqr(x):
    return mul(x, x)


def conj(x):
    """The p^6-Frobenius (a + b w) -> (a - b w); the inverse in the
    cyclotomic subgroup."""
    return f12(c0(x), fp.neg(c1(x)))


def inv(x):
    """1/(a + b w) = (a - b w) / (a^2 - v b^2); inv(0) = 0."""
    a0, a1 = c0(x), c1(x)
    s = f6_mul(torch.stack([a0, a1], dim=-4), torch.stack([a0, a1], dim=-4))
    d = f6_inv(fp.sub(s[..., 0, :, :, :], f6_mul_by_v(s[..., 1, :, :, :])))
    r = f6_mul(torch.stack([a0, a1], dim=-4), d.unsqueeze(-4))
    return f12(r[..., 0, :, :, :], fp.neg(r[..., 1, :, :, :]))


def eq(x, y):
    return (x == y).flatten(-4).all(-1)


def is_one(x):
    return eq(x, one(x.shape[:-4], x.device))


def select(mask, x, y):
    return torch.where(mask[..., None, None, None, None], x, y)


def mul_by_line(f, a, b, c):
    """f * (a v^2 + b w + c v w), a, b, c in Fp2 (..., 2, 12): the line is
    sparse in the w-power basis (v^2 = w^4, w, v w = w^3), so 72 Fp
    products and one fp.linear."""
    shape = torch.broadcast_shapes(f.shape[:-4], a.shape[:-2])
    line = zeros(shape, f.device)
    line[..., 0, 2, :, :] = a                  # v^2 = w^4: (c=0, j=2)
    line[..., 1, 0, :, :] = b                  # w:         (c=1, j=0)
    line[..., 1, 1, :, :] = c                  # v w = w^3: (c=1, j=1)
    return _mul_w(f.expand(*shape, *f.shape[-4:]), line, (1, 3, 4))


# --- Frobenius ----------------------------------------------------------------
#
# In the w-power basis f = sum g_i w^i (g_i in Fp2, i = 2j + c for (Cc, Bj)):
#   f^(p^k) = sum conj^k(g_i) * GAMMA[k][i] * w^i,
#   GAMMA[k][i] = xi^(i (p^k - 1) / 6)  (computed, not hard-coded).


def _fp2_pow_int(c0_: int, c1_: int, e: int):
    r0, r1 = 1, 0
    b0, b1 = c0_ % P, c1_ % P
    while e:
        if e & 1:
            r0, r1 = (r0 * b0 - r1 * b1) % P, (r0 * b1 + r1 * b0) % P
        b0, b1 = (b0 * b0 - b1 * b1) % P, (2 * b0 * b1) % P
        e >>= 1
    return r0, r1


def gamma_ints(k: int) -> list:
    """[[(c0, c1)] * 3] * 2: GAMMA[k][2j + c] at (c, j), plain ints."""
    return [[_fp2_pow_int(1, 1, (2 * j + comp) * (P**k - 1) // 6)
             for j in range(3)] for comp in range(2)]


_GAMMA: dict = {}


def _gamma(k: int, device) -> torch.Tensor:
    key = (k, str(device))
    if key not in _GAMMA:
        g = gamma_ints(k)
        flat = [pr for comp in g for pr in comp]
        _GAMMA[key] = fp2.pack_mont(flat, device).reshape(2, 3, 2,
                                                           fp.N_LIMBS)
    return _GAMMA[key]


def frobenius(x, k: int):
    """x^(p^k) for k in {1, 2, 3}."""
    assert k in (1, 2, 3)
    if k % 2 == 1:
        x = torch.stack([x[..., 0, :], fp.neg(x[..., 1, :])], dim=-2)
    return fp2.mul(x, _gamma(k, x.device))


# --- Cyclotomic squaring (final exponentiation hard part) ------------------


def cyclotomic_sqr(x):
    """Squaring in the cyclotomic subgroup.  The CUDA header uses the
    Granger-Scott formula (9 Fp2 squarings), which equals the square on the
    subgroup; the plain version computes the square itself (one stacked
    mont_mul and one fp.linear, fewer PyTorch calls than the formula)."""
    return sqr(x)


def cyclotomic_pow(x, e: int):
    """x^e (static e > 0) for x in the cyclotomic subgroup: LSB-first square
    and multiply with cyclotomic squarings."""
    res = None
    base = x
    while e:
        if e & 1:
            res = base if res is None else mul(res, base)
        e >>= 1
        if e:
            base = cyclotomic_sqr(base)
    return res

