"""Optimal-ate pairing for BLS12-381: plain PyTorch versions.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/pairing.py``: a Miller loop
per pair lane, the product of the lane values, one final exponentiation.

Lines use Jacobian T on the twist and affine P, scaled by factors of Fp2
(which the easy part of the final exponentiation kills) into the sparse
class a v^2 + b w + c v w of ``tower.mul_by_line``:

  doubling  (scale 2YZ^3):  a = 2YZ^3 yp,  b = 3X^3 - 2Y^2,  c = -3X^2Z^2 xp
  addition  (N = yq Z^3 - Y, D = xq Z^2 - X, scale ZD):
            a = ZD yp,  b = N xq - ZD yq,  c = -N xp

The loop runs over the bits of |x| = 0xd201000000010000 below the leading
one; x < 0, so f is conjugated at the end.  The final exponentiation is
exact, so ``pairing`` equals ``pairing_ref.pairing`` coefficient for
coefficient:

  easy part  m = f^((p^6 - 1)(p^2 + 1))
  hard part  m^(e1 (x + p)(x^2 + p^2 - 1) + 1),  e1 = (x - 1)^2 / 3
"""
from __future__ import annotations

import torch

from ..constants import P, R, X as BLS_X
from . import curve, fp, fp2, tower
from .curve import F2, Jacobian

ABS_X = -BLS_X
X_BITS = [int(b) for b in bin(ABS_X)[3:]]   # MSB-first, below the leading 1
E1 = (BLS_X - 1) ** 2 // 3
assert (BLS_X - 1) ** 2 % 3 == 0
assert E1 * (BLS_X + P) * (BLS_X**2 + P**2 - 1) + 1 == (P**4 - P**2 + 1) // R


def doubling_step(t: Jacobian, xp, yp):
    """Tangent line at T evaluated at P, and 2T."""
    X, Y, Z = t
    X2, Y2, Z2, YZ = curve.muls(F2, [X, Y, Z, Y], [X, Y, Z, Z])
    X3, X2Z2, YZ3 = curve.muls(F2, [X2, X2, YZ], [X, Z2, Z2])
    a = fp2.mul_fp(YZ3, yp)
    a = fp2.add(a, a)
    b = fp2.sub(fp2.add(fp2.add(X3, X3), X3), fp2.add(Y2, Y2))
    c3 = fp2.add(fp2.add(X2Z2, X2Z2), X2Z2)
    c = fp2.neg(fp2.mul_fp(c3, xp))
    return (a, b, c), curve.double(F2, t)


def addition_step(t: Jacobian, xq, yq, xp, yp):
    """Line through T and affine Q evaluated at P, and T + Q (T != +-Q:
    T is m Q with 2 <= m < |x|, far below the order r)."""
    X, Y, Z = t
    (Z2,) = curve.muls(F2, [Z], [Z])
    Z3, xqZ2 = curve.muls(F2, [Z, xq], [Z2, Z2])
    (yqZ3,) = curve.muls(F2, [yq], [Z3])
    N = fp2.sub(yqZ3, Y)
    D = fp2.sub(xqZ2, X)
    ZD, Nxq = curve.muls(F2, [Z, N], [D, xq])
    (yqZD,) = curve.muls(F2, [yq], [ZD])
    b = fp2.sub(Nxq, yqZD)
    a = fp2.mul_fp(ZD, yp)
    c = fp2.neg(fp2.mul_fp(N, xp))
    one = fp2.one(xq.shape[:-2], xq.device)
    t_next = curve.add(F2, t, Jacobian(xq, yq, one))
    return (a, b, c), t_next


def miller_loop(xp, yp, p_inf, xq, yq, q_inf):
    """Per-lane Miller values f_i, (..., 2, 3, 2, 12).  Lanes where either
    point is infinity give f = 1 (generators stand in while computing)."""
    device = xp.device
    inactive = p_inf | q_inf
    g1, g2 = curve.g1_generator(device), curve.g2_generator(device)
    xp = fp.select(inactive, g1.x.expand_as(xp), xp)
    yp = fp.select(inactive, g1.y.expand_as(yp), yp)
    xq = fp2.select(inactive, g2.x.expand_as(xq), xq)
    yq = fp2.select(inactive, g2.y.expand_as(yq), yq)
    batch = xp.shape[:-1]
    f = tower.one(batch, device)
    t = Jacobian(xq, yq, fp2.one(batch, device))
    for bit in X_BITS:
        f = tower.sqr(f)
        (a, b, c), t = doubling_step(t, xp, yp)
        f = tower.mul_by_line(f, a, b, c)
        if bit:
            (a, b, c), t = addition_step(t, xq, yq, xp, yp)
            f = tower.mul_by_line(f, a, b, c)
    f = tower.conj(f)
    return tower.select(inactive, tower.one(batch, device), f)


def product_reduce(f):
    """prod_i f_i over the leading axis: halving tree, padded with 1."""
    n = f.shape[0]
    if n == 0:
        return tower.one((), f.device)
    n_pad = 1 << (n - 1).bit_length()
    if n_pad != n:
        f = torch.cat([f, tower.one((n_pad - n,), f.device)])
    while f.shape[0] > 1:
        f = tower.mul(f[0::2], f[1::2])
    return f[0]


def final_exponentiation(f):
    """f^((p^12 - 1) / r), exact."""
    m = tower.mul(tower.conj(f), tower.inv(f))            # f^(p^6 - 1)
    m = tower.mul(tower.frobenius(m, 2), m)               # ^(p^2 + 1)
    a = tower.cyclotomic_pow(m, E1)
    b = tower.mul(tower.conj(tower.cyclotomic_pow(a, ABS_X)),
                  tower.frobenius(a, 1))                  # a^(x + p)
    c = tower.mul(
        tower.cyclotomic_pow(tower.cyclotomic_pow(b, ABS_X), ABS_X),
        tower.mul(tower.frobenius(b, 2), tower.conj(b)))  # b^(x^2+p^2-1)
    return tower.mul(c, m)


def multi_pairing_is_one(xp, yp, p_inf, xq, yq, q_inf):
    """prod_i e(P_i, Q_i) == 1 over the leading pairs axis; also returns
    the GT value (Montgomery)."""
    gt = final_exponentiation(
        product_reduce(miller_loop(xp, yp, p_inf, xq, yq, q_inf)))
    return tower.is_one(gt), gt


def pairing(xp, yp, p_inf, xq, yq, q_inf):
    """e(P, Q) per lane; exact GT element (Montgomery)."""
    return final_exponentiation(miller_loop(xp, yp, p_inf, xq, yq, q_inf))
