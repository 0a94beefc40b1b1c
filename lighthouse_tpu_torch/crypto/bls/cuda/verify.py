"""Monolithic batch verification: the counterpart of
``lighthouse_tpu/crypto/bls/tpu/verify.py`` and of the jit programs over it,
``tpu/backend.py:98 _verify_batch_kernel`` and ``:106
_verify_batch_multi_kernel``.

    prod_i e([r_i] P_i, H(m_i)) * e(-g1, sum_i [r_i] sig_i) == 1

Two forms of each check:

  * the plain versions ``verify_batch``, ``verify_batch_multi`` and
    ``verify_each``, written from the reference functions in plain PyTorch
    (``.curve``, ``.hash_to_g2``, ``.pairing``), on any device; the tests
    hold the kernel sequences to them;
  * ``verify_batch_kernel`` and ``verify_batch_multi_kernel``, each a
    sequence of the hand-written launches of ``.staged``: k_hash on u,
    k_points (its mask variant for multi), k_pair, and with
    ``check_subgroups`` k_subgroup on every lane, the two verdicts ANDed on
    the card by k_and: one readback.  On CPU tensors the launches are their
    plain versions.

Inputs are the port's tensors: int32 limbs (affine Montgomery points, x =
y = 0 at infinity), bool masks, ``u_plain`` (n, 2, 2, 12) plain
hash-to-field limbs and ``rand`` (n, 2) int32 words of the 64-bit weights.
Padding lanes carry infinity points and zero weights.  Every function
returns a (1,) bool tensor on the inputs' device.
"""
from __future__ import annotations

import torch

from . import curve, fp, hash_to_g2 as h2, pairing, staged, tower
from .curve import F1, F2, Jacobian
from ....runtime.tensors import to_i64


# --- Plain versions ------------------------------------------------------------


def _neg_g1(device):
    gx, gy = curve.neg_g1_affine(device)
    return gx[None], gy[None], torch.zeros(1, dtype=torch.bool, device=device)


def _pair_with_sum(wx, wy, winf, h: Jacobian, s_sum: Jacobian, h_mask=None):
    """The tail of verify_batch: the hashes and the signature sum affine in
    one batch, the closing pair (-g1, sum), one multi-pairing."""
    qx, qy, qinf = curve.to_affine(F2, Jacobian(
        *(torch.cat([a, b[None]]) for a, b in zip(h, s_sum))))
    if h_mask is not None:
        qinf = torch.cat([qinf[:-1] | h_mask, qinf[-1:]])
    gx, gy, ginf = _neg_g1(wx.device)
    ok, _gt = pairing.multi_pairing_is_one(
        torch.cat([wx, gx]), torch.cat([wy, gy]), torch.cat([winf, ginf]),
        qx, qy, qinf)
    return ok


def verify_batch(xp, yp, p_inf, xs, ys, s_inf, u_plain, rand,
                 check_subgroups=True):
    """tpu/verify.py:77 verify_batch in plain PyTorch: one verdict for n
    sets.  Padding lanes have p_inf = s_inf = True."""
    active = ~(p_inf & s_inf)
    pk = curve.from_affine(F1, to_i64(xp), to_i64(yp), p_inf)
    sig = curve.from_affine(F2, to_i64(xs), to_i64(ys), s_inf)
    r = to_i64(rand)
    wp = curve.scalar_mul_dynamic(F1, pk, r, 64)
    ws = curve.scalar_mul_dynamic(F2, sig, r, 64)
    s_sum = curve.sum_reduce(F2, ws)
    h = h2.hash_to_g2(to_i64(u_plain))
    wx, wy, winf = curve.to_affine(F1, wp)
    ok = _pair_with_sum(wx, wy, winf, h, s_sum)
    if check_subgroups:
        ok = ok & (curve.g1_subgroup_check(pk) | ~active).all()
        ok = ok & (curve.g2_subgroup_check(sig) | ~active).all()
    return ok.reshape(1)


def aggregate_points_g1(xs, ys, infs, mask) -> Jacobian:
    """tpu/verify.py:173: (n, k) padded affine pubkeys -> (n,) Jacobian sums
    over the keys whose mask is set."""
    return curve.aggregate_g1(to_i64(xs), to_i64(ys), infs, mask)


def verify_batch_multi(xpk, ypk, ipk, mask, xs, ys, s_inf, u_plain, rand,
                       check_subgroups=True):
    """tpu/verify.py:122 verify_batch_multi in plain PyTorch: the sets'
    pubkeys are (n, k) planes summed under ``mask``; a set with no key or an
    infinity signature is padding."""
    active = mask.any(dim=1) & ~s_inf
    pk = aggregate_points_g1(xpk, ypk, ipk, mask)
    sig = curve.from_affine(F2, to_i64(xs), to_i64(ys), s_inf | ~active)
    r = to_i64(rand)
    wp = curve.scalar_mul_dynamic(F1, pk, r, 64)
    ws = curve.scalar_mul_dynamic(F2, sig, r, 64)
    s_sum = curve.sum_reduce(F2, ws)
    h = h2.hash_to_g2(to_i64(u_plain))
    wx, wy, winf = curve.to_affine(F1, wp)
    ok = _pair_with_sum(wx, wy, winf | ~active, h, s_sum, h_mask=~active)
    if check_subgroups:
        each = curve.from_affine(F1, to_i64(xpk).reshape(-1, fp.N_LIMBS),
                                 to_i64(ypk).reshape(-1, fp.N_LIMBS),
                                 (ipk | ~mask).reshape(-1))
        ok = ok & (curve.g1_subgroup_check(each) | ~mask.reshape(-1)).all()
        ok = ok & (curve.g2_subgroup_check(sig) | ~active).all()
    return ok.reshape(1)


def verify_each(xp, yp, p_inf, xs, ys, s_inf, u_plain, check_subgroups=True):
    """tpu/verify.py:47 verify_each in plain PyTorch: (n,) per-set verdicts
    e(P, H(m)) e(-g1, sig) == 1; an infinity key or signature fails, and
    with ``check_subgroups`` a point outside its subgroup too."""
    n, device = xp.shape[0], xp.device
    hx, hy, hinf = curve.to_affine(F2, h2.hash_to_g2(to_i64(u_plain)))
    gx, gy = curve.neg_g1_affine(device)
    x1, y1 = to_i64(xp), to_i64(yp)
    x2, y2 = to_i64(xs), to_i64(ys)
    f = pairing.miller_loop(
        torch.stack([x1, gx.expand(n, -1)], 1),
        torch.stack([y1, gy.expand(n, -1)], 1),
        torch.stack([p_inf, torch.zeros_like(p_inf)], 1),
        torch.stack([hx, x2], 1), torch.stack([hy, y2], 1),
        torch.stack([hinf, s_inf], 1))
    ok = tower.is_one(pairing.final_exponentiation(
        tower.mul(f[:, 0], f[:, 1])))
    ok = ok & ~p_inf & ~s_inf
    if check_subgroups:
        ok = ok & curve.g1_subgroup_check(curve.from_affine(F1, x1, y1, p_inf))
        ok = ok & curve.g2_subgroup_check(curve.from_affine(F2, x2, y2, s_inf))
    return ok


# --- Kernel sequences ----------------------------------------------------------


def verify_batch_kernel(xp, yp, p_inf, xs, ys, s_inf, u_plain, rand,
                        check_subgroups=False):
    """The counterpart of tpu/backend.py:98 _verify_batch_kernel: k_hash,
    k_points, k_pair, and with ``check_subgroups`` k_subgroup over every
    lane's key and signature (a lane with p_inf and s_inf is padding and
    passes), ANDed by k_and -> (1,) bool."""
    hx, hy, hinf = staged.k_hash(u_plain)
    wx, wy, winf, sx, sy, sinf = staged.k_points(xp, yp, p_inf, xs, ys,
                                                 s_inf, rand)
    ok, _gt = staged.k_pair(wx, wy, winf, hx, hy, hinf, sx, sy, sinf)
    if not check_subgroups:
        return ok
    active = ~(p_inf & s_inf)
    _lanes, sub_ok = staged.k_subgroup(xp, yp, p_inf, active, xs, ys, s_inf,
                                       active)
    return staged.k_and(ok, sub_ok)


def verify_batch_multi_kernel(xpk, ypk, ipk, mask, xs, ys, s_inf, u_plain,
                              rand, check_subgroups=False):
    """The counterpart of tpu/backend.py:106 _verify_batch_multi_kernel:
    k_hash, k_points' mask variant, k_pair, and with ``check_subgroups``
    k_subgroup over all n k keys (those under the mask) and the active sets'
    signatures, ANDed by k_and -> (1,) bool."""
    n, k = mask.shape
    active = mask.any(dim=1) & ~s_inf
    hx, hy, hinf = staged.k_hash(u_plain)
    hinf = hinf | ~active
    wx, wy, winf, sx, sy, sinf = staged.k_points(xpk, ypk, ipk, xs, ys,
                                                 s_inf, rand, mask=mask)
    ok, _gt = staged.k_pair(wx, wy, winf, hx, hy, hinf, sx, sy, sinf)
    if not check_subgroups:
        return ok
    L = fp.N_LIMBS
    _lanes, sub_ok = staged.k_subgroup(
        xpk.reshape(n * k, L), ypk.reshape(n * k, L), ipk.reshape(n * k),
        mask.reshape(n * k), xs, ys, s_inf, active)
    return staged.k_and(ok, sub_ok)
