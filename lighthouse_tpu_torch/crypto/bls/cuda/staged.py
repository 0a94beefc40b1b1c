"""The four kernels of batch verification and the pipelines that drive them.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/staged.py``:

  k_xmd     32-byte signing roots        -> (u0, u1) hash-to-field limbs
  k_hash    (u0, u1)                     -> affine H(m)
  k_points  pubkeys, signatures, weights -> affine [r_i] P_i, sum [r_i] sig_i
            (with a (n, k) mask: sums k pubkeys a set first)
  k_pair    all affine pairs             -> verdict (and the GT value)

Each wrapper checks device, dtype, shape and contiguity, launches its CUDA
kernel (``csrc/k_*.cu``) for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it runs the kernel's plain PyTorch
version (``*_plain``, also callable on CUDA tensors to compare).  A CUDA
tensor never reaches a plain version through a wrapper, and a failed build
or launch raises.

Tensor conventions at the wrappers: limbs are ``int32`` holding the uint32
limb bit patterns (``(..., 12)``, Montgomery unless noted), masks are
``bool``, weights are ``(n, 2)`` int32 little-endian words of the 64-bit
weight.  Subgroup checks happen when keys and signatures are deserialized
(the api layer), as in the TPU package.
"""
from __future__ import annotations

import torch

from . import curve, fp, fp2, hash_to_g2 as h2, pairing
from .curve import F1, F2

_M32 = 0xFFFFFFFF


def to_i64(t: torch.Tensor) -> torch.Tensor:
    """int32 limb bit patterns -> int64 non-negative limbs."""
    return t.to(torch.int64) & _M32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 limbs in [0, 2^32) -> int32 bit patterns."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _on_cpu(device: torch.device) -> bool:
    """True for the CPU (the plain version runs), False for a CUDA device
    (the kernel launches); anything else is refused."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


# --- k_xmd ---------------------------------------------------------------------


def k_xmd_plain(msg_words: torch.Tensor) -> torch.Tensor:
    return to_i32(h2.hash_to_field_device(to_i64(msg_words)))


def k_xmd(msg_words: torch.Tensor) -> torch.Tensor:
    """(n, 8) big-endian words of 32-byte roots -> (n, 2, 2, 12) plain
    limbs of (u0, u1).  Replaces tpu/staged.py:58 k_xmd."""
    n, device = msg_words.shape[0], msg_words.device
    _check("k_xmd msg_words", msg_words, (n, 8), torch.int32, device)
    if _on_cpu(device):
        return k_xmd_plain(msg_words)
    from ....runtime import build

    out = _empty((n, 2, 2, fp.N_LIMBS), torch.int32, device)
    build.call("k_xmd", "k_xmd_launch", msg_words, out, n)
    k_xmd.launches += 1
    return out


k_xmd.launches = 0


# --- k_hash --------------------------------------------------------------------


def k_hash_plain(u_plain: torch.Tensor):
    x, y, inf = h2.hash_to_g2_affine(to_i64(u_plain))
    return to_i32(x), to_i32(y), inf


def k_hash(u_plain: torch.Tensor):
    """(n, 2, 2, 12) plain (u0, u1) -> affine H(m): hx, hy (n, 2, 12),
    hinf (n,).  Replaces tpu/staged.py:51 k_hash."""
    n, device = u_plain.shape[0], u_plain.device
    _check("k_hash u_plain", u_plain, (n, 2, 2, fp.N_LIMBS), torch.int32,
           device)
    if _on_cpu(device):
        return k_hash_plain(u_plain)
    from ....runtime import build

    hx = _empty((n, 2, fp.N_LIMBS), torch.int32, device)
    hy = _empty((n, 2, fp.N_LIMBS), torch.int32, device)
    hinf = _empty((n,), torch.bool, device)
    build.call("k_hash", "k_hash_launch", u_plain, hx, hy, hinf, n)
    k_hash.launches += 1
    return hx, hy, hinf


k_hash.launches = 0


# --- k_points ------------------------------------------------------------------


def k_points_plain(xp, yp, p_inf, xs, ys, s_inf, rand, mask=None):
    """Plain version of k_points; see ``k_points``."""
    if mask is None:
        pk = curve.from_affine(F1, to_i64(xp), to_i64(yp), p_inf)
        active = torch.ones_like(s_inf)
    else:
        pk = curve.aggregate_g1(to_i64(xp), to_i64(yp), p_inf, mask)
        active = mask.any(dim=1) & ~s_inf
    sig = curve.from_affine(F2, to_i64(xs), to_i64(ys), s_inf | ~active)
    r = to_i64(rand)
    wp = curve.scalar_mul_dynamic(F1, pk, r, 64)
    ws = curve.scalar_mul_dynamic(F2, sig, r, 64)
    s_sum = curve.sum_reduce(F2, ws)
    # one Fermat inversion for the n G1 Z's and the norm of the sum's Z
    zz = fp.mont_mul(s_sum.z, s_sum.z)
    zinv = fp.inv(torch.cat([wp.z, fp.add(zz[0], zz[1])[None]]))
    s_zi = fp.mont_mul(fp2.conj(s_sum.z), zinv[-1])
    wx, wy, winf = curve.to_affine(F1, wp, zinv[:-1])
    sx, sy, sinf = curve.to_affine(F2, s_sum, s_zi)
    return (to_i32(wx), to_i32(wy), winf | ~active, to_i32(sx), to_i32(sy),
            sinf.reshape(1))


def k_points(xp, yp, p_inf, xs, ys, s_inf, rand, mask=None):
    """Weighting ladders and the signature sum.

    Single-key form: xp, yp (n, 12), p_inf (n,).  Mask form (``mask`` given,
    (n, k) bool): xp, yp (n, k, 12), p_inf (n, k); each set's pubkey is the
    sum of its masked keys, and a set with no key or an infinity signature
    is inactive (its signature counts as infinity, its winf is set).
    xs, ys (n, 2, 12), s_inf (n,), rand (n, 2).
    Returns wx, wy (n, 12), winf (n,), sx, sy (2, 12), sinf (1,).
    Replaces tpu/staged.py:89 k_points and :156 k_points_multi."""
    n, device = xs.shape[0], xs.device
    L = fp.N_LIMBS
    if mask is None:
        k = 0
        _check("k_points xp", xp, (n, L), torch.int32, device)
        _check("k_points yp", yp, (n, L), torch.int32, device)
        _check("k_points p_inf", p_inf, (n,), torch.bool, device)
    else:
        k = mask.shape[1]
        _check("k_points mask", mask, (n, k), torch.bool, device)
        _check("k_points xp", xp, (n, k, L), torch.int32, device)
        _check("k_points yp", yp, (n, k, L), torch.int32, device)
        _check("k_points p_inf", p_inf, (n, k), torch.bool, device)
    _check("k_points xs", xs, (n, 2, L), torch.int32, device)
    _check("k_points ys", ys, (n, 2, L), torch.int32, device)
    _check("k_points s_inf", s_inf, (n,), torch.bool, device)
    _check("k_points rand", rand, (n, 2), torch.int32, device)
    if _on_cpu(device):
        return k_points_plain(xp, yp, p_inf, xs, ys, s_inf, rand, mask)
    from ....runtime import build

    wx = _empty((n, L), torch.int32, device)
    wy = _empty((n, L), torch.int32, device)
    winf = _empty((n,), torch.bool, device)
    sx = _empty((2, L), torch.int32, device)
    sy = _empty((2, L), torch.int32, device)
    sinf = _empty((1,), torch.bool, device)
    ws_jac = _empty((n, 72), torch.int32, device)
    if mask is None:
        pubkeys = (xp, yp, p_inf, None, None, None, None)
        pk_jac = act = None
    else:
        pubkeys = (None, None, None, xp, yp, p_inf, mask)
        pk_jac = _empty((n, 36), torch.int32, device)
        act = _empty((n,), torch.bool, device)
    build.call("k_points", "k_points_launch", *pubkeys, n, k, xs, ys, s_inf,
               rand, wx, wy, winf, sx, sy, sinf, pk_jac, act, ws_jac)
    k_points.launches += 1
    return wx, wy, winf, sx, sy, sinf


k_points.launches = 0


# --- k_pair --------------------------------------------------------------------


def k_pair_plain(wx, wy, winf, hx, hy, hinf, sx, sy, sinf):
    device = wx.device
    gx, gy = curve.neg_g1_affine(device)
    xp = torch.cat([to_i64(wx), gx[None]])
    yp = torch.cat([to_i64(wy), gy[None]])
    pi = torch.cat([winf, torch.zeros(1, dtype=torch.bool, device=device)])
    xq = torch.cat([to_i64(hx), to_i64(sx)[None]])
    yq = torch.cat([to_i64(hy), to_i64(sy)[None]])
    qi = torch.cat([hinf, sinf.reshape(1)])
    ok, gt = pairing.multi_pairing_is_one(xp, yp, pi, xq, yq, qi)
    return ok.reshape(1), to_i32(gt)


def k_pair(wx, wy, winf, hx, hy, hinf, sx, sy, sinf):
    """prod_i e(w_i, H_i) * e(-g1, S) == 1 -> (ok (1,) bool, gt (2, 3, 2, 12)
    the GT value of the product).  Replaces tpu/staged.py:104 k_pair."""
    n, device = wx.shape[0], wx.device
    L = fp.N_LIMBS
    _check("k_pair wx", wx, (n, L), torch.int32, device)
    _check("k_pair wy", wy, (n, L), torch.int32, device)
    _check("k_pair winf", winf, (n,), torch.bool, device)
    _check("k_pair hx", hx, (n, 2, L), torch.int32, device)
    _check("k_pair hy", hy, (n, 2, L), torch.int32, device)
    _check("k_pair hinf", hinf, (n,), torch.bool, device)
    _check("k_pair sx", sx, (2, L), torch.int32, device)
    _check("k_pair sy", sy, (2, L), torch.int32, device)
    _check("k_pair sinf", sinf, (1,), torch.bool, device)
    if _on_cpu(device):
        return k_pair_plain(wx, wy, winf, hx, hy, hinf, sx, sy, sinf)
    from ....runtime import build

    f_all = _empty((n + 1, 144), torch.int32, device)
    ok = _empty((1,), torch.bool, device)
    gt = _empty((2, 3, 2, L), torch.int32, device)
    build.call("k_pair", "k_pair_launch", wx, wy, winf, hx, hy, hinf, sx, sy,
               sinf, n, f_all, ok, gt)
    k_pair.launches += 1
    return ok, gt


k_pair.launches = 0

KERNELS = {"k_xmd": k_xmd, "k_hash": k_hash, "k_points": k_points,
           "k_pair": k_pair}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# --- Pipelines -----------------------------------------------------------------


def verify_batch_staged(xp, yp, p_inf, xs, ys, s_inf, u_plain, rand):
    """Single-key batch from hash-to-field limbs (host XMD for messages that
    are not 32 bytes) -> verdict tensor (1,)."""
    hx, hy, hinf = k_hash(u_plain)
    wx, wy, winf, sx, sy, sinf = k_points(xp, yp, p_inf, xs, ys, s_inf, rand)
    return k_pair(wx, wy, winf, hx, hy, hinf, sx, sy, sinf)[0]


def verify_batch_staged_roots(xp, yp, p_inf, xs, ys, s_inf, msg_words, rand):
    """All-device single-key batch: signing roots in, k_xmd first."""
    return verify_batch_staged(xp, yp, p_inf, xs, ys, s_inf,
                               k_xmd(msg_words), rand)


def verify_batch_multi_staged(xpk, ypk, ipk, mask, xs, ys, s_inf, u_plain,
                              rand):
    """Multi-key batch ((n, k) pubkeys under a mask): inactive sets (no key,
    or an infinity signature) contribute the neutral pair."""
    hx, hy, hinf = k_hash(u_plain)
    hinf = hinf | ~(mask.any(dim=1) & ~s_inf)
    wx, wy, winf, sx, sy, sinf = k_points(xpk, ypk, ipk, xs, ys, s_inf, rand,
                                          mask=mask)
    return k_pair(wx, wy, winf, hx, hy, hinf, sx, sy, sinf)[0]
