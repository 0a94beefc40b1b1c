"""The kernels of BLS verification and the pipelines that drive them.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/staged.py`` (and of the
per-set ``backend._verify_each_kernel``, the pubkey arena's
``_scatter_rows`` / row gather and the secret-key arena's ``_scatter_rows``
/ ``signer.gather_rows``; the signing kernels are in ``.signer``):

  k_xmd     32-byte signing roots        -> (u0, u1) hash-to-field limbs
  k_hash    (u0, u1)                     -> affine H(m)
  k_decode  wire x limbs, sign, inf      -> affine signatures, all-lanes ok
  k_points  pubkeys, signatures, weights -> affine [r_i] P_i, sum [r_i] sig_i
            (with a (n, k) mask: sums k pubkeys a set first)
  k_pair    all affine pairs             -> verdict (and the GT value)
  k_and     two verdicts                 -> their AND (one readback)
  k_each    pubkeys, signatures, H(m)    -> (n,) per-set verdicts
  k_scatter_rows / k_gather_rows         -> the pubkey arena on the card
  k_scatter_sk_rows / k_gather_sk_rows   -> the secret-key arena on the card
  k_subgroup    G1 and G2 lanes, active masks -> per-lane subgroup verdicts
  k_decode_g1   wire x limbs, sign, inf      -> affine G1 points, lane ok
  k_pair_partial / k_pair_combine        -> k_pair split for a mesh: a
                shard's Miller product; S products -> final exp, verdict
  k_ring_mul / k_ring_sum                -> the cross-shard folds (Fp12
                product, affine G2 sum)

Each wrapper checks device, dtype, shape and contiguity, launches its CUDA
kernel (``csrc/k_*.cu``) for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it runs the kernel's plain PyTorch
version (``*_plain``, also callable on CUDA tensors to compare).  A CUDA
tensor never reaches a plain version through a wrapper, and a failed build
or launch raises.

Tensor conventions at the wrappers: limbs are ``int32`` holding the uint32
limb bit patterns (``(..., 12)``, Montgomery unless noted), masks are
``bool``, weights are ``(n, 2)`` int32 little-endian words of the 64-bit
weight, row indices are ``int64``.  Public keys are subgroup-checked when
they are deserialized (the api layer); signatures too, except wire bytes
(``LazySignature``), which ``k_decode`` checks on the card, as in the TPU
package.
"""
from __future__ import annotations

import torch

from . import curve, fp, fp2, hash_to_g2 as h2, pairing, tower
from .curve import F1, F2

from ....runtime.tensors import (check as _check,
                                 check_aligned as _check_aligned,
                                 empty as _empty, on_cpu as _on_cpu,
                                 resolve_device, to_i32, to_i64)


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

# --- k_decode and k_and --------------------------------------------------------


def k_decode_plain(x, sign, inf):
    pt, ok = curve.g2_decompress(to_i64(x), sign, inf)
    ok = ok & (curve.g2_subgroup_check(pt) | inf)
    pinf = curve.is_infinity(F2, pt)
    zero = torch.zeros_like(pt.x)
    xs = fp2.select(pinf, zero, pt.x)
    ys = fp2.select(pinf, zero, pt.y)
    return to_i32(xs), to_i32(ys), pinf | inf, ok.all().reshape(1)


def k_decode(x, sign, inf):
    """Wire signatures on the card: x (m, 2, 12) canonical PLAIN limbs of
    the wire x coordinate, sign and inf (m,) bool (padding lanes are
    infinity) -> xs, ys (m, 2, 12) affine Montgomery, si (m,) (the point's
    infinity or ``inf``), ok (1,): every lane on the curve and in G2, or a
    well-formed infinity.  Replaces tpu/staged.py:66 k_decode."""
    m, device = x.shape[0], x.device
    L = fp.N_LIMBS
    _check("k_decode x", x, (m, 2, L), torch.int32, device)
    _check("k_decode sign", sign, (m,), torch.bool, device)
    _check("k_decode inf", inf, (m,), torch.bool, device)
    if _on_cpu(device):
        return k_decode_plain(x, sign, inf)
    from ....runtime import build

    xs = _empty((m, 2, L), torch.int32, device)
    ys = _empty((m, 2, L), torch.int32, device)
    si = _empty((m,), torch.bool, device)
    if not m:
        return xs, ys, si, torch.ones((1,), dtype=torch.bool, device=device)
    ok = _empty((1,), torch.bool, device)
    build.call("k_decode", "k_decode_launch", x, sign, inf, m, xs, ys, si, ok)
    k_decode.launches += 1
    return xs, ys, si, ok


k_decode.launches = 0


def k_and_plain(a, b):
    return a & b


def k_and(a, b):
    """(1,) bool AND (1,) bool -> (1,) bool on the device: the wire path's
    decode verdict and pairing verdict in one readback.  Replaces
    tpu/staged.py:81 k_and."""
    device = a.device
    _check("k_and a", a, (1,), torch.bool, device)
    _check("k_and b", b, (1,), torch.bool, device)
    if _on_cpu(device):
        return k_and_plain(a, b)
    from ....runtime import build

    out = _empty((1,), torch.bool, device)
    build.call("k_decode", "k_and_launch", a, b, out)
    k_and.launches += 1
    return out


k_and.launches = 0


# --- k_each --------------------------------------------------------------------


def k_each_plain(xp, yp, p_inf, xs, ys, s_inf, hx, hy, hinf):
    n, device = xp.shape[0], xp.device
    gx, gy = curve.neg_g1_affine(device)
    mxp = torch.stack([to_i64(xp), gx.expand(n, -1)], dim=1)
    myp = torch.stack([to_i64(yp), gy.expand(n, -1)], dim=1)
    mpi = torch.stack([p_inf, torch.zeros_like(p_inf)], dim=1)
    mxq = torch.stack([to_i64(hx), to_i64(xs)], dim=1)
    myq = torch.stack([to_i64(hy), to_i64(ys)], dim=1)
    mqi = torch.stack([hinf, s_inf], dim=1)
    f = pairing.miller_loop(mxp, myp, mpi, mxq, myq, mqi)
    gt = pairing.final_exponentiation(tower.mul(f[:, 0], f[:, 1]))
    return tower.is_one(gt) & ~p_inf & ~s_inf


def k_each(xp, yp, p_inf, xs, ys, s_inf, hx, hy, hinf):
    """Per-set verdicts e(P_i, H_i) e(-g1, sig_i) == 1, False where P_i or
    sig_i is infinity: xp, yp (n, 12), p_inf (n,); xs, ys, hx, hy
    (n, 2, 12), s_inf, hinf (n,) -> (n,) bool.  Replaces
    tpu/backend.py:90 _verify_each_kernel (tpu/verify.py:47 verify_each)
    after its hash-to-G2."""
    n, device = xp.shape[0], xp.device
    L = fp.N_LIMBS
    _check("k_each xp", xp, (n, L), torch.int32, device)
    _check("k_each yp", yp, (n, L), torch.int32, device)
    _check("k_each p_inf", p_inf, (n,), torch.bool, device)
    for name, t in (("xs", xs), ("ys", ys), ("hx", hx), ("hy", hy)):
        _check(f"k_each {name}", t, (n, 2, L), torch.int32, device)
    _check("k_each s_inf", s_inf, (n,), torch.bool, device)
    _check("k_each hinf", hinf, (n,), torch.bool, device)
    if _on_cpu(device):
        return k_each_plain(xp, yp, p_inf, xs, ys, s_inf, hx, hy, hinf)
    from ....runtime import build

    f_all = _empty((2 * n, 144), torch.int32, device)
    ok = _empty((n,), torch.bool, device)
    if n:
        build.call("k_each", "k_each_launch", xp, yp, p_inf, xs, ys, s_inf,
                   hx, hy, hinf, n, f_all, ok)
        k_each.launches += 1
    return ok


k_each.launches = 0


# --- The pubkey arena: k_scatter_rows, k_gather_rows ---------------------------


def _check_arena(name, ax, ay):
    L, device = fp.N_LIMBS, ax.device
    rows = ax.shape[0]
    _check(f"{name} ax", ax, (rows, L), torch.int32, device)
    _check(f"{name} ay", ay, (rows, L), torch.int32, device)
    if rows >= 1 << 31:
        raise ValueError(f"{name}: {rows} arena rows exceed int32")


def _check_rows(name, idx, rows):
    if idx.numel() and bool(((idx < 0) | (idx >= rows)).any()):
        raise IndexError(f"{name}: row index outside [0, {rows})")


def k_scatter_rows_plain(ax, ay, idx, vx, vy):
    _check_rows("k_scatter_rows", idx, ax.shape[0])
    ax[idx] = vx
    ay[idx] = vy
    return ax, ay


def k_scatter_rows(ax, ay, idx, vx, vy):
    """ax[idx] = vx, ay[idx] = vy IN PLACE on the (rows, 12) arena: idx
    (d,) int64 distinct rows (a repeated row must carry equal values), vx,
    vy (d, 12) -> (ax, ay).  A row outside [0, rows) raises: IndexError
    here on the CPU; on the card the kernel traps and the next
    synchronising call raises.  Replaces tpu/pubkey_cache.py:74
    _scatter_rows."""
    d, device = idx.shape[0], ax.device
    L = fp.N_LIMBS
    _check_arena("k_scatter_rows", ax, ay)
    _check("k_scatter_rows idx", idx, (d,), torch.int64, device)
    _check("k_scatter_rows vx", vx, (d, L), torch.int32, device)
    _check("k_scatter_rows vy", vy, (d, L), torch.int32, device)
    if _on_cpu(device):
        return k_scatter_rows_plain(ax, ay, idx, vx, vy)
    from ....runtime import build

    if d:
        _check_aligned("k_scatter_rows", ax, ay, vx, vy)
        build.call("k_arena", "k_scatter_rows_launch", ax, ay, ax.shape[0],
                   idx, vx, vy, d)
        k_scatter_rows.launches += 1
    return ax, ay


k_scatter_rows.launches = 0


def k_gather_rows_plain(ax, ay, rows):
    _check_rows("k_gather_rows", rows, ax.shape[0])
    return ax[rows], ay[rows], rows == 0


def k_gather_rows(ax, ay, rows):
    """Arena rows by index: rows (m,) int64 -> x, y (m, 12), inf (m,) =
    rows == 0 (row 0 is the infinity / padding row).  A row outside
    [0, rows) raises as in ``k_scatter_rows``.  Replaces the row gather of
    parallel/sharded_verify.py:374-375."""
    m, device = rows.shape[0], ax.device
    L = fp.N_LIMBS
    _check_arena("k_gather_rows", ax, ay)
    _check("k_gather_rows rows", rows, (m,), torch.int64, device)
    if _on_cpu(device):
        return k_gather_rows_plain(ax, ay, rows)
    from ....runtime import build

    x = _empty((m, L), torch.int32, device)
    y = _empty((m, L), torch.int32, device)
    inf = _empty((m,), torch.bool, device)
    if m:
        _check_aligned("k_gather_rows", ax, ay, x, y)
        build.call("k_arena", "k_gather_rows_launch", ax, ay, ax.shape[0],
                   rows, m, x, y, inf)
        k_gather_rows.launches += 1
    return x, y, inf


k_gather_rows.launches = 0


# --- The secret-key arena: k_scatter_sk_rows, k_gather_sk_rows ----------------

SK_WORDS = 8        # little-endian 32-bit words of a secret scalar


def _check_sk_arena(name, a):
    rows = a.shape[0]
    _check(f"{name} arena", a, (rows, SK_WORDS), torch.int32, a.device)
    if rows >= 1 << 31:
        raise ValueError(f"{name}: {rows} arena rows exceed int32")


def k_scatter_sk_rows_plain(a, idx, v):
    _check_rows("k_scatter_sk_rows", idx, a.shape[0])
    a[idx] = v
    return a


def k_scatter_sk_rows(a, idx, v):
    """a[idx] = v IN PLACE on the (rows, 8) secret-scalar arena: idx (d,)
    int64 distinct rows, v (d, 8) int32 words -> a.  A row outside
    [0, rows) raises as in ``k_scatter_rows``.  Replaces
    tpu/seckey_cache.py:67 _scatter_rows."""
    d, device = idx.shape[0], a.device
    _check_sk_arena("k_scatter_sk_rows", a)
    _check("k_scatter_sk_rows idx", idx, (d,), torch.int64, device)
    _check("k_scatter_sk_rows v", v, (d, SK_WORDS), torch.int32, device)
    if _on_cpu(device):
        return k_scatter_sk_rows_plain(a, idx, v)
    from ....runtime import build

    if d:
        _check_aligned("k_scatter_sk_rows", a, v)
        build.call("k_arena", "k_scatter_sk_rows_launch", a, a.shape[0], idx,
                   v, d)
        k_scatter_sk_rows.launches += 1
    return a


k_scatter_sk_rows.launches = 0


def k_gather_sk_rows_plain(a, rows):
    _check_rows("k_gather_sk_rows", rows, a.shape[0])
    return a[rows]


def k_gather_sk_rows(a, rows):
    """Secret-scalar rows by index, arena -> lanes on the device: rows (m,)
    int64 -> w (m, 8) int32 (row 0 is the zero scalar of padding lanes).  A
    row outside [0, rows) raises as in ``k_scatter_rows``.  Replaces
    tpu/signer.py:229 gather_rows."""
    m, device = rows.shape[0], a.device
    _check_sk_arena("k_gather_sk_rows", a)
    _check("k_gather_sk_rows rows", rows, (m,), torch.int64, device)
    if _on_cpu(device):
        return k_gather_sk_rows_plain(a, rows)
    from ....runtime import build

    w = _empty((m, SK_WORDS), torch.int32, device)
    if m:
        _check_aligned("k_gather_sk_rows", a, w)
        build.call("k_arena", "k_gather_sk_rows_launch", a, a.shape[0], rows,
                   m, w)
        k_gather_sk_rows.launches += 1
    return w


k_gather_sk_rows.launches = 0


# --- k_subgroup and k_decode_g1 ------------------------------------------------


def k_subgroup_plain(x1, y1, inf1, act1, x2, y2, inf2, act2):
    g1 = curve.g1_subgroup_check(
        curve.from_affine(F1, to_i64(x1), to_i64(y1), inf1)) | ~act1
    g2 = curve.g2_subgroup_check(
        curve.from_affine(F2, to_i64(x2), to_i64(y2), inf2)) | ~act2
    lanes = torch.cat([g1, g2])
    return lanes, lanes.all().reshape(1)


def k_subgroup(x1, y1, inf1, act1, x2, y2, inf2, act2):
    """Subgroup checks of G1 and G2 lanes: x1, y1 (n1, 12) affine
    Montgomery, inf1, act1 (n1,) bool; x2, y2 (n2, 2, 12), inf2, act2 (n2,)
    -> lanes (n1 + n2,) bool (G1 lanes first; a lane that is off or
    infinity passes) and ok (1,) their AND.  Replaces the check_subgroups
    branch of tpu/verify.py verify_batch / verify_batch_multi
    (tpu/curve.py:608 g1_subgroup_check, :636 g2_subgroup_check)."""
    n1, n2, device = x1.shape[0], x2.shape[0], x1.device
    L = fp.N_LIMBS
    _check("k_subgroup x1", x1, (n1, L), torch.int32, device)
    _check("k_subgroup y1", y1, (n1, L), torch.int32, device)
    _check("k_subgroup inf1", inf1, (n1,), torch.bool, device)
    _check("k_subgroup act1", act1, (n1,), torch.bool, device)
    _check("k_subgroup x2", x2, (n2, 2, L), torch.int32, device)
    _check("k_subgroup y2", y2, (n2, 2, L), torch.int32, device)
    _check("k_subgroup inf2", inf2, (n2,), torch.bool, device)
    _check("k_subgroup act2", act2, (n2,), torch.bool, device)
    if _on_cpu(device):
        return k_subgroup_plain(x1, y1, inf1, act1, x2, y2, inf2, act2)
    from ....runtime import build

    lanes = _empty((n1 + n2,), torch.bool, device)
    ok = _empty((1,), torch.bool, device)
    build.call("k_verify", "k_subgroup_launch", x1, y1, inf1, act1, n1, x2,
               y2, inf2, act2, n2, lanes, ok)
    k_subgroup.launches += 1
    return lanes, ok


k_subgroup.launches = 0


def k_decode_g1_plain(x, sign, inf, check=False):
    pt, ok = curve.g1_decompress(to_i64(x), sign, inf)
    if check:
        ok = ok & (curve.g1_subgroup_check(pt) | inf)
    zero = torch.zeros_like(pt.x)
    return (to_i32(fp.select(inf, zero, pt.x)),
            to_i32(fp.select(inf, zero, pt.y)), inf.clone(), ok)


def k_decode_g1(x, sign, inf, check=False):
    """Compressed G1 points on the card: x (m, 12) canonical PLAIN limbs of
    the wire x coordinate, sign and inf (m,) bool -> xs, ys (m, 12) affine
    Montgomery (0 at infinity), si (m,) = inf, ok (m,) per lane: on the
    curve (a well-formed infinity: x == 0), and with ``check`` in G1.
    Replaces tpu/curve.py:684 g1_decompress (+ g1_subgroup_check)."""
    m, device = x.shape[0], x.device
    L = fp.N_LIMBS
    _check("k_decode_g1 x", x, (m, L), torch.int32, device)
    _check("k_decode_g1 sign", sign, (m,), torch.bool, device)
    _check("k_decode_g1 inf", inf, (m,), torch.bool, device)
    if _on_cpu(device):
        return k_decode_g1_plain(x, sign, inf, check)
    from ....runtime import build

    xs = _empty((m, L), torch.int32, device)
    ys = _empty((m, L), torch.int32, device)
    si = _empty((m,), torch.bool, device)
    ok = _empty((m,), torch.bool, device)
    if m:
        build.call("k_verify", "k_decode_g1_launch", x, sign, inf, m,
                   int(bool(check)), xs, ys, si, ok)
        k_decode_g1.launches += 1
    return xs, ys, si, ok


k_decode_g1.launches = 0


# --- k_pair_partial, k_pair_combine --------------------------------------------

F12_SHAPE = (2, 3, 2, fp.N_LIMBS)       # one Fp12: 144 words


def k_pair_partial_plain(wx, wy, winf, hx, hy, hinf, sx=None, sy=None,
                         sinf=None, closing=False):
    xp, yp, pi = to_i64(wx), to_i64(wy), winf
    xq, yq, qi = to_i64(hx), to_i64(hy), hinf
    if closing:
        gx, gy = curve.neg_g1_affine(wx.device)
        xp, yp = torch.cat([xp, gx[None]]), torch.cat([yp, gy[None]])
        pi = torch.cat([pi, torch.zeros(1, dtype=torch.bool,
                                        device=wx.device)])
        xq, yq = torch.cat([xq, to_i64(sx)[None]]), torch.cat(
            [yq, to_i64(sy)[None]])
        qi = torch.cat([qi, sinf.reshape(1)])
    f = pairing.miller_loop(xp, yp, pi, xq, yq, qi)
    return to_i32(pairing.product_reduce(f))


def k_pair_partial(wx, wy, winf, hx, hy, hinf, sx=None, sy=None, sinf=None,
                   closing=False):
    """One shard's Miller product: prod_i f(w_i, H_i) over its n lanes, times
    f(-g1, S) when ``closing`` (sx, sy (2, 12), sinf (1,): the cross-shard
    signature sum; shard 0 only) -> (2, 3, 2, 12) Montgomery words, no final
    exponentiation.  The shard half of tpu/staged.py:104 k_pair, as
    parallel/sharded_verify.py:269 _cross_chip_pair splits it."""
    n, device = wx.shape[0], wx.device
    L = fp.N_LIMBS
    _check("k_pair_partial wx", wx, (n, L), torch.int32, device)
    _check("k_pair_partial wy", wy, (n, L), torch.int32, device)
    _check("k_pair_partial winf", winf, (n,), torch.bool, device)
    _check("k_pair_partial hx", hx, (n, 2, L), torch.int32, device)
    _check("k_pair_partial hy", hy, (n, 2, L), torch.int32, device)
    _check("k_pair_partial hinf", hinf, (n,), torch.bool, device)
    if closing:
        _check("k_pair_partial sx", sx, (2, L), torch.int32, device)
        _check("k_pair_partial sy", sy, (2, L), torch.int32, device)
        _check("k_pair_partial sinf", sinf, (1,), torch.bool, device)
    else:
        sx = sy = sinf = None
    if _on_cpu(device):
        return k_pair_partial_plain(wx, wy, winf, hx, hy, hinf, sx, sy, sinf,
                                    closing)
    from ....runtime import build

    f_all = _empty((n + 1, 144), torch.int32, device)
    out = _empty(F12_SHAPE, torch.int32, device)
    build.call("k_pair", "k_pair_partial_launch", wx, wy, winf, hx, hy, hinf,
               sx, sy, sinf, n, int(bool(closing)), f_all, out)
    k_pair_partial.launches += 1
    return out


k_pair_partial.launches = 0


def k_pair_combine_plain(parts):
    gt = pairing.final_exponentiation(pairing.product_reduce(to_i64(parts)))
    return tower.is_one(gt).reshape(1), to_i32(gt)


def k_pair_combine(parts):
    """S shard partials (S, 2, 3, 2, 12) -> (ok (1,) bool, gt (2, 3, 2, 12)):
    their product, the final exponentiation and the is-one test, once for
    the batch (parallel/sharded_verify.py:295-296, the half of
    tpu/staged.py:104 k_pair after the Miller product)."""
    s, device = parts.shape[0], parts.device
    _check("k_pair_combine parts", parts, (s, *F12_SHAPE), torch.int32,
           device)
    if _on_cpu(device):
        return k_pair_combine_plain(parts)
    from ....runtime import build

    ok = _empty((1,), torch.bool, device)
    gt = _empty(F12_SHAPE, torch.int32, device)
    build.call("k_pair", "k_pair_combine_launch", parts, s, ok, gt)
    k_pair_combine.launches += 1
    return ok, gt


k_pair_combine.launches = 0


# --- k_ring --------------------------------------------------------------------


def k_ring_mul_plain(a, b):
    return to_i32(tower.mul(to_i64(a), to_i64(b)))


def k_ring_mul(a, b):
    """One hop of the Fp12 ring: a * b, each (2, 3, 2, 12) Montgomery words.
    Replaces the fold of parallel/ring.py:37 ring_reduce_fp12."""
    device = a.device
    _check("k_ring_mul a", a, F12_SHAPE, torch.int32, device)
    _check("k_ring_mul b", b, F12_SHAPE, torch.int32, device)
    if _on_cpu(device):
        return k_ring_mul_plain(a, b)
    from ....runtime import build

    out = _empty(F12_SHAPE, torch.int32, device)
    build.call("k_ring", "k_ring_mul_launch", a, b, out)
    k_ring_mul.launches += 1
    return out


k_ring_mul.launches = 0


def k_ring_sum_plain(x, y, inf):
    total = curve.sum_reduce(F2, curve.from_affine(F2, to_i64(x), to_i64(y),
                                                   inf))
    sx, sy, sinf = curve.to_affine(F2, total)
    return to_i32(sx), to_i32(sy), sinf.reshape(1)


def k_ring_sum(x, y, inf):
    """The affine sum of S affine G2 points: x, y (S, 2, 12), inf (S,) ->
    sx, sy (2, 12), sinf (1,), complete additions.  S = 2 is one hop of
    parallel/ring.py:61 ring_sum_g2; S = the shard count is the gathered sum
    of parallel/sharded_verify.py:97 and its affine conversion."""
    s, device = x.shape[0], x.device
    L = fp.N_LIMBS
    _check("k_ring_sum x", x, (s, 2, L), torch.int32, device)
    _check("k_ring_sum y", y, (s, 2, L), torch.int32, device)
    _check("k_ring_sum inf", inf, (s,), torch.bool, device)
    if _on_cpu(device):
        return k_ring_sum_plain(x, y, inf)
    from ....runtime import build

    sx = _empty((2, L), torch.int32, device)
    sy = _empty((2, L), torch.int32, device)
    sinf = _empty((1,), torch.bool, device)
    build.call("k_ring", "k_ring_sum_launch", x, y, inf, s, sx, sy, sinf)
    k_ring_sum.launches += 1
    return sx, sy, sinf


k_ring_sum.launches = 0

KERNELS = {"k_xmd": k_xmd, "k_hash": k_hash, "k_points": k_points,
           "k_pair": k_pair, "k_decode": k_decode, "k_and": k_and,
           "k_each": k_each, "k_scatter_rows": k_scatter_rows,
           "k_gather_rows": k_gather_rows,
           "k_scatter_sk_rows": k_scatter_sk_rows,
           "k_gather_sk_rows": k_gather_sk_rows, "k_subgroup": k_subgroup,
           "k_decode_g1": k_decode_g1, "k_pair_partial": k_pair_partial,
           "k_pair_combine": k_pair_combine, "k_ring_mul": k_ring_mul,
           "k_ring_sum": k_ring_sum}


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


def verify_batch_wire_roots(xp, yp, p_inf, x, sign, inf, msg_words, rand):
    """Wire-signature batch of signing roots: k_decode first, then the
    all-device pipeline, the two verdicts ANDed on the device (k_and)."""
    xs, ys, s_inf, ok_decode = k_decode(x, sign, inf)
    ok_pair = verify_batch_staged_roots(xp, yp, p_inf, xs, ys, s_inf,
                                        msg_words, rand)
    return k_and(ok_pair, ok_decode)


def verify_batch_multi_staged(xpk, ypk, ipk, mask, xs, ys, s_inf, u_plain,
                              rand):
    """Multi-key batch ((n, k) pubkeys under a mask): inactive sets (no key,
    or an infinity signature) contribute the neutral pair."""
    hx, hy, hinf = k_hash(u_plain)
    hinf = hinf | ~(mask.any(dim=1) & ~s_inf)
    wx, wy, winf, sx, sy, sinf = k_points(xpk, ypk, ipk, xs, ys, s_inf, rand,
                                          mask=mask)
    return k_pair(wx, wy, winf, hx, hy, hinf, sx, sy, sinf)[0]
