"""The port's plain G1/G2 arithmetic and the k_points kernel's plain version
against the pure-Python curve (crypto/bls/curve_ref of the JAX package),
including P == Q, P == -Q, infinity and zero-weight padding lanes.
Group elements compare as affine canonical integers (tolerance zero)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import curve_ref as jcv
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
from lighthouse_tpu_torch.crypto.bls.cuda.curve import F1, F2

RNG = np.random.default_rng(0xC0FFEE)


def scalars(n, bits=64):
    """n random nonzero scalars of exactly `bits` bits (bits <= 64)."""
    words = RNG.integers(0, 2**32, size=(n, 2), dtype=np.uint64)
    return [((int(hi) << 32 | int(lo)) >> (64 - bits)) | (1 << (bits - 1))
            for hi, lo in words]


def same(port_pts, jax_pts):
    """Port points (port curve_ref) == JAX curve_ref points, affine."""
    def key(p):
        if p.is_infinity():
            return None
        x, y = p.x, p.y
        return ((x.c0, x.c1, y.c0, y.c1) if hasattr(x, "c0")
                else (x.v, y.v))
    return [key(p) for p in port_pts] == [key(p) for p in jax_pts]


def as_port(points):
    """JAX curve_ref points -> the port's curve_ref points."""
    from lighthouse_tpu_torch.crypto.bls import fields_ref as fr

    out = []
    for p in points:
        if p.is_infinity():
            out.append(cv.g1_infinity() if not hasattr(p.b, "c0")
                       else cv.g2_infinity())
        elif hasattr(p.x, "c0"):
            out.append(cv.Point(fr.Fp2(p.x.c0, p.x.c1),
                                fr.Fp2(p.y.c0, p.y.c1), cv.B_G2))
        else:
            out.append(cv.Point(fr.Fp(p.x.v), fr.Fp(p.y.v), cv.B_G1))
    return out


@pytest.fixture(scope="module")
def points():
    ks = scalars(3, 60)
    g1 = [jcv.g1_generator().mul(k) for k in ks]
    g2 = [jcv.g2_generator().mul(k) for k in ks]
    return g1, g2


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_complete_addition_cases(points, group):
    g1, g2 = points
    pts = g1 if group == "g1" else g2
    F = F1 if group == "g1" else F2
    pack = curve.pack_g1_affine if group == "g1" else curve.pack_g2_affine
    unpack = curve.unpack_g1_affine if group == "g1" else \
        curve.unpack_g2_affine
    inf = jcv.g1_infinity() if group == "g1" else jcv.g2_infinity()
    lhs = [pts[0], pts[1], pts[2], pts[0], inf, inf]
    rhs = [pts[1], pts[1], -pts[2], inf, pts[2], inf]   # P+Q, P+P, P-P, ...
    a = curve.from_affine(F, *pack(as_port(lhs)))
    b = curve.from_affine(F, *pack(as_port(rhs)))
    got = unpack(*curve.to_affine(F, curve.add(F, a, b)))
    assert same(got, [x + y for x, y in zip(lhs, rhs)])
    got = unpack(*curve.to_affine(F, curve.double(F, a)))
    assert same(got, [x.double() for x in lhs])


def test_k_points_plain_single_and_mask(points):
    """k_points' plain version (the 64-bit ladders on both groups, the
    signature sum, the affine conversions): weighted pubkeys and the
    signature sum, with a padding lane (infinity, weight 0), equal
    signatures with equal weights (the sum hits P == Q), and the (n, k)
    mask form with an empty set, masked-off keys and an infinity key."""
    g1, g2 = points
    pks = [g1[0], g1[1], g1[2], jcv.g1_infinity()]
    sigs = [g2[0], g2[1], g2[1], jcv.g2_infinity()]
    ks = scalars(2) * 2
    ks[2], ks[3] = ks[1], 0
    rand = np.array([[k & 0xFFFFFFFF, k >> 32] for k in ks], np.uint32)
    i32 = staged.to_i32
    xp, yp, pi = curve.pack_g1_affine(as_port(pks))
    xs, ys, si = curve.pack_g2_affine(as_port(sigs))
    rand_t = torch.as_tensor(rand.view(np.int32))
    out = staged.k_points(i32(xp), i32(yp), pi, i32(xs), i32(ys), si, rand_t)
    wx, wy, winf, sx, sy, sinf = (t.to(torch.int64) & 0xFFFFFFFF
                                  if t.dtype == torch.int32 else t
                                  for t in out)
    assert same(curve.unpack_g1_affine(wx, wy, winf),
                [p.mul(k) for p, k in zip(pks, ks)])
    total = jcv.g2_infinity()
    for s, k in zip(sigs, ks):
        total = total + s.mul(k)
    assert same(curve.unpack_g2_affine(sx[None], sy[None], sinf), [total])

    # mask form: 3 sets of up to 3 keys
    keys = [[g1[0], g1[1], g1[2]], [g1[2], g1[2], g1[0]],
            [g1[1], jcv.g1_infinity(), g1[0]]]
    mask = torch.tensor([[True, True, False], [False, False, False],
                         [True, True, True]])
    flat = [p for row in keys for p in row]
    x, y, inf = curve.pack_g1_affine(as_port(flat))
    msig = [g2[0], g2[1], g2[2]]
    mxs, mys, msi = curve.pack_g2_affine(as_port(msig))
    mk = ks[:3]
    mrand = torch.as_tensor(rand[:3].view(np.int32))
    out = staged.k_points(i32(x.reshape(3, 3, -1)), i32(y.reshape(3, 3, -1)),
                          inf.reshape(3, 3), i32(mxs), i32(mys), msi, mrand,
                          mask=mask)
    wx, wy, winf = (out[0].to(torch.int64) & 0xFFFFFFFF,
                    out[1].to(torch.int64) & 0xFFFFFFFF, out[2])
    want, total = [], jcv.g2_infinity()
    for i in range(3):
        agg = jcv.g1_infinity()
        for j in range(3):
            if mask[i, j]:
                agg = agg + keys[i][j]
        active = bool(mask[i].any())
        want.append(agg.mul(mk[i]) if active else jcv.g1_infinity())
        if active:
            total = total + msig[i].mul(mk[i])
    assert same(curve.unpack_g1_affine(wx, wy, winf), want)
    sx, sy = (t.to(torch.int64) & 0xFFFFFFFF for t in out[3:5])
    assert same(curve.unpack_g2_affine(sx[None], sy[None], out[5]), [total])


def test_psi_matches_reference(points):
    from lighthouse_tpu.crypto.bls.curve_ref import psi

    _, g2 = points
    pt = curve.from_affine(F2, *curve.pack_g2_affine(as_port(g2)))
    got = curve.unpack_g2_affine(*curve.to_affine(F2, curve.g2_psi(pt)))
    assert same(got, [psi(p) for p in g2])
