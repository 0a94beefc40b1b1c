"""The port's plain pairing against pairing_ref (the JAX package's pure-Python
pairing, its own reference: the JAX pairing programs take tens of minutes
to compile cold).  GT values compare coefficient for coefficient (exact);
the multi-pairing verdict is checked with infinity and padding lanes."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import curve_ref as jcv
from lighthouse_tpu.crypto.bls import pairing_ref as jpr
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls import fields_ref as fr
from lighthouse_tpu_torch.crypto.bls.cuda import curve, fp2, pairing, staged

RNG = np.random.default_rng(0x9A1)


def port_point(p, g2):
    if p.is_infinity():
        return cv.g2_infinity() if g2 else cv.g1_infinity()
    if g2:
        return cv.Point(fr.Fp2(p.x.c0, p.x.c1), fr.Fp2(p.y.c0, p.y.c1),
                        cv.B_G2)
    return cv.Point(fr.Fp(p.x.v), fr.Fp(p.y.v), cv.B_G1)


def gt_coeffs(t):
    return fp2.unpack_mont(t)


def ref_coeffs(f):
    return [(c.c0, c.c1) for c6 in (f.c0, f.c1) for c in (c6.c0, c6.c1, c6.c2)]


def test_single_pairing_exact_vs_ref():
    a, b = (int(x) for x in RNG.integers(2, 2**40, size=2))
    p1, q2 = jcv.g1_generator().mul(a), jcv.g2_generator().mul(b)
    x, y, i = curve.pack_g1_affine([port_point(p1, False)])
    xq, yq, iq = curve.pack_g2_affine([port_point(q2, True)])
    got = pairing.pairing(x, y, i, xq, yq, iq)
    assert gt_coeffs(got) == ref_coeffs(jpr.pairing(p1, q2))


@pytest.mark.parametrize("tamper", [False, True])
def test_k_pair_plain_with_infinity_and_padding(tamper):
    """e(a g1, H) e(b g1, H) e(-g1, (a + b) H) == 1 through k_pair's plain
    version, with an infinity pubkey lane and an infinity H lane (padding)
    that must contribute nothing; tampered: the sum uses a + b + 1."""
    a, b = (int(x) for x in RNG.integers(2, 2**40, size=2))
    h = jcv.g2_generator().mul(int(RNG.integers(2, 2**40)))
    g1 = jcv.g1_generator()
    w = [g1.mul(a), g1.mul(b), jcv.g1_infinity(), g1.mul(7)]
    hs = [h, h, h, jcv.g2_infinity()]
    s = h.mul(a + b + (1 if tamper else 0))
    i32 = staged.to_i32
    wx, wy, wi = curve.pack_g1_affine([port_point(p, False) for p in w])
    hx, hy, hi = curve.pack_g2_affine([port_point(p, True) for p in hs])
    sx, sy, si = curve.pack_g2_affine([port_point(s, True)])
    ok, gt = staged.k_pair(i32(wx), i32(wy), wi, i32(hx), i32(hy), hi,
                           i32(sx[0]), i32(sy[0]), si)
    assert ok.tolist() == [not tamper]
    assert gt.shape == (2, 3, 2, 12) and gt.dtype == torch.int32
    # the product is e(g1, h)^(a + b - s) = 1, or e(-g1, h) when tampered
    want = jpr.pairing(-g1, h) if tamper else \
        jpr.final_exponentiation(jpr.miller_loop([]))
    assert gt_coeffs(staged.to_i64(gt)) == ref_coeffs(want)
