"""Wire-signature inputs shared by the port's tests (no jax import, so the
card-only tests load them under --noconftest), and checks that each input
is what its name says, held with the port's host reference curve_ref:

  * ``non_subgroup_signature()``: the bytes of bls_adversarial.json's
    non_subgroup_signature case, an on-curve G2 point outside the subgroup;
  * ``real_y_point()``: an on-curve G2 point whose y is in Fp (y.c1 == 0),
    outside the subgroup, where the sign bit comes from c0 alone;
  * ``OFF_CURVE_X1``: the wire bytes of x = 1, where x^3 + 4(1 + u) is not
    a square in Fp2, so no point has that x.
"""
import json
import os

import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp, Fp2

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
OFF_CURVE_X1 = bytes([0x80]) + bytes(47) + (1).to_bytes(48, "big")


def non_subgroup_signature() -> bytes:
    with open(os.path.join(VECTORS, "bls_adversarial.json")) as f:
        case = [c for c in json.load(f)["cases"]
                if c["name"] == "non_subgroup_signature"][0]
    return bytes.fromhex(case["sets"][0]["signature"])


def real_y_point():
    """With x = a + 2u and a^2 = 2/3 the imaginary part of x^3 + 4(1 + u)
    is 0; one of the two choices of a gives a square right-hand side."""
    a = Fp(2 * pow(3, P - 2, P)).sqrt()
    for av in (a.v, (-a).v):
        x = Fp2(av, 2)
        y = (x.square() * x + cv.B_G2).sqrt()
        if y is not None and y.c1 == 0:
            return cv.Point(x, y, cv.B_G2)
    raise AssertionError("no on-curve point with y in Fp at x = a + 2u")


def _parse(raw):
    c0, c1, sign, inf = cv.g2_parse_compressed(raw)
    return Fp2(c0, c1), sign, inf


def test_non_subgroup_signature_is_on_curve_outside_g2():
    raw = non_subgroup_signature()
    x, _sign, inf = _parse(raw)
    assert not inf
    assert (x.square() * x + cv.B_G2).sqrt() is not None     # on the curve
    pt = cv.g2_decompress(raw, subgroup_check=False)
    assert pt is not None and pt.is_on_curve()
    assert not cv.g2_subgroup_check(pt)
    assert cv.g2_decompress(raw) is None
    with pytest.raises(bls.BlsError):
        bls.Signature.from_bytes(raw)


@pytest.mark.parametrize("neg", [False, True], ids=["y", "minus_y"])
def test_real_y_point_is_on_curve_with_real_y(neg):
    pt = real_y_point()
    pt = -pt if neg else pt
    assert pt.is_on_curve() and pt.y.c1 == 0 and pt.y.c0 != 0
    assert not cv.g2_subgroup_check(pt)
    raw = cv.g2_compress(pt)
    x, _sign, inf = _parse(raw)
    assert not inf and x == pt.x
    assert cv.g2_decompress(raw, subgroup_check=False) == pt


def test_off_curve_x1_has_no_point():
    x, _sign, inf = _parse(OFF_CURVE_X1)
    assert not inf and x == Fp2(1, 0)
    assert (x.square() * x + cv.B_G2).sqrt() is None
    assert cv.g2_decompress(OFF_CURVE_X1, subgroup_check=False) is None
    with pytest.raises(bls.BlsError):
        bls.Signature.from_bytes(OFF_CURVE_X1)
