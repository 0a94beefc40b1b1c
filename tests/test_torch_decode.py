"""Wire-signature decoding in the port (lighthouse_tpu_torch crypto/bls/cuda:
backend.parse_g2_compressed_many, curve.g2_decompress / g2_subgroup_check /
fp2_is_lex_largest, staged.k_decode's plain version) against the JAX
package: its host parse (tpu/backend.py _parse_g2_compressed_many), its
lexicographic sign (tpu/curve.py, under jit on the CPU), its pure-Python
decompression (curve_ref.g2_decompress) and, in the slow tier, its
staged.k_decode itself (a long XLA compile on the CPU).

Signatures come from secret keys drawn with a numpy seed; every value is
compared exactly (canonical integers, flags; tolerance 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu.crypto.bls import curve_ref as jcv
from lighthouse_tpu.crypto.bls.fields_ref import Fp2 as JFp2
from lighthouse_tpu.crypto.bls.hash_to_curve_ref import hash_to_g2 as jh2g
from lighthouse_tpu.crypto.bls.tpu import backend as jbackend
from lighthouse_tpu.crypto.bls.tpu import curve as jcurve
from lighthouse_tpu.crypto.bls.tpu import fp as jfp
from lighthouse_tpu.crypto.bls.tpu import fp2 as jfp2
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.cuda import convert, curve, fp, fp2
from lighthouse_tpu_torch.crypto.bls.cuda import staged
from lighthouse_tpu_torch.crypto.bls.cuda.backend import (
    parse_g2_compressed_many)
from lighthouse_tpu_torch.crypto.bls.cuda.curve import F2
from tests.test_torch_wire_vectors import (
    OFF_CURVE_X1, non_subgroup_signature, real_y_point)

RNG = np.random.default_rng(0xDEC0DE)


@pytest.fixture(scope="module")
def wire():
    """Wire bytes: valid signatures of both sign bits, the real-y point of
    both signs, infinity, an off-curve x, the non-subgroup vector."""
    ks = [int(k) for k in RNG.integers(2, 2**60, size=2)]
    g2 = cv.g2_generator()
    sigs = [g2.mul(k) for k in ks]
    sigs.append(-sigs[0])
    ry = real_y_point()
    raws = [cv.g2_compress(s) for s in sigs] + [
        cv.g2_compress(ry), cv.g2_compress(-ry),
        cv.g2_compress(cv.g2_infinity()), OFF_CURVE_X1,
        non_subgroup_signature()]
    assert len({r[0] & 0x20 for r in raws[:3]}) == 2     # both sign bits
    return raws


MALFORMED = {
    "no_compression_flag": bytes([0x00]) + bytes(95),
    "infinity_with_sign": bytes([0xE0]) + bytes(95),
    "infinity_with_bytes": bytes([0xC0]) + bytes(94) + b"\x01",
    "c1_not_below_p": bytes([0x80 | (P >> 376)]) + (P % (1 << 376))
    .to_bytes(47, "big") + bytes(48),
    "c0_not_below_p": bytes([0x80]) + bytes(47) + P.to_bytes(48, "big"),
    "short": bytes([0x80]) + bytes(94),
}


def test_parse_matches_jax(wire):
    m = len(wire) + 2                                 # two padding lanes
    x, sign, inf = parse_g2_compressed_many(wire, m)
    jx, jsign, jinf = jbackend._parse_g2_compressed_many(wire, m)
    assert fp.unpack(x) == jfp.unpack_ints(jx)
    assert sign.tolist() == [bool(b) for b in jsign]
    assert inf.tolist() == [bool(b) for b in jinf]
    assert inf.tolist()[-3:] == [False, True, True]
    px, psign, pinf = convert.decode_inputs_from_jax(jx, jsign, jinf)
    assert torch.equal(px, x) and torch.equal(psign, sign)
    assert torch.equal(pinf, inf)


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_parse_rejects_malformed_like_jax(wire, name):
    batch = [wire[0], MALFORMED[name]]
    with pytest.raises(jbls.BlsError):
        jbackend._parse_g2_compressed_many(batch, 2)
    with pytest.raises(bls.BlsError):
        parse_g2_compressed_many(batch, 2)


def test_lex_sign_matches_jax():
    """The values of tests/test_lazy_decode.py's lex-sign test: the sign
    is decided on the real value, not on y R mod p."""
    vals = [(5, 0), (P - 5, 0), (0, 7), (0, P - 7), (123, (P - 1) // 2),
            (99, (P + 1) // 2)]
    for i in range(10):
        h = jh2g(bytes([i]) * 32).mul(301 + i)
        vals.append((h.y.c0, h.y.c1))
    got = curve.fp2_is_lex_largest(fp2.pack_mont(vals)).tolist()
    ys = jnp.asarray(np.stack([jfp2.pack_mont(a, b) for a, b in vals]))
    want_jax = [bool(b) for b in
                np.asarray(jax.jit(jcurve.fp2_is_lex_largest)(ys))]
    assert got == want_jax == [jcv._fp2_is_lex_largest(JFp2(a, b))
                               for a, b in vals]
    singles = [1, P - 1, (P - 1) // 2, (P + 1) // 2]
    got1 = curve.fp_is_lex_largest(fp.pack_mont(singles)).tolist()
    ys1 = jnp.asarray(np.stack([jfp.mont_limbs(v) for v in singles]))
    want1 = [bool(b) for b in
             np.asarray(jax.jit(jcurve.fp_is_lex_largest)(ys1))]
    assert got1 == want1 == [False, True, False, True]


def test_k_decode_plain_matches_reference(wire):
    """Per lane against the JAX package's host decompression: the point,
    and whether it is valid (on the curve, in G2); all lanes ANDed."""
    m = len(wire) + 1
    x, sign, inf = parse_g2_compressed_many(wire, m)
    xs, ys, si, ok = staged.k_decode_plain(x, sign, inf)
    pt, lane_ok = curve.g2_decompress(staged.to_i64(x), sign, inf)
    lane_ok = lane_ok & (curve.g2_subgroup_check(pt) | inf)
    got = curve.unpack_g2_affine(staged.to_i64(xs), staged.to_i64(ys), si)
    refs = [jcv.g2_decompress(r) for r in wire] + [jcv.g2_infinity()]
    assert lane_ok.tolist() == [r is not None for r in refs]
    assert lane_ok.tolist() == [True] * 3 + [False] * 2 + [True] + [
        False] * 2 + [True]
    for g, r in zip(got, refs):
        if r is not None:
            assert g.is_infinity() == r.is_infinity()
            if not r.is_infinity():
                assert (g.x.c0, g.x.c1, g.y.c0, g.y.c1) == (
                    r.x.c0, r.x.c1, r.y.c0, r.y.c1)
    for i in (3, 4):                  # y.c1 == 0: the sign falls to y.c0
        r = jcv.g2_decompress(wire[i], subgroup_check=False)
        assert r.y.c1 == 0
        assert (got[i].y.c0, got[i].y.c1) == (r.y.c0, r.y.c1)
    assert ok.tolist() == [False]
    good = staged.k_decode_plain(x[:3], sign[:3], inf[:3])
    assert good[3].tolist() == [True]


def test_subgroup_check_and_projective_eq():
    g = curve.g2_generator("cpu")
    two = curve.double(F2, g)
    two_affine = curve.from_affine(F2, *curve.to_affine(F2, two))
    assert not torch.equal(two.z, two_affine.z)          # Z differs
    assert curve.eq(F2, two, two_affine).item()
    assert not curve.eq(F2, two, g).item()
    inf = curve.infinity(F2, (), "cpu")
    assert curve.eq(F2, inf, inf).item() and not curve.eq(F2, inf, g).item()
    assert curve.g2_subgroup_check(
        curve.Jacobian(*(torch.stack([a, b, c]) for a, b, c in
                         zip(g, two, inf)))).tolist() == [True] * 3


@pytest.mark.slow
def test_k_decode_plain_matches_jax_k_decode(wire):
    from lighthouse_tpu.crypto.bls.tpu import staged as jstaged

    m = len(wire) + 1
    jx, jsign, jinf = jbackend._parse_g2_compressed_many(wire, m)
    jxs, jys, jsi, jok = jstaged.k_decode(
        jnp.asarray(jx), jnp.asarray(jsign), jnp.asarray(jinf))
    x, sign, inf = convert.decode_inputs_from_jax(jx, jsign, jinf)
    xs, ys, si, ok = staged.k_decode_plain(x, sign, inf)
    valid = [jcv.g2_decompress(r, subgroup_check=False) is not None
             for r in wire] + [True]
    keep = torch.tensor(valid)
    assert torch.equal(convert.fp_from_jax(np.asarray(jxs))[keep], xs[keep])
    assert torch.equal(convert.fp_from_jax(np.asarray(jys))[keep], ys[keep])
    assert si.tolist() == [bool(b) for b in np.asarray(jsi)]
    assert ok.tolist() == [bool(jok)]
