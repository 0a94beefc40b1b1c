"""The port's G1 endomorphism, subgroup check, square root and G1
decompression (crypto/bls/cuda/curve.py, the plain versions of k_subgroup
and k_decode_g1) against the JAX package's tpu/curve.py functions, each
jitted at one small shape on the CPU, on the generator, random multiples,
bls_adversarial.json's non_subgroup_pubkey, infinity, both sign bits and an
off-curve x; beta itself against the JAX package's choice and the
generated header; and the plain verify_batch with subgroup checks on a
batch holding a G1 point outside the subgroup (built by the JAX package's
curve_ref.g1_decompress without its check) and without it.  All
comparisons are exact: bools and canonical integers."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import curve_ref as jcv
from lighthouse_tpu.crypto.bls.tpu import curve as jcurve
from lighthouse_tpu.crypto.bls.tpu import fp as jfp
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls.constants import P, R
from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
from lighthouse_tpu_torch.crypto.bls.cuda import convert, curve, fp, staged
from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2
from lighthouse_tpu_torch.crypto.bls.cuda import verify
from lighthouse_tpu_torch.crypto.bls.cuda.curve import F1
from lighthouse_tpu_torch.csrc import gen_consts

RNG = np.random.default_rng(0x5B6)
VECTORS = os.path.join(os.path.dirname(__file__), "vectors")


def non_subgroup_pubkey() -> bytes:
    with open(os.path.join(VECTORS, "bls_adversarial.json")) as f:
        case = [c for c in json.load(f)["cases"]
                if c["name"] == "non_subgroup_pubkey"][0]
    return bytes.fromhex(case["sets"][0]["pubkeys"][0])


def off_curve_x() -> int:
    x = 1
    while (x ** 3 + 4) % P and pow((x ** 3 + 4) % P, (P - 1) // 2, P) == 1:
        x += 1
    return x


def as_port(p):
    from lighthouse_tpu_torch.crypto.bls import fields_ref as fr

    if p.is_infinity():
        return cv.g1_infinity()
    return cv.Point(fr.Fp(p.x.v), fr.Fp(p.y.v), cv.B_G1)


@pytest.fixture(scope="module")
def g1_points():
    """JAX curve_ref points: the generator, two random multiples, the
    non-subgroup key, infinity, a multiple's negation."""
    g = jcv.g1_generator()
    ks = [int(k) for k in RNG.integers(2, 2**62, size=2)]
    ns = jcv.g1_decompress(non_subgroup_pubkey(), subgroup_check=False)
    assert ns is not None and not jcv.g1_subgroup_check(ns)
    return [g, g.mul(ks[0]), g.mul(ks[1]), ns, jcv.g1_infinity(),
            -g.mul(ks[0])]


def test_beta_is_the_jax_choice_and_the_header_constant():
    assert curve.G1_BETA == jcurve.G1_BETA
    assert curve.G1_LAMBDA == jcurve.G1_LAMBDA == (-0xD201000000010000) ** 2 - 1
    beta = curve.G1_BETA
    assert beta != 1 and pow(beta, 3, P) == 1
    g = cv.g1_generator()
    from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp

    assert cv.Point(Fp(beta) * g.x, g.y, g.b) == g.mul(curve.G1_LAMBDA)
    other = beta * beta % P           # the other cube root fails
    assert cv.Point(Fp(other) * g.x, g.y, g.b) != g.mul(curve.G1_LAMBDA)
    text = gen_consts.render()
    words = re.search(r"LH_G1_BETA = \{\{([^}]*)\}\}", text).group(1)
    limbs = [int(w.strip().rstrip("u"), 16) for w in words.split(",")]
    assert fp.limbs_to_int(limbs) == beta * fp.R_MOD_P % P
    lam = re.search(r"LH_G1_LAMBDA\[4\] = \{([^}]*)\}", text).group(1)
    lam = [int(w.strip().rstrip("u"), 16) for w in lam.split(",")]
    assert sum(w << (32 * i) for i, w in enumerate(lam)) == curve.G1_LAMBDA


def test_g1_subgroup_check_matches_jax(g1_points):
    jx, jy, jinf = jcurve.pack_g1_affine(g1_points)
    want = [bool(b) for b in np.asarray(jax.jit(
        lambda x, y, i: jcurve.g1_subgroup_check(
            jcurve.from_affine(jcurve.F1, x, y, i)))(jx, jy, jinf))]
    x, y, inf = curve.pack_g1_affine([as_port(p) for p in g1_points])
    got = curve.g1_subgroup_check(curve.from_affine(F1, x, y, inf)).tolist()
    assert got == want == [True, True, True, False, True, True]
    assert want == [jcv.g1_subgroup_check(p) for p in g1_points]
    # the plain k_subgroup: the same verdicts, a lane that is off passes
    act = torch.tensor([True, True, True, True, True, False])
    x2, y2, i2 = curve.pack_g2_affine([cv.g2_generator()])
    lanes, ok = staged.k_subgroup(
        staged.to_i32(x), staged.to_i32(y), inf, act, staged.to_i32(x2),
        staged.to_i32(y2), i2, torch.ones(1, dtype=torch.bool))
    assert lanes.tolist() == want[:5] + [True, True] and not bool(ok)
    lanes, ok = staged.k_subgroup(
        staged.to_i32(x), staged.to_i32(y), inf, act & (torch.arange(6) != 3),
        staged.to_i32(x2), staged.to_i32(y2), i2,
        torch.ones(1, dtype=torch.bool))
    assert bool(ok)


@pytest.fixture(scope="module")
def wire_g1(g1_points):
    """Compressed bytes: each point of g1_points, and an off-curve x."""
    raws = [jcv.g1_compress(p) for p in g1_points]
    raw = off_curve_x().to_bytes(48, "big")
    return raws + [bytes([raw[0] | 0x80]) + raw[1:]]


def test_g1_decompress_matches_jax(wire_g1):
    x, sign, inf = bk.parse_g1_compressed_many(wire_g1)
    assert sign.tolist()[1] != sign.tolist()[5]        # both sign bits
    xj = jnp.asarray(np.stack([jfp.int_to_limbs(v) for v in
                               fp.unpack(staged.to_i64(x))]))
    jpt, jok = jax.jit(jcurve.g1_decompress)(
        xj, jnp.asarray(sign.numpy()), jnp.asarray(inf.numpy()))
    pt, ok = curve.g1_decompress(staged.to_i64(x), sign, inf)
    assert ok.tolist() == [bool(b) for b in np.asarray(jok)]
    assert ok.tolist() == [True] * 6 + [False]
    for port, jax_ in ((pt.x, jpt.x), (pt.y, jpt.y), (pt.z, jpt.z)):
        assert torch.equal(staged.to_i32(port),
                           convert.fp_from_jax(np.asarray(jax_)))
    # the plain k_decode_g1 against the reference decompression
    for check in (False, True):
        xs, ys, si, lane_ok = staged.k_decode_g1(staged.to_i32(
            staged.to_i64(x)), sign, inf, check=check)
        pts = curve.unpack_g1_affine(staged.to_i64(xs), staged.to_i64(ys),
                                     si)
        for i, raw in enumerate(wire_g1):
            ref = jcv.g1_decompress(raw, subgroup_check=check)
            assert bool(lane_ok[i]) == (ref is not None)
            if ref is not None:
                assert pts[i] == as_port(ref)


def test_fp_sqrt_matches_jax():
    vals = [0, 1, 4, 5, off_curve_x() ** 3 + 4] + [
        int(v) % P for v in RNG.integers(1, 2**62, size=3)]
    a = fp.pack_mont(vals)
    r, ok = curve.fp_sqrt(a)
    ja = jnp.asarray(np.stack([jfp.int_to_limbs(v * jfp.R % P)
                               for v in vals]))
    jr, jok = jax.jit(jcurve.fp_sqrt)(ja)
    assert ok.tolist() == [bool(b) for b in np.asarray(jok)]
    assert ok.tolist() == [pow(v, (P - 1) // 2, P) in (0, 1) for v in vals]
    got = fp.unpack_mont(r)
    want = [v * pow(jfp.R, -1, P) % P for v in jfp.unpack_ints(
        np.asarray(jr))]
    assert got == want
    for v, s, good in zip(vals, got, ok.tolist()):
        assert (s * s % P == v % P) == good


def _batch(n, bad_key=False):
    """n single-key sets (port tensors); with ``bad_key`` lane 1's key is
    the non-subgroup point (its signature stays the original's)."""
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr

    sks = [int(k) for k in RNG.integers(1, 2**62, size=n)]
    msgs = [bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in sks]
    pks = [cv.g1_generator().mul(k) for k in sks]
    if bad_key:
        pks[1] = as_port(jcv.g1_decompress(non_subgroup_pubkey(),
                                           subgroup_check=False))
    sigs = [hr.hash_to_g2(m).mul(k) for m, k in zip(msgs, sks)]
    xp, yp, pi = curve.pack_g1_affine(pks)
    xs, ys, si = curve.pack_g2_affine(sigs)
    rand = torch.as_tensor(bk.random_weights(n, n).view(np.int32))
    return (staged.to_i32(xp), staged.to_i32(yp), pi, staged.to_i32(xs),
            staged.to_i32(ys), si, staged.to_i32(h2.hash_to_field(msgs)),
            rand)


@pytest.mark.parametrize("bad_key", [False, True],
                         ids=["valid", "non_subgroup_key"])
def test_plain_verify_batch_checks_g1_subgroup(bad_key):
    args = _batch(2, bad_key)
    assert bool(verify.verify_batch(*args, check_subgroups=True)) is (
        not bad_key)


@pytest.mark.slow
@pytest.mark.parametrize("bad_key", [False, True],
                         ids=["valid", "non_subgroup_key"])
def test_kernel_sequence_and_verify_each_match_the_plain_versions(bad_key):
    """verify_batch_kernel (the plain launches on the CPU) equals the plain
    verify_batch with and without subgroup checks, and the plain
    verify_each gives the per-set verdicts (the non-subgroup lane False)."""
    args = _batch(3, bad_key)
    for check in (False, True):
        assert bool(verify.verify_batch_kernel(*args, check_subgroups=check)
                    ) is bool(verify.verify_batch(*args,
                                                  check_subgroups=check))
    assert bool(verify.verify_batch_kernel(*args, check_subgroups=True)) is (
        not bad_key)
    each = verify.verify_each(*args[:7], check_subgroups=True).tolist()
    assert each == [True, not bad_key, True]


@pytest.mark.slow
def test_multi_kernel_sequence_matches_plain_and_the_jax_verdict():
    """verify_batch_multi_kernel and the plain verify_batch_multi on a
    3-key set beside a 1-key set and a padding set, valid and with the
    signatures swapped, against the JAX "python" backend."""
    from lighthouse_tpu.crypto.bls import api as jbls

    sks = [[int(k) for k in RNG.integers(1, 2**62, size=c)] for c in (3, 1)]
    msgs = [bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in sks]
    raws = [jbls.SecretKey(sum(k) % R).sign(m).to_bytes()
            for k, m in zip(sks, msgs)]
    for swapped in (False, True):
        sig_raws = raws[::-1] if swapped else raws
        jsets = [jbls.SignatureSet(
            jbls.Signature.from_bytes(r),
            [jbls.SecretKey(k).public_key() for k in ks], m)
            for r, ks, m in zip(sig_raws, sks, msgs)]
        prev = jbls.get_backend().name
        jbls.set_backend("python")
        try:
            want = jbls.verify_signature_sets(jsets)
        finally:
            jbls.set_backend(prev)
        assert want is not swapped
        k, n = 3, 3
        pts = [[cv.g1_generator().mul(x) for x in ks] for ks in sks]
        flat = []
        for i in range(n):
            row = pts[i] if i < 2 else []
            flat += row + [cv.g1_infinity()] * (k - len(row))
        x, y, inf = curve.pack_g1_affine(flat)
        mask = torch.tensor([[True] * 3, [True, False, False], [False] * 3])
        sigs = [cv.g2_decompress(r) for r in sig_raws] + [cv.g2_infinity()]
        xs, ys, si = curve.pack_g2_affine(sigs)
        u = staged.to_i32(h2.hash_to_field(msgs + [b""]))
        rand = torch.as_tensor(bk.random_weights(n, 2).view(np.int32))
        args = (staged.to_i32(x).reshape(n, k, -1),
                staged.to_i32(y).reshape(n, k, -1), inf.reshape(n, k), mask,
                staged.to_i32(xs), staged.to_i32(ys), si, u, rand)
        for check in (False, True):
            assert bool(verify.verify_batch_multi_kernel(
                *args, check_subgroups=check)) is want
        assert bool(verify.verify_batch_multi(*args)) is want
