"""The port's plain field arithmetic (lighthouse_tpu_torch crypto/bls/cuda
fp, fp2, tower) against the JAX package and the pure-Python tower.

Inputs come from numpy with a fixed seed; values compare as canonical
integers with tolerance zero (exact finite-field arithmetic).  JAX functions
run on the CPU under jit; JAX's fp2.sqrt compiles for ~10-15 s on one core,
so its comparison is in the slow tier and tier 1 holds the port's square
root against fields_ref.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import fields_ref as jfr
from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.tpu import fp as jfp
from lighthouse_tpu.crypto.bls.tpu import fp2 as jfp2
from lighthouse_tpu_torch.crypto.bls import fields_ref as fr
from lighthouse_tpu_torch.crypto.bls.cuda import convert, fp, fp2, tower
from lighthouse_tpu_torch.csrc import gen_consts

RNG = np.random.default_rng(0x7F1E1D)


def rand_ints(n):
    words = RNG.integers(0, 2**32, size=(n, 12), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P
            for row in words]


EDGE = [0, 1, 2, P - 1, P - 2, (P - 1) // 2]


def test_fp_mont_mul_matches_jax():
    a = EDGE + rand_ints(10)
    b = rand_ints(len(EDGE)) + EDGE[::-1] + rand_ints(4)
    ja = jnp.asarray(jfp.mont_ints_to_limbs(a))
    jb = jnp.asarray(jfp.mont_ints_to_limbs(b))
    jout = np.asarray(jax.jit(jfp.mont_mul)(ja, jb))
    pa = convert.fp_from_jax(np.asarray(ja)).to(torch.int64) & 0xFFFFFFFF
    pb = convert.fp_from_jax(np.asarray(jb)).to(torch.int64) & 0xFFFFFFFF
    got = fp.mont_mul(pa, pb)
    want = convert.fp_from_jax(jout).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got, want)
    assert fp.unpack_mont(got) == [x * y % P for x, y in zip(a, b)]


def test_fp_ops_exact():
    a = EDGE + rand_ints(8)
    b = EDGE[::-1] + rand_ints(8)
    ta, tb = fp.pack_mont(a), fp.pack_mont(b)
    assert fp.unpack_mont(fp.add(ta, tb)) == [(x + y) % P for x, y in zip(a, b)]
    assert fp.unpack_mont(fp.sub(ta, tb)) == [(x - y) % P for x, y in zip(a, b)]
    assert fp.unpack_mont(fp.neg(ta)) == [(-x) % P for x in a]
    assert fp.unpack_mont(fp.pow(ta, 0x1234567)) == [
        pow(x, 0x1234567, P) for x in a]
    assert fp.unpack_mont(fp.inv_many(ta)) == [pow(x, P - 2, P) for x in a]
    assert fp.unpack(fp.from_mont(ta)) == a
    assert torch.equal(fp.to_mont(fp.pack(a)), ta)
    # every output is fully reduced
    for t in (fp.add(ta, tb), fp.sub(ta, tb), fp.mont_mul(ta, tb)):
        assert all(v < P for v in fp.unpack(t))


def test_fp2_mul_matches_jax_mul_stacked():
    pairs_a = list(zip(rand_ints(6), rand_ints(6))) + [(0, 0), (P - 1, 1)]
    pairs_b = list(zip(rand_ints(8), rand_ints(8)))
    ja = jnp.asarray(np.stack([jfp2.pack_mont(*p) for p in pairs_a]))
    jb = jnp.asarray(np.stack([jfp2.pack_mont(*p) for p in pairs_b]))
    jout = np.asarray(jax.jit(jfp2.mul_stacked)(ja[None], jb[None]))[0]
    pa = convert.fp_from_jax(np.asarray(ja)).to(torch.int64) & 0xFFFFFFFF
    pb = convert.fp_from_jax(np.asarray(jb)).to(torch.int64) & 0xFFFFFFFF
    want = convert.fp_from_jax(jout).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(fp2.mul(pa, pb), want)
    got_sq = fp2.unpack_mont(fp2.sqr(pa))
    assert got_sq == [((jfr.Fp2(*p).square()).c0, (jfr.Fp2(*p).square()).c1)
                      for p in pairs_a]


def _sqrt_inputs():
    base = list(zip(rand_ints(4), rand_ints(4)))
    squares = [fr.Fp2(*p).square() for p in base]
    return ([(s.c0, s.c1) for s in squares]
            + [(0, 0), (rand_ints(1)[0], 0)] + list(zip(rand_ints(3),
                                                         rand_ints(3))))


def test_fp2_sqrt_against_fields_ref():
    vals = _sqrt_inputs()
    root, ok = fp2.sqrt(fp2.pack_mont(vals))
    for (c0, c1), r, good in zip(vals, fp2.unpack_mont(root), ok.tolist()):
        a = fr.Fp2(c0, c1)
        assert good == (a.is_zero() or a.is_square())
        if good:
            assert fr.Fp2(*r).square() == a


@pytest.mark.slow
def test_fp2_sqrt_matches_jax():
    vals = _sqrt_inputs()
    ja = jnp.asarray(np.stack([jfp2.pack_mont(*p) for p in vals]))
    jroot, jok = jax.jit(jfp2.sqrt)(ja)
    root, ok = fp2.sqrt(convert.fp_from_jax(np.asarray(ja)).to(torch.int64)
                        & 0xFFFFFFFF)
    assert ok.tolist() == np.asarray(jok).tolist()
    want = convert.fp_from_jax(np.asarray(jroot)).to(torch.int64) & 0xFFFFFFFF
    sel = ok.nonzero().reshape(-1)
    assert torch.equal(root[sel], want[sel])


# --- tower vs fields_ref -----------------------------------------------------


def _rand_f12(n):
    out = []
    for _ in range(n):
        c = [fr.Fp2(*p) for p in zip(rand_ints(6), rand_ints(6))]
        out.append(fr.Fp12(fr.Fp6(*c[:3]), fr.Fp6(*c[3:])))
    return out


def _pack12(fs):
    flat = []
    for f in fs:
        for c6 in (f.c0, f.c1):
            flat += [(c.c0, c.c1) for c in (c6.c0, c6.c1, c6.c2)]
    return fp2.pack_mont(flat).reshape(len(fs), 2, 3, 2, fp.N_LIMBS)


def _unpack12(t):
    v = fp2.unpack_mont(t)
    out = []
    for i in range(0, len(v), 6):
        c = [fr.Fp2(*v[i + j]) for j in range(6)]
        out.append(fr.Fp12(fr.Fp6(*c[:3]), fr.Fp6(*c[3:])))
    return out


@pytest.fixture(scope="module")
def f12():
    a, b = _rand_f12(2), _rand_f12(2)
    return a, b, _pack12(a), _pack12(b)


@pytest.mark.parametrize("op", ["mul", "inv", "conj", "frob1", "frob2"])
def test_tower_matches_fields_ref(f12, op):
    a, b, ta, tb = f12
    if op == "mul":
        assert _unpack12(tower.mul(ta, tb)) == [x * y for x, y in zip(a, b)]
    elif op == "inv":
        assert _unpack12(tower.inv(ta)) == [x.inv() for x in a]
    elif op == "conj":
        assert _unpack12(tower.conj(ta)) == [x.conjugate() for x in a]
    else:
        k = 1 if op == "frob1" else 2
        assert _unpack12(tower.frobenius(ta, k)) == [x.pow(P**k) for x in a]


def test_tower_line_and_cyclotomic(f12):
    a, _b, ta, _tb = f12
    coef = [fp2.pack_mont(list(zip(rand_ints(2), rand_ints(2))))
            for _ in range(3)]
    la, lb, lc = (fp2.unpack_mont(t) for t in coef)
    z = fr.Fp2(0, 0)
    lines = [fr.Fp12(fr.Fp6(z, z, fr.Fp2(*la[i])),
                     fr.Fp6(fr.Fp2(*lb[i]), fr.Fp2(*lc[i]), z))
             for i in range(2)]
    got = _unpack12(tower.mul_by_line(ta, *coef))
    assert got == [x * ln for x, ln in zip(a, lines)]
    cyc = [x.conjugate() * x.inv() for x in a]
    cyc = [c.pow(P * P) * c for c in cyc]
    assert _unpack12(tower.cyclotomic_sqr(_pack12(cyc))) == [c * c
                                                             for c in cyc]
    assert tower.is_one(tower.one((2,), "cpu")).all()
    assert not tower.is_one(ta).any()


# --- constants header and state conversion -----------------------------------


def test_cuda_constants_header_is_generated():
    with open(gen_consts.HEADER) as f:
        assert f.read() == gen_consts.render()


def test_convert_roundtrips_jax_layouts():
    from lighthouse_tpu.crypto.bls import curve_ref as jcv
    from lighthouse_tpu.crypto.bls.tpu import curve as jcurve
    from lighthouse_tpu.crypto.bls.tpu import hash_to_g2 as jh2
    from lighthouse_tpu_torch.crypto.bls.cuda import curve

    vals = EDGE + rand_ints(5)
    limbs = jfp.mont_ints_to_limbs(vals)
    port = convert.fp_from_jax(limbs)
    assert fp.unpack_mont(port) == vals
    assert np.array_equal(convert.fp_to_jax(port), limbs)
    # loose JAX limbs (value >= p) convert to the canonical element
    loose = np.asarray(jfp.add(jnp.asarray(limbs), jnp.asarray(limbs)))
    assert fp.unpack_mont(convert.fp_from_jax(loose)) == [
        2 * v % P for v in vals]
    g1 = [jcv.g1_generator().mul(k) for k in (3, 5)] + [jcv.g1_infinity()]
    jx, jy, ji = (np.asarray(t) for t in jcurve.pack_g1_affine(g1))
    px, py, pi = convert.g1_affine_from_jax(jx, jy, ji)
    want = curve.pack_g1_affine(
        [fr_pt for fr_pt in _port_g1(g1)])
    assert torch.equal(px.to(torch.int64) & 0xFFFFFFFF, want[0])
    assert torch.equal(py.to(torch.int64) & 0xFFFFFFFF, want[1])
    assert pi.tolist() == [False, False, True]
    g2 = [jcv.g2_generator().mul(7), jcv.g2_infinity()]
    jx, jy, ji = (np.asarray(t) for t in jcurve.pack_g2_affine(g2))
    px, py, pi = convert.g2_affine_from_jax(jx, jy, ji)
    assert fp2.unpack_mont(px.to(torch.int64) & 0xFFFFFFFF)[0] == (
        g2[0].x.c0, g2[0].x.c1)
    assert pi.tolist() == [False, True]
    u = jh2.hash_to_field([b"abc", b"\x00" * 32])
    assert fp.unpack(convert.u_from_jax(u)) == [
        v for m in (b"abc", b"\x00" * 32)
        for e in jfr_h2f(m) for v in (e.c0, e.c1)]
    ax, ay, ainf = convert.arena_rows_from_jax(
        np.concatenate([np.zeros((1, 30), np.uint32), limbs[:2]]),
        np.concatenate([np.zeros((1, 30), np.uint32), limbs[2:4]]))
    assert ainf.tolist() == [True, False, False]
    rand = np.array([[1, 0xFFFFFFFF], [0x80000000, 7]], np.uint32)
    w = convert.weights_from_jax(rand)
    assert w.dtype == torch.int32
    assert np.array_equal(w.numpy().view(np.uint32), rand)


def _port_g1(points):
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv

    return [cv.g1_infinity() if p.is_infinity() else
            cv.Point(fr.Fp(p.x.v), fr.Fp(p.y.v), cv.B_G1) for p in points]


def jfr_h2f(msg):
    from lighthouse_tpu.crypto.bls.hash_to_curve_ref import hash_to_field_fp2

    return hash_to_field_fp2(msg, 2)
