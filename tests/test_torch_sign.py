"""The port's batched signer (lighthouse_tpu_torch crypto/bls/cuda/signer.py
and crypto/bls/sign_engine.py) against the JAX package, on the CPU where
the kernels' plain versions run:

  * the host wire assembly (compress_to_wire, parse_wire_planes) byte for
    byte against the JAX functions, on both signs, infinity, a y with
    c1 == 0 and malformed encodings;
  * plain k_sign_root and k_sign_field (scalars 1, r - 1, a random one and
    the zero padding row) against the JAX api's SecretKey(k).sign(msg);
  * plain k_sign_agg against AggregateSignature.from_signatures and the
    JAX kernel's ok = all(ok | ~mask) (a repeat, a negation, a masked lane,
    an off-curve x, an on-curve point outside G2);
  * sign_batch(device="cpu") over mixed message lengths against the JAX
    sign_engine on its python backend; threshold routing, empty inputs, an
    empty group, BlsError on a bad signature, and no host hop when a
    kernel's plain version raises.

Inputs come from a numpy seed; signatures and aggregates compare as bytes
(tolerance 0).  The JAX signer's own kernels take minutes of XLA compile
on a CPU, so their comparison is the slow-marked test at the end.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu.crypto.bls import sign_engine as jse
from lighthouse_tpu.crypto.bls.tpu import fp as jfp
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
from lighthouse_tpu_torch.crypto.bls import sign_engine as se
from lighthouse_tpu_torch.crypto.bls.constants import P, R
from lighthouse_tpu_torch.crypto.bls.cuda import convert, fp, signer
from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2
from lighthouse_tpu_torch.crypto.bls.cuda import seckey_cache, staged
from tests.test_torch_wire_vectors import (
    OFF_CURVE_X1, non_subgroup_signature, real_y_point)

RNG = np.random.default_rng(0x516E)
INF = bls.INFINITY_SIGNATURE


def _rand_scalar():
    return int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1


def _words(ks):
    return torch.tensor([[(k >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
                         for k in ks], dtype=torch.int64).to(torch.int32)


def _jax_sign(k, msg):
    return jbls.SecretKey(k).sign(msg).to_bytes() if k else INF


@pytest.fixture(scope="module", autouse=True)
def _real_signing():
    """The JAX api signs for real only off its fake_crypto backend; the
    port's sign engine starts from its defaults."""
    jbls.set_backend("python")
    se.reset_engine()
    seckey_cache.reset_cache()
    yield
    se.reset_engine()


def _planes(points):
    """Points -> (x plain ints (c0, c1), sign, inf) as the card emits."""
    rows = []
    for p in points:
        if p.is_infinity():
            rows.append(((0, 0), False, True))
            continue
        y = p.y
        lex = y.c1 > (P - 1) // 2 if y.c1 else y.c0 > (P - 1) // 2
        rows.append(((p.x.c0, p.x.c1), lex, False))
    return rows


def test_compress_to_wire_matches_jax():
    sig = hr.hash_to_g2(RNG.bytes(32)).mul(_rand_scalar())
    ry = real_y_point()
    pts = [sig, -sig, ry, -ry, cv.g2_infinity()]
    rows = _planes(pts)
    assert {s for _, s, i in rows if not i} == {False, True}
    vals = [v for (c, _, _) in rows for v in c]
    sign = np.array([s for _, s, _ in rows])
    inf = np.array([i for _, _, i in rows])
    x = fp.ints_to_limbs(vals).reshape(len(pts), 2, fp.N_LIMBS)
    got = se.compress_to_wire(torch.from_numpy(x.view(np.int32)),
                              torch.from_numpy(sign), torch.from_numpy(inf))
    jx = convert.ints_to_jax_limbs(vals).reshape(len(pts), 2,
                                                 convert.JAX_N_LIMBS)
    want = jse.compress_to_wire(jx, sign, inf)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert [bytes(r) for r in got] == [cv.g2_compress(p) for p in pts]
    assert np.array_equal(se.compress_to_wire(x, sign, inf), got)


def test_parse_wire_planes_matches_jax():
    sig = hr.hash_to_g2(RNG.bytes(32)).mul(_rand_scalar())
    ry = real_y_point()
    good = [cv.g2_compress(p) for p in (sig, -sig, ry, cv.g2_infinity())]
    big_x = bytearray(good[0])
    big_x[48:] = P.to_bytes(48, "big")             # c0 = p: out of range
    bad = [bytes(big_x), bytes(96),                # no compression flag
           bytes([0xE0]) + bytes(95)]              # infinity with a sign
    raws = good + [OFF_CURVE_X1, non_subgroup_signature()] + bad
    x, sign, inf, ok = se.parse_wire_planes(raws)
    jx, jsign, jinf, jok = jse.parse_wire_planes(raws)
    assert x.shape == (len(raws), 2, fp.N_LIMBS) and x.dtype == np.uint32
    assert [fp.limbs_to_int(r) for r in x.reshape(-1, fp.N_LIMBS)] == \
        convert.jax_limbs_to_ints(jx)
    for a, b in ((sign, jsign), (inf, jinf), (ok, jok)):
        assert a.tolist() == b.tolist()
    assert ok.tolist() == [True] * 6 + [False] * 3


def test_plain_sign_root_matches_jax_api():
    ks = [1, R - 1, _rand_scalar(), 0]             # 0: the padding row
    msgs = [RNG.bytes(32) for _ in ks]
    words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32))
    out = signer.k_sign_root(_words(ks), words)
    assert [t.shape for t in out] == [(4, 2, 12), (4,), (4,)]
    assert [bytes(r) for r in se.compress_to_wire(*out)] == [
        _jax_sign(k, m) for k, m in zip(ks, msgs)]
    assert out[2].tolist() == [False, False, False, True]
    assert not out[0][3].any() and not out[1][3]


def test_plain_sign_field_matches_jax_api():
    ks = [R - 1, (1 << 254) + 5, 0, _rand_scalar()]  # bit 254; a pad row
    msgs = [b"", RNG.bytes(48), RNG.bytes(100), RNG.bytes(31)]
    u = staged.to_i32(h2.hash_to_field(msgs))
    out = signer.k_sign_field(_words(ks), u)
    assert [bytes(r) for r in se.compress_to_wire(*out)] == [
        _jax_sign(k, m) for k, m in zip(ks, msgs)]


def _agg_planes(rows, live):
    x, sign, inf, ok = se.parse_wire_planes([r for row in rows for r in row])
    assert ok.all()
    m, k = len(rows), len(rows[0])
    return (torch.from_numpy(x.view(np.int32)).reshape(m, k, 2, 12),
            torch.from_numpy(sign).reshape(m, k),
            torch.from_numpy(inf).reshape(m, k), torch.tensor(live))


def _jax_aggregate(raws):
    return jbls.AggregateSignature.from_signatures(
        [jbls.Signature.from_bytes(r) for r in raws]).to_bytes()


def test_plain_sign_agg_matches_jax():
    sigs = [hr.hash_to_g2(RNG.bytes(32)).mul(_rand_scalar())
            for _ in range(2)]
    raw = [cv.g2_compress(p) for p in sigs]
    neg = cv.g2_compress(-sigs[1])
    rows = [[raw[0], raw[0], raw[1]],              # a repeat doubles
            [raw[1], neg, OFF_CURVE_X1]]           # sigma + (-sigma)
    for live, ok in (([[True] * 3, [True, True, False]], [True, True]),
                     ([[True, False, True], [True] * 3], [True, False])):
        ax, asign, ainf, aok = signer.k_sign_agg(*_agg_planes(rows, live))
        # the JAX kernel's ok: every live lane on the curve (no subgroup
        # check), held with the host reference
        on_curve = [[cv.g2_decompress(r, subgroup_check=False) is not None
                     for r in row] for row in rows]
        assert aok.tolist() == ok == [
            all(c or not lv for c, lv in zip(cs, ls))
            for cs, ls in zip(on_curve, live)]
        wire = [bytes(r) for r in se.compress_to_wire(ax, asign, ainf)]
        assert wire[0] == _jax_aggregate(
            [r for r, lv in zip(rows[0], live[0]) if lv])
        if ok[1]:
            assert wire[1] == _jax_aggregate(rows[1][:2]) == INF
            assert ainf.tolist() == [False, True]


def test_aggregate_of_a_point_outside_g2_follows_the_device_kernel():
    """The reference disagrees with itself here: its device aggregate (no
    subgroup check) sums an on-curve point outside G2, its host path
    (Signature.from_bytes) raises.  The port follows the device kernel."""
    se.configure(threshold=1)
    sig = cv.g2_compress(hr.hash_to_g2(b"m" * 32).mul(7))
    outside = non_subgroup_signature()
    got = se.aggregate_batch([[sig, outside]], device="cpu")
    want = cv.g2_decompress(sig) + cv.g2_decompress(
        outside, subgroup_check=False)
    assert got == [cv.g2_compress(want)]
    with pytest.raises(jbls.BlsError):
        jbls.Signature.from_bytes(outside)
    se.configure(threshold=10)                     # the host path
    with pytest.raises(bls.BlsError):
        se.aggregate_batch([[sig, outside]], device="cpu")
    se.reset_engine()


def test_sign_batch_on_cpu_matches_the_jax_python_engine():
    seckey_cache.reset_cache()
    se.configure(threshold=1)
    ks = [0x5EE0 + 7 * i for i in range(5)]
    msgs = [RNG.bytes(32), b"not a root", RNG.bytes(32), RNG.bytes(96),
            RNG.bytes(32)]                          # two launches
    pks = [RNG.bytes(48) for _ in ks]               # arena identities
    got = se.sign_batch([(bls.SecretKey(k), m, pk)
                         for k, m, pk in zip(ks, msgs, pks)], device="cpu")
    jse.configure(backend="python")
    try:
        want = jse.sign_batch([(jbls.SecretKey(k), m, pk)
                               for k, m, pk in zip(ks, msgs, pks)])
    finally:
        jse.reset_engine()
    assert got == want
    call = se.last_call()
    assert call["backend"] == "cuda" and call["n"] == 5
    assert call["device"] == "cpu"
    assert set(call["stages"]) == {"pack", "dispatch", "compress"}
    assert call["sync_bytes"] > 0                   # a cold arena
    assert len(seckey_cache.get_cache()) == 5
    se.reset_engine()


def test_threshold_routing_and_empty_inputs():
    assert se.engine_status() == {"requested": "cuda", "threshold": 4}
    assert [se.backend_for(n) for n in (1, 3, 4, 64)] == [
        "python", "python", "cuda", "cuda"]
    sk = bls.SecretKey(0x5EE0)
    msgs = [b"\x01" * 32, b"short"]
    entries = [(sk, m, b"pk") for m in msgs]
    assert se.sign_batch(entries) == [sk.sign(m).to_bytes() for m in msgs]
    assert se.last_call()["backend"] == "python"    # under the threshold
    assert se.sign_batch([]) == [] and se.aggregate_batch([]) == []
    sig = sk.sign(msgs[0]).to_bytes()
    se.configure(threshold=1)
    # an empty group takes the host path: its aggregate is infinity
    assert se.aggregate_batch([[sig], []], device="cpu") == [sig, INF]
    assert se.last_call()["backend"] == "python"
    se.configure(backend="python")
    assert se.backend_for(100) == "python"
    with pytest.raises(ValueError, match="unknown sign backend"):
        se.configure(backend="jax")
    se.reset_engine()
    assert se.engine_status()["requested"] == "cuda"


def test_aggregate_batch_raises_blserror_on_a_bad_signature():
    se.configure(threshold=1)
    sig = cv.g2_compress(hr.hash_to_g2(b"x" * 32).mul(3))
    with pytest.raises(bls.BlsError, match="encoding"):
        se.aggregate_batch([[sig, bytes(96)]], device="cpu")
    with pytest.raises(bls.BlsError, match="curve"):
        se.aggregate_batch([[sig], [OFF_CURVE_X1, sig]], device="cpu")
    se.reset_engine()


def test_no_host_hop_when_a_kernel_fails(monkeypatch):
    def broken(*_a):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(signer, "k_sign_root_plain", broken)
    monkeypatch.setattr(signer, "k_sign_agg_plain", broken)
    se.configure(threshold=1)
    se._LAST_CALL.clear()
    sk = bls.SecretKey(5)
    with pytest.raises(RuntimeError, match="kernel fault"):
        se.sign_batch([(sk, b"\x02" * 32, b"pk5")], device="cpu")
    sig = sk.sign(b"\x02" * 32).to_bytes()
    with pytest.raises(RuntimeError, match="kernel fault"):
        se.aggregate_batch([[sig, sig]], device="cpu")
    assert se.last_call() == {}                     # nothing answered
    se.reset_engine()


@pytest.mark.slow
def test_jax_sign_kernels_match_the_plain_versions():
    """The JAX signer's own programs (XLA compiles of minutes on a CPU)
    against the plain versions, as canonical integers: its 255-step ladder
    and compression (signer._ladder_compress, k_sign_root after the hash
    to G2, whose device version slice 1 holds against hash_to_curve_ref)
    from the same H(m), and k_sign_agg at (2, 4)."""
    import jax
    import jax.numpy as jnp

    from lighthouse_tpu.crypto.bls.tpu import curve as jcurve
    from lighthouse_tpu.crypto.bls.tpu import signer as jsigner

    ks = [1, R - 1, _rand_scalar(), 0]
    msgs = [RNG.bytes(32) for _ in ks]
    hx, hy, hinf = jcurve.pack_g2_affine([hr.hash_to_g2(m) for m in msgs])
    base = jcurve.from_affine(jcurve.F2, jnp.asarray(hx), jnp.asarray(hy),
                              jnp.asarray(hinf))
    w = _words(ks)
    jx, jsign, jinf = jax.jit(jsigner._ladder_compress)(
        jnp.asarray(w.numpy().view(np.uint32)), base)
    x, sign, inf = signer.k_sign_root(
        w, torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)))
    assert fp.unpack(x) == [v % P for v in convert.jax_limbs_to_ints(jx)]
    assert sign.tolist() == np.asarray(jsign).tolist()
    assert inf.tolist() == np.asarray(jinf).tolist() == [False] * 3 + [True]

    sigs = [hr.hash_to_g2(RNG.bytes(32)).mul(_rand_scalar())
            for _ in range(2)]
    raw = [cv.g2_compress(p) for p in sigs]
    # row 0 holds an on-curve point outside G2, which the JAX kernel sums
    # (ROADMAP queue 3: its host path raises instead)
    rows = [[raw[0], raw[0], non_subgroup_signature(), raw[1]],
            [raw[1], cv.g2_compress(-sigs[1]), OFF_CURVE_X1, raw[0]]]
    live = [[True, True, True, False], [True, True, True, True]]
    args = _agg_planes(rows, live)
    jl, js, ji, _ = jse.parse_wire_planes([r for row in rows for r in row])
    jout = jsigner.k_sign_agg(
        jnp.asarray(jl.reshape(2, 4, 2, jfp.N_LIMBS)),
        jnp.asarray(js.reshape(2, 4)), jnp.asarray(ji.reshape(2, 4)),
        jnp.asarray(np.array(live)))
    out = signer.k_sign_agg(*args)
    assert out[3].tolist() == np.asarray(jout[3]).tolist() == [True, False]
    assert fp.unpack(out[0][0]) == [
        v % P for v in convert.jax_limbs_to_ints(jout[0][0])]
    assert out[1][0] == bool(jout[1][0]) and out[2][0] == bool(jout[2][0])
    want = cv.g2_decompress(raw[0]) + cv.g2_decompress(raw[0]) + \
        cv.g2_decompress(rows[0][2], subgroup_check=False)
    assert [bytes(r) for r in se.compress_to_wire(*out[:3])][0] == \
        cv.g2_compress(want)
