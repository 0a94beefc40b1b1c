"""The port's KZG blob-verification path against the JAX package's, on the
CPU: Fr arithmetic, the barycentric evaluation (k_blob_eval's plain
version), the trusted setup and its commitments and proofs, and the
facade's verdicts.  Inputs come from numpy with a seed; every tolerance is
exact equality of canonical integers, bytes or verdicts.

The JAX k_blob_eval is jitted here once at (3, 8), not run through the
JAX package's ``eval_blobs``, whose pickled-executable cache is keyed
without the device layout.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu.crypto.kzg import fr as jfr
from lighthouse_tpu.crypto.kzg import kernels as jkernels
from lighthouse_tpu.crypto.kzg import reference as jref
from lighthouse_tpu.crypto.kzg import setup as jset

from lighthouse_tpu_torch.crypto import kzg
from lighthouse_tpu_torch.crypto.bls.cuda import convert
from lighthouse_tpu_torch.crypto.kzg import reference as ref
from lighthouse_tpu_torch.crypto.kzg import setup as kset
from lighthouse_tpu_torch.crypto.kzg.cuda import fr
from lighthouse_tpu_torch.crypto.kzg.cuda import kernel as K

R = ref.R


def _scalars(rng, n):
    """n uniform scalars < r from numpy bytes."""
    raw = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    return [int.from_bytes(bytes(row), "big") % R for row in raw]


def _jax_ints(arr):
    return convert.jax_limbs_to_ints(np.asarray(arr), convert.JAX_FR_LIMBS)


# --- 1. Fr ops ---------------------------------------------------------------


@jax.jit
def _jax_fr_ops(a, b):
    return (jfr.from_mont(jfr.mont_mul(a, b)), jfr.from_mont(jfr.add(a, b)),
            jfr.from_mont(jfr.sub(a, b)), jfr.from_mont(jfr.inv_many(a)))


def test_fr_ops_match_the_jax_package_and_python():
    rng = np.random.default_rng(0xF4)
    a = [0, 1, R - 1, R - 2] + _scalars(rng, 12)
    b = _scalars(rng, 12) + [R - 1, 0, 1, R - 2]
    jm, ja, js, ji = _jax_fr_ops(jnp.asarray(jfr.mont_ints_to_limbs(a)),
                                 jnp.asarray(jfr.mont_ints_to_limbs(b)))
    am, bm = fr.pack_mont(a), fr.pack_mont(b)
    want_mul = [x * y % R for x, y in zip(a, b)]
    want_inv = [pow(x, R - 2, R) for x in a]
    assert fr.unpack_mont(fr.mont_mul(am, bm)) == _jax_ints(jm) == want_mul
    assert fr.unpack_mont(fr.sqr(am)) == [x * x % R for x in a]
    assert fr.unpack(fr.add(fr.pack(a), fr.pack(b))) == _jax_ints(ja) \
        == [(x + y) % R for x, y in zip(a, b)]
    assert fr.unpack(fr.sub(fr.pack(a), fr.pack(b))) == _jax_ints(js) \
        == [(x - y) % R for x, y in zip(a, b)]
    assert fr.unpack(fr.neg(fr.pack(a))) == [(-x) % R for x in a]
    assert fr.unpack_mont(fr.inv_many(am)) == _jax_ints(ji) == want_inv
    assert fr.unpack_mont(fr.inv(am)) == want_inv
    assert fr.unpack(fr.from_mont(fr.to_mont(fr.pack(a)))) == a


def test_device_header_constants_match_the_field():
    import os
    import re

    path = os.path.join(os.path.dirname(fr.__file__), os.pardir, os.pardir,
                        os.pardir, "csrc", "fr.cuh")
    text = open(path).read()

    def words(name):
        body = re.search(name + r" = \{\{([^}]*)\}\}", text).group(1)
        return fr.limbs_to_int(int(w.strip().rstrip("u"), 16)
                               for w in body.split(","))

    assert words("FR_MOD") == R
    assert words("FR_ONE") == fr.RADIX_MOD_R
    assert words("FR_R2") == fr.RADIX2_MOD_R
    assert words("FR_EXP_INV") == R - 2
    n0 = int(re.search(r"#define FR_N0 (0x[0-9a-f]+)u", text).group(1), 16)
    assert n0 == (-pow(R, -1, 1 << 32)) % (1 << 32)


# --- 2. k_blob_eval_plain against the JAX k_blob_eval ------------------------


_JAX_EVAL = jax.jit(jkernels.k_blob_eval)


def test_blob_eval_plain_matches_the_jax_kernel():
    rng = np.random.default_rng(0xB10B)
    n = 8
    polys = [_scalars(rng, n) for _ in range(3)]
    roots = ref.roots_of_unity(n)
    zs = [_scalars(rng, 1)[0], roots[3], 0]
    jroots, jinv_n = jkernels._domain_mont(n)
    flat = [v for p in polys for v in p]
    out = _JAX_EVAL(jnp.asarray(jfr.mont_ints_to_limbs(flat).reshape(
        3, n, jfr.N_LIMBS)), jnp.asarray(jfr.mont_ints_to_limbs(zs)),
        jnp.asarray(jroots), jnp.asarray(jinv_n))
    got = K.eval_blobs(K.ints_to_words(polys), zs, device="cpu")
    assert got == _jax_ints(out)
    assert got == [ref.evaluate_polynomial(p, z) for p, z in zip(polys, zs)]
    assert got[1] == polys[1][3]


# --- 3. k_blob_eval_plain against reference.evaluate_polynomial --------------


@pytest.mark.parametrize("case", ["minimal_2x64", "mainnet_1x4096", "n1",
                                  "n2", "zero_blob", "z_one", "r_minus_1"])
def test_blob_eval_plain_matches_the_reference(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    b, n = {"minimal_2x64": (2, 64), "mainnet_1x4096": (1, 4096),
            "n1": (2, 1), "n2": (2, 2)}.get(case, (2, 16))
    polys = [_scalars(rng, n) for _ in range(b)]
    zs = _scalars(rng, b)
    if case in ("n1", "n2"):
        zs[1] = ref.roots_of_unity(n)[-1]           # a hit on the last root
    if case == "zero_blob":
        polys[0] = [0] * n
    if case == "z_one":
        zs = [1] * b
    if case == "r_minus_1":
        polys[0] = [R - 1] * n
        zs[1] = 0
    words = K.ints_to_words(polys)
    assert K.eval_blobs(words, zs, device="cpu") == \
        [ref.evaluate_polynomial(p, z) for p, z in zip(polys, zs)]


def test_blob_words_reads_big_endian_elements_and_flags_non_canonical():
    rng = np.random.default_rng(3)
    vals = _scalars(rng, 4)
    blob = b"".join(v.to_bytes(32, "big") for v in vals)
    words, ok = K.blob_words([blob])
    assert ok.tolist() == [True]
    assert fr.unpack(torch.from_numpy(words.astype(np.int64))) == vals
    for bad in (R, R + 1, (1 << 256) - 1):
        tampered = blob[:32] + bad.to_bytes(32, "big") + blob[64:]
        assert K.blob_words([tampered, blob])[1].tolist() == [False, True]
    edge = (R - 1).to_bytes(32, "big") * 4
    assert K.blob_words([edge])[1].tolist() == [True]


# --- 4. Conversions, setup, commitments and proofs ---------------------------


def test_fr_conversions_round_trip():
    rng = np.random.default_rng(0xC0)
    vals = [0, 1, R - 1] + _scalars(rng, 5)
    jm = jfr.mont_ints_to_limbs(vals)
    port = convert.fr_from_jax(jm)
    assert fr.unpack_mont(port) == vals
    assert np.array_equal(convert.fr_to_jax(port), jm)
    jp = jfr.ints_to_limbs(vals)
    plain = convert.fr_from_jax(jp, mont=False)
    assert fr.unpack(plain) == vals
    assert np.array_equal(convert.fr_to_jax(plain, mont=False), jp)


@pytest.fixture(scope="module")
def batch():
    """4 blobs of 64 elements (MINIMAL's width is 4,096; 64 keeps the
    host generation cheap) with the dev setup's commitments and proofs."""
    kzg.reset_engine()
    blobs = [kset.make_blob(64, b"torch-kzg-%d" % i) for i in range(4)]
    cs = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    ps = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]
    return blobs, cs, ps


def test_setup_commitments_and_proofs_match_the_jax_package(batch):
    blobs, cs, ps = batch
    assert convert.setup_from_jax(jset.dev_setup()) == kset.dev_setup()
    js = jset.dev_setup()
    assert blobs == [jset.make_blob(64, b"torch-kzg-%d" % i)
                     for i in range(4)]
    assert cs[:2] == [jset.blob_to_commitment(b, js) for b in blobs[:2]]
    assert ps[:2] == [jset.compute_blob_proof(b, c, js)
                      for b, c in zip(blobs[:2], cs[:2])]


def test_setup_file_round_trip(tmp_path):
    path = str(tmp_path / "setup.json")
    kset.dump_trusted_setup(kset.dev_setup(), path)
    assert kset.load_trusted_setup(path) == kset.dev_setup()
    assert kset.load_trusted_setup() == kset.dev_setup()


# --- 5. The facade's verdicts ------------------------------------------------


def _case(name, blobs, cs, ps):
    """(blobs, commitments, proofs, the backend that must answer)."""
    if name == "valid":
        return blobs, cs, ps, "cuda"
    if name == "swapped_proofs":                     # 2 blobs: a cheaper fold
        return blobs[:2], cs[:2], [ps[1], ps[0]], "cuda"
    if name == "changed_element":
        b0 = bytearray(blobs[0])
        b0[40] ^= 1                                   # element 1, after proof
        return [bytes(b0), blobs[1]], cs[:2], ps[:2], "cuda"
    if name == "element_not_canonical":
        b0 = R.to_bytes(32, "big") + blobs[0][32:]
        return [b0] + blobs[1:], cs, ps, "validate"
    if name == "bad_g1":
        return blobs, [b"\x00" * 48] + cs[1:], ps, "validate"
    if name == "length_mismatch":
        return blobs, cs[:3], ps, "validate"
    if name == "empty":
        return [], [], [], None
    if name == "ragged":
        short = kset.make_blob(32, b"torch-kzg-short")
        c = kzg.blob_to_kzg_commitment(short)
        return ([blobs[0], short], [cs[0], c],
                [ps[0], kzg.compute_blob_kzg_proof(short, c)], "python")
    if name == "single":
        return blobs[:1], cs[:1], ps[:1], "python"
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "valid", "swapped_proofs", "changed_element", "element_not_canonical",
    "bad_g1", "length_mismatch", "empty", "ragged", "single"])
def test_facade_verdicts_match_the_jax_package(batch, name):
    blobs, cs, ps, backend = _case(name, *batch)
    kzg.reset_engine()
    kzg.configure(backend="cuda", device="cpu")
    got = kzg.verify_blob_kzg_proof_batch(blobs, cs, ps)
    if backend is not None:
        assert kzg.last_call()["backend"] == backend
    if backend == "cuda":
        assert [s["stage"] for s in kzg.last_call()["stages"]] == \
            ["challenge", "eval", "pairing"]
    want = jref.verify_blob_kzg_proof_batch(blobs, cs, ps,
                                            jset.dev_setup().tau_g2())
    assert got is want
    if backend != "cuda":      # the python paths pair on the host: cheap
        jkzg.reset_engine()
        jkzg.set_setup(jset.dev_setup())
        jkzg.configure(backend="python")
        assert jkzg.verify_blob_kzg_proof_batch(blobs, cs, ps) is want
    if backend in (None, "validate"):
        kzg.configure(backend="python")
        assert kzg.verify_blob_kzg_proof_batch(blobs, cs, ps) is want
    assert want is (name in ("valid", "empty", "ragged", "single"))


def test_facade_routes_by_threshold_and_rejects_unknown_backends():
    kzg.reset_engine()
    assert kzg.backend_for(1) == "python" and kzg.backend_for(2) == "cuda"
    kzg.configure(threshold=8)
    assert kzg.backend_for(6) == "python"
    kzg.configure(backend="python", threshold=1)
    assert kzg.backend_for(6) == "python"
    with pytest.raises(ValueError, match="unknown kzg backend"):
        kzg.configure(backend="jax")
    st = kzg.engine_status()
    assert st["backend"] == "python" and st["launches"] == {"k_blob_eval": 0}
    kzg.reset_engine()
