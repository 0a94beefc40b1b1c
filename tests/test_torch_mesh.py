"""The port's mesh-primary verification (lighthouse_tpu_torch/parallel) on
meshes of CPU shards, where every launch is its kernel's plain version:

  * the mesh steps sharded_verify_batch_fn and ring_verify_batch_fn, and
    through the backend the programs firehose_fn (wire / decoded signatures
    x 32-byte roots / host hash_to_field limbs) and multi_fn, on a valid
    batch and its tampered twins with the bad lane at the first lane, at a
    shard boundary and next to padding, each verdict equal to the JAX
    package's "python" backend on the same sets (a key or signature outside
    its subgroup cannot be built there: bls_adversarial.json expects
    invalid_pubkey / invalid_signature, a False verdict);
  * the ring folds against the JAX tower.mul (jitted) and the gathered sum;
  * the ladder with stub steps (a mesh fault gives the single-device hop's
    verdict, a double fault raises BackendFault, a BlsError passes through
    undegraded), the backend's routing, and a warm mesh batch that syncs no
    arena row.
All comparisons are exact (bools, canonical integers).  A plain mesh
verify takes ~5 s a shard here, so the cases beyond one a program are in
the slow tier."""
import json
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu.crypto.bls.constants import R
from lighthouse_tpu.crypto.bls.tpu import tower as jtower
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
from lighthouse_tpu_torch.crypto.bls.cuda import convert, curve, fp, staged
from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2
from lighthouse_tpu_torch.crypto.bls.cuda import pubkey_cache
from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend
from lighthouse_tpu_torch.parallel import ring
from lighthouse_tpu_torch.parallel import sharded_verify as sv

RNG = np.random.default_rng(0x3E54)
VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
N = 4              # lanes: 2 shards of 2, the boundary at lane 2


def adversarial(name, field):
    with open(os.path.join(VECTORS, "bls_adversarial.json")) as f:
        case = [c for c in json.load(f)["cases"] if c["name"] == name][0]
    s = case["sets"][0]
    return (bytes.fromhex(s["pubkeys"][0]) if field == "pubkey"
            else bytes.fromhex(s["signature"])), case["expect"]


@pytest.fixture(scope="module")
def mesh2():
    return sv.make_mesh(["cpu", "cpu"])


@pytest.fixture(scope="module")
def port(mesh2):
    be = CudaBackend(name="cuda-cpu-mesh", device="cpu", mesh=mesh2,
                     mesh_min_sets=1)
    bls.register_backend(be)
    bls.set_backend(be.name)
    return be


def both_sets(specs, wire=False):
    """specs: [(secret keys, msg)] -> (JAX sets, port sets) with the same
    bytes; the signature is the keys' aggregate on msg (signed once with
    their sum), as LazySignature bytes on the port side with ``wire``."""
    jsets, psets = [], []
    for sks, msg in specs:
        raw = jbls.SecretKey(sum(sks) % R).sign(msg).to_bytes()
        pks = [jbls.SecretKey(k).public_key().to_bytes() for k in sks]
        jsets.append(jbls.SignatureSet(
            jbls.Signature.from_bytes(raw),
            [jbls.PublicKey.from_bytes(p) for p in pks], msg))
        psig = (bls.LazySignature(raw) if wire
                else bls.Signature.from_bytes(raw))
        psets.append(bls.SignatureSet(
            psig, [bls.PublicKey.from_bytes(p) for p in pks], msg))
    return jsets, psets


def jax_verdict(sets):
    prev = jbls.get_backend().name
    jbls.set_backend("python")
    try:
        return jbls.verify_signature_sets(sets)
    finally:
        jbls.set_backend(prev)


def specs(n, msg_len=32, keys=1):
    return [([int(k) for k in RNG.integers(1, 2**62, size=keys)],
             bytes(RNG.integers(0, 256, msg_len, dtype=np.uint8)))
            for _ in range(n)]


def swap(sets, i, j, make):
    """sets with the signatures of lanes i and j exchanged."""
    out = list(sets)
    out[i] = make(sets[j].signature, sets[i].pubkeys, sets[i].message)
    out[j] = make(sets[i].signature, sets[j].pubkeys, sets[j].message)
    return out


def step_inputs(psets, m, bad_key=None, bad_sig=None):
    """The eight tensors of the mesh step for port sets padded to m lanes;
    ``bad_key`` / ``bad_sig`` put the adversarial non-subgroup point at that
    lane."""
    pks = [s.pubkeys[0].point for s in psets] + [cv.g1_infinity()] * (
        m - len(psets))
    sigs = [s.signature.point for s in psets] + [cv.g2_infinity()] * (
        m - len(psets))
    if bad_key is not None:
        pks[bad_key] = cv.g1_decompress(
            adversarial("non_subgroup_pubkey", "pubkey")[0],
            subgroup_check=False)
    if bad_sig is not None:
        sigs[bad_sig] = cv.g2_decompress(
            adversarial("non_subgroup_signature", "signature")[0],
            subgroup_check=False)
    xp, yp, pi = curve.pack_g1_affine(pks)
    xs, ys, si = curve.pack_g2_affine(sigs)
    msgs = [s.message for s in psets] + [b""] * (m - len(psets))
    rand = torch.as_tensor(bk.random_weights(m, len(psets)).view(np.int32))
    return (staged.to_i32(xp), staged.to_i32(yp), pi, staged.to_i32(xs),
            staged.to_i32(ys), si, staged.to_i32(h2.hash_to_field(msgs)),
            rand)


STEP_CASES = {
    # name: (number of sets, how the batch is spoiled)
    "valid": (N, None),
    "non_subgroup_key_boundary": (N, "bad_key"),
    "non_subgroup_signature_first": (N, "bad_sig"),
    "swapped_first": (N, "swap"),
    "wrong_message_next_to_padding": (N - 1, "message"),
}
FAST_STEP = {("sharded", "non_subgroup_key_boundary")}


def _step_params():
    out = []
    for fn in ("sharded", "ring"):
        for case in STEP_CASES:
            marks = () if (fn, case) in FAST_STEP else (pytest.mark.slow,)
            out.append(pytest.param(fn, case, marks=marks,
                                    id=f"{fn}-{case}"))
    return out


@pytest.mark.parametrize("fn,case", _step_params())
def test_mesh_step_gives_the_jax_verdict(mesh2, fn, case):
    n, spoil = STEP_CASES[case]
    jsets, psets = both_sets(specs(n))
    kw = {}
    if spoil == "bad_key":
        kw["bad_key"] = N // 2
        _raw, expect = adversarial("non_subgroup_pubkey", "pubkey")
        assert expect == "invalid_pubkey"
        want = False
    elif spoil == "bad_sig":
        kw["bad_sig"] = 0
        _raw, expect = adversarial("non_subgroup_signature", "signature")
        assert expect == "invalid_signature"
        want = False
    else:
        if spoil == "swap":
            jsets = swap(jsets, 0, 1, jbls.SignatureSet)
            psets = swap(psets, 0, 1, bls.SignatureSet)
        elif spoil == "message":
            last = n - 1
            msg = bytes(b ^ 1 for b in psets[last].message)
            jsets[last] = jbls.SignatureSet(jsets[last].signature,
                                            jsets[last].pubkeys, msg)
            psets[last] = bls.SignatureSet(psets[last].signature,
                                           psets[last].pubkeys, msg)
        want = jax_verdict(jsets)
        assert want is (spoil is None)
    args = step_inputs(psets, N, **kw)
    step = (sv.sharded_verify_batch_fn if fn == "sharded"
            else ring.ring_verify_batch_fn)(mesh2)
    assert bool(step(*args)) is want


ROUTE_CASES = {
    # name: (wire, message length, keys a set, sets, spoil)
    "wire_roots_swapped_first": (True, 32, 1, N, "swap_first"),
    "wire_roots_valid_padded": (True, 32, 1, N - 1, None),
    "affine_roots_swapped_boundary": (False, 32, 1, N, "swap_boundary"),
    "wire_field_valid": (True, 48, 1, N, None),
    "affine_field_wrong_message_next_to_padding": (False, 48, 1, N - 1,
                                                   "message"),
    "multi_valid": (False, 32, 3, 2, None),
    "multi_swapped": (False, 32, 3, 2, "swap_first"),
}
FAST_ROUTE = {"wire_roots_swapped_first"}


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=() if c in FAST_ROUTE else (pytest.mark.slow,))
    for c in ROUTE_CASES])
def test_backend_mesh_routes_give_the_jax_verdict(port, case):
    wire, msg_len, keys, n, spoil = ROUTE_CASES[case]
    sp = specs(n, msg_len, keys)
    if keys > 1:
        sp[1] = (sp[1][0][:1], sp[1][1])       # a single set beside it
    jsets, psets = both_sets(sp, wire=wire)
    if spoil in ("swap_first", "swap_boundary"):
        i = 0 if spoil == "swap_first" else n // 2 - 1
        jsets = swap(jsets, i, i + 1, jbls.SignatureSet)
        psets = swap(psets, i, i + 1, bls.SignatureSet)
    elif spoil == "message":
        msg = bytes(b ^ 1 for b in psets[-1].message)
        jsets[-1] = jbls.SignatureSet(jsets[-1].signature, jsets[-1].pubkeys,
                                      msg)
        psets[-1] = bls.SignatureSet(psets[-1].signature, psets[-1].pubkeys,
                                     msg)
    sv.reset_mesh_stats()
    got = bls.verify_signature_sets(psets)
    assert got is jax_verdict(jsets)
    assert got is (spoil is None)
    stats = sv.mesh_stats()
    assert stats["dispatches"] == 1 and stats["last_shards"] == 2
    assert not any(stats["degradations"].values())
    if wire:
        assert not any(s.signature.decoded() for s in psets)


def test_malformed_wire_bytes_are_a_false_verdict_not_a_fault(port):
    _jsets, psets = both_sets(specs(2), wire=True)
    x_not_below_p = bytes([0x9F]) + bytes([0xFF]) * 95
    psets[1] = bls.SignatureSet(bls.LazySignature(x_not_below_p),
                                psets[1].pubkeys, psets[1].message)
    sv.reset_mesh_stats()
    assert bls.verify_signature_sets(psets) is False
    assert sv.mesh_stats()["dispatches"] == 0
    assert not any(sv.mesh_stats()["degradations"].values())


def _fp12(vals):
    return fp.pack_mont(vals).reshape(2, 3, 2, fp.N_LIMBS)


def test_ring_folds_match_jax_tower_mul_and_the_gathered_sum():
    mesh3 = sv.make_mesh(["cpu"] * 3)
    from lighthouse_tpu.crypto.bls.constants import P

    vals = [[int(v) % P for v in RNG.integers(0, 2**62, size=12)]
            for _ in range(3)]
    parts = [staged.to_i32(_fp12(v)) for v in vals]
    got = ring.ring_reduce_fp12(mesh3, parts)
    mul = jax.jit(jtower.mul)
    acc = convert.fp_to_jax(parts[0])
    for p in parts[1:]:
        acc = mul(acc, convert.fp_to_jax(p))
    want = convert.fp_from_jax(np.asarray(acc))
    assert all(torch.equal(g, want) for g in got)
    # G2: equal points, one's negation and infinity across four shards
    mesh4 = sv.make_mesh(["cpu"] * 4)
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr

    h = hr.hash_to_g2(b"ring")
    pts = [h, h, cv.g2_infinity(), h.mul(5)]
    x, y, inf = curve.pack_g2_affine(pts)
    x, y = staged.to_i32(x), staged.to_i32(y)
    sums = ring.ring_sum_g2(mesh4, [(x[i], y[i], inf[i:i + 1])
                                    for i in range(4)])
    gx, gy, gi = staged.k_ring_sum(x, y, inf)
    ref = cv.g2_infinity()
    for p in pts:
        ref = ref + p
    for sx, sy, si in sums:
        assert torch.equal(sx, gx) and torch.equal(sy, gy)
        assert torch.equal(si, gi)
        assert curve.unpack_g2_affine(staged.to_i64(sx[None]),
                                      staged.to_i64(sy[None]), si) == [ref]
    neg = ring.ring_sum_g2(sv.make_mesh(["cpu"] * 2),
                           [(x[0], y[0], inf[:1]), (x[0], (staged.to_i32(
                               fp.neg(staged.to_i64(y[0])))), inf[:1])])
    assert all(bool(si) for _sx, _sy, si in neg)


def _stub_inputs():
    return tuple(torch.zeros((N, 1)) for _ in range(8))


def test_ladder_degrades_mesh_to_single_and_raises_on_a_double_fault(mesh2):
    def boom(*_a):
        raise RuntimeError("mesh step failed")

    sv.reset_mesh_stats()
    assert sv.sharded_verify_with_fallback(
        mesh2, _stub_inputs(), step=lambda *a: torch.tensor([True])) is True
    assert sv.mesh_stats()["degradations"]["mesh_to_single"] == 0
    for single in (True, False):
        assert sv.sharded_verify_with_fallback(
            mesh2, _stub_inputs(), step=boom,
            single_step=lambda *a, v=single: torch.tensor([v])) is single
    stats = sv.mesh_stats()
    assert stats["mesh_faults"] == 2
    assert stats["degradations"] == {"mesh_to_single": 2, "single_to_cpu": 0}
    fut = sv.sharded_verify_with_fallback_async(
        mesh2, _stub_inputs(), step=lambda *a: torch.tensor([True]))
    assert fut.result() is True and fut.result() is True
    with pytest.raises(bls.BackendFault) as err:
        sv.sharded_verify_with_fallback(mesh2, _stub_inputs(), step=boom,
                                        single_step=boom)
    assert err.value.site == "mesh_step"
    assert isinstance(err.value.cause, RuntimeError)
    assert sv.mesh_stats()["degradations"]["single_to_cpu"] == 1

    def bls_error(*_a):
        raise bls.BlsError("bad encoding")

    sv.reset_mesh_stats()
    with pytest.raises(bls.BlsError):
        sv.sharded_verify_with_fallback(mesh2, _stub_inputs(),
                                        step=bls_error, single_step=boom)
    with pytest.raises(bls.BlsError):
        sv.sharded_verify_with_fallback(mesh2, _stub_inputs(), step=boom,
                                        single_step=bls_error)
    assert sv.mesh_stats()["degradations"]["single_to_cpu"] == 0


def test_backend_ladder_and_routing(monkeypatch, mesh2):
    _jsets, psets = both_sets(specs(2))
    be = CudaBackend(name="route", device="cpu", mesh=mesh2, mesh_min_sets=64)
    assert be._mesh_for(63) is None and be._mesh_for(64) is mesh2
    assert CudaBackend(device="cpu", mesh=False)._mesh_for(10**4) is None
    assert CudaBackend(device="cpu")._mesh_for(10**4) is None
    assert sv.mesh_wanted(1, sv.make_mesh(["cpu"] * 3), min_sets=1) is None
    with pytest.raises(TypeError):
        CudaBackend(device="cpu", mesh="cpu")

    calls = []

    def single(sets, max_k):
        calls.append(len(sets))
        return torch.tensor([True])

    monkeypatch.setattr(be, "_dispatch_device", single)
    monkeypatch.setattr(be, "_dispatch_mesh", lambda *a: pytest.fail(
        "a batch under mesh_min_sets went to the mesh"))
    assert be.verify_signature_sets(psets) is True and calls == [2]
    monkeypatch.undo()

    # a mesh fault at dispatch: the single-device route answers
    be = CudaBackend(name="route", device="cpu", mesh=mesh2, mesh_min_sets=1)
    monkeypatch.setattr(sv, "firehose_fn", lambda *a, **k: (
        lambda *b: (_ for _ in ()).throw(RuntimeError("shard lost"))))
    monkeypatch.setattr(be, "_dispatch_device", single)
    sv.reset_mesh_stats()
    assert be.verify_signature_sets(psets) is True and calls == [2, 2]
    assert sv.mesh_stats()["degradations"]["mesh_to_single"] == 1

    def dead(sets, max_k):
        raise RuntimeError("card lost")

    monkeypatch.setattr(be, "_dispatch_device", dead)
    with pytest.raises(bls.BackendFault):
        be.verify_signature_sets(psets)
    assert sv.mesh_stats()["degradations"]["single_to_cpu"] == 1


def test_warm_mesh_batch_syncs_no_arena_row(mesh2):
    cache = pubkey_cache.PackedPubkeyCache(initial_rows=8)
    _jsets, psets = both_sets(specs(3))
    keys = [s.pubkeys[0] for s in psets] + [None]
    rows, cold = cache.pack_rows_device(keys, mesh2)
    s1 = cache.sync_stats()
    rows2, warm = cache.pack_rows_device(keys, mesh2)
    s2 = cache.sync_stats()
    assert s1["device_sync_rows"] > 0
    assert s2 == s1                             # nothing crossed again
    assert torch.equal(rows, rows2) and rows.tolist()[-1] == 0
    assert len(cold) == len(warm) == 2
    x, y, inf = cache.pack_gathered(keys)
    for (gx, gy, gi), lo in zip(warm, (0, 2)):
        assert torch.equal(gx, torch.from_numpy(x[lo:lo + 2].view(np.int32)))
        assert torch.equal(gy, torch.from_numpy(y[lo:lo + 2].view(np.int32)))
        assert gi.tolist() == inf[lo:lo + 2].tolist()
    assert cache.stats()["device_mirrors"] == 1  # one mirror a device
