"""Guards of the PyTorch/CUDA port: it imports neither jax nor the JAX
package, it never falls back from the card to the CPU, and its kernel
wrappers refuse what their kernels do not take."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lighthouse_tpu_torch
from lighthouse_tpu_torch.crypto.bls.cuda import staged
from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend

PKG = os.path.dirname(lighthouse_tpu_torch.__file__)
REPO = os.path.dirname(PKG)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "lighthouse_tpu" or name.startswith("lighthouse_tpu."))


def test_no_module_imports_jax_or_the_jax_package():
    bad, scanned = [], set()
    for root, _dirs, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            scanned.add(os.path.relpath(path, PKG))
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad
    epoch = os.path.join("state_transition", "epoch_engine")
    assert {os.path.join("types", "primitives.py"),
            os.path.join("runtime", "stages.py"),
            os.path.join("state_transition", "per_epoch.py"),
            os.path.join("state_transition", "helpers.py"),
            os.path.join("state_transition", "shuffle.py"),
            os.path.join(epoch, "api.py"), os.path.join(epoch, "soa.py"),
            os.path.join(epoch, "cuda", "kernel.py"),
            os.path.join("crypto", "kzg", "__init__.py"),
            os.path.join("crypto", "kzg", "reference.py"),
            os.path.join("crypto", "kzg", "setup.py"),
            os.path.join("crypto", "kzg", "cuda", "fr.py"),
            os.path.join("crypto", "kzg", "cuda", "kernel.py"),
            os.path.join("crypto", "bls", "cuda", "verify.py"),
            os.path.join("parallel", "__init__.py"),
            os.path.join("parallel", "sharded_verify.py"),
            os.path.join("parallel", "ring.py")} <= scanned
    assert not _forbidden("lighthouse_tpu_torch")
    assert not _forbidden("lighthouse_tpu_torch.crypto")


def test_cpu_verify_in_a_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from lighthouse_tpu_torch.crypto import bls\n"
        "from lighthouse_tpu_torch.crypto.bls.cuda.backend import "
        "CudaBackend\n"
        "bls.register_backend(CudaBackend(name='c', device='cpu'))\n"
        "bls.set_backend('c')\n"
        "sk = bls.SecretKey(12345)\n"
        "m = bytes(range(32))\n"
        "s = bls.SignatureSet(sk.sign(m), [sk.public_key()], m)\n"
        "assert bls.verify_signature_sets([s]) is True\n"
        "lazy = bls.LazySignature(s.signature.to_bytes())\n"
        "w = bls.SignatureSet(lazy, [sk.public_key()], m)\n"
        "assert bls.verify_signature_sets([w]) is True\n"
        "assert not lazy.decoded()\n"
        "from lighthouse_tpu_torch.parallel import make_mesh, mesh_stats\n"
        "mesh = make_mesh(['cpu', 'cpu'])\n"
        "bls.register_backend(CudaBackend(name='m', device='cpu', mesh=mesh,"
        " mesh_min_sets=1))\n"
        "bls.set_backend('m')\n"
        "sk2 = bls.SecretKey(54321)\n"
        "s2 = bls.SignatureSet(sk2.sign(m), [sk2.public_key()], m)\n"
        "assert bls.verify_signature_sets([s, s2]) is True\n"
        "assert mesh_stats()['dispatches'] == 1\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'lighthouse_tpu' or k.startswith('lighthouse_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_cuda_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaBackend()
    from lighthouse_tpu_torch.crypto.bls import api

    monkeypatch.setattr(api, "_BACKENDS", {})
    monkeypatch.setattr(api, "_ACTIVE", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_backend()                 # the default backend is "cuda"
    assert CudaBackend(device="cpu").device.type == "cpu"


def test_wrappers_check_dtype_shape_contiguity():
    words = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        staged.k_xmd(words.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        staged.k_xmd(torch.zeros(4, 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        staged.k_xmd(torch.zeros(8, 4, dtype=torch.int32).t())
    u = torch.zeros(2, 2, 2, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        staged.k_hash(u[:, :1].contiguous())
    z = torch.zeros(2, 12, dtype=torch.int32)
    b = torch.zeros(2, dtype=torch.bool)
    z2 = torch.zeros(2, 2, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="rand"):
        staged.k_points(z, z, b, z2, z2, b, torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="sinf"):
        staged.k_pair(z, z, b, z2, z2, b, z2[0], z2[0], b)


def test_new_wrappers_check_dtype_shape_contiguity():
    x = torch.zeros(2, 2, 12, dtype=torch.int32)
    b = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="dtype"):
        staged.k_decode(x, b.to(torch.uint8), b)
    with pytest.raises(ValueError, match="shape"):
        staged.k_decode(x[:, :1].contiguous(), b, b)
    one = torch.ones(1, dtype=torch.bool)
    with pytest.raises(ValueError, match="shape"):
        staged.k_and(one, b)
    z = torch.zeros(2, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="hinf"):
        staged.k_each(z, z, b, x, x, b, x, x, one)
    with pytest.raises(ValueError, match="contiguous"):
        staged.k_each(z, z, b, x.transpose(0, 1), x, b, x, x, b)
    arena = torch.zeros(4, 12, dtype=torch.int32)
    rows = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        staged.k_gather_rows(arena, arena, rows.to(torch.int32))
    with pytest.raises(ValueError, match="ay"):
        staged.k_gather_rows(arena, arena[:3], rows)
    with pytest.raises(ValueError, match="vx"):
        staged.k_scatter_rows(arena, arena, rows, arena[:2], arena[:3])


def test_mesh_wrappers_check_dtype_shape_contiguity():
    z = torch.zeros(2, 12, dtype=torch.int32)
    z2 = torch.zeros(2, 2, 12, dtype=torch.int32)
    b = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="act1"):
        staged.k_subgroup(z, z, b, b.to(torch.uint8), z2, z2, b, b)
    with pytest.raises(ValueError, match="y2"):
        staged.k_subgroup(z, z, b, b, z2, z2[:1], b, b)
    with pytest.raises(ValueError, match="contiguous"):
        staged.k_decode_g1(torch.zeros(12, 2, dtype=torch.int32).t(), b, b)
    with pytest.raises(ValueError, match="sinf"):
        staged.k_pair_partial(z, z, b, z2, z2, b, z2[0], z2[0], b,
                              closing=True)
    f12 = torch.zeros(2, 2, 3, 2, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="parts"):
        staged.k_pair_combine(f12[:, :1].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        staged.k_ring_mul(f12[0], f12[1].to(torch.int64))
    with pytest.raises(ValueError, match="inf"):
        staged.k_ring_sum(z2, z2, b[:1])


def test_weights_are_nonzero_words_with_zero_padding():
    from lighthouse_tpu_torch.crypto.bls.cuda.backend import random_weights

    w = random_weights(8, 5)
    assert w.dtype == np.uint32 and w.shape == (8, 2)
    assert (w[:5, 0] & 1).all() and not w[5:].any()


def test_cpu_signing_in_a_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from lighthouse_tpu_torch.crypto import bls\n"
        "from lighthouse_tpu_torch.crypto.bls import sign_engine as se\n"
        "se.configure(threshold=1)\n"
        "sk = bls.SecretKey(0x5ee0)\n"
        "m = bytes(range(32))\n"
        "sig = se.sign_batch([(sk, m, b'pk')], device='cpu')[0]\n"
        "assert sig == sk.sign(m).to_bytes()\n"
        "assert se.last_call()['backend'] == 'cuda'\n"
        "assert se.aggregate_batch([[sig]], device='cpu') == [sig]\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'lighthouse_tpu' or k.startswith('lighthouse_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_sign_engine_without_a_card_raises(monkeypatch):
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import sign_engine as se

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    se.reset_engine()
    se.configure(threshold=1)
    sk = bls.SecretKey(9)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            se.sign_batch([(sk, b"\x03" * 32, b"pk9")])
        sig = sk.sign(b"\x03" * 32).to_bytes()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            se.aggregate_batch([[sig]])
        with pytest.raises(ValueError, match="unsupported device"):
            se.sign_batch([(sk, b"\x03" * 32, b"pk9")], device="meta")
    finally:
        se.reset_engine()


def test_sign_wrappers_check_dtype_shape_contiguity_device():
    from lighthouse_tpu_torch.crypto.bls.cuda import signer

    w = torch.zeros(2, 8, dtype=torch.int32)
    words = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        signer.k_sign_root(w.to(torch.int64), words)
    with pytest.raises(ValueError, match="msg_words"):
        signer.k_sign_root(w, words[:1])
    with pytest.raises(ValueError, match="contiguous"):
        signer.k_sign_root(w, torch.zeros(8, 2, dtype=torch.int32).t())
    with pytest.raises(ValueError, match="u_plain"):
        signer.k_sign_field(w, torch.zeros(2, 2, 12, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        signer.k_sign_root(w.to("meta"), words.to("meta"))
    with pytest.raises(ValueError, match=r"on meta"):
        signer.k_sign_field(w, torch.zeros(2, 2, 2, 12, dtype=torch.int32,
                                           device="meta"))
    x = torch.zeros(2, 3, 2, 12, dtype=torch.int32)
    b = torch.zeros(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="mask"):
        signer.k_sign_agg(x, b, b, b.to(torch.uint8))
    with pytest.raises(ValueError, match="k_sign_agg x"):
        signer.k_sign_agg(x[:, :2].contiguous(), b, b, b)
    with pytest.raises(ValueError, match="inf"):
        signer.k_sign_agg(x, b, b.t().contiguous(), b)
    arena = torch.zeros(4, 8, dtype=torch.int32)
    rows = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="arena"):
        staged.k_gather_sk_rows(torch.zeros(4, 12, dtype=torch.int32), rows)
    with pytest.raises(ValueError, match="dtype"):
        staged.k_gather_sk_rows(arena, rows.to(torch.int32))
    with pytest.raises(ValueError, match=" v:"):
        staged.k_scatter_sk_rows(arena, rows, arena[:2])
    with pytest.raises(ValueError, match="contiguous"):
        staged.k_scatter_sk_rows(arena, rows,
                                 torch.zeros(8, 3, dtype=torch.int32).t())


def test_cpu_state_root_in_a_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from lighthouse_tpu_torch import types as ty\n"
        "from lighthouse_tpu_torch.crypto.sha256 import api\n"
        "from lighthouse_tpu_torch.state_transition.epoch_engine import "
        "shuffle\n"
        "api.configure(backend='cuda', threshold=8, device='cpu')\n"
        "T = ty.SpecTypes(ty.MINIMAL)\n"
        "vals = [ty.Validator(pubkey=i.to_bytes(48, 'big'), "
        "effective_balance=32 * 10**9) for i in range(300)]\n"
        "s = T.BeaconStateDeneb(validators=vals, balances=[1] * 300)\n"
        "root = T.BeaconStateDeneb.hash_tree_root(s)\n"
        "perm = shuffle.batched_shuffle_indices(300, bytes(32), 10)\n"
        "assert sorted(perm.tolist()) == list(range(300))\n"
        "st = api.engine_status()\n"
        "assert st['digests']['cuda'] > 0, st\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'lighthouse_tpu' or k.startswith('lighthouse_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_hash_wrappers_check_dtype_shape_contiguity_device():
    from lighthouse_tpu_torch.crypto.sha256.cuda import kernel as hk

    words = torch.zeros(4, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        hk.k_pairs(words.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        hk.k_entry(torch.zeros(4, 15, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        hk.k_pairs(torch.zeros(16, 4, dtype=torch.int32).t())
    with pytest.raises(ValueError, match="unsupported device"):
        hk.k_entry(words.to("meta"))
    with pytest.raises(ValueError, match="even count"):
        hk.k_level(torch.zeros(3, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="k_level state: shape"):
        hk.k_level(torch.zeros(4, 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="1 <= m <= 4"):
        hk.k_digest(torch.zeros(2, 5, 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="1 <= m <= 4"):
        hk.k_digest(words)
    with pytest.raises(ValueError, match="k_digest blocks: shape"):
        hk.k_digest(torch.zeros(2, 1, 8, dtype=torch.int32))
    assert hk.k_pairs(words[:0]).shape == (0, 8)


def test_cpu_epoch_in_a_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from dataclasses import replace\n"
        "from lighthouse_tpu_torch import types as ty\n"
        "from lighthouse_tpu_torch.crypto.sha256 import api as hapi\n"
        "from lighthouse_tpu_torch.state_transition import per_epoch\n"
        "from lighthouse_tpu_torch.state_transition.epoch_engine import api\n"
        "hapi.configure(backend='cuda', threshold=8, device='cpu')\n"
        "api.configure(backend='cuda', threshold=1, device='cpu')\n"
        "T, E = ty.SpecTypes(ty.MINIMAL), ty.MINIMAL\n"
        "spec = replace(ty.ChainSpec.minimal(), altair_fork_epoch=0)\n"
        "far = 2**64 - 1\n"
        "vals = [ty.Validator(pubkey=i.to_bytes(48, 'big'), "
        "effective_balance=32 * 10**9, exit_epoch=far, "
        "withdrawable_epoch=far) for i in range(16)]\n"
        "s = T.states['altair'](slot=5 * E.slots_per_epoch - 1, "
        "validators=vals, balances=[32 * 10**9 + i for i in range(16)], "
        "previous_epoch_participation=[7] * 16, "
        "current_epoch_participation=[3] * 16, inactivity_scores=[1] * 16)\n"
        "per_epoch.process_epoch(s, T, E, spec)\n"
        "assert api.engine_status()['answered'] == {'cuda': 1, 'python': 0}\n"
        "root = type(s).hash_tree_root(s)\n"
        "assert hapi.engine_status()['digests']['cuda'] > 0\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'lighthouse_tpu' or k.startswith('lighthouse_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_cpu_kzg_verify_in_a_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from lighthouse_tpu_torch.crypto import kzg\n"
        "from lighthouse_tpu_torch.crypto.kzg import setup as kset\n"
        "kzg.configure(backend='cuda', device='cpu')\n"
        "blobs = [kset.make_blob(4, bytes([i])) for i in range(2)]\n"
        "cs = [kzg.blob_to_kzg_commitment(b) for b in blobs]\n"
        "ps = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]\n"
        "assert kzg.verify_blob_kzg_proof_batch(blobs, cs, ps) is True\n"
        "assert kzg.last_call()['backend'] == 'cuda'\n"
        "assert kzg.engine_status()['launches'] == {'k_blob_eval': 0}\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'lighthouse_tpu' or k.startswith('lighthouse_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_kzg_without_a_card_raises_and_its_wrapper_checks_arguments(
        monkeypatch):
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.kzg import setup as kset
    from lighthouse_tpu_torch.crypto.kzg.cuda import kernel as kk

    poly = torch.zeros(2, 4, 8, dtype=torch.int32)
    z = torch.zeros(2, 8, dtype=torch.int32)
    roots, inv_n = kk.domain(4, "cpu")
    with pytest.raises(ValueError, match="dtype"):
        kk.k_blob_eval(poly.to(torch.int64), z, roots, inv_n)
    with pytest.raises(ValueError, match="k_blob_eval z: shape"):
        kk.k_blob_eval(poly, z[:1], roots, inv_n)
    with pytest.raises(ValueError, match="k_blob_eval roots: shape"):
        kk.k_blob_eval(poly, z, roots[:2], inv_n)
    with pytest.raises(ValueError, match="contiguous"):
        kk.k_blob_eval(torch.zeros(2, 8, 4, dtype=torch.int32).transpose(1, 2),
                       z, roots, inv_n)
    with pytest.raises(ValueError, match="power of two"):
        kk.k_blob_eval(torch.zeros(2, 3, 8, dtype=torch.int32), z,
                       torch.zeros(3, 8, dtype=torch.int32), inv_n)
    with pytest.raises(ValueError, match="unsupported device"):
        kk.k_blob_eval(poly.to("meta"), z.to("meta"), roots.to("meta"),
                       inv_n.to("meta"))
    with pytest.raises(ValueError, match="on meta"):
        kk.k_blob_eval(poly, z.to("meta"), roots, inv_n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kk.eval_blobs(poly.numpy().view(np.uint32), [0, 0])
    kzg.reset_engine()
    try:
        blobs = [kset.make_blob(4, bytes([i])) for i in range(2)]
        cs = [kzg.blob_to_kzg_commitment(b) for b in blobs]
        ps = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kzg.verify_blob_kzg_proof_batch(blobs, cs, ps)
    finally:
        kzg.reset_engine()
