"""The plain versions of k_xmd and k_hash against the JAX package:
expand_message_xmd + hash_to_field of the JAX host path (through
crypto/bls/cuda/convert.py) and the pure-Python hash_to_g2.  Exact
(tolerance zero)."""
import numpy as np
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import hash_to_curve_ref as jhr
from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.crypto.bls.tpu import hash_to_g2 as jh2
from lighthouse_tpu_torch.crypto.bls.cuda import convert, curve, staged
from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

RNG = np.random.default_rng(0x4A54)


def messages(n):
    return [bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]


def test_k_xmd_plain_matches_jax_hash_to_field():
    msgs = messages(5) + [b"\x00" * 32, b"\xff" * 32]
    words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32))
    got = staged.k_xmd(words)
    want = convert.u_from_jax(jh2.hash_to_field(msgs))
    assert got.dtype == torch.int32 and got.shape == (7, 2, 2, 12)
    assert torch.equal(got, want)


def test_os2ip_reduces_every_chunk_exactly():
    chunks = [b"\xff" * 64, b"\x00" * 64, P.to_bytes(64, "big"),
              (P * 3 + 5).to_bytes(64, "big"),
              bytes(RNG.integers(0, 256, 64, dtype=np.uint8))]
    words = torch.tensor(np.stack([np.frombuffer(c, ">u4").astype(np.int64)
                                   for c in chunks]))
    got = h2.fp.unpack(h2.os2ip_mod_p(words))
    assert got == [int.from_bytes(c, "big") % P for c in chunks]


def test_k_hash_plain_matches_hash_to_g2():
    msgs = messages(2)
    u = staged.k_xmd(torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)))
    hx, hy, hinf = staged.k_hash(u)
    got = curve.unpack_g2_affine(staged.to_i64(hx), staged.to_i64(hy), hinf)
    want = [jhr.hash_to_g2(m) for m in msgs]
    assert [(p.x.c0, p.x.c1, p.y.c0, p.y.c1) for p in got] == [
        (p.x.c0, p.x.c1, p.y.c0, p.y.c1) for p in want]
    assert not hinf.any()
