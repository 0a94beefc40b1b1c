"""Lane-parallel SHA-256 on the card: the hash engine's four kernels, their
plain PyTorch versions, and the host entry points that drive them.

Counterpart of ``lighthouse_tpu/crypto/sha256/kernel.py``:

  k_pairs   (n, 16) LE words of n 64-byte messages -> (n, 8) LE digest words
  k_entry   (n, 16) LE words of n 64-byte messages -> (n, 8) digest state
  k_level   (2m, 8) state of a tree level          -> (m, 8) parent state
  k_digest  (n, m, 16) LE padded blocks, m <= 4    -> (n, 8) LE digest words

"LE words" are the bytes of SSZ chunks read as little-endian uint32 (the
``padding.pairs_to_words`` view), so ``k_pairs``' output bytes are the
digests.  A "state" holds the 8 digest words as natural values, the form a
level chain hashes on without a byte swap; the TPU kernel keeps it as
(8, n) with lanes minor, the card as (n, 8) rows in node order, so row
pairs (2j, 2j+1) are the 64-byte message of parent j.  Tests compare digest
bytes at a stage boundary, never layouts.

Host entry points (``hash_pairs``, ``digest_blocks``, ``reduce_levels``)
mirror ``hash_pairs_jax``, ``digest_blocks_jax`` and ``reduce_levels_jax``
and take the device to run on: the kernels for a CUDA device, the plain
versions for the CPU.  What existed only for XLA (the exec cache, lane
buckets, the optimization barriers) has no counterpart: a kernel takes
any n.

Each wrapper checks device, dtype, shape, contiguity and alignment,
launches its kernel (``csrc/k_sha256.cu``) for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs the plain
version (``*_plain``, also callable on CUDA tensors to compare).  A failed
build or launch raises.  Words are ``int32`` bit patterns.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from ....runtime.tensors import (M32, check, check_aligned, empty, on_cpu,
                                 to_i32, to_i64)
from ..padding import WORDS_PER_BLOCK

# --- The compression, plain ------------------------------------------------------

# Round constants (FIPS 180-4 §4.2.2) and initial hash value (§5.3.3).
SHA_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
SHA_IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & M32


def _schedule(w16: list) -> list:
    w = list(w16)
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    return w


def sha_compress(state, block):
    """One SHA-256 compression over a batch: state (..., 8), block (..., 16)
    int64 tensors holding 32-bit words (natural values); the two broadcast.
    The one plain compression of the port (XMD uses it too)."""
    w = _schedule([block[..., i] for i in range(16)])
    a, b, c, d, e, f, g, h = (state[..., i] for i in range(8))
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = (h + S1 + ch + SHA_K[i] + w[i]) & M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + S0 + maj) & M32)
    return (torch.stack([a, b, c, d, e, f, g, h], dim=-1) + state) & M32


# Padding block of a 64-byte message: 0x80, zeros, bit length 512; and its
# K[i] + W[i] (the card's LH_SHA_PAD64_KW, csrc/sha256.cuh).
PAD64 = [0x80000000] + [0] * 14 + [512]
PAD64_KW = [(k + w) & M32 for k, w in zip(SHA_K, _schedule(PAD64))]


def _bswap(x):
    return (((x >> 24) | ((x >> 8) & 0xFF00) | ((x << 8) & 0xFF0000)
             | (x << 24)) & M32)


def _iv(device):
    return torch.tensor(SHA_IV, dtype=torch.int64, device=device)


def _pair_state(w):
    """(n, 16) int64 natural message words -> (n, 8) state of their hash:
    the message block, then the constant padding block."""
    s = sha_compress(_iv(w.device), w)
    pad = torch.tensor(PAD64, dtype=torch.int64, device=w.device)
    return sha_compress(s, pad)


def k_pairs_plain(words):
    return to_i32(_bswap(_pair_state(_bswap(to_i64(words)))))


def k_entry_plain(words):
    return to_i32(_pair_state(_bswap(to_i64(words))))


def k_level_plain(state):
    return to_i32(_pair_state(to_i64(state).reshape(-1, 16)))


def k_digest_plain(blocks):
    s = _iv(blocks.device)
    for j in range(blocks.shape[1]):
        s = sha_compress(s, _bswap(to_i64(blocks[:, j])))
    return to_i32(_bswap(s.expand(blocks.shape[0], 8)))


# --- Wrappers ---------------------------------------------------------------------


def _launch(fn, plain, x, x_name, x_shape, out_rows):
    """Checks, then the plain version on the CPU or fn's kernel."""
    name, device = fn.__name__, x.device
    check(f"{name} {x_name}", x, x_shape, torch.int32, device)
    if on_cpu(device):
        return plain(x)
    from ....runtime import build

    out = empty((out_rows, 8), torch.int32, device)
    if out_rows:
        check_aligned(name, x, out)
        args = (x, out, out_rows) if x.dim() == 2 else (
            x, out, out_rows, x.shape[1])
        build.call("k_sha256", f"{name}_launch", *args)
        fn.launches += 1
    return out


def k_pairs(words):
    """(n, 16) int32 little-endian words of n 64-byte messages -> (n, 8)
    int32 words whose bytes are the n digests.  Replaces
    crypto/sha256/kernel.py:190 k_pairs."""
    n = words.shape[0]
    return _launch(k_pairs, k_pairs_plain, words, "words", (n, 16), n)


def k_entry(words):
    """(n, 16) little-endian words -> (n, 8) state (natural word values) of
    the n pair hashes.  Replaces crypto/sha256/kernel.py:162 k_entry."""
    n = words.shape[0]
    return _launch(k_entry, k_entry_plain, words, "words", (n, 16), n)


def k_level(state):
    """(2m, 8) state of a tree level -> (m, 8) state of its parents: row j
    hashes rows 2j and 2j+1.  Replaces crypto/sha256/kernel.py:175
    k_level."""
    c = state.shape[0]
    if c % 2:
        raise ValueError(f"k_level state: {c} rows, expected an even count")
    return _launch(k_level, k_level_plain, state, "state", (c, 8), c // 2)


def k_digest(blocks):
    """(n, m, 16) little-endian words of n padded m-block messages
    (1 <= m <= 4) -> (n, 8) int32 words whose bytes are the digests.
    Replaces crypto/sha256/kernel.py:201 k_digest."""
    if blocks.dim() != 3 or not 1 <= blocks.shape[1] <= 4:
        raise ValueError(f"k_digest blocks: shape {tuple(blocks.shape)}, "
                         "expected (n, m, 16) with 1 <= m <= 4")
    n, m = blocks.shape[:2]
    return _launch(k_digest, k_digest_plain, blocks, "blocks",
                   (n, m, WORDS_PER_BLOCK), n)


for _fn in (k_pairs, k_entry, k_level, k_digest):
    _fn.launches = 0
KERNELS = {fn.__name__: fn for fn in (k_pairs, k_entry, k_level, k_digest)}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# --- Host entry points --------------------------------------------------------------

#: Bytes copied to the card and back by the host entry points.
_TRANSFER = {"h2d_bytes": 0, "d2h_bytes": 0}
_TRANSFER_LOCK = threading.Lock()


def _count_transfer(key: str, nbytes: int) -> None:
    with _TRANSFER_LOCK:
        _TRANSFER[key] += nbytes


def transfer_counts() -> dict:
    with _TRANSFER_LOCK:
        return dict(_TRANSFER)


def reset_transfer() -> None:
    with _TRANSFER_LOCK:
        for key in _TRANSFER:
            _TRANSFER[key] = 0


def _to_device(data, shape, device) -> torch.Tensor:
    """Little-endian words of a host buffer as an int32 tensor on device
    (a read-only zero-copy view on the CPU: nothing writes to it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only buffer
        words = torch.frombuffer(data, dtype=torch.int32).reshape(shape)
    if device.type == "cuda":
        _count_transfer("h2d_bytes", words.numel() * 4)
    return words.to(device)


def _to_host(x: torch.Tensor) -> np.ndarray:
    if x.device.type == "cuda":
        _count_transfer("d2h_bytes", x.numel() * 4)
    return x.cpu().numpy()


def hash_pairs(data, device: torch.device) -> bytes:
    """n concatenated 64-byte messages -> n concatenated 32-byte digests,
    one launch."""
    words = _to_device(data, (-1, WORDS_PER_BLOCK), device)
    return _to_host(k_pairs(words)).tobytes()


def digest_blocks(blocks: np.ndarray, device: torch.device) -> bytes:
    """(n, m, 16) padded LE blocks -> n concatenated digests."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint32)
    words = _to_device(blocks, blocks.shape, device)
    return _to_host(k_digest(words)).tobytes()


def reduce_levels(buf, depth: int, zero_hashes, depth_limit: int,
                  min_pairs: int, device: torch.device,
                  stats: Optional[List[dict]] = None) -> Tuple[bytes, int]:
    """Hash successive tree levels on the card while the pair count stays
    >= `min_pairs` (and depth < depth_limit): ``k_entry`` lifts the chunk
    buffer into the (c, 8) state once, then each ``k_level`` feeds the next
    on the card.  Odd levels are completed with `zero_hashes[depth]`.
    Returns (remaining level bytes, new depth) for the host tail; `stats`,
    when given, gets one row a level (and the card is synchronised for
    it)."""
    def _tick(n, t0):
        if stats is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stats.append({"pairs": int(n), "backend": "cuda",
                          "ms": round((time.perf_counter() - t0) * 1e3, 3)})

    # Entry level: chunk bytes -> (n, 8) state.
    t0 = time.perf_counter()
    if (len(buf) // 32) % 2:
        buf = bytes(buf) + bytes(zero_hashes[depth])
    x = k_entry(_to_device(buf, (-1, WORDS_PER_BLOCK), device))
    depth += 1
    _tick(x.shape[0], t0)
    # Chained levels: (c, 8) -> (c // 2, 8).
    while depth < depth_limit and (x.shape[0] + 1) // 2 >= min_pairs:
        t0 = time.perf_counter()
        if x.shape[0] % 2:
            pad = np.frombuffer(bytes(zero_hashes[depth]), dtype=">u4")
            x = torch.cat([x, _to_device(pad.astype("<u4"), (1, 8), device)])
        x = k_level(x)
        depth += 1
        _tick(x.shape[0], t0)
    # Exit: natural-value state -> chunk bytes (big-endian words).
    out = _to_host(x).view(np.uint32).astype(">u4").tobytes()
    return out, depth
