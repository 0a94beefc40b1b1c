"""Batched signing kernels: a slot's whole duty cohort in one launch.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/signer.py``:

  k_sign_root   secret words, 32-byte roots        -> compressed signatures
  k_sign_field  secret words, hash-to-field limbs  -> compressed signatures
  k_sign_agg    (m, k) compressed signatures, mask -> m compressed aggregates

A compressed signature leaves the card as planes: canonical PLAIN limbs of
the affine x (n, 2, 12), the lexicographic sign of y and the infinity flag
(n,); the host assembles the 96 wire bytes (``..sign_engine``).  The secret
words come from the secret-key arena on the card (``.seckey_cache``), so a
warm slot moves no secret across to the device.

Signing is [k] H(m) for k < 2^255 (the TPU package scans
``curve.ladder_step`` over 255 scalar bits; the plain versions here run
``curve.ladder_ct``).  On the card two threads a lane split k mod r into
four base-|z| digits and run a psi-split 64-step ladder
(``csrc/hash_g2.cuh``) whose instruction sequence does not depend on the
scalar; the result is the same point.  The zero scalar of a padding row
signs to infinity.  ``k_sign_agg`` decompresses every lane
without a subgroup check (the TPU kernel's semantics), sums each row's
masked lanes with complete additions and reports ``ok[row] = all(ok |
~mask)``.

Each wrapper checks device, dtype, shape and contiguity, launches its CUDA
kernel (``csrc/k_sign.cu``) for CUDA tensors and counts the launch in its
``launches`` attribute, or runs the plain version (``*_plain``) for CPU
tensors.  Tensor conventions as in ``.staged``: limbs and words are int32
bit patterns, flags bool.  There is no bucket floor: a call launches n
lanes.
"""
from __future__ import annotations

import torch

from . import curve, fp, fp2
from . import hash_to_g2 as h2
from .curve import F2, Jacobian
from .staged import (SK_WORDS, _check, _empty, _on_cpu, k_xmd_plain, to_i32,
                     to_i64)

# --- k_sign_root and k_sign_field ----------------------------------------------


def _sign_plain(w, u_plain):
    base = h2.hash_to_g2(to_i64(u_plain))
    x, sign, inf = curve.g2_compress(curve.ladder_ct(F2, base, to_i64(w)))
    return to_i32(x), sign, inf


def k_sign_root_plain(w, msg_words):
    return _sign_plain(w, k_xmd_plain(msg_words))


def k_sign_field_plain(w, u_plain):
    return _sign_plain(w, u_plain)


def _sign(fn, plain, w, data, data_name, data_shape):
    """Checks, then the plain version on the CPU or fn's kernel."""
    name, n, device = fn.__name__, w.shape[0], w.device
    _check(f"{name} w", w, (n, SK_WORDS), torch.int32, device)
    _check(f"{name} {data_name}", data, (n, *data_shape), torch.int32, device)
    if _on_cpu(device):
        return plain(w, data)
    from ....runtime import build

    L = fp.N_LIMBS
    x = _empty((n, 2, L), torch.int32, device)
    sign = _empty((n,), torch.bool, device)
    inf = _empty((n,), torch.bool, device)
    if n:
        build.call("k_sign", f"{name}_launch", w, data, n, x, sign, inf)
        fn.launches += 1
    return x, sign, inf


def k_sign_root(w, msg_words):
    """(n, 8) secret-scalar words + (n, 8) big-endian words of 32-byte
    signing roots -> x (n, 2, 12) canonical plain limbs, sign (n,), inf
    (n,): XMD, hash to G2, [k] H(m) and the compression.
    Replaces tpu/signer.py:113 k_sign_root."""
    return _sign(k_sign_root, k_sign_root_plain, w, msg_words, "msg_words",
                 (8,))


k_sign_root.launches = 0


def k_sign_field(w, u_plain):
    """(n, 8) secret-scalar words + (n, 2, 2, 12) canonical plain limbs of
    the host's hash_to_field (messages that are not 32 bytes) -> the
    planes of ``k_sign_root``.  Replaces tpu/signer.py:122 k_sign_field."""
    return _sign(k_sign_field, k_sign_field_plain, w, u_plain, "u_plain",
                 (2, 2, fp.N_LIMBS))


k_sign_field.launches = 0


# --- k_sign_agg ------------------------------------------------------------------


def k_sign_agg_plain(x, sign, inf, mask):
    m, k = mask.shape
    pt, ok = curve.g2_decompress(to_i64(x), sign, inf)
    # a masked-off lane contributes infinity (an infinity flag already does)
    z = fp2.select(mask, pt.z, torch.zeros_like(pt.z))
    if k:
        lanes = Jacobian(*(c.transpose(0, 1) for c in (pt.x, pt.y, z)))
        total = curve.sum_reduce(F2, lanes)     # the kernel's tree order
    else:
        total = curve.infinity(F2, (m,), x.device)
    ax, asign, ainf = curve.g2_compress(total)
    return to_i32(ax), asign, ainf, (ok | ~mask).all(dim=1)


def k_sign_agg(x, sign, inf, mask):
    """(m, k) planes of compressed signatures -- x (m, k, 2, 12) canonical
    plain limbs, sign, inf and mask (m, k) bool -> m aggregates: x (m, 2,
    12), sign, inf (m,), and ok (m,): every live lane decompressed (on the
    curve, or x == 0 under an infinity flag; no subgroup check).  A masked
    lane contributes infinity.  Replaces tpu/signer.py:143 k_sign_agg."""
    m, k = mask.shape
    device = mask.device
    L = fp.N_LIMBS
    _check("k_sign_agg mask", mask, (m, k), torch.bool, device)
    _check("k_sign_agg x", x, (m, k, 2, L), torch.int32, device)
    _check("k_sign_agg sign", sign, (m, k), torch.bool, device)
    _check("k_sign_agg inf", inf, (m, k), torch.bool, device)
    if _on_cpu(device):
        return k_sign_agg_plain(x, sign, inf, mask)
    from ....runtime import build

    ax = _empty((m, 2, L), torch.int32, device)
    asign = _empty((m,), torch.bool, device)
    ainf = _empty((m,), torch.bool, device)
    ok = _empty((m,), torch.bool, device)
    if m:
        jac = _empty((m * k, 72), torch.int32, device)   # lane points
        build.call("k_sign", "k_sign_agg_launch", x, sign, inf, mask, m, k,
                   jac, ax, asign, ainf, ok)
        k_sign_agg.launches += 1
    return ax, asign, ainf, ok


k_sign_agg.launches = 0

KERNELS = {"k_sign_root": k_sign_root, "k_sign_field": k_sign_field,
           "k_sign_agg": k_sign_agg}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
