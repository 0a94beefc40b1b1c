"""RFC 9380 hash-to-G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_): plain PyTorch
versions of the device stages.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/hash_to_g2.py``:

* ``hash_to_field_device`` (``k_xmd``): SHA-256 expand_message_xmd of 32-byte
  signing roots with the Ethereum DST, len 256, each 64-byte chunk reduced
  mod p -> (n, 2, 2, 12) canonical plain limbs of (u0, u1);
* ``map_to_curve_g2``: simplified SWU on the 3-isogenous curve plus the
  isogeny, in affine coordinates with Fermat inversions (the steps of
  ``..hash_to_curve_ref``);
* ``clear_cofactor``: Budroni-Pintore, [x^2-x-1]P + [x-1]psi(P) +
  psi^2(2P);
* ``hash_to_g2`` (inside ``k_sign_root`` / ``k_sign_field``): both maps,
  their sum and cofactor clearing; ``hash_to_g2_affine`` (``k_hash``) adds
  the affine conversion.

The host path for messages that are not 32 bytes is ``hash_to_field``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    DST, ISO3_A, ISO3_B, ISO3_XDEN, ISO3_XNUM, ISO3_YDEN, ISO3_YNUM, ISO3_Z,
    P, X as BLS_X,
)
from ...sha256.cuda.kernel import SHA_IV, sha_compress
from ..hash_to_curve_ref import hash_to_field_fp2
from . import curve, fp, fp2
from .curve import F2, Jacobian

# --- Host stage ----------------------------------------------------------------


def hash_to_field(msgs, dst: bytes = DST, device="cpu") -> torch.Tensor:
    """list[bytes] -> (n, 2, 2, 12) canonical plain limbs of (u0, u1)."""
    vals = []
    for m in msgs:
        for u in hash_to_field_fp2(m, 2, dst):
            vals.extend((u.c0, u.c1))
    return fp.pack(vals, device).reshape(len(msgs), 2, 2, fp.N_LIMBS)


def pack_msg_words(msgs) -> np.ndarray:
    """32-byte messages -> (n, 8) uint32 big-endian words."""
    out = np.zeros((len(msgs), 8), dtype=np.uint32)
    for i, m in enumerate(msgs):
        assert len(m) == 32, "signing roots are 32 bytes"
        out[i] = np.frombuffer(m, dtype=">u4")
    return out


# --- SHA-256 expand_message_xmd on 32-byte messages ----------------------------
#
# b0 = H(Z_pad(64) || msg(32) || 0x0100 || 0x00 || DST')   3 blocks
# b1 = H(b0 || 0x01 || DST')                                2 blocks
# bi = H((b0 ^ b_{i-1}) || i || DST')                       2 blocks
# ell = 8: 256 output bytes = four 64-byte chunks (u0.c0, u0.c1, u1.c0, u1.c1)

_M32 = 0xFFFFFFFF


def _words(data: bytes) -> list:
    return [int.from_bytes(data[i:i + 4], "big") for i in range(0, len(data), 4)]


def xmd_templates():
    """Static message words: (b0 block 2 tail (8 words), b0 block 3 (16),
    b_i block 1 tail after the counter byte (8 words, top byte 0), b_i
    block 2 (16))."""
    dst_prime = DST + bytes([len(DST)])
    b0_blk2_tail = _words(bytes([1, 0, 0]) + dst_prime[:29])
    content = dst_prime[29:] + b"\x80"
    b0_blk3 = _words(content + b"\x00" * (64 - len(content) - 8)
                     + (143 * 8).to_bytes(8, "big"))
    bi_blk1_tail = _words(b"\x00" + dst_prime[:31])
    content2 = dst_prime[31:] + b"\x80"
    bi_blk2 = _words(content2 + b"\x00" * (64 - len(content2) - 8)
                     + (77 * 8).to_bytes(8, "big"))
    return b0_blk2_tail, b0_blk3, bi_blk1_tail, bi_blk2


def os2ip_mod_p(words):
    """(..., 16) big-endian 32-bit words of a 64-byte chunk -> its value mod
    p, canonical plain limbs (..., 12).  The value splits into four 128-bit
    pieces c_k (each < p, a valid Montgomery operand): sum_k c_k 2^(128 k) R
    is its Montgomery form, which from_mont takes back to v mod p."""
    device = words.device
    le = words.flip(-1)                            # 16 little-endian limbs
    pieces = torch.zeros(*le.shape[:-1], 4, fp.N_LIMBS, dtype=torch.int64,
                         device=device)
    for k in range(4):
        pieces[..., k, :4] = le[..., 4 * k: 4 * k + 4]
    scale = fp.pack([(1 << (128 * k)) * fp.R2_MOD_P % P for k in range(4)],
                    device)
    t = fp.mont_mul(pieces, scale)
    half = fp.add(t[..., 0:2, :], t[..., 2:4, :])
    return fp.from_mont(fp.add(half[..., 0, :], half[..., 1, :]))


def hash_to_field_device(msg_words: torch.Tensor) -> torch.Tensor:
    """(n, 8) big-endian words of 32-byte messages -> (n, 2, 2, 12)
    canonical plain limbs of (u0, u1): the plain version of ``k_xmd``."""
    n = msg_words.shape[0]
    device = msg_words.device
    words = msg_words.to(torch.int64) & _M32

    def c(vals):
        return torch.tensor(vals, dtype=torch.int64,
                            device=device).expand(n, len(vals))

    b0_blk2_tail, b0_blk3, bi_blk1_tail, bi_blk2 = xmd_templates()
    iv = c(SHA_IV)
    s = sha_compress(iv, torch.zeros(n, 16, dtype=torch.int64, device=device))
    s = sha_compress(s, torch.cat([words, c(b0_blk2_tail)], dim=-1))
    b0 = sha_compress(s, c(b0_blk3))
    prev = None
    out = []
    for i in range(1, 9):
        x = b0 if prev is None else (b0 ^ prev)
        tail = list(bi_blk1_tail)
        tail[0] |= i << 24
        prev = sha_compress(sha_compress(iv, torch.cat([x, c(tail)], dim=-1)),
                            c(bi_blk2))
        out.append(prev)
    uniform = torch.cat(out, dim=-1).reshape(n, 4, 16)
    return os2ip_mod_p(uniform).reshape(n, 2, 2, fp.N_LIMBS)


# --- SSWU + 3-isogeny ---------------------------------------------------------


def _fp2_int_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _fp2_int_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
    return (a[0] * d % P, (-a[1]) * d % P)


# x1 in the exceptional case (tv == 0): B / (Z A); otherwise -B/A (1 + 1/tv).
EXC_X1 = _fp2_int_mul(ISO3_B, _fp2_int_inv(_fp2_int_mul(ISO3_Z, ISO3_A)))
NEG_B_OVER_A = _fp2_int_mul(((-ISO3_B[0]) % P, (-ISO3_B[1]) % P),
                            _fp2_int_inv(ISO3_A))


def _k(pair, device):
    return fp2.const_mont(pair, device)


def _iso_polys(device):
    """(4, 4, 2, 12): XNUM, XDEN, YNUM, YDEN zero-padded to degree 3."""
    polys = []
    for poly in (ISO3_XNUM, ISO3_XDEN, ISO3_YNUM, ISO3_YDEN):
        coeffs = list(poly) + [(0, 0)] * (4 - len(poly))
        polys.append(fp2.pack_mont(coeffs, device))
    return torch.stack(polys)


def map_to_curve_g2(u_plain):
    """(..., 2, 12) canonical plain u -> affine (x, y) Montgomery on E2."""
    device = u_plain.device
    u = fp.to_mont(u_plain)
    A, B, Z = _k(ISO3_A, device), _k(ISO3_B, device), _k(ISO3_Z, device)
    zu2 = fp2.mul(Z, fp2.sqr(u))
    tv = fp2.add(fp2.sqr(zu2), zu2)
    x1n = fp2.mul(_k(NEG_B_OVER_A, device),
                  fp2.add(fp2.one(tv.shape[:-2], device), fp2.inv(tv)))
    x1 = fp2.select(fp2.is_zero(tv), _k(EXC_X1, device).expand_as(x1n), x1n)
    x2 = fp2.mul(zu2, x1)
    xs = torch.stack([x1, x2], dim=-3)
    gx = fp2.add(fp2.mul(fp2.add(fp2.sqr(xs), A), xs), B)
    ys, ok = fp2.sqrt(gx)
    use1 = ok[..., 0]
    x = fp2.select(use1, x1, x2)
    y = fp2.select(use1, ys[..., 0, :, :], ys[..., 1, :, :])
    flip = fp2.sgn0_plain(u_plain) != fp2.sgn0_plain(fp.from_mont(y))
    y = fp2.select(flip, fp2.neg(y), y)
    # Isogeny: the four polynomials by Horner in one stacked product each.
    coeffs = _iso_polys(device)
    xb = x.unsqueeze(-3).expand(*x.shape[:-2], 4, 2, fp.N_LIMBS)
    acc = coeffs[:, 3].expand_as(xb)
    for k in (2, 1, 0):
        acc = fp2.add(fp2.mul(acc, xb), coeffs[:, k])
    xnum, xden, ynum, yden = (acc[..., i, :, :] for i in range(4))
    dinv = fp2.inv(torch.stack([xden, yden], dim=-3))
    r = fp2.mul(torch.stack([xnum, y], dim=-3),
                torch.stack([dinv[..., 0, :, :], ynum], dim=-3))
    return r[..., 0, :, :], fp2.mul(r[..., 1, :, :], dinv[..., 1, :, :])


ABS_X = -BLS_X


def mul_by_x(pt: Jacobian) -> Jacobian:
    """[x] pt for the (negative) curve parameter x."""
    return curve.neg(F2, curve.scalar_mul_static(F2, pt, ABS_X))


def clear_cofactor(pt: Jacobian) -> Jacobian:
    """[h_eff] P = [x^2 - x - 1] P + [x - 1] psi(P) + psi^2([2] P)."""
    t1 = mul_by_x(pt)
    t2 = mul_by_x(t1)
    npt = curve.neg(F2, pt)
    acc = curve.add(F2, curve.add(F2, t2, curve.neg(F2, t1)), npt)
    acc = curve.add(F2, acc, curve.g2_psi(curve.add(F2, t1, npt)))
    psi2 = curve.g2_psi(curve.g2_psi(curve.double(F2, pt)))
    return curve.add(F2, acc, psi2)


def hash_to_g2(u_plain) -> Jacobian:
    """(n, 2, 2, 12) plain (u0, u1) -> H(m), Jacobian: both maps, their sum
    and cofactor clearing (``hash_to_g2`` of csrc/hash_g2.cuh)."""
    x, y = map_to_curve_g2(u_plain)            # (n, 2, 2, 12): both maps
    no = torch.zeros(x.shape[:-3], dtype=torch.bool, device=x.device)
    q0 = curve.from_affine(F2, x[..., 0, :, :], y[..., 0, :, :], no)
    q1 = curve.from_affine(F2, x[..., 1, :, :], y[..., 1, :, :], no)
    return clear_cofactor(curve.add(F2, q0, q1))


def hash_to_g2_affine(u_plain):
    """(n, 2, 2, 12) plain (u0, u1) -> affine H(m): x, y (n, 2, 12)
    Montgomery canonical and inf (n,) -- the plain version of ``k_hash``."""
    return curve.to_affine(F2, hash_to_g2(u_plain))
