"""RFC 9380 hash-to-curve for BLS12-381 G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_).

Pure-Python ground truth.  Pipeline:
    msg --expand_message_xmd--> u0, u1 in Fp2     (host-side SHA-256)
    u --SSWU--> point on isogenous curve E2'
    --3-isogeny--> point on E2
    (sum of the two) --clear_cofactor--> G2

The reference reaches this through blst's hash-to-curve with the Ethereum DST
(crypto/bls/src/impls/blst.rs:14,179).
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

from .constants import (
    DST,
    ISO3_A,
    ISO3_B,
    ISO3_XDEN,
    ISO3_XNUM,
    ISO3_YDEN,
    ISO3_YNUM,
    ISO3_Z,
    P,
)
from .curve_ref import B_G2, Point, clear_cofactor_g2
from .fields_ref import Fp2

# --- expand_message_xmd (SHA-256) ------------------------------------------

_H_OUT = 32  # SHA-256 output size
_H_BLOCK = 64  # SHA-256 block size


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    ell = (len_in_bytes + _H_OUT - 1) // _H_OUT
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd parameter out of range")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _H_BLOCK
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        prev = bytes(x ^ y for x, y in zip(b0, b[-1]))
        b.append(hashlib.sha256(prev + bytes([i]) + dst_prime).digest())
    return b"".join(b)[:len_in_bytes]


_L = 64  # bytes per field coordinate (ceil((381 + 128) / 8))


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = DST) -> List[Fp2]:
    data = expand_message_xmd(msg, dst, count * 2 * _L)
    out = []
    for i in range(count):
        c0 = int.from_bytes(data[(2 * i) * _L:(2 * i + 1) * _L], "big") % P
        c1 = int.from_bytes(data[(2 * i + 1) * _L:(2 * i + 2) * _L], "big") % P
        out.append(Fp2(c0, c1))
    return out


# --- Simplified SWU on the isogenous curve E2' ------------------------------

_A = Fp2(*ISO3_A)
_B = Fp2(*ISO3_B)
_Z = Fp2(*ISO3_Z)


def sswu_map(u: Fp2) -> Tuple[Fp2, Fp2]:
    """RFC 9380 §6.6.2 simplified SWU: u -> (x', y') on E2'."""
    u2 = u.square()
    zu2 = _Z * u2
    tv = zu2.square() + zu2           # Z^2 u^4 + Z u^2
    if tv.is_zero():
        x1 = _B * (_Z * _A).inv()     # exceptional case
    else:
        x1 = (-_B) * _A.inv() * (Fp2.one() + tv.inv())
    gx1 = (x1.square() + _A) * x1 + _B
    if gx1.is_square():
        x, y = x1, gx1.sqrt()
    else:
        x2 = zu2 * x1
        gx2 = (x2.square() + _A) * x2 + _B
        x, y = x2, gx2.sqrt()
    assert y is not None
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


def iso3_map(xp: Fp2, yp: Fp2) -> Point:
    """Apply the 3-isogeny E2' -> E2 via the rational maps (Horner form)."""
    def horner(coeffs, z):
        acc = Fp2(*coeffs[-1])
        for c in reversed(coeffs[:-1]):
            acc = acc * z + Fp2(*c)
        return acc

    xn = horner(ISO3_XNUM, xp)
    xd = horner(ISO3_XDEN, xp)
    yn = horner(ISO3_YNUM, xp)
    yd = horner(ISO3_YDEN, xp)
    x = xn * xd.inv()
    y = yp * yn * yd.inv()
    return Point(x, y, B_G2)


def map_to_curve_g2(u: Fp2) -> Point:
    return iso3_map(*sswu_map(u))


def hash_to_g2(msg: bytes, dst: bytes = DST) -> Point:
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q = map_to_curve_g2(u0) + map_to_curve_g2(u1)
    return clear_cofactor_g2(q)
