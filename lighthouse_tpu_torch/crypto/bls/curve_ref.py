"""Pure-Python BLS12-381 group operations: G1 (over Fp), G2 (over Fp2).

Affine arithmetic (clarity over speed — this is the ground truth / host
fallback, not the device hot path).  Serialization follows the ZCash/"official"
compressed encoding used by Ethereum consensus (48-byte G1, 96-byte G2),
byte-compatible with the reference's blst backend
(crypto/bls/src/generic_public_key.rs,
 generic_signature.rs: PUBLIC_KEY_BYTES_LEN=48, SIGNATURE_BYTES_LEN=96).
"""
from __future__ import annotations

from typing import Optional, Tuple

from .constants import G1_X, G1_Y, G2_X, G2_Y, P, R, X
from .fields_ref import Fp, Fp2, XI


class Point:
    """Affine point on y^2 = x^3 + b over a field (Fp or Fp2).

    `None` coordinates represent the point at infinity.
    """
    __slots__ = ("x", "y", "b")

    def __init__(self, x, y, b):
        self.x, self.y, self.b = x, y, b

    # -- constructors --------------------------------------------------------
    @staticmethod
    def infinity(b):
        return Point(None, None, b)

    def is_infinity(self) -> bool:
        return self.x is None

    # -- predicates ----------------------------------------------------------
    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        return self.y.square() == self.x.square() * self.x + self.b

    def __eq__(self, o) -> bool:
        if self.is_infinity() or o.is_infinity():
            return self.is_infinity() and o.is_infinity()
        return self.x == o.x and self.y == o.y

    # -- group law -----------------------------------------------------------
    def __neg__(self):
        if self.is_infinity():
            return self
        return Point(self.x, -self.y, self.b)

    def double(self):
        if self.is_infinity() or self.y.is_zero():
            return Point.infinity(self.b)
        x2 = self.x.square()
        lam = (x2 + x2 + x2) * (self.y + self.y).inv()
        x3 = lam.square() - self.x - self.x
        y3 = lam * (self.x - x3) - self.y
        return Point(x3, y3, self.b)

    def __add__(self, o):
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        if self.x == o.x:
            if self.y == o.y:
                return self.double()
            return Point.infinity(self.b)
        lam = (o.y - self.y) * (o.x - self.x).inv()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return Point(x3, y3, self.b)

    def mul(self, k: int):
        """Scalar multiplication (double-and-add); negative k handled."""
        if k < 0:
            return (-self).mul(-k)
        acc = Point.infinity(self.b)
        add = self
        while k > 0:
            if k & 1:
                acc = acc + add
            add = add.double()
            k >>= 1
        return acc

    def __repr__(self):
        if self.is_infinity():
            return "Point(inf)"
        return f"Point({self.x!r}, {self.y!r})"


# Curve coefficients as field elements.
B_G1 = Fp(4)
B_G2 = Fp2(4, 4)


def g1_generator() -> Point:
    return Point(Fp(G1_X), Fp(G1_Y), B_G1)


def g2_generator() -> Point:
    return Point(Fp2(*G2_X), Fp2(*G2_Y), B_G2)


def g1_infinity() -> Point:
    return Point.infinity(B_G1)


def g2_infinity() -> Point:
    return Point.infinity(B_G2)


# --- psi endomorphism (for fast G2 cofactor clearing & subgroup checks) -----
#
# psi = untwist o Frobenius o twist.  On the M-twist E2: y^2 = x^3 + 4 xi,
#   psi(x, y) = (PSI_CX * conj(x), PSI_CY * conj(y))
# with PSI_CX = 1 / xi^((p-1)/3), PSI_CY = 1 / xi^((p-1)/2) — computed, not
# hard-coded.
PSI_CX = XI.pow((P - 1) // 3).inv()
PSI_CY = XI.pow((P - 1) // 2).inv()


def psi(pt: Point) -> Point:
    if pt.is_infinity():
        return pt
    return Point(PSI_CX * pt.x.conjugate(), PSI_CY * pt.y.conjugate(), pt.b)


def clear_cofactor_g2(pt: Point) -> Point:
    """Map a point of E2(Fp2) into the order-r subgroup G2.

    Budroni–Pintore fast cofactor clearing, equal to multiplication by the
    RFC 9380 effective cofactor h_eff:
        [h_eff] P = [x^2 - x - 1] P + [x - 1] psi(P) + psi(psi([2] P))
    (verified against [H2] multiplication in tests, which differs by a factor
    coprime to r — both land in G2; equality with blst is pinned by the
    psi-formula itself).
    """
    x = X  # the signed curve parameter (negative for BLS12-381)
    t1 = pt.mul(x)          # [x] P
    t2 = t1.mul(x)          # [x^2] P
    acc = t2 + (-t1) + (-pt)            # [x^2 - x - 1] P
    acc = acc + psi(t1 + (-pt))         # + [x - 1] psi(P)
    acc = acc + psi(psi(pt.double()))   # + psi^2([2] P)
    return acc


def g2_subgroup_check(pt: Point) -> bool:
    """Subgroup membership: psi(P) == [x] P on G2 (eigenvalue of psi is the
    curve parameter x; cross-checked against [r]P == inf in tests)."""
    if pt.is_infinity():
        return True
    if not pt.is_on_curve():
        return False
    return psi(pt) == pt.mul(X)


def g1_subgroup_check(pt: Point) -> bool:
    """G1 subgroup membership via full-order check [r]P == inf.

    (The reference's blst uses the sigma/GLV fast check; the device
    backends carry their own vectorized checks — this host-side version favors
    obviousness over speed.)
    """
    if pt.is_infinity():
        return True
    if not pt.is_on_curve():
        return False
    return pt.mul(R).is_infinity()


# --- Serialization (ZCash compressed format) --------------------------------

_COMP_FLAG = 0x80
_INF_FLAG = 0x40
_SIGN_FLAG = 0x20


def _fp_is_lex_largest(y: Fp) -> bool:
    return y.v > (P - 1) // 2


def _fp2_is_lex_largest(y: Fp2) -> bool:
    if y.c1 != 0:
        return y.c1 > (P - 1) // 2
    return y.c0 > (P - 1) // 2


def g1_compress(pt: Point) -> bytes:
    if pt.is_infinity():
        return bytes([_COMP_FLAG | _INF_FLAG]) + b"\x00" * 47
    flags = _COMP_FLAG | (_SIGN_FLAG if _fp_is_lex_largest(pt.y) else 0)
    raw = pt.x.v.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def g1_decompress(data: bytes, subgroup_check: bool = True) -> Optional[Point]:
    if len(data) != 48:
        return None
    flags = data[0]
    if not flags & _COMP_FLAG:
        return None
    if flags & _INF_FLAG:
        if flags & _SIGN_FLAG or any(data[1:]) or data[0] & 0x1F:
            return None
        return g1_infinity()
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        return None
    xf = Fp(x)
    y = (xf.square() * xf + B_G1).sqrt()
    if y is None:
        return None
    if bool(flags & _SIGN_FLAG) != _fp_is_lex_largest(y):
        y = -y
    pt = Point(xf, y, B_G1)
    if subgroup_check and not g1_subgroup_check(pt):
        return None
    return pt


def g2_compress(pt: Point) -> bytes:
    if pt.is_infinity():
        return bytes([_COMP_FLAG | _INF_FLAG]) + b"\x00" * 95
    flags = _COMP_FLAG | (_SIGN_FLAG if _fp2_is_lex_largest(pt.y) else 0)
    raw_c1 = pt.x.c1.to_bytes(48, "big")
    raw_c0 = pt.x.c0.to_bytes(48, "big")
    return bytes([raw_c1[0] | flags]) + raw_c1[1:] + raw_c0


def g2_parse_compressed(data: bytes):
    """Flag/range validation half of g2 decompression, shared with the
    device backends' decode paths (one copy of the consensus-
    critical byte rules).  Returns (c0, c1, sign, inf) or None for a
    malformed encoding; (0, 0, False, True) is the valid infinity."""
    if len(data) != 96:
        return None
    flags = data[0]
    if not flags & _COMP_FLAG:
        return None
    if flags & _INF_FLAG:
        if flags & _SIGN_FLAG or any(data[1:]) or data[0] & 0x1F:
            return None
        return 0, 0, False, True
    c1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    c0 = int.from_bytes(data[48:], "big")
    if c0 >= P or c1 >= P:
        return None
    return c0, c1, bool(flags & _SIGN_FLAG), False


def g2_decompress(data: bytes, subgroup_check: bool = True) -> Optional[Point]:
    parsed = g2_parse_compressed(data)
    if parsed is None:
        return None
    c0, c1, sign, inf = parsed
    if inf:
        return g2_infinity()
    xf = Fp2(c0, c1)
    y = (xf.square() * xf + B_G2).sqrt()
    if y is None:
        return None
    if sign != _fp2_is_lex_largest(y):
        y = -y
    pt = Point(xf, y, B_G2)
    if subgroup_check and not g2_subgroup_check(pt):
        return None
    return pt
