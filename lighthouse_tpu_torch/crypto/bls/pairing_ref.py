"""Pure-Python optimal-ate pairing for BLS12-381.

Ground truth for the device pairing kernels.  Strategy: untwist G2 points into
E(Fp12) and run a textbook Miller loop in full Fp12 arithmetic — slow but
transparently correct.  Final exponentiation does the easy part via the p^6
conjugate + inversion, and the hard part by plain square-and-multiply with the
integer exponent (p^4 - p^2 + 1) / r; no addition-chain cleverness to get
wrong.

Semantics match the reference's blst calls
(crypto/bls/src/impls/blst.rs:36-119): multi-pairing
accumulation with a single shared final exponentiation.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from .constants import P, R, X
from .curve_ref import Point
from .fields_ref import Fp, Fp2, Fp6, Fp12

# --- Embedding Fp / Fp2 into Fp12 ------------------------------------------


def fp_to_fp12(a: Fp) -> Fp12:
    return Fp12(Fp6(Fp2(a.v, 0), Fp2.zero(), Fp2.zero()), Fp6.zero())


def _fp2_to_fp12(a: Fp2) -> Fp12:
    return Fp12(Fp6(a, Fp2.zero(), Fp2.zero()), Fp6.zero())


# w and w^-1 powers for the untwist.  Fp12 = Fp6[w]/(w^2 - v):
#   w^2 = v, w^3 = v*w.
_W2 = Fp12(Fp6(Fp2.zero(), Fp2.one(), Fp2.zero()), Fp6.zero())          # v
_W3 = Fp12(Fp6.zero(), Fp6(Fp2.zero(), Fp2.one(), Fp2.zero()))          # v*w
_W2_INV = _W2.inv()
_W3_INV = _W3.inv()


def untwist(q: Point) -> Tuple[Fp12, Fp12]:
    """Map an affine twist point (x, y) in E2'(Fp2) to E(Fp12):
    (x / w^2, y / w^3) lands on y^2 = x^3 + 4."""
    return (_fp2_to_fp12(q.x) * _W2_INV, _fp2_to_fp12(q.y) * _W3_INV)


# --- Miller loop ------------------------------------------------------------

_ABS_X = -X
_X_BITS = bin(_ABS_X)[3:]  # skip the leading 1


def _line_eval(t_xy, q_xy, p_xy, doubling: bool) -> Tuple[Fp12, Tuple[Fp12, Fp12]]:
    """Evaluate the line through T and Q (or tangent at T when doubling) at P,
    and return (line_value, T') where T' = T+Q (or 2T)."""
    tx, ty = t_xy
    px, py = p_xy
    if doubling:
        tx2 = tx.square()
        lam = (tx2 + tx2 + tx2) * (ty + ty).inv()
        qx, qy = tx, ty
    else:
        qx, qy = q_xy
        lam = (qy - ty) * (qx - tx).inv()
    # l(P) = (yP - yT) - lam * (xP - xT)
    l = (py - ty) - lam * (px - tx)
    x3 = lam.square() - tx - qx
    y3 = lam * (tx - x3) - ty
    return l, (x3, y3)


def miller_loop(pairs: Iterable[Tuple[Point, Point]]) -> Fp12:
    """Multi-Miller loop: product over (P in G1, Q in G2) pairs, shared
    accumulator squaring (the CUDA kernel instead runs one Miller loop per pair
    and multiplies the lane values afterwards; see cuda/pairing.py)."""
    prepared = []
    for p_g1, q_g2 in pairs:
        if p_g1.is_infinity() or q_g2.is_infinity():
            continue  # contributes the neutral element
        px, py = fp_to_fp12(p_g1.x), fp_to_fp12(p_g1.y)
        qx, qy = untwist(q_g2)
        prepared.append(((px, py), (qx, qy)))

    f = Fp12.one()
    ts = [q for _, q in prepared]
    for bit in _X_BITS:
        f = f.square()
        for i, (p_xy, q_xy) in enumerate(prepared):
            l, ts[i] = _line_eval(ts[i], None, p_xy, doubling=True)
            f = f * l
        if bit == "1":
            for i, (p_xy, q_xy) in enumerate(prepared):
                l, ts[i] = _line_eval(ts[i], q_xy, p_xy, doubling=False)
                f = f * l
    # x < 0: conjugate (p^6-Frobenius); valid up to final exponentiation.
    return f.conjugate()


# --- Final exponentiation ---------------------------------------------------

_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f: Fp12) -> Fp12:
    # easy part: f^((p^6 - 1)(p^2 + 1))
    t = f.conjugate() * f.inv()        # f^(p^6 - 1)
    t = t.pow(P * P) * t               # ^(p^2 + 1)
    # hard part: ^((p^4 - p^2 + 1) / r)
    return t.pow(_HARD_EXP)


def pairing(p_g1: Point, q_g2: Point) -> Fp12:
    return final_exponentiation(miller_loop([(p_g1, q_g2)]))


def multi_pairing_is_one(pairs: Iterable[Tuple[Point, Point]]) -> bool:
    """prod e(P_i, Q_i) == 1 — the shape every verification reduces to."""
    return final_exponentiation(miller_loop(pairs)).is_one()
