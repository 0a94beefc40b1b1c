"""G1 / G2 point arithmetic: plain PyTorch versions.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/curve.py``.  Points are
Jacobian triples ``(X, Y, Z)`` of Montgomery field elements (G1 over Fp:
``(..., 12)``; G2 over Fp2: ``(..., 2, 12)``); infinity is Z = 0.  The group
law is complete by case analysis, as ``_add_core`` of the TPU package does
it with masks: P == Q doubles, P == -Q gives infinity, infinity passes
through.  Neither curve has 2-torsion, so the a = 0 doubling is complete.

Affine points cross the kernel boundary as canonical ``(x, y, inf)``
tensors with x = y = 0 at infinity (``pack_g1_affine`` / ``pack_g2_affine``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import B2, G1_X, G1_Y, G2_X, G2_Y, P, X as BLS_X
from . import fp, fp2


class _F1:
    """Fp as the coordinate field (G1)."""
    nd = 1
    mul = staticmethod(fp.mont_mul)
    sqr = staticmethod(fp.sqr)
    add = staticmethod(fp.add)
    sub = staticmethod(fp.sub)
    neg = staticmethod(fp.neg)
    inv = staticmethod(fp.inv)
    select = staticmethod(fp.select)
    is_zero = staticmethod(fp.is_zero)
    eq = staticmethod(fp.eq)
    zeros = staticmethod(fp.zeros)
    one = staticmethod(fp.one)


class _F2:
    """Fp2 as the coordinate field (G2)."""
    nd = 2
    mul = staticmethod(fp2.mul)
    sqr = staticmethod(fp2.sqr)
    add = staticmethod(fp2.add)
    sub = staticmethod(fp2.sub)
    neg = staticmethod(fp2.neg)
    inv = staticmethod(fp2.inv)
    select = staticmethod(fp2.select)
    is_zero = staticmethod(fp2.is_zero)
    eq = staticmethod(fp2.eq)
    zeros = staticmethod(fp2.zeros)
    one = staticmethod(fp2.one)


F1 = _F1
F2 = _F2


class Jacobian(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _stack(F, ts):
    return torch.stack(ts, dim=-1 - F.nd)


def _unstack(F, t, k):
    return [t.select(-1 - F.nd, i) for i in range(k)]


def muls(F, xs, ys):
    """Independent products stacked into one field multiplication."""
    xs = torch.broadcast_tensors(*xs, *ys)
    k = len(ys)
    return _unstack(F, F.mul(_stack(F, list(xs[:k])), _stack(F, list(xs[k:]))),
                    k)


def batch_shape(F, pt: Jacobian):
    return pt.x.shape[: pt.x.dim() - F.nd]


def infinity(F, shape, device) -> Jacobian:
    z = F.zeros(shape, device)
    return Jacobian(z, F.one(shape, device), z.clone())


def is_infinity(F, pt: Jacobian):
    return F.is_zero(pt.z)


def from_affine(F, x, y, inf) -> Jacobian:
    shape = x.shape[: x.dim() - F.nd]
    one = F.one(shape, x.device)
    z = F.select(inf, torch.zeros_like(one), one)
    return Jacobian(x, y, z)


def select(F, mask, p: Jacobian, q: Jacobian) -> Jacobian:
    return Jacobian(F.select(mask, p.x, q.x), F.select(mask, p.y, q.y),
                    F.select(mask, p.z, q.z))


def neg(F, pt: Jacobian) -> Jacobian:
    return Jacobian(pt.x, F.neg(pt.y), pt.z)


def lin(F, vals, coeffs):
    """Small integer linear combinations of field elements (one
    ``fp.linear`` call; over Fp2 the coefficients act on each
    component)."""
    v = torch.stack(torch.broadcast_tensors(*vals), dim=-1 - F.nd)
    if F.nd == 2:
        out = fp.linear(v.transpose(-3, -2), coeffs).transpose(-3, -2)
    else:
        out = fp.linear(v, coeffs)
    return _unstack(F, out, len(coeffs))


def double(F, pt: Jacobian) -> Jacobian:
    """dbl-2009-l (a = 0); infinity maps to infinity (Z3 = 2YZ = 0)."""
    X1, Y1, Z1 = pt
    A, B, YZ = muls(F, [X1, Y1, Y1], [X1, Y1, Z1])
    (XB,) = lin(F, [X1, B], [[1, 1]])
    C, T = muls(F, [B, XB], [B, XB])
    D, E = lin(F, [T, A, C], [[2, -2, -2], [0, 3, 0]])   # 2((X+B)^2-A-C), 3A
    (Fq,) = muls(F, [E], [E])
    X3, DmX3 = lin(F, [Fq, D], [[1, -2], [-1, 3]])       # F - 2D, D - X3
    (Y3a,) = muls(F, [E], [DmX3])
    Y3, Z3 = lin(F, [Y3a, C, YZ], [[1, -8, 0], [0, 0, 2]])
    return Jacobian(X3, Y3, Z3)


def add(F, p: Jacobian, q: Jacobian) -> Jacobian:
    """Complete addition: add-2007-bl plus the case analysis."""
    p = Jacobian(*torch.broadcast_tensors(*p))
    q = Jacobian(*torch.broadcast_tensors(*q))
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2 = muls(F, [Z1, Z2], [Z1, Z2])
    U1, U2, t1, t2 = muls(F, [X1, X2, Z2, Z1], [Z2Z2, Z1Z1, Z2Z2, Z1Z1])
    S1, S2 = muls(F, [Y1, Y2], [t1, t2])
    H, rr, H2, ZZ = lin(F, [U2, U1, S2, S1, Z1, Z2],
                        [[1, -1, 0, 0, 0, 0], [0, 0, 2, -2, 0, 0],
                         [2, -2, 0, 0, 0, 0], [0, 0, 0, 0, 1, 1]])
    I, W = muls(F, [H2, ZZ], [H2, ZZ])
    (Wz,) = lin(F, [W, Z1Z1, Z2Z2], [[1, -1, -1]])
    J, V, Z3, R2 = muls(F, [H, U1, Wz, rr], [I, I, H, rr])
    X3, VmX3 = lin(F, [R2, J, V], [[1, -1, -2], [-1, 1, 3]])
    Y3a, S1J = muls(F, [rr, S1], [VmX3, J])
    (Y3,) = lin(F, [Y3a, S1J], [[1, -2]])
    out = Jacobian(X3, Y3, Z3)
    dbl = F.is_zero(H) & F.is_zero(rr)
    if bool(dbl.any()):
        out = select(F, dbl, double(F, p), out)      # P == Q
    pinf, qinf = is_infinity(F, p), is_infinity(F, q)
    out = select(F, qinf, p, out)
    out = select(F, pinf, q, out)
    return out


def scalar_mul_static(F, pt: Jacobian, k: int) -> Jacobian:
    """[k] pt for a static k > 0 (MSB-first double and add)."""
    assert k > 0
    acc = pt
    for bit in bin(k)[3:]:
        acc = double(F, acc)
        if bit == "1":
            acc = add(F, acc, pt)
    return acc


def scalar_mul_dynamic(F, pt: Jacobian, scalars: torch.Tensor,
                       nbits: int) -> Jacobian:
    """[k_i] pt_i for runtime scalars: ``scalars`` (..., nbits/32) int64
    holding little-endian 32-bit words (the batch weights).  MSB-first
    double and add; a zero scalar gives infinity."""
    shape = batch_shape(F, pt)
    acc = infinity(F, shape, pt.x.device)
    for i in range(nbits - 1, -1, -1):
        acc = double(F, acc)
        bit = ((scalars[..., i // 32] >> (i % 32)) & 1) == 1
        acc = select(F, bit, add(F, acc, pt), acc)
    return acc


def ladder_ct(F, base: Jacobian, words: torch.Tensor,
              nbits: int = 255) -> Jacobian:
    """[k_i] base_i for secret scalars: ``words`` (..., 8) int64 holding
    little-endian 32-bit words.  The plain version of the signing kernels'
    scalar multiplication (the LSB-first ``ladder_step`` of the TPU
    package scanned over all ``nbits`` bits; the kernels run a psi-split
    ladder, csrc/hash_g2.cuh, with the same result for every k < 2^255):
    every step adds and doubles, and a select keeps the sum where the bit
    is set; a zero scalar gives infinity."""
    acc = infinity(F, batch_shape(F, base), base.x.device)
    addend = base
    for j in range(nbits):
        take = ((words[..., j // 32] >> (j % 32)) & 1) == 1
        acc = select(F, take, add(F, addend, acc), acc)
        addend = double(F, addend)
    return acc


def sum_reduce(F, pt: Jacobian) -> Jacobian:
    """Point sum over the leading axis: halving tree of complete adds,
    padded with infinity to a power of two."""
    n = pt.x.shape[0]
    if n == 0:
        return infinity(F, (), pt.x.device)
    n_pad = 1 << (n - 1).bit_length()
    if n_pad != n:
        inf = infinity(F, (n_pad - n, *pt.x.shape[1: pt.x.dim() - F.nd]),
                       pt.x.device)
        pt = Jacobian(*(torch.cat([a, b]) for a, b in zip(pt, inf)))
    while pt.x.shape[0] > 1:
        pt = add(F, Jacobian(*(c[0::2] for c in pt)),
                 Jacobian(*(c[1::2] for c in pt)))
    return Jacobian(*(c[0] for c in pt))


def to_affine(F, pt: Jacobian, zi=None):
    """(x, y, inf), canonical Montgomery; x = y = 0 at infinity.  ``zi`` is
    1/Z when the caller has it (one inversion shared by several points)."""
    if zi is None:
        zi = F.inv(pt.z)
    zi2 = F.sqr(zi)
    x, zi3 = muls(F, [pt.x, zi], [zi2, zi2])
    (y,) = muls(F, [pt.y], [zi3])
    inf = is_infinity(F, pt)
    zero = torch.zeros_like(x)
    return F.select(inf, zero, x), F.select(inf, zero, y), inf


# --- G2 endomorphism psi -------------------------------------------------------
#
# psi(x, y) = (PSI_CX conj(x), PSI_CY conj(y)) on the M-twist, computed from
# xi = 1 + u (curve_ref.PSI_CX / PSI_CY); on Jacobian coordinates conj acts
# on Z too.


def _fp2_pow_int(c0_: int, c1_: int, e: int):
    r0, r1 = 1, 0
    b0, b1 = c0_ % P, c1_ % P
    while e:
        if e & 1:
            r0, r1 = (r0 * b0 - r1 * b1) % P, (r0 * b1 + r1 * b0) % P
        b0, b1 = (b0 * b0 - b1 * b1) % P, (2 * b0 * b1) % P
        e >>= 1
    return r0, r1


def _fp2_inv_int(c0_: int, c1_: int):
    d = pow((c0_ * c0_ + c1_ * c1_) % P, P - 2, P)
    return c0_ * d % P, (-c1_) * d % P


PSI_CX = _fp2_inv_int(*_fp2_pow_int(1, 1, (P - 1) // 3))
PSI_CY = _fp2_inv_int(*_fp2_pow_int(1, 1, (P - 1) // 2))


def g2_psi(pt: Jacobian) -> Jacobian:
    device = pt.x.device
    cx = fp2.const_mont(PSI_CX, device)
    cy = fp2.const_mont(PSI_CY, device)
    x, y = muls(F2, [fp2.conj(pt.x), fp2.conj(pt.y)], [cx, cy])
    return Jacobian(x, y, fp2.conj(pt.z))


def eq(F, p: Jacobian, q: Jacobian):
    """Projective equality across different Z (the same affine point, or
    both infinity): X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3."""
    Z1Z1, Z2Z2 = muls(F, [p.z, q.z], [p.z, q.z])
    U1, U2, t1, t2 = muls(F, [p.x, q.x, q.z, p.z], [Z2Z2, Z1Z1, Z2Z2, Z1Z1])
    S1, S2 = muls(F, [p.y, q.y], [t1, t2])
    pinf, qinf = is_infinity(F, p), is_infinity(F, q)
    same = F.eq(U1, U2) & F.eq(S1, S2)
    return torch.where(pinf | qinf, pinf & qinf, same)


def g2_subgroup_check(pt: Jacobian):
    """P in G2  <=>  psi(P) == [z] P, z = -|z| the curve parameter: the
    ladder runs over |z| and its result is negated.  Infinity passes."""
    zp = neg(F2, scalar_mul_static(F2, pt, -BLS_X))
    return eq(F2, g2_psi(pt), zp)


# --- G1 endomorphism phi --------------------------------------------------------
#
# phi(x, y) = (beta x, y) with beta a cube root of unity in Fp acts on G1 as
# [lambda], lambda = z^2 - 1 (lambda^2 + lambda + 1 = z^4 - z^2 + 1 = r).  Of
# the two cube roots the one whose phi matches [lambda] on the generator is
# chosen, as tpu/curve.py _select_beta chooses it.

G1_LAMBDA = BLS_X ** 2 - 1


def _select_beta() -> int:
    from .. import curve_ref as cv
    from ..fields_ref import Fp as RefFp

    g = 2
    while pow(g, (P - 1) // 3, P) == 1:
        g += 1
    beta = pow(g, (P - 1) // 3, P)
    gen = cv.g1_generator()
    target = gen.mul(G1_LAMBDA)
    for cand in (beta, beta * beta % P):
        if cv.Point(RefFp(cand) * gen.x, gen.y, gen.b) == target:
            return cand
    raise AssertionError("no cube root of unity matches the G1 endomorphism")


G1_BETA = _select_beta()


def g1_endo(pt: Jacobian) -> Jacobian:
    """phi(X, Y, Z) = (beta X, Y, Z): the affine x scales by beta."""
    beta = fp.pack_mont([G1_BETA], pt.x.device)[0]
    return Jacobian(fp.mont_mul(pt.x, beta), pt.y, pt.z)


def g1_subgroup_check(pt: Jacobian):
    """P in G1  <=>  phi(P) == [lambda] P (a 128-bit ladder where [r] P
    would take 255 bits).  Infinity passes."""
    return eq(F1, g1_endo(pt), scalar_mul_static(F1, pt, G1_LAMBDA))


# --- G2 decompression (the field half; the host parses the bytes) -------------

_HALF_P = (P - 1) // 2


def fp_is_lex_largest(y):
    """y > (p - 1) / 2 for a MONTGOMERY element, decided on the real value:
    the Montgomery factor comes off first (comparing y R mod p answers
    another question and negates about half the lanes)."""
    return fp.gt_const(fp.from_mont(y), _HALF_P)


def fp2_is_lex_largest(y):
    """The ZCash sign of a Montgomery Fp2 element: c1 > (p - 1) / 2, or
    c0 > (p - 1) / 2 where c1 == 0 (on real values)."""
    yc = fp.from_mont(y)
    big = fp.gt_const(yc, _HALF_P)
    c1_zero = fp.is_zero(fp2.c1(yc))
    return torch.where(c1_zero, big[..., 0], big[..., 1])


def fp_sqrt(a):
    """Square root in Fp (p = 3 mod 4): r = a^((p + 1) / 4) and whether
    r^2 == a (a is a square)."""
    r = fp.pow(a, (P + 1) // 4)
    return r, fp.eq(fp.mont_mul(r, r), a)


def g1_decompress(x, sign, inf):
    """x (..., 12) canonical plain limbs of the wire x coordinate, sign and
    inf (...,) bool -> (Jacobian, ok): y = sqrt(x^3 + 4) with the
    lexicographic sign of the wire flag; ok is "x == 0" on infinity lanes
    and "on the curve" elsewhere (no subgroup check: g1_subgroup_check)."""
    xm = fp.to_mont(x)
    four = fp.pack_mont([4], x.device)[0]
    rhs = fp.add(fp.mont_mul(fp.sqr(xm), xm), four)
    y, on_curve = fp_sqrt(rhs)
    flip = fp_is_lex_largest(y) != sign
    y = fp.select(flip, fp.neg(y), y)
    ok = torch.where(inf, fp.is_zero(x), on_curve)
    return from_affine(F1, xm, y, inf), ok


def g2_decompress(x, sign, inf):
    """x (..., 2, 12) canonical plain limbs of the wire x coordinate, sign
    and inf (...,) bool -> (Jacobian, ok): y = sqrt(x^3 + 4(1 + u)) with the
    lexicographic sign of the wire flag; ok is "x == 0" on infinity lanes
    and "on the curve" elsewhere (no subgroup check: g2_subgroup_check)."""
    device = x.device
    xm = fp.to_mont(x)
    rhs = fp2.add(fp2.mul(fp2.sqr(xm), xm), fp2.const_mont(B2, device))
    y, on_curve = fp2.sqrt(rhs)
    flip = fp2_is_lex_largest(y) != sign
    y = fp2.select(flip, fp2.neg(y), y)
    ok = torch.where(inf, fp2.is_zero(x), on_curve)
    return from_affine(F2, xm, y, inf), ok


def g2_compress(pt: Jacobian):
    """The compressed planes of G2 points: canonical PLAIN affine x
    (..., 2, 12), the lexicographic sign of y and the infinity flag (x = 0
    and sign False at infinity) -- ``curve.to_affine``, ``fp.from_mont`` and
    ``fp2_is_lex_largest`` of the TPU package's signer."""
    x, y, inf = to_affine(F2, pt)
    return fp.from_mont(x), fp2_is_lex_largest(y), inf


# --- Generators and host packing ---------------------------------------------


def g1_generator(device) -> Jacobian:
    return from_affine(F1, fp.pack_mont([G1_X], device)[0],
                       fp.pack_mont([G1_Y], device)[0],
                       torch.zeros((), dtype=torch.bool, device=device))


def g2_generator(device) -> Jacobian:
    return from_affine(F2, fp2.const_mont(G2_X, device),
                       fp2.const_mont(G2_Y, device),
                       torch.zeros((), dtype=torch.bool, device=device))


def neg_g1_affine(device):
    """(x, y) of -g1, Montgomery."""
    return (fp.pack_mont([G1_X], device)[0],
            fp.pack_mont([(-G1_Y) % P], device)[0])


def pack_g1_affine(points, device="cpu"):
    """list[curve_ref.Point (G1)] -> (x, y, inf): (n, 12) int64 Montgomery
    limbs and an (n,) bool mask; infinity packs as (0, 0, True)."""
    vals, infs = [], []
    for p in points:
        if p.is_infinity():
            infs.append(True)
            vals.extend((0, 0))
        else:
            infs.append(False)
            vals.extend((p.x.v, p.y.v))
    n = len(points)
    limbs = fp.pack([v * fp.R_MOD_P % P for v in vals], device)
    limbs = limbs.reshape(n, 2, fp.N_LIMBS)
    return (limbs[:, 0].contiguous(), limbs[:, 1].contiguous(),
            torch.tensor(infs, dtype=torch.bool, device=device))


def pack_g2_affine(points, device="cpu"):
    """list[curve_ref.Point (G2)] -> (x, y, inf): (n, 2, 12) limbs."""
    vals, infs = [], []
    for p in points:
        if p.is_infinity():
            infs.append(True)
            vals.extend((0, 0, 0, 0))
        else:
            infs.append(False)
            vals.extend((p.x.c0, p.x.c1, p.y.c0, p.y.c1))
    n = len(points)
    limbs = fp.pack([v * fp.R_MOD_P % P for v in vals], device)
    limbs = limbs.reshape(n, 2, 2, fp.N_LIMBS)
    return (limbs[:, 0].contiguous(), limbs[:, 1].contiguous(),
            torch.tensor(infs, dtype=torch.bool, device=device))


def unpack_g1_affine(x, y, inf) -> list:
    """Canonical affine Montgomery tensors -> list[curve_ref.Point]."""
    from .. import curve_ref as cv
    from ..fields_ref import Fp as RefFp

    xs, ys = fp.unpack_mont(x), fp.unpack_mont(y)
    return [cv.g1_infinity() if bool(i) else
            cv.Point(RefFp(a), RefFp(b), cv.B_G1)
            for a, b, i in zip(xs, ys, inf.reshape(-1).tolist())]


def unpack_g2_affine(x, y, inf) -> list:
    from .. import curve_ref as cv
    from ..fields_ref import Fp2 as RefFp2

    xs, ys = fp2.unpack_mont(x), fp2.unpack_mont(y)
    return [cv.g2_infinity() if bool(i) else
            cv.Point(RefFp2(*a), RefFp2(*b), cv.B_G2)
            for a, b, i in zip(xs, ys, inf.reshape(-1).tolist())]


def aggregate_g1(xpk, ypk, ipk, mask) -> Jacobian:
    """Masked G1 aggregation (counterpart of ``verify.aggregate_points_g1``):
    (n, k) padded affine pubkeys -> (n,) Jacobian sums over the keys whose
    mask is set and that are not infinity."""
    pt = from_affine(F1, xpk, ypk, ipk | ~mask)
    pt = Jacobian(*(c.transpose(0, 1) for c in pt))
    return sum_reduce(F1, pt)
