"""Pure-Python BLS12-381 field tower: Fp, Fp2, Fp6, Fp12.

This is the ground-truth implementation the CUDA kernels and their plain
PyTorch versions are verified against, and the host-side fallback for cold paths (key decompression,
one-off verifies).  It corresponds to the arithmetic the reference gets from
blst (crypto/bls/src/impls/blst.rs) but is written from the
mathematics, not translated.

Tower construction (standard for BLS12-381):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)
"""
from __future__ import annotations

from .constants import P


class Fp:
    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % P

    def __add__(self, o): return Fp(self.v + o.v)
    def __sub__(self, o): return Fp(self.v - o.v)
    def __mul__(self, o): return Fp(self.v * o.v)
    def __neg__(self): return Fp(-self.v)
    def __eq__(self, o): return self.v == o.v
    def __hash__(self): return hash(self.v)

    def square(self): return Fp(self.v * self.v)

    def inv(self):
        return Fp(pow(self.v, P - 2, P))

    def pow(self, e: int):
        return Fp(pow(self.v, e, P))

    def is_zero(self): return self.v == 0

    def sqrt(self):
        """Return a square root or None (p ≡ 3 mod 4)."""
        r = pow(self.v, (P + 1) // 4, P)
        if r * r % P == self.v:
            return Fp(r)
        return None

    def sgn0(self) -> int:
        return self.v & 1

    @staticmethod
    def zero(): return Fp(0)

    @staticmethod
    def one(): return Fp(1)

    def __repr__(self): return f"Fp(0x{self.v:x})"


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    def __add__(self, o): return Fp2(self.c0 + o.c0, self.c1 + o.c1)
    def __sub__(self, o): return Fp2(self.c0 - o.c0, self.c1 - o.c1)
    def __neg__(self): return Fp2(-self.c0, -self.c1)
    def __eq__(self, o): return self.c0 == o.c0 and self.c1 == o.c1
    def __hash__(self): return hash((self.c0, self.c1))

    def __mul__(self, o):
        # (a0 + a1 u)(b0 + b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fp2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self):
        a0, a1 = self.c0, self.c1
        return Fp2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def mul_scalar(self, k: int): return Fp2(self.c0 * k, self.c1 * k)

    def conjugate(self): return Fp2(self.c0, -self.c1)

    def mul_by_xi(self):
        # * (1 + u)
        return Fp2(self.c0 - self.c1, self.c0 + self.c1)

    def inv(self):
        # 1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2)
        d = pow((self.c0 * self.c0 + self.c1 * self.c1) % P, P - 2, P)
        return Fp2(self.c0 * d, -self.c1 * d)

    def pow(self, e: int):
        res, base = Fp2.one(), self
        while e > 0:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def is_zero(self): return self.c0 == 0 and self.c1 == 0

    def sgn0(self) -> int:
        # RFC 9380 sgn0 for m=2.
        sign_0 = self.c0 & 1
        zero_0 = self.c0 == 0
        sign_1 = self.c1 & 1
        return sign_0 | (zero_0 & sign_1)

    _SQRT_NQR = None  # cached quadratic non-residue for Tonelli-Shanks

    def is_square(self) -> bool:
        return self.pow((P * P - 1) // 2) == Fp2.one()

    def sqrt(self):
        """Tonelli-Shanks over Fp2 (q = p^2, q-1 = 2^3 * m).  Returns None
        if not a square."""
        if self.is_zero():
            return Fp2.zero()
        q1 = P * P - 1
        s = 0
        m = q1
        while m % 2 == 0:
            m //= 2
            s += 1
        if Fp2._SQRT_NQR is None:
            # find a quadratic non-residue
            for cand in (Fp2(1, 1), Fp2(0, 1), Fp2(2, 1), Fp2(1, 2), Fp2(3, 1)):
                if not cand.is_square():
                    Fp2._SQRT_NQR = cand
                    break
        z = Fp2._SQRT_NQR.pow(m)
        x = self.pow((m + 1) // 2)
        b = self.pow(m)
        # maintain x^2 = self * b, b a 2^(s-1)-th root of unity
        while b != Fp2.one():
            # find least k with b^(2^k) == 1
            t, k = b, 0
            while t != Fp2.one():
                t = t.square()
                k += 1
            if k == s:
                return None
            g = z
            for _ in range(s - k - 1):
                g = g.square()
            x = x * g
            z = g.square()
            b = b * z
            s = k
        if x.square() == self:
            return x
        return None

    @staticmethod
    def zero(): return Fp2(0, 0)

    @staticmethod
    def one(): return Fp2(1, 0)

    def __repr__(self): return f"Fp2(0x{self.c0:x}, 0x{self.c1:x})"


XI = Fp2(1, 1)  # the Fp6 non-residue


class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o): return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)
    def __sub__(self, o): return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)
    def __neg__(self): return Fp6(-self.c0, -self.c1, -self.c2)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_xi() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self): return self * self

    def mul_by_v(self):
        # (c0 + c1 v + c2 v^2) * v = c2*xi + c0 v + c1 v^2
        return Fp6(self.c2.mul_by_xi(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_xi()
        t1 = a2.square().mul_by_xi() - a0 * a1
        t2 = a1.square() - a0 * a2
        d = (a0 * t0 + (a2 * t1).mul_by_xi() + (a1 * t2).mul_by_xi()).inv()
        return Fp6(t0 * d, t1 * d, t2 * d)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    @staticmethod
    def zero(): return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one(): return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())


class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o): return Fp12(self.c0 + o.c0, self.c1 + o.c1)
    def __sub__(self, o): return Fp12(self.c0 - o.c0, self.c1 - o.c1)
    def __neg__(self): return Fp12(-self.c0, -self.c1)
    def __eq__(self, o): return self.c0 == o.c0 and self.c1 == o.c1

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fp12(t0 + t1.mul_by_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self): return self * self

    def conjugate(self):
        """The p^6-Frobenius: (a + b w) -> (a - b w)."""
        return Fp12(self.c0, -self.c1)

    def inv(self):
        # 1/(a + b w) = (a - b w) / (a^2 - b^2 v)
        d = (self.c0.square() - self.c1.square().mul_by_v()).inv()
        return Fp12(self.c0 * d, -(self.c1 * d))

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        res, base = Fp12.one(), self
        while e > 0:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def is_one(self): return self == Fp12.one()

    @staticmethod
    def zero(): return Fp12(Fp6.zero(), Fp6.zero())

    @staticmethod
    def one(): return Fp12(Fp6.one(), Fp6.zero())
