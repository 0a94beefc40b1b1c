"""BLS12-381 base field Fp on 12 x 32-bit limbs: plain PyTorch versions.

Counterpart of ``lighthouse_tpu/crypto/bls/tpu/fp.py``.  An element is a
tensor ``(..., 12)`` of little-endian 32-bit limbs held in ``int64`` (the
values are non-negative; PyTorch has few ops on unsigned types), Montgomery
form with R = 2^384, and always fully reduced (< p) after every op.  The
CUDA kernels (``csrc/bls12_381.cuh``) use the same limbs as ``uint32``, so a
kernel's output and its plain version compare limb for limb.

None of the TPU representation survives: 13-bit limbs, loose-limb bounds
and the MXU product path exist there because the TPU has no 64-bit integer
datapath.  Here each op is exact integer arithmetic on int64 tensors:

* products split the limbs into 24-bit digits (3 limbs = 4 digits), so a
  digit product is < 2^48 and a column of 16 of them stays below 2^53;
* Montgomery reduction is done for the whole operand at once (m = T*N' mod
  R, then (T + m*p) / R), the exact carry out of the low half read with one
  float64 rounding (the low half is an exact multiple of R, and the float
  error is far below 1/2);
* carries are resolved by passes over the limb axis until none is left; a
  result and the result minus p are normalized together, and the sign of
  the second picks the reduced one.

The digit-split product (``mont_digits``) and the carry passes
(``carry_fixed``, ``carry_exact``, ``pick_reduced``) take the modulus and
the digit width as arguments: the scalar field of the KZG path
(``crypto/kzg/cuda/fr.py``) shares them with 16-bit digits.

Every function broadcasts over leading dimensions.  Stacking many
independent products into one ``mont_mul`` call is what keeps the plain
versions usable: the op count of a call does not depend on its batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import P

N_LIMBS = 12
LIMB_BITS = 32
MASK = (1 << LIMB_BITS) - 1
R_BITS = 384
R = 1 << R_BITS
R_MOD_P = R % P
R2_MOD_P = R * R % P
INV_R = pow(R, -1, P)

_DIGIT_BITS = 24
_N_DIGITS = 16
_DMASK = (1 << _DIGIT_BITS) - 1
_NPRIME = (-pow(P, -1, R)) % R  # -p^-1 mod R

DTYPE = torch.int64

# --- Host packing ------------------------------------------------------------


def int_to_limbs(v: int) -> list:
    assert 0 <= v < R
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)]


def limbs_to_int(limbs) -> int:
    return sum(int(x) << (LIMB_BITS * i) for i, x in enumerate(limbs))


def ints_to_limbs(vals) -> np.ndarray:
    """ints in [0, 2^384) -> (len, 12) uint32 limbs in one pass (each
    value's 48 little-endian bytes, read as words)."""
    raw = b"".join(v.to_bytes(4 * N_LIMBS, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32).reshape(
        len(vals), N_LIMBS)


def mont_ints_to_limbs(vals) -> np.ndarray:
    """Canonical ints -> (len, 12) uint32 Montgomery limbs."""
    return ints_to_limbs([v * R_MOD_P % P for v in vals])


def pack(vals, device="cpu") -> torch.Tensor:
    """ints -> (len, 12) int64 limbs of each value mod p."""
    limbs = ints_to_limbs([v % P for v in vals]).astype(np.int64)
    return torch.from_numpy(limbs).to(device)


def pack_mont(vals, device="cpu") -> torch.Tensor:
    return pack([v * R_MOD_P % P for v in vals], device)


def unpack(t: torch.Tensor) -> list:
    """(..., 12) limbs (any integer dtype holding 32-bit values) -> flat
    list of ints."""
    rows = (t.to(torch.int64) & MASK).reshape(-1, N_LIMBS).tolist()
    return [limbs_to_int(r) for r in rows]


def unpack_mont(t: torch.Tensor) -> list:
    return [v * INV_R % P for v in unpack(t)]


def const(v: int, device) -> torch.Tensor:
    """One canonical element (12,) on `device`."""
    return torch.tensor(int_to_limbs(v), dtype=DTYPE, device=device)


_CONSTS: dict = {}


def _c(name: str, device) -> torch.Tensor:
    key = (name, device)
    t = _CONSTS.get(key)
    if t is None:
        t = _build_const(name, torch.device(device))
        _CONSTS[key] = t
    return t


def _digits_of(v: int, n: int) -> list:
    return [(v >> (_DIGIT_BITS * i)) & _DMASK for i in range(n)]


def _build_const(name: str, device) -> torch.Tensor:
    def t(vals, dtype=DTYPE):
        return torch.tensor(vals, dtype=dtype, device=device)

    if name == "p":
        return const(P, device)
    if name == "p24":
        return t(_digits_of(P, _N_DIGITS))
    if name == "np24":
        return t(_digits_of(_NPRIME, _N_DIGITS))
    if name == "one":
        return const(R_MOD_P, device)
    if name == "r2":
        return const(R2_MOD_P, device)
    if name == "conv_idx":  # column of digit product (i, j)
        i = torch.arange(_N_DIGITS, device=device)
        return (i[:, None] + i[None, :]).reshape(-1)
    if name == "conv_lo":  # products with i + j < 16 (the low half)
        i = torch.arange(_N_DIGITS, device=device)
        return ((i[:, None] + i[None, :]) < _N_DIGITS).reshape(-1).nonzero(
        ).reshape(-1)
    if name == "carry_w":  # float64 weights 2^(24 j - 384), j < 16
        return t([2.0 ** (_DIGIT_BITS * j - R_BITS) for j in range(_N_DIGITS)],
                 torch.float64)
    # limbs -> digits: d_j = (l[lo] >> off | l[hi] << hsh) & DMASK
    if name in ("td_lo", "td_off", "td_hi", "td_hsh"):
        lo = [(24 * j) // 32 for j in range(_N_DIGITS)]
        off = [(24 * j) % 32 for j in range(_N_DIGITS)]
        hi = [min(a + 1, N_LIMBS - 1) for a in lo]
        hsh = [32 - o if o + 24 > 32 else 40 for o in off]
        return t({"td_lo": lo, "td_off": off, "td_hi": hi,
                  "td_hsh": hsh}[name])
    # digits -> limbs: l_i = (d[j] >> o | d[j + 1] << (24 - o)) & MASK
    if name in ("fd_j", "fd_o", "fd_j1", "fd_s"):
        j = [(32 * i) // 24 for i in range(N_LIMBS)]
        o = [(32 * i) % 24 for i in range(N_LIMBS)]
        return t({"fd_j": j, "fd_o": o, "fd_j1": [x + 1 for x in j],
                  "fd_s": [24 - x for x in o]}[name])
    # carry-pass shift/mask vectors ("sh_<bits>_<n>_<kind>", "mk_..."): the
    # top position keeps everything ("top") or is split like the others,
    # its carry dropped ("mod").
    what, bits, n, kind = name.split("_")
    bits, n = int(bits), int(n)
    if what == "sh":
        return t([bits] * (n - 1) + [63 if kind == "top" else bits])
    m = (1 << bits) - 1
    return t([m] * (n - 1) + [-1 if kind == "top" else m])


# --- Limb <-> digit conversion ----------------------------------------------


def _to_digits(a: torch.Tensor) -> torch.Tensor:
    """(..., 12) 32-bit limbs -> (..., 16) 24-bit digits."""
    d = a.device
    lo = a.index_select(-1, _c("td_lo", d)) >> _c("td_off", d)
    hi = a.index_select(-1, _c("td_hi", d)) << _c("td_hsh", d)
    return (lo | hi) & _DMASK


def _from_digits(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) normalized 24-bit digits -> (..., 12) 32-bit limbs."""
    d = x.device
    lo = x.index_select(-1, _c("fd_j", d)) >> _c("fd_o", d)
    hi = x.index_select(-1, _c("fd_j1", d)) << _c("fd_s", d)
    return (lo | hi) & MASK


# --- Carry handling ----------------------------------------------------------


_PASS: dict = {}


def _pass(t: torch.Tensor, bits: int, kind: str) -> tuple:
    """One carry pass over the last axis; returns (t', carries moved).
    kind "top": the last position is never split (it keeps the overflow,
    signed); kind "mod": the overflow out of the last position is dropped
    (arithmetic mod 2^(n bits)).  Shifts are arithmetic, so a negative
    position passes a borrow."""
    key = (bits, t.shape[-1], kind, t.device)
    consts = _PASS.get(key)
    if consts is None:
        n = t.shape[-1]
        consts = _PASS[key] = (_c(f"sh_{bits}_{n}_{kind}", t.device),
                               _c(f"mk_{bits}_{n}_{kind}", t.device))
    c = t >> consts[0]
    low = t & consts[1]
    c = c[..., :-1]
    low[..., 1:] += c
    return low, c


def carry_fixed(t: torch.Tensor, bits: int, passes: int,
                kind: str) -> torch.Tensor:
    for _ in range(passes):
        t, _c0 = _pass(t, bits, kind)
    return t


def carry_exact(t: torch.Tensor, bits: int, start: int = 0) -> torch.Tensor:
    """Passes until no carry is left (the first `start` unchecked):
    positions 0..n-2 end in [0, 2^bits), the top one keeps the signed
    overflow."""
    t = carry_fixed(t, bits, start, "top")
    while True:
        t, c = _pass(t, bits, "top")
        if not bool(c.any()):
            return t


def _conv(a: torch.Tensor, b: torch.Tensor, idx_name: str, ncols: int):
    """Column sums of the digit products a_i * b_j at column i + j."""
    device = a.device
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
    idx = _c("conv_idx", device)
    if idx_name == "conv_lo":
        sel = _c("conv_lo", device)
        prod = prod.index_select(-1, sel)
        idx = idx.index_select(0, sel)
    out = torch.zeros(*prod.shape[:-1], ncols, dtype=DTYPE, device=device)
    return out.index_add_(-1, idx, prod)


def pick_reduced(x: torch.Tensor, y: torch.Tensor, bits: int,
                 start: int = 0):
    """x, y = x - p, both unnormalized on the last axis: normalize the two
    together (one loop) and return x mod p, i.e. y where y >= 0 else x
    (valid when 0 <= x < 2p)."""
    st = carry_exact(torch.stack([x, y]), bits, start)
    neg = (st[1][..., -1] < 0).unsqueeze(-1)
    return torch.where(neg, st[0], st[1])


# --- Field ops ----------------------------------------------------------------


def mont_digits(ad: torch.Tensor, bd: torch.Tensor, mod_d: torch.Tensor,
                nprime_d: torch.Tensor, carry_w: torch.Tensor,
                bits: int) -> torch.Tensor:
    """Montgomery product in 16-digit form, not reduced, for any modulus
    q < R = 2^(16 bits): mod_d and nprime_d are the digits of q and of
    -q^-1 mod R, carry_w the float64 weights 2^(bits j) / R.  Inputs with
    digits <= 2^bits + 2^5 and a * b < 0.99 R q; output (T + m q) / R < 2q,
    digits unnormalized.

    m = T N' mod R comes from three carry passes, so it may exceed R by a
    hair (m < R (1 + 2^-bits)); the bound on a * b keeps the output < 2q.
    The low half of T + m q is an exact multiple of R, so its carry is read
    with one float64 rounding (the float error is far below 1/2)."""
    t = _conv(ad, bd, "conv_idx", 2 * _N_DIGITS)            # 31 columns + 1
    t = carry_fixed(t, bits, 2, "top")                      # digits < 2^(b+1)
    m = _conv(t[..., :_N_DIGITS], nprime_d, "conv_lo", _N_DIGITS)
    m = carry_fixed(m, bits, 3, "mod")                      # m = T N' mod R
    u = t + _conv(m, mod_d.expand_as(m), "conv_idx",
                  2 * _N_DIGITS)                            # u = 0 mod R
    lo = (u[..., :_N_DIGITS].to(torch.float64) * carry_w).sum(-1)
    hi = u[..., _N_DIGITS:].clone()
    hi[..., 0] += torch.round(lo).to(DTYPE)                 # (T + m q) / R
    return hi


def _mont_digits(ad: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """``mont_digits`` mod p in 24-bit digits (two values < 2p qualify:
    4p^2 < 0.41 R p)."""
    d = ad.device
    return mont_digits(ad, bd, _c("p24", d), _c("np24", d), _c("carry_w", d),
                       _DIGIT_BITS)


def _canonical(hi: torch.Tensor) -> torch.Tensor:
    """Digit form of a value < 2p -> canonical 12-limb element."""
    return _from_digits(pick_reduced(hi, hi - _c("p24", hi.device),
                                     _DIGIT_BITS, start=3))


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p for normalized limbs with a * b < 0.99 R p (two
    elements < 2p qualify); the output is canonical."""
    a, b = torch.broadcast_tensors(a, b)
    ad, bd = _to_digits(torch.stack([a, b]))
    return _canonical(_mont_digits(ad, bd))


def add_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b without the final reduction (< 2p): a valid mont_mul input."""
    return carry_exact(a + b, LIMB_BITS)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    return pick_reduced(s, s - _c("p", s.device), LIMB_BITS)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    st = carry_exact(torch.stack([d, d + _c("p", d.device)]), LIMB_BITS)
    neg = (st[0][..., -1] < 0).unsqueeze(-1)
    return torch.where(neg, st[1], st[0])


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


_LINEAR: dict = {}


def linear(vals: torch.Tensor, coeffs) -> torch.Tensor:
    """Small integer linear combinations of canonical elements, reduced:
    vals (..., T, 12); coeffs a list of K rows, each a dict {t: int}
    (or a dense list of T ints) -> (..., K, 12) with
    out_k = sum_t coeffs[k][t] vals_t mod p.

    The raw sums lie in (-neg p, pos p); their candidates r + j p (one per
    j) are normalized in one carry loop, and the first non-negative one is
    r mod p."""
    rows = [r if isinstance(r, dict) else
            {t: c for t, c in enumerate(r) if c} for r in coeffs]
    key = (tuple(tuple(sorted(r.items())) for r in rows), vals.device)
    if key not in _LINEAR:
        width = max(1, max(len(r) for r in rows))
        idx = [[t for t in r] + [0] * (width - len(r)) for r in rows]
        cof = [[r[t] for t in r] + [0] * (width - len(r)) for r in rows]
        pos = max(sum(c for c in r.values() if c > 0) for r in rows)
        neg = max(sum(-c for c in r.values() if c < 0) for r in rows)
        js = torch.arange(1 - max(pos, 1), neg + 1, dtype=DTYPE,
                          device=vals.device)
        _LINEAR[key] = (
            torch.tensor(idx, device=vals.device).reshape(-1),
            torch.tensor(cof, dtype=DTYPE, device=vals.device).unsqueeze(-1),
            js, len(rows), width)
    idx, cof, js, k, width = _LINEAR[key]
    g = vals.index_select(-2, idx).unflatten(-2, (k, width))
    r = (g * cof).sum(-2)                                  # (..., K, 12)
    jp = js.view(-1, *([1] * r.dim())) * _c("p", vals.device)
    st = carry_exact(r.unsqueeze(0) + jp, LIMB_BITS)       # (J, ..., K, 12)
    first = (st[..., -1] >= 0).to(torch.int8).argmax(0, keepdim=True)
    return st.gather(0, first.unsqueeze(-1).expand(1, *st.shape[1:]))[0]


def add_or_sub(a: torch.Tensor, b: torch.Tensor,
               minus: torch.Tensor) -> torch.Tensor:
    """a - b where ``minus`` (a bool tensor broadcast against the batch
    dims) is set, else a + b: one carry loop over the three candidates
    r - p, r, r + p of r = a -+ b."""
    sign = 1 - 2 * minus.to(DTYPE).unsqueeze(-1)
    r = a + sign * b
    p = _c("p", r.device)
    st = carry_exact(torch.stack([r - p, r, r + p]), LIMB_BITS)
    lo_ok = (st[0][..., -1] >= 0).unsqueeze(-1)      # r >= p
    mid_ok = (st[1][..., -1] >= 0).unsqueeze(-1)     # 0 <= r
    return torch.where(lo_ok, st[0], torch.where(mid_ok, st[1], st[2]))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def gt_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """a > c for canonical limbs a and an int c < 2^384: the sign of
    a - (c + 1) once its borrows are resolved."""
    d = a - const(c + 1, a.device)
    return carry_exact(d, LIMB_BITS)[..., -1] >= 0


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """mask ? a : b, mask over the batch dims."""
    return torch.where(mask.unsqueeze(-1), a, b)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(*shape, N_LIMBS, dtype=DTYPE, device=device)


def one(shape, device) -> torch.Tensor:
    return _c("one", device).expand(*shape, N_LIMBS).clone()


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical plain -> Montgomery."""
    return mont_mul(a, _c("r2", a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    o = torch.zeros_like(a)
    o[..., 0] = 1
    return mont_mul(a, o)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


def pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent e >= 0: 4-bit fixed windows, MSB first.
    The chain stays in digit form between products (three carry passes
    keep each digit <= 2^24 + 1 and the value < 2p) and is reduced once."""
    if e == 0:
        return one(a.shape[:-1], a.device)

    def prod(x, y):
        return carry_fixed(_mont_digits(x, y), _DIGIT_BITS, 3, "top")

    ad = _to_digits(a)
    table = [None, ad]
    for _ in range(14):
        table.append(prod(table[-1], ad))
    digits = []
    while e:
        digits.append(e & 15)
        e >>= 4
    out = table[digits[-1]]
    for d in reversed(digits[:-1]):
        for _ in range(4):
            out = prod(out, out)
        if d:
            out = prod(out, table[d])
    return _canonical(out)


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2): Fermat inversion; inv(0) = 0."""
    return pow(a, P - 2)


def inv_many(a: torch.Tensor) -> torch.Tensor:
    """Batched inversion: every element of the batch with one pow (the pow
    is already batched, so this is inv)."""
    return inv(a)
