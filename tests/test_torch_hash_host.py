"""The lane machine of csrc/hash_g2.cuh (k_hash, k_sign_root, k_sign_field),
run on the host.

The headers compile as plain C++ (g++ -x c++), with the PTX carry chains of
csrc/fp_ptx.cuh run as C with the carry flag in a variable: a pair's two
machines run in turn over one slot array, stopping at each swap point, as
the two threads of a warp do.  Held with no tolerance against the Python
references: the Fp product and squaring (against integers), one
straight-line SSWU map and isogeny on random and edge elements (against
hash_to_curve_ref.map_to_curve_g2), the whole two-thread hash (against
hash_to_g2), signing from a 32-byte root and from field elements (against
curve_ref), the base-|z| digits of k mod r, and the psi-split ladder's two
halves and their join from H(m) and from infinity.  The PTX bodies run only
on the card (tools/fp_chain.py, chip_smoke.py).  Skipped without g++; a
CUDA card is not needed.
"""
import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest

from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
from lighthouse_tpu_torch.crypto.bls.constants import (
    ISO3_A, ISO3_B, ISO3_Z, P, R)
from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp2
from lighthouse_tpu_torch.runtime.build import CSRC

HARNESS = r"""
#include "k_hash.cu"
#include "k_sign.cu"
#include <vector>

// A pair's two machines over one slot array (nt = 2).
struct pair_t {
  std::vector<uint32_t> sm;
  lh_vm v[2];
  pair_t(int ns, int script) : sm((size_t)ns * 24 * 2) {
    for (int t = 0; t < 2; t++) v[t].init(sm.data(), 2, t, script);
  }
  bool step() {                      // both to the next swap point
    bool a = v[0].run();
    bool b = v[1].run();
    return a || b;
  }
  void run() { while (step()) {} }
};

extern "C" void h_fp(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  fp_t x, y, z;
  load(x, a);
  load(y, b);
  fmul(z, x, y);
  store(r, z);
  fsqr(z, x);
  store(r + 12, z);
}
// One map: u (24 plain words) -> the Jacobian point (72 Montgomery words).
extern "C" void h_map(const uint32_t* u, uint32_t* out) {
  std::vector<uint32_t> sm(LH_HASH_SLOTS * 24);
  lh_vm v;
  v.init(sm.data(), 1, 0, S_MAP);
  v.load_u(u);
  while (v.run()) {}
  for (int c = 0; c < 3; c++) {
    fp2_t a;
    v.ld(a, QP + c);
    store(out + 24 * c, a);
  }
}
// k_hash of one message: hx, hy (48 words), hinf.
extern "C" void h_hash(const uint32_t* u, uint32_t* out) {
  pair_t p(LH_HASH_SLOTS, S_HASH);
  p.v[0].load_u(u);
  p.v[1].load_u(u + 24);
  p.run();
  for (int t = 0; t < 2; t++) {      // the kernel's inverse, then LH_S_AFF
    lh_invert_norm(p.v[t]);
    p.v[t].start(S_AFF);
  }
  p.run();
  uint8_t inf;
  hash_store(p.v[0], out, out + 24, &inf);
  out[48] = inf;
}
// The machine's complete addition: a + b (72 Jacobian words each).
extern "C" void h_add(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  std::vector<uint32_t> sm(LH_SIGN_SLOTS * 24);
  lh_vm v;
  v.init(sm.data(), 1, 0, S_ADD);
  for (int c = 0; c < 3; c++) {
    fp2_t x;
    load(x, a + 24 * c);
    v.st(PA + c, x);
    load(x, b + 24 * c);
    v.st(PB + c, x);
  }
  while (v.run()) {}
  for (int c = 0; c < 3; c++) {
    fp2_t x;
    v.ld(x, PA + c);
    store(out + 24 * c, x);
  }
}
extern "C" void h_digits(const uint32_t* w, uint32_t* dg) {
  lh_digits(dg, w);
}
// k_sign_field / k_sign_root of one lane: x (24 words), sign, inf.
extern "C" void h_sign_field(const uint32_t* w, const uint32_t* u,
                             uint32_t* out) {
  pair_t p(LH_SIGN_SLOTS, S_SIGN);
  for (int t = 0; t < 2; t++) {
    p.v[t].load_u(u + 24 * t);
    p.v[t].load_scalar(w);
  }
  p.run();
  uint8_t s, i;
  sign_store(p.v[0], out, &s, &i);
  out[24] = s;
  out[25] = i;
}
extern "C" void h_sign_root(const uint32_t* w, const uint32_t* msg,
                            uint32_t* out) {
  uint32_t u[48];
  xmd_lane(msg, u);
  h_sign_field(w, u, out);
}
// The signing half from H (72 Jacobian Montgomery words): each thread's
// ladder half (2 x 72 words) at the join's swap point, then the planes.
extern "C" void h_ladder(const uint32_t* w, const uint32_t* h,
                         uint32_t* out) {
  pair_t p(LH_SIGN_SLOTS, S_LADDER);
  for (int t = 0; t < 2; t++) {
    for (int c = 0; c < 3; c++) {
      fp2_t a;
      load(a, h + 24 * c);
      p.v[t].st(PA + c, a);
    }
    p.v[t].load_scalar(w);
  }
  p.step();
  for (int t = 0; t < 2; t++)
    for (int c = 0; c < 3; c++) {
      fp2_t a;
      p.v[t].ld(a, PA + c);
      store(out + 72 * t + 24 * c, a);
    }
  p.run();
  uint8_t s, i;
  sign_store(p.v[0], out + 144, &s, &i);
  out[168] = s;
  out[169] = i;
}
"""

VP = ctypes.c_void_p
RM = 1 << 384
RINV = pow(RM, -1, P)
ABS_Z = 0xD201000000010000


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("hash_host")
    src, so = d / "harness.cpp", d / "libhash_host.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)], check=True)
    h = ctypes.CDLL(str(so))
    for fn in (h.h_fp, h.h_sign_field, h.h_sign_root, h.h_ladder, h.h_add):
        fn.argtypes = [VP, VP, VP]
    for fn in (h.h_map, h.h_hash, h.h_digits):
        fn.argtypes = [VP, VP]
    return h


def _words(v: int, n: int = 12) -> list:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def _arr(ws) -> np.ndarray:
    return np.ascontiguousarray(ws, dtype=np.uint32)


def _p(a: np.ndarray):
    return a.ctypes.data_as(VP)


def _int(ws) -> int:
    return sum(int(x) << (32 * i) for i, x in enumerate(ws))


def _fp2_plain(u: Fp2) -> list:
    return _words(u.c0) + _words(u.c1)


def _fp2_mont(u: Fp2) -> list:
    return _words(u.c0 * RM % P) + _words(u.c1 * RM % P)


def _from_mont(ws) -> Fp2:
    return Fp2(_int(ws[:12]) * RINV % P, _int(ws[12:24]) * RINV % P)


def _point(ws) -> cv.Point:
    """72 Jacobian Montgomery words -> the affine point."""
    x, y, z = _from_mont(ws[:24]), _from_mont(ws[24:48]), _from_mont(ws[48:])
    if z.is_zero():
        return cv.g2_infinity()
    zi = z.inv()
    return cv.Point(x * zi.square(), y * zi.square() * zi, cv.B_G2)


def _jacobian(pt: cv.Point, lam: int) -> list:
    """pt with Z = lam (Montgomery words); infinity as (0, 1, 0)."""
    if pt.is_infinity():
        return [0] * 24 + _fp2_mont(Fp2.one()) + [0] * 24
    z = Fp2(lam, lam + 1)
    return (_fp2_mont(pt.x * z.square()) + _fp2_mont(pt.y * z.square() * z)
            + _fp2_mont(z))


def _planes(pt: cv.Point) -> list:
    """The compressed planes: x plain (24 words), sign, inf."""
    if pt.is_infinity():
        return [0] * 24 + [0, 1]
    return _fp2_plain(pt.x) + [int(cv._fp2_is_lex_largest(pt.y)), 0]


def _gx1_square(u: Fp2) -> bool:
    """The SSWU branch of u: whether g(x1) is a square."""
    a, b, z = Fp2(*ISO3_A), Fp2(*ISO3_B), Fp2(*ISO3_Z)
    zu2 = z * u.square()
    tv = zu2.square() + zu2
    if tv.is_zero():
        x1 = b * (z * a).inv()
    else:
        x1 = (-b) * a.inv() * (Fp2.one() + tv.inv())
    return ((x1.square() + a) * x1 + b).is_square()


@pytest.mark.parametrize("case", ["random", "edges"])
def test_fp_product_and_square_match_integers(lib, case):
    rnd = random.Random(0xF9)
    edges = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, RM % P]
    pairs = ([(a, b) for a in edges for b in edges] if case == "edges" else
             [(rnd.randrange(P), rnd.randrange(P)) for _ in range(500)])
    for a, b in pairs:
        r = np.zeros(24, np.uint32)
        lib.h_fp(_p(_arr(_words(a))), _p(_arr(_words(b))), _p(r))
        assert _int(r[:12]) == a * b * RINV % P, (hex(a), hex(b))
        assert _int(r[12:]) == a * a * RINV % P, hex(a)


def _map_cases():
    rnd = random.Random(0x55)
    square = non_square = None
    while square is None or non_square is None:
        u = Fp2(rnd.randrange(P), rnd.randrange(P))
        if _gx1_square(u):
            square = square or u
        else:
            non_square = non_square or u
    return {"zero": Fp2(0, 0), "one": Fp2(1, 0), "p_minus_1": Fp2(P - 1, 0),
            "c0_zero": Fp2(0, rnd.randrange(1, P)),
            "c0_zero_c1_one": Fp2(0, 1), "square": square,
            "non_square": non_square,
            "random": Fp2(rnd.randrange(P), rnd.randrange(P))}


MAP_CASES = _map_cases()


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_map_matches_reference(lib, case):
    u = MAP_CASES[case]
    out = np.zeros(72, np.uint32)
    lib.h_map(_p(_arr(_fp2_plain(u))), _p(out))
    assert _point(out) == hr.map_to_curve_g2(u), case


@pytest.mark.parametrize("case", ["generic", "equal", "negated", "a_inf",
                                  "b_inf", "both_inf"])
def test_complete_addition_by_masks(lib, case):
    """The machine's PA + PB (add-2007-bl with its exceptional cases
    settled by masks: 2 PB, infinity, the other point) on points of E2 in
    other Jacobian representations, against curve_ref."""
    rnd = random.Random(0xCADD)
    p, q = (hr.map_to_curve_g2(Fp2(rnd.randrange(P), rnd.randrange(P)))
            for _ in range(2))
    inf = cv.g2_infinity()
    a, b = {"generic": (p, q), "equal": (p, p), "negated": (p, -p),
            "a_inf": (inf, q), "b_inf": (p, inf),
            "both_inf": (inf, inf)}[case]
    out = np.zeros(72, np.uint32)
    lib.h_add(_p(_arr(_jacobian(a, rnd.randrange(1, P)))),
              _p(_arr(_jacobian(b, rnd.randrange(1, P)))), _p(out))
    assert _point(out) == a + b, case


@pytest.mark.parametrize("i", range(6))
def test_hash_matches_reference(lib, i):
    msg = bytes(random.Random(0x4A5 + i).randrange(256) for _ in range(32))
    u0, u1 = hr.hash_to_field_fp2(msg, 2)
    out = np.zeros(49, np.uint32)
    lib.h_hash(_p(_arr(_fp2_plain(u0) + _fp2_plain(u1))), _p(out))
    h = hr.hash_to_g2(msg)
    assert _from_mont(out[:24]) == h.x and _from_mont(out[24:48]) == h.y
    assert out[48] == 0


SCALARS = {"0": 0, "1": 1, "2": 2, "z-1": ABS_Z - 1, "z": ABS_Z,
           "z^2": ABS_Z ** 2, "r-1": R - 1, "r": R, "r+1": R + 1,
           "2^255-1": (1 << 255) - 1,
           "random": random.Random(0x5C).randrange(R)}


@pytest.mark.parametrize("name", sorted(SCALARS))
def test_digits_are_base_z_of_k_mod_r(lib, name):
    k = SCALARS[name]
    dg = np.zeros(8, np.uint32)
    lib.h_digits(_p(_arr(_words(k, 8))), _p(dg))
    v, want = k % R, []
    for _ in range(4):
        want.append(v % ABS_Z)
        v //= ABS_Z
    assert v == 0
    assert [_int(dg[2 * i:2 * i + 2]) for i in range(4)] == want


@pytest.mark.parametrize("base", ["hash", "infinity"])
@pytest.mark.parametrize("name", sorted(SCALARS))
def test_psi_split_ladder_halves_and_join(lib, name, base):
    k = SCALARS[name]
    rnd = random.Random(0x1AD)
    h = (hr.hash_to_g2(bytes(rnd.randrange(256) for _ in range(32)))
         if base == "hash" else cv.g2_infinity())
    out = np.zeros(170, np.uint32)
    lib.h_ladder(_p(_arr(_words(k, 8))),
                 _p(_arr(_jacobian(h, rnd.randrange(1, P)))), _p(out))
    v, d = k % R, []
    for _ in range(4):
        d.append(v % ABS_Z)
        v //= ABS_Z
    assert _point(out[:72]) == h.mul(d[0] + d[1] * ABS_Z)
    assert _point(out[72:144]) == h.mul(d[2] * ABS_Z ** 2 + d[3] * ABS_Z ** 3)
    assert list(out[144:]) == _planes(h.mul(k % R))


@pytest.mark.parametrize("i", range(2))
def test_sign_root_and_field_match_host_signing(lib, i):
    rnd = random.Random(0x519 + i)
    k = rnd.randrange(1, R)
    msg = bytes(rnd.randrange(256) for _ in range(32))
    want = _planes(hr.hash_to_g2(msg).mul(k))
    be = np.frombuffer(msg, dtype=">u4").astype(np.uint32)
    out = np.zeros(26, np.uint32)
    lib.h_sign_root(_p(_arr(_words(k, 8))), _p(_arr(be)), _p(out))
    assert list(out) == want
    u0, u1 = hr.hash_to_field_fp2(msg, 2)
    out = np.zeros(26, np.uint32)
    lib.h_sign_field(_p(_arr(_words(k, 8))),
                     _p(_arr(_fp2_plain(u0) + _fp2_plain(u1))), _p(out))
    assert list(out) == want
