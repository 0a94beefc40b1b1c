"""k_sign_agg of csrc/k_sign.cu (segments decoded and summed on
check_coop.cuh's G2 decoding steps and points_coop.cuh's engine, in the
order of curve.sum_reduce) and k_ring_mul of csrc/k_ring.cu (pair_coop.cuh's
fin_prog over two values from two pointers), emulated on the host.

The headers compile as plain C++ (g++ -x c++): lh_host_group runs the tasks
of each barrier-separated round one after another, forward or backward (a
task that read what another task of its round writes would make the two
differ), which emulates a block; its shared memory is filled with a
pattern first (the card does not clear it).  k_sign_agg runs its passes
as the launcher does (sa_passes, sa_block), at the kernel's segment of
SA_LANES lanes and at segments of 4 (three passes from 17 lanes), and
every output word is held against signer.k_sign_agg_plain: a repeated signature
on both sides of a segment edge (P == Q where the segment sums join),
sigma and -sigma in adjacent segments, an off-curve x in the first, a
middle and the last segment (ok False, the words still the plain
version's), the non-subgroup signature, infinity, masked-off and
malformed-infinity lanes, and k = 0, 1, a segment - 1, a segment + 1 and
k not a power of two; on valid rows the segment sums (nodes of the tree)
are held against the JAX package's pure-Python curve_ref.  k_ring_mul's
block is held against staged.k_ring_mul_plain and the JAX package's
fields_ref Fp12 product.  Skipped without g++; a CUDA card is not needed.
"""
import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import curve_ref as jcv
from lighthouse_tpu.crypto.bls import fields_ref as jfr
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls import sign_engine as se
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.cuda import signer, staged
from lighthouse_tpu_torch.runtime.build import CSRC
from lighthouse_tpu_torch.tools.check_layouts import (
    OFF_CURVE_X1, non_subgroup_signature)

HARNESS = r"""
#include <string.h>
#include "k_ring.cu"
#include "k_sign.cu"

// k_sign_agg's passes as the launcher runs them, each block of a pass in
// turn on a pattern-filled state; the scratch jac keeps the segment sums.
template <int S>
int agg(const uint32_t* x, const uint8_t* sign, const uint8_t* inf,
        const uint8_t* mask, int m, int k, uint32_t* jac, uint32_t* ox,
        uint8_t* osign, uint8_t* oinf, uint8_t* ok, int rev) {
  auto* st = new sa_state<S, SA_WIN>();
  memset(ok, 1, (size_t)m);
  int passes = 0;
  sa_passes<S>(m, k, jac, 1 << 30,
               [&](int dec, int n, int t, int segs, const uint32_t* jin,
                   uint32_t* jout) {
                 for (int b = 0; b < m * segs; b++) {
                   memset((void*)st, 0x5a, sizeof(*st));
                   lh_host_group g{rev};
                   auto pr = sa_block(*st, b, x, sign, inf, mask, jin, dec,
                                      n, t, segs, jout, ox, osign, oinf, ok);
                   lh_run(g, pr);
                 }
                 passes++;
                 return 0;
               });
  delete st;
  return passes;
}

// seg4 0: the kernel's SA_LANES lanes a segment; 1: four.  Returns the
// passes run.
extern "C" int sign_agg(int seg4, const uint32_t* x, const uint8_t* sign,
                        const uint8_t* inf, const uint8_t* mask, int m,
                        int k, uint32_t* jac, uint32_t* ox, uint8_t* osign,
                        uint8_t* oinf, uint8_t* ok, int rev) {
  if (seg4) return agg<4>(x, sign, inf, mask, m, k, jac, ox, osign, oinf, ok,
                          rev);
  return agg<SA_LANES>(x, sign, inf, mask, m, k, jac, ox, osign, oinf, ok,
                       rev);
}

extern "C" int sa_lanes() { return SA_LANES; }

// k_ring_mul's block: a from a, b from its own pointer.
extern "C" void ring_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                         int rev) {
  auto* s = new fin_t();
  memset((void*)s, 0x5a, sizeof(*s));
  lh_host_group g{rev};
  fin_prog pr{*s, a, 2, false, out, nullptr, fin_k0(2)};
  pr.f_b = b;
  lh_run(g, pr);
  delete s;
}
"""

VP = ctypes.c_void_p
I = ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("sign_agg_host")
    src, so = d / "harness.cpp", d / "libsign_agg_host.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)], check=True)
    h = ctypes.CDLL(str(so))
    h.sign_agg.argtypes = [I, VP, VP, VP, VP, I, I, VP, VP, VP, VP, VP, I]
    h.sign_agg.restype = I
    h.sa_lanes.restype = I
    h.ring_mul.argtypes = [VP, VP, VP, I]
    h.ring_mul.restype = None
    return h


def _p(a):
    return a.ctypes.data_as(VP)


def _u8(t):
    return np.ascontiguousarray(t.numpy().astype(np.uint8))


def _planes(rows, live, malformed=()):
    """(m, k) rows of wire signatures, their live mask and (row, lane)
    infinity lanes to spoil with x != 0 -> k_sign_agg's CPU planes."""
    m, k = len(rows), len(rows[0]) if rows else 0
    x, sign, inf, ok = se.parse_wire_planes([r for row in rows for r in row])
    assert ok.all()
    x = np.ascontiguousarray(x.view(np.int32)).reshape(m, k, 2, 12)
    for r, i in malformed:
        assert inf.reshape(m, k)[r, i]
        x[r, i, 0, 0] = 1
    return (torch.from_numpy(x), torch.from_numpy(sign).reshape(m, k),
            torch.from_numpy(inf).reshape(m, k),
            torch.as_tensor(np.array(live, dtype=bool)).reshape(m, k))


def _emulated(lib, planes, seg4, rev):
    """The block program's outputs (as k_sign_agg returns them), the passes
    run and the scratch of segment sums (Jacobian words)."""
    x, sign, inf, mask = planes
    m, k = mask.shape
    xw = np.ascontiguousarray(x.numpy().view(np.uint32)).reshape(-1)
    jac = np.zeros(72 * max(m * k, 1), np.uint32)
    ox = np.full(24 * m, 0xA5A5A5A5, np.uint32)
    osign = np.full(m, 7, np.uint8)
    oinf = np.full(m, 7, np.uint8)
    ok = np.full(m, 7, np.uint8)
    sw, iw, mw = _u8(sign), _u8(inf), _u8(mask)
    passes = lib.sign_agg(seg4, _p(xw), _p(sw), _p(iw), _p(mw), m, k,
                          _p(jac), _p(ox), _p(osign), _p(oinf), _p(ok), rev)
    got = (torch.as_tensor(ox.view(np.int32)).reshape(m, 2, 12),
           torch.as_tensor(osign.astype(bool)),
           torch.as_tensor(oinf.astype(bool)),
           torch.as_tensor(ok.astype(bool)))
    return got, passes, jac


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _jac_affine(words):
    """Jacobian Montgomery G2 words (X, Y, Z: 24 words each) -> a JAX
    curve_ref point."""
    rinv = pow(1 << 384, P - 2, P)

    def f(w):
        return sum(int(v) << (32 * i) for i, v in enumerate(w)) * rinv % P

    co = [jfr.Fp2(f(words[24 * c:24 * c + 12]),
                  f(words[24 * c + 12:24 * c + 24])) for c in range(3)]
    if co[2] == jfr.Fp2(0, 0):
        return jcv.g2_infinity()
    zi = co[2].inv()
    return jcv.Point(co[0] * zi * zi, co[1] * zi * zi * zi, jcv.B_G2)


def _jax(p):
    if p.is_infinity():
        return jcv.g2_infinity()
    return jcv.Point(jfr.Fp2(p.x.c0, p.x.c1), jfr.Fp2(p.y.c0, p.y.c1),
                     jcv.B_G2)


def _seg_log2(n, seg):
    t = 0
    while (1 << t) < n and (1 << t) < seg:
        t += 1
    return t


def _want_nodes(points, live, seg):
    """The first pass's segment sums of each row (curve_ref), in the
    scratch's order, or None when the row count needs one pass."""
    m, k = len(points), len(points[0]) if points else 0
    t = _seg_log2(k, seg)
    size = 1 << t
    segs = (k + size - 1) // size if k else 1
    if segs == 1:
        return None
    out = []
    for r in range(m):
        for g in range(segs):
            total = jcv.g2_infinity()
            for i in range(g * size, min(k, (g + 1) * size)):
                if live[r][i] and not points[r][i].is_infinity():
                    total = total + _jax(points[r][i])
            out.append(total)
    return out


def _pool(n, seed):
    """n points of G2 (multiples of the generator), as curve_ref points."""
    rng = np.random.default_rng(seed)
    g2 = cv.g2_generator()
    step = g2.mul(int(rng.integers(2, 2**62)))
    pts = [g2.mul(int(rng.integers(2, 2**62)))]
    for _ in range(n - 1):
        pts.append(pts[-1] + step)
    return pts


CASES = ("repeat_across_edge", "opposite_segments", "off_curve",
         "non_subgroup", "inf_masked_malformed", "all_masked_or_infinity",
         "k_1", "k_seg_minus_1", "k_seg_plus_1", "k_2seg_plus_3", "k_0")


@functools.lru_cache(maxsize=None)
def _case_rows(seg):
    """CASES at segments of seg lanes: name -> (points or raw bytes per
    lane, live mask, malformed lanes, valid: every live lane a point of the
    curve or a well-formed infinity; None: not asserted)."""
    pool = _pool(3 * seg + 8, 0x5A66 + seg)
    sig = pool[0]
    nss = cv.g2_decompress(non_subgroup_signature(), subgroup_check=False)
    inf = cv.g2_infinity()

    def full(k, at=0):
        return [pool[(at + i) % len(pool)] for i in range(k)]

    cases = {}
    # the repeat across the edge, and P == Q where the segment sums join
    cases["repeat_across_edge"] = ([[sig] * (2 * seg)], None, (), True)
    # sigma + (-sigma) across the edge and where the segment sums join
    cases["opposite_segments"] = ([[sig] * seg + [-sig] * seg], None, (),
                                  True)
    # off-curve x in the first and the last segment, and in a middle one
    k = 2 * seg + 2
    off = [full(k, 1), full(k, 2)]
    off[0][0] = off[0][k - 1] = OFF_CURVE_X1
    off[1][seg + seg // 2] = OFF_CURVE_X1
    cases["off_curve"] = (off, None, (), False)
    # the non-subgroup signature (on the curve: ok True)
    ns = full(seg + 3, 6)
    ns[2] = ns[seg + 1] = nss
    cases["non_subgroup"] = ([ns], None, (), True)
    # infinity, masked-off (one of them off the curve) and malformed lanes
    k = seg + 2
    rows = [full(k, 8), full(k, 9), full(k, 10)]
    live = [[True] * k for _ in rows]
    rows[0][0] = rows[0][seg] = inf
    live[0][1] = live[0][k - 1] = False
    rows[1][3] = OFF_CURVE_X1
    live[1][3] = False
    rows[1][seg - 1] = inf
    live[1][seg - 1] = False
    rows[2][seg] = inf                   # spoiled below: x != 0, live
    rows[2][2] = inf                     # spoiled, masked: ok stays True
    live[2][2] = False
    rows[2][k - 1] = OFF_CURVE_X1
    live[2][k - 1] = False
    cases["inf_masked_malformed"] = (rows, live, ((2, seg), (2, 2)), None)
    k = seg + 1
    cases["all_masked_or_infinity"] = (
        [full(k, 11), [inf] * k], [[False] * k, [True] * k], (), True)
    # lane counts
    cases["k_1"] = ([full(1, 1), full(1, 2)], None, (), True)
    for name, k in (("k_seg_minus_1", seg - 1), ("k_seg_plus_1", seg + 1),
                    ("k_2seg_plus_3", 2 * seg + 3)):
        cases[name] = ([full(k, k)], None, (), True)
    cases["k_0"] = ([[], []], None, (), True)
    assert tuple(cases) == CASES
    return cases


def _raw(p):
    return p if isinstance(p, bytes) else cv.g2_compress(p)


@pytest.fixture(scope="module")
def seg(lib):
    return lib.sa_lanes()


@pytest.mark.parametrize("case", CASES)
def test_sign_agg_matches_plain(lib, seg, case):
    """Each case (placed for the kernel's segment) at the kernel's segment
    and at segments of 4, each task order: every output word against
    k_sign_agg_plain; on valid rows the first pass's segment sums against
    curve_ref."""
    rows, live, malformed, valid = _case_rows(seg)[case]
    m, k = len(rows), len(rows[0])
    live = live or [[True] * k for _ in range(m)]
    if k == 0:
        planes = (torch.zeros((m, 0, 2, 12), dtype=torch.int32),
                  torch.zeros((m, 0), dtype=torch.bool),
                  torch.zeros((m, 0), dtype=torch.bool),
                  torch.zeros((m, 0), dtype=torch.bool))
    else:
        planes = _planes([[_raw(p) for p in row] for row in rows], live,
                         malformed)
    want = signer.k_sign_agg_plain(*planes)
    if valid is not None:
        assert bool(want[3].all()) == valid
    if case == "off_curve":
        assert not want[3].any()
    if case == "inf_masked_malformed":
        assert want[3].tolist() == [True, True, False]
    for seg4, size in ((0, seg), (1, 4)):
        for rev in (0, 1):
            got, passes, jac = _emulated(lib, planes, seg4, rev)
            assert _same(got, want), (case, seg4, rev)
        if not valid:
            continue
        nodes = _want_nodes(rows, live, size)
        if nodes is None:
            assert passes == 1, (case, seg4)
            continue
        assert passes >= 2, (case, seg4)
        got_nodes = [_jac_affine(jac[72 * i:72 * i + 72])
                     for i in range(len(nodes))]
        assert got_nodes == nodes, (case, seg4)


def test_sign_agg_sums_equal_curve_ref(lib, seg):
    """Valid rows at a segment + 3 lanes with a repeated and an opposite
    signature: each compressed aggregate is curve_ref's sum, at both
    segment sizes."""
    pts = _pool(seg + 3, 0xA66)
    rows = [pts, [pts[0]] * 2 + pts[2:seg + 1] + [-pts[5], pts[5]]]
    planes = _planes([[cv.g2_compress(p) for p in row] for row in rows],
                     [[True] * (seg + 3)] * 2)
    for seg4 in (0, 1):
        got, _, _ = _emulated(lib, planes, seg4, 0)
        wire = se.compress_to_wire(got[0].numpy().view(np.uint32),
                                   got[1].numpy(), got[2].numpy())
        for row, raw in zip(rows, wire):
            total = cv.g2_infinity()
            for p in row:
                total = total + p
            assert bytes(raw) == cv.g2_compress(total), seg4


def _f12(words):
    """(2, 3, 2, 12) Montgomery words -> a JAX fields_ref Fp12."""
    rinv = pow(1 << 384, P - 2, P)
    w = words.reshape(2, 3, 2, 12).numpy().view(np.uint32)

    def f(v):
        return sum(int(x) << (32 * i) for i, x in enumerate(v)) * rinv % P

    return jfr.Fp12(*(jfr.Fp6(*(jfr.Fp2(f(w[i, j, 0]), f(w[i, j, 1]))
                                for j in range(3))) for i in range(2)))


def _mont(vals):
    """Plain Fp values (2, 3, 2) -> (2, 3, 2, 12) Montgomery int32 words."""
    words = np.zeros((2, 3, 2, 12), np.uint32)
    for idx in np.ndindex(2, 3, 2):
        v = vals[idx] * (1 << 384) % P
        for i in range(12):
            words[idx + (i,)] = (v >> (32 * i)) & 0xFFFFFFFF
    return torch.as_tensor(words.view(np.int32))


def _ring_operands():
    rng = np.random.default_rng(0x12F)

    def rand():
        return np.array([[[int(rng.integers(0, 2**63)) * int(
            rng.integers(0, 2**63)) * int(rng.integers(0, 2**63)) % P
            for _ in range(2)] for _ in range(3)] for _ in range(2)],
            dtype=object)

    one = np.zeros((2, 3, 2), dtype=object)
    one[0, 0, 0] = 1
    top = np.full((2, 3, 2), P - 1, dtype=object)
    a, b = rand(), rand()
    return {"random": (a, b), "one_times_b": (one, b), "a_times_one": (a, one),
            "all_p_minus_1": (top, top), "p_minus_1_times_a": (top, a),
            "one_times_one": (one, one)}


@pytest.mark.parametrize("case", list(_ring_operands()))
def test_ring_mul_matches_plain_and_fields_ref(lib, case):
    """k_ring_mul's block, each task order: every word against
    k_ring_mul_plain, the value against fields_ref's Fp12 product."""
    a, b = (_mont(v) for v in _ring_operands()[case])
    want = staged.k_ring_mul_plain(a, b)
    aw = np.ascontiguousarray(a.numpy().view(np.uint32)).reshape(-1)
    bw = np.ascontiguousarray(b.numpy().view(np.uint32)).reshape(-1)
    for rev in (0, 1):
        out = np.full(144, 0xA5A5A5A5, np.uint32)
        lib.ring_mul(_p(aw), _p(bw), _p(out), rev)
        got = torch.as_tensor(out.view(np.int32)).reshape(2, 3, 2, 12)
        assert torch.equal(got, want), (case, rev)
    assert _f12(want) == _f12(a) * _f12(b)
