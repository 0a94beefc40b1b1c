"""Wire-signature decoding and the subgroup checks of csrc/check_coop.cuh
(k_decode.cu, k_subgroup in k_verify.cu), emulated on the host.

The headers compile as plain C++ (g++ -x c++): lh_host_group runs the tasks
of each barrier-separated round one after another, forward or backward (a
task that read what another task of its round writes would make the two
differ), which emulates a block.  The blocks are composed as the kernels
launch them, at the kernels' lanes a block and at a wider layout, each
block's shared memory filled with a pattern first (the card does not clear
it), and held word for word against staged.k_decode_plain /
k_subgroup_plain, the verdicts against the JAX package's pure-Python
curve_ref: both sign bits, y.c1 == 0 and y.c0 == 0 (the square root's
corner d1 == 0) of both signs, infinity, a malformed infinity, an
off-curve x, bls_adversarial.json's non-subgroup signature and pubkey,
inactive and padding lanes with n1 != n2, and points of small order: the
G1 point (0, 2) of order 3 (its ladder meets acc == P, P == -Q and
infinity while phi(P) = P), a G1 point of order 11 and G2 points of order
13 and 23, which divide the cofactors; the ladders' accumulators too.  Skipped without g++; a CUDA card is not needed.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import curve_ref as jcv
from lighthouse_tpu.crypto.bls import fields_ref as jfr
from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls.constants import P, R
from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
from lighthouse_tpu_torch.crypto.bls.cuda.backend import (
    parse_g2_compressed_many)
from lighthouse_tpu_torch.runtime.build import CSRC
from lighthouse_tpu_torch.tools.check_layouts import (
    OFF_CURVE_X1, ORDER_11, ORDER_13, ORDER_23, axis_y_points,
    non_subgroup_pubkey, non_subgroup_signature, order3_g1, small_order)

HARNESS = r"""
#include <string.h>
#include "k_decode.cu"
#include "k_verify.cu"

// The blocks of one launch, l0 = 0, L, 2L, ...; each block's shared
// memory starts as a pattern, not as the last block left it.
template <int L>
void dec_run(const uint32_t* x, const uint8_t* sign, const uint8_t* inf,
             int m, uint32_t* xs, uint32_t* ys, uint8_t* si, uint8_t* ok,
             int rev) {
  auto* s = new ck_state<L, L>();
  *ok = 1;
  for (int l0 = 0; l0 < m; l0 += L) {
    memset((void*)s, 0x5a, sizeof(*s));
    lh_host_group g{rev};
    ck_prog<L, true> pr{*s, {s->pc, 0, 0, false}, l0, x, nullptr, inf,
                        sign, m, nullptr, nullptr, nullptr, nullptr, 0, xs,
                        ys, si, nullptr, ok, 0, 0};
    lh_run(g, pr);
  }
  delete s;
}

template <int L>
void sub_run(const uint32_t* x1, const uint32_t* y1, const uint8_t* inf1,
             const uint8_t* act1, int n1, const uint32_t* x2,
             const uint32_t* y2, const uint8_t* inf2, const uint8_t* act2,
             int n2, uint8_t* lanes, uint8_t* ok, int rev) {
  auto* s = new ck_state<2 * L, 1>();
  *ok = 1;
  const int m = n1 > n2 ? n1 : n2;
  for (int l0 = 0; l0 < m; l0 += L) {
    memset((void*)s, 0x5a, sizeof(*s));
    lh_host_group g{rev};
    ck_prog<L, false> pr{*s, {s->pc, 0, 0, false}, l0, x1, y1, inf1, act1,
                         n1, x2, y2, inf2, act2, n2, nullptr, nullptr,
                         nullptr, lanes, ok, 0, 0};
    lh_run(g, pr);
  }
  delete s;
}

// One k_subgroup block over an active G1 lane and G2 lane: its two
// accumulators after the run (Jacobian, 72 words each): [lambda] P as
// [|z|]([|z|] P) - P, and [|z|] Q.
extern "C" void subgroup_acc(const uint32_t* x1, const uint32_t* y1,
                             const uint32_t* x2, const uint32_t* y2,
                             uint32_t* acc, int rev) {
  auto* s = new ck_state<2, 1>();
  memset((void*)s, 0x5a, sizeof(*s));
  const uint8_t no = 0, yes = 1;
  uint8_t lanes[2], ok = 1;
  lh_host_group g{rev};
  ck_prog<1, false> pr{*s, {s->pc, 0, 0, false}, 0, x1, y1, &no, &yes, 1,
                       x2, y2, &no, &yes, 1, nullptr, nullptr, nullptr,
                       lanes, &ok, 0, 0};
  lh_run(g, pr);
  for (int j = 0; j < 2; j++)
    for (int c = 0; c < 3; c++) store(acc + 72 * j + 24 * c, pt_co(s->pc.p[j], c));
  delete s;
}

// wide 0: the kernels' narrow layout (a lane a block); 1: their wide one.
extern "C" void decode(int wide, const uint32_t* x, const uint8_t* sign,
                       const uint8_t* inf, int m, uint32_t* xs, uint32_t* ys,
                       uint8_t* si, uint8_t* ok, int rev) {
  if (wide) dec_run<DEC_WIDE_LANES>(x, sign, inf, m, xs, ys, si, ok, rev);
  else dec_run<1>(x, sign, inf, m, xs, ys, si, ok, rev);
}
extern "C" void subgroup(int wide, const uint32_t* x1, const uint32_t* y1,
                         const uint8_t* inf1, const uint8_t* act1, int n1,
                         const uint32_t* x2, const uint32_t* y2,
                         const uint8_t* inf2, const uint8_t* act2, int n2,
                         uint8_t* lanes, uint8_t* ok, int rev) {
  if (wide) sub_run<SUB_WIDE_LANES>(x1, y1, inf1, act1, n1, x2, y2, inf2,
                                    act2, n2, lanes, ok, rev);
  else sub_run<1>(x1, y1, inf1, act1, n1, x2, y2, inf2, act2, n2, lanes,
                  ok, rev);
}
"""

VP = ctypes.c_void_p
I = ctypes.c_int

@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("decode_host")
    src, so = d / "harness.cpp", d / "libdecode_host.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)], check=True)
    h = ctypes.CDLL(str(so))
    h.decode.argtypes = [I, VP, VP, VP, I, VP, VP, VP, VP, I]
    h.subgroup.argtypes = [I, VP, VP, VP, VP, I, VP, VP, VP, VP, I, VP, VP,
                           I]
    h.subgroup_acc.argtypes = [VP, VP, VP, VP, VP, I]
    return h


def _u32(t):
    return np.ascontiguousarray(t.numpy().view(np.uint32))


def _u8(t):
    return np.ascontiguousarray(t.numpy().astype(np.uint8))


def _p(a):
    return a.ctypes.data_as(VP)


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a).view(np.int32))


def _jax(p):
    """A port curve_ref point -> the JAX package's curve_ref point."""
    if hasattr(p.b, "c0"):
        if p.is_infinity():
            return jcv.g2_infinity()
        return jcv.Point(jfr.Fp2(p.x.c0, p.x.c1), jfr.Fp2(p.y.c0, p.y.c1),
                         jcv.B_G2)
    if p.is_infinity():
        return jcv.g1_infinity()
    return jcv.Point(jfr.Fp(p.x.v), jfr.Fp(p.y.v), jcv.B_G1)


def _decode_emulated(lib, x, sign, inf, wide, rev):
    m = x.shape[0]
    xs = np.zeros((m, 24), np.uint32)
    ys = np.zeros((m, 24), np.uint32)
    si = np.zeros(m, np.uint8)
    ok = np.zeros(1, np.uint8)
    lib.decode(wide, _p(_u32(x).reshape(m, 24)), _p(_u8(sign)), _p(_u8(inf)),
               m, _p(xs), _p(ys), _p(si), _p(ok), rev)
    return (_i32(xs).reshape(m, 2, 12), _i32(ys).reshape(m, 2, 12),
            torch.as_tensor(si.astype(bool)), torch.as_tensor(ok.astype(bool)))


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_decode_matches_plain_and_curve_ref(lib):
    """Both sign bits, y.c1 == 0 and y.c0 == 0 of both signs, infinity, a
    malformed infinity, an off-curve x (its y words too), the
    non-subgroup signature, the order-13 and order-23 points and padding
    lanes: every output word against k_decode_plain, each task order and
    layout; each lane's verdict alone against curve_ref."""
    rng = np.random.default_rng(0xDEC1)
    g2 = cv.g2_generator()
    sig = g2.mul(int(rng.integers(2, 2**62)))
    ry, iy = axis_y_points()
    pts = [sig, -sig, ry, -ry, iy, -iy, cv.g2_infinity()]
    raws = [cv.g2_compress(p) for p in pts + [cv.g2_infinity()]]
    raws += [OFF_CURVE_X1, non_subgroup_signature(), ORDER_13, ORDER_23,
             cv.g2_compress(g2)]
    assert len({r[0] & 0x20 for r in raws[:2]}) == 2
    m = len(raws) + 2                        # two padding lanes
    malformed = 7                            # infinity with x != 0
    x, sign, inf = parse_g2_compressed_many(raws, m)
    x[malformed, 0, 0] = 1
    want = staged.k_decode_plain(x, sign, inf)
    assert not bool(want[3][0])
    for wide in (0, 1):
        for rev in (0, 1):
            got = _decode_emulated(lib, x, sign, inf, wide, rev)
            assert _same(got, want), (wide, rev)
    lane_ok = [bool(_decode_emulated(lib, x[i:i + 1], sign[i:i + 1],
                                     inf[i:i + 1], 0, 0)[3][0])
               for i in range(m)]
    ref = []
    for i, raw in enumerate(raws):
        if i == malformed:
            ref.append(False)
            continue
        p = jcv.g2_decompress(raw, subgroup_check=False)
        ref.append(p is not None and jcv.g2_subgroup_check(p))
    ref += [True, True]
    assert lane_ok == ref
    assert lane_ok == [True, True] + [False] * 4 + [True] + [False] * 5 + [
        True] * 3
    got = curve.unpack_g2_affine(staged.to_i64(want[0][:7]),
                                 staged.to_i64(want[1][:7]), want[2][:7])
    assert got == pts


def _sub_inputs(g1, g2, act1, act2):
    x1, y1, i1 = curve.pack_g1_affine(g1)
    x2, y2, i2 = curve.pack_g2_affine(g2)
    return (staged.to_i32(x1), staged.to_i32(y1), i1,
            torch.tensor(act1, dtype=torch.bool), staged.to_i32(x2),
            staged.to_i32(y2), i2, torch.tensor(act2, dtype=torch.bool))


def _sub_emulated(lib, args, wide, rev):
    x1, y1, i1, a1, x2, y2, i2, a2 = args
    n1, n2 = x1.shape[0], x2.shape[0]
    lanes = np.full(n1 + n2, 7, np.uint8)
    ok = np.zeros(1, np.uint8)
    lib.subgroup(wide, _p(_u32(x1)), _p(_u32(y1)), _p(_u8(i1)), _p(_u8(a1)),
                 n1, _p(_u32(x2).reshape(n2, 24)),
                 _p(_u32(y2).reshape(n2, 24)), _p(_u8(i2)), _p(_u8(a2)), n2,
                 _p(lanes), _p(ok), rev)
    return (torch.as_tensor(lanes.astype(bool)),
            torch.as_tensor(ok.astype(bool)))


def _subgroup_cases():
    """G1: generator, k g, the non-subgroup pubkey, infinity, the
    non-subgroup pubkey inactive, -k g, (0, 2) and (0, -2) of order 3,
    (r - 1) g, the point of order 11; G2: k h, the non-subgroup signature,
    the y.c1 == 0 point, infinity, the non-subgroup signature inactive,
    -h, the order-13 and order-23 points; n1 = 10, n2 = 8."""
    rng = np.random.default_rng(0x5B6)
    g, h = cv.g1_generator(), cv.g2_generator().mul(int(rng.integers(2, 2**60)))
    k = int(rng.integers(2, 2**62))
    nsp = cv.g1_decompress(non_subgroup_pubkey(), subgroup_check=False)
    nss = cv.g2_decompress(non_subgroup_signature(), subgroup_check=False)
    t3 = order3_g1()
    g1 = [g, g.mul(k), nsp, cv.g1_infinity(), nsp, -g.mul(k), t3, -t3,
          g.mul(R - 1), small_order(ORDER_11, 11)]
    g2 = [h.mul(k), nss, axis_y_points()[0], cv.g2_infinity(), nss, -h,
          small_order(ORDER_13, 13), small_order(ORDER_23, 23)]
    act1 = [True] * 4 + [False] + [True] * 5
    act2 = [True] * 4 + [False] + [True] * 3
    return g1, g2, act1, act2


@pytest.mark.parametrize("n1, n2", [(10, 8), (3, 8), (10, 0)])
def test_subgroup_matches_plain_and_curve_ref(lib, n1, n2):
    """The emulated k_subgroup against k_subgroup_plain, each task order
    and layout, over G1 and G2 prefixes of _subgroup_cases (n1 != n2: some
    blocks run one group only); the verdicts against curve_ref."""
    g1, g2, act1, act2 = _subgroup_cases()
    args = _sub_inputs(g1[:n1], g2[:n2], act1[:n1], act2[:n2])
    want = staged.k_subgroup_plain(*args)
    for wide in (0, 1):
        for rev in (0, 1):
            got = _sub_emulated(lib, args, wide, rev)
            assert _same(got, want), (wide, rev)
    ref = [not a or jcv.g1_subgroup_check(_jax(p))
           for p, a in zip(g1[:n1], act1)]
    ref += [not a or jcv.g2_subgroup_check(_jax(p))
            for p, a in zip(g2[:n2], act2)]
    assert want[0].tolist() == ref
    full = ([True, True, False, True, True, True, False, False, True, False]
            + [True, False, False, True, True, True, False, False])
    assert ref == full[:n1] + full[10:10 + n2]
    assert bool(want[1][0]) == all(ref)


def _jac_affine(words, g2):
    """Jacobian Montgomery words (X, Y, Z: 24 words each) -> a JAX curve_ref
    point."""
    rinv = pow(1 << 384, P - 2, P)

    def f(w):
        return sum(int(v) << (32 * i) for i, v in enumerate(w)) * rinv % P

    co = [(f(words[24 * c:24 * c + 12]), f(words[24 * c + 12:24 * c + 24]))
          for c in range(3)]
    if co[2] == (0, 0):
        return jcv.g2_infinity() if g2 else jcv.g1_infinity()
    if g2:
        x, y, z = (jfr.Fp2(*v) for v in co)
        b = jcv.B_G2
    else:
        assert all(v[1] == 0 for v in co)
        x, y, z = (jfr.Fp(v[0]) for v in co)
        b = jcv.B_G1
    zi = z.inv()
    return jcv.Point(x * zi * zi, y * zi * zi * zi, b)


def test_subgroup_ladder_values(lib):
    """The accumulators a k_subgroup block leaves, [|z|]^2 P - P and
    [|z|] Q, against curve_ref's [lambda] P and [|z|] Q, each task order:
    the ladders of the order-3 point (P == Q, P == -Q, infinity + P) and
    the order-11 point (P == Q, which changes its [lambda] P when the
    doubling after it is dropped; a verdict alone would not show it, the
    point is outside G1 either way), the order-13 point's (P == -Q,
    infinity + P); and a group point of each."""
    g1, g2, _, _ = _subgroup_cases()
    lam = curve.G1_LAMBDA
    z = -curve.BLS_X
    for p, q in ((g1[6], g2[6]), (g1[9], g2[7]), (g1[1], g2[0])):
        x1, y1, _ = curve.pack_g1_affine([p])
        x2, y2, _ = curve.pack_g2_affine([q])
        want = (_jax(p).mul(lam), _jax(q).mul(z))
        for rev in (0, 1):
            acc = np.zeros(144, np.uint32)
            lib.subgroup_acc(_p(_u32(staged.to_i32(x1))),
                             _p(_u32(staged.to_i32(y1))),
                             _p(_u32(staged.to_i32(x2))),
                             _p(_u32(staged.to_i32(y2))), _p(acc), rev)
            assert _jac_affine(acc[:72], False) == want[0], rev
            assert _jac_affine(acc[72:], True) == want[1], rev
