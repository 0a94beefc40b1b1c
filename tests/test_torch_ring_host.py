"""k_ring_sum of csrc/k_ring.cu (points_coop.cuh's pc_reduce with affine G2
points as its source), emulated on the host.

The headers compile as plain C++ (g++ -x c++): lh_host_group runs the tasks
of each barrier-separated round one after another, forward or backward (a
task that read what another task of its round writes would make the two
differ), which emulates the kernel's one block, its shared memory filled
with a pattern first (the card does not clear it).  The block runs at the
kernel's RING_ACC accumulators and at 2, where S > 2 points stream in; its
outputs are held word for word against staged.k_ring_sum_plain, the sums
against the JAX package's pure-Python curve_ref, and the tree's
accumulators (its intermediate sums) against curve_ref too: S = 0 to 5,
P + P, P + (-P), all infinity, an infinity lane holding x and y words,
three equal points and four points with an infinity.  Skipped without
g++; a CUDA card is not needed.
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
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
from lighthouse_tpu_torch.runtime.build import CSRC
from lighthouse_tpu_torch.tools.check_layouts import (
    non_subgroup_signature)

HARNESS = r"""
#include <string.h>
#include "k_ring.cu"

// One k_ring_sum block over J accumulators, its shared memory a pattern
// first; acc (if not null) gets the J accumulators after the run
// (Jacobian, 72 words each).
template <int J>
void ring(const uint32_t* x, const uint32_t* y, const uint8_t* inf, int s,
          uint32_t* ox, uint32_t* oy, uint8_t* oinf, uint32_t* acc,
          int rev) {
  auto* st = new pc_state<J>();
  memset((void*)st, 0x5a, sizeof(*st));
  lh_host_group g{rev};
  pc_reduce<J> pr{{*st, 0, 0, false}, false, x, y, inf, nullptr, s, ox, oy,
                  oinf};
  lh_run(g, pr);
  for (int j = 0; acc && j < J; j++)
    for (int c = 0; c < 3; c++)
      store(acc + 72 * j + 24 * c, pt_co(st->p[j], c));
  delete st;
}

// acc2 0: the kernel's RING_ACC accumulators; 1: two.
extern "C" int ring_sum(int acc2, const uint32_t* x, const uint32_t* y,
                        const uint8_t* inf, int s, uint32_t* ox,
                        uint32_t* oy, uint8_t* oinf, uint32_t* acc,
                        int rev) {
  if (acc2) {
    ring<2>(x, y, inf, s, ox, oy, oinf, acc, rev);
    return 2;
  }
  ring<RING_ACC>(x, y, inf, s, ox, oy, oinf, acc, rev);
  return RING_ACC;
}
"""

VP = ctypes.c_void_p
I = ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("ring_host")
    src, so = d / "harness.cpp", d / "libring_host.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)], check=True)
    h = ctypes.CDLL(str(so))
    h.ring_sum.argtypes = [I, VP, VP, VP, I, VP, VP, VP, VP, I]
    h.ring_sum.restype = I
    return h


def _u32(t):
    return np.ascontiguousarray(t.numpy().view(np.uint32))


def _p(a):
    return a.ctypes.data_as(VP)


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a).view(np.int32))


def _jax(p):
    """A port curve_ref G2 point -> the JAX package's curve_ref point."""
    if p.is_infinity():
        return jcv.g2_infinity()
    return jcv.Point(jfr.Fp2(p.x.c0, p.x.c1), jfr.Fp2(p.y.c0, p.y.c1),
                     jcv.B_G2)


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


def _planes(points):
    x, y, inf = curve.pack_g2_affine(points)
    return staged.to_i32(x), staged.to_i32(y), inf


def _emulated(lib, planes, acc2, rev):
    x, y, inf = planes
    s = x.shape[0]
    ox = np.zeros(24, np.uint32)
    oy = np.zeros(24, np.uint32)
    oinf = np.full(1, 7, np.uint8)
    acc = np.zeros(72 * 4, np.uint32)
    xw = _u32(x).reshape(-1)
    yw = _u32(y).reshape(-1)
    iw = np.ascontiguousarray(inf.numpy().astype(np.uint8))
    j = lib.ring_sum(acc2, _p(xw), _p(yw), _p(iw), s, _p(ox), _p(oy),
                     _p(oinf), _p(acc), rev)
    got = (_i32(ox).reshape(2, 12), _i32(oy).reshape(2, 12),
           torch.as_tensor(oinf.astype(bool)))
    return got, [_jac_affine(acc[72 * i:72 * i + 72]) for i in range(j)]


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _sum(points):
    total = jcv.g2_infinity()
    for p in points:
        total = total + _jax(p)
    return total


def _cases():
    rng = np.random.default_rng(0x5161)
    g2 = cv.g2_generator()
    h = g2.mul(int(rng.integers(2, 2**62)))
    q = g2.mul(int(rng.integers(2, 2**62)))
    nss = cv.g2_decompress(non_subgroup_signature(), subgroup_check=False)
    inf = cv.g2_infinity()
    return {
        "s0": [],
        "s1": [h],
        "s1_inf": [inf],
        "p_plus_p": [h, h],
        "p_minus_p": [h, -h],
        "s2": [h, q],
        "inf_inf": [inf, inf],
        "inf_p": [inf, q],
        "s3_equal": [h, h, h],
        "s3": [h, q, nss],
        "s4_inf": [h, nss.mul(3), inf, -h],
        "s4": [h, q, -q, nss],
        "s4_all_inf": [inf] * 4,
        "s5": [h, q, h, -h, g2],
        "s5_pq": [q, h, q, q, h],
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_ring_sum_matches_plain_and_curve_ref(lib, case):
    """Each case at the kernel's accumulators and at 2, each task order:
    every output word against k_ring_sum_plain, the sum against
    curve_ref."""
    pts = _cases()[case]
    planes = _planes(pts)
    want = staged.k_ring_sum_plain(*planes)
    ref = _sum(pts)
    for acc2 in (0, 1):
        for rev in (0, 1):
            got, _ = _emulated(lib, planes, acc2, rev)
            assert _same(got, want), (acc2, rev)
    aff = curve.unpack_g2_affine(staged.to_i64(want[0][None]),
                                 staged.to_i64(want[1][None]), want[2])[0]
    assert _jax(aff) == ref


def test_ring_sum_infinity_lane_words_ignored(lib):
    """An infinity lane loads as (0, 1, 0) whatever its x and y words
    hold: S = 1 and S = 3 with junk words under the flag, against the
    plain version and the clean inputs' outputs."""
    h = cv.g2_generator().mul(12345)
    for pts, lane in (([cv.g2_infinity()], 0),
                      ([h, cv.g2_infinity(), h], 1)):
        x, y, inf = _planes(pts)
        clean = staged.k_ring_sum_plain(x, y, inf)
        x, y = x.clone(), y.clone()
        x[lane] = 3
        y[lane, 1, 5] = 77
        want = staged.k_ring_sum_plain(x, y, inf)
        assert _same(want, clean)
        for acc2 in (0, 1):
            got, _ = _emulated(lib, (x, y, inf), acc2, 0)
            assert _same(got, want), acc2


def test_ring_sum_tree_values(lib):
    """The accumulators the block leaves: at 4 accumulators and S = 4 the
    tree's level values (acc 1 = P1 + P3, then the total in acc 0); at 2
    accumulators and S = 5 the streamed sums (acc 1 = P1 + P3, acc 0 the
    total); at 4 and S = 3 (an odd tree) acc 1 = P1; each task order,
    against curve_ref (P == Q and P == -Q met on the way)."""
    rng = np.random.default_rng(0x7EE)
    g2 = cv.g2_generator()
    h = g2.mul(int(rng.integers(2, 2**62)))
    q = g2.mul(int(rng.integers(2, 2**62)))
    for pts, acc2, want in (
            ([h, q, h, q], 0, lambda p: [None, p[1] + p[3]]),
            ([h, q, -h, -q, q], 1, lambda p: [None, p[1] + p[3]]),
            ([h, q, h], 0, lambda p: [None, p[1]])):
        jp = [_jax(p) for p in pts]
        expect = want(jp)
        expect[0] = _sum(pts)
        for rev in (0, 1):
            _, acc = _emulated(lib, _planes(pts), acc2, rev)
            assert acc[:2] == expect, (len(pts), acc2, rev)
