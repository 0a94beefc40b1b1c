"""k_decode_g1 of csrc/k_verify.cu (check_coop.cuh's ck_prog in mode
CK_DEC1: one thread's G1 decompression a lane, then with the check
k_subgroup's G1 program as the block's jobs), emulated on the host.

The headers compile as plain C++ (g++ -x c++): lh_host_group runs the tasks
of each barrier-separated round one after another, forward or backward (a
task that read what another task of its round writes would make the two
differ), which emulates a block.  The blocks are composed as the kernel
launches them, at its narrow layout (a lane a block) and its wide and
wider ones (G1D_WIDE_LANES and G1D_WIDER_LANES lanes a block, the last
block partly filled), each block's shared memory filled with a pattern
first (the card does not clear it), with the check on and off, and held
word for word against
staged.k_decode_g1_plain; the points and verdicts against the JAX
package's pure-Python curve_ref: both sign bits, the generator and -g,
infinity and an infinity lane with x != 0, x = 0 (the points (0, +-2) of
order 3), the point of order 11, an x off the curve, the non-subgroup
pubkey of bls_adversarial.json and padding lanes; and the check ladder's
accumulator ([|z|]^2 P - P = [lambda] P) at the order-3 and order-11
points and a group point, since a verdict alone would not show a dropped
P == Q doubling.  Skipped without g++; a CUDA card is not needed.
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
    parse_g1_compressed_many)
from lighthouse_tpu_torch.runtime.build import CSRC
from lighthouse_tpu_torch.tools.check_layouts import (
    OFF_CURVE_G1, ORDER_11, non_subgroup_pubkey, order3_g1, small_order)

HARNESS = r"""
#include <string.h>
#include "k_verify.cu"

// The blocks of one k_decode_g1 launch, l0 = 0, L, 2L, ...; each block's
// shared memory starts as a pattern, not as the last block left it.
template <int L>
void dec1_run(const uint32_t* x, const uint8_t* sign, const uint8_t* inf,
              int m, int check, uint32_t* xs, uint32_t* ys, uint8_t* si,
              uint8_t* ok, uint32_t* acc, int rev) {
  using prog = ck_prog<L, CK_DEC1>;
  auto* s = new typename prog::state_t();
  for (int l0 = 0; l0 < m; l0 += L) {
    memset((void*)s, 0x5a, sizeof(*s));
    lh_host_group g{rev};
    prog pr{*s, {s->pc, 0, 0, false}, l0, x, nullptr, inf, sign, m, nullptr,
            nullptr, nullptr, nullptr, 0, xs, ys, si, ok, nullptr, 0, 0,
            check != 0};
    lh_run(g, pr);
    // the accumulators after the run (Jacobian, 72 words a lane)
    for (int j = 0; acc && j < L && l0 + j < m; j++)
      for (int c = 0; c < 3; c++)
        store(acc + 72 * (l0 + j) + 24 * c, pt_co(s->pc.p[j], c));
  }
  delete s;
}

// wide 0: the kernel's narrow layout (a lane a block); 1: its wide one;
// 2: its wider one.
extern "C" void decode_g1(int wide, const uint32_t* x, const uint8_t* sign,
                          const uint8_t* inf, int m, int check, uint32_t* xs,
                          uint32_t* ys, uint8_t* si, uint8_t* ok,
                          uint32_t* acc, int rev) {
  if (wide == 2)
    dec1_run<G1D_WIDER_LANES>(x, sign, inf, m, check, xs, ys, si, ok, acc,
                              rev);
  else if (wide)
    dec1_run<G1D_WIDE_LANES>(x, sign, inf, m, check, xs, ys, si, ok, acc,
                             rev);
  else
    dec1_run<1>(x, sign, inf, m, check, xs, ys, si, ok, acc, rev);
}
"""

VP = ctypes.c_void_p
I = ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("decode_g1_host")
    src, so = d / "harness.cpp", d / "libdecode_g1_host.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)], check=True)
    h = ctypes.CDLL(str(so))
    h.decode_g1.argtypes = [I, VP, VP, VP, I, I, VP, VP, VP, VP, VP, I]
    return h


def _u32(t):
    return np.ascontiguousarray(t.numpy().view(np.uint32))


def _u8(t):
    return np.ascontiguousarray(t.numpy().astype(np.uint8))


def _p(a):
    return a.ctypes.data_as(VP)


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a).view(np.int32))


def _emulated(lib, planes, check, wide, rev, with_acc=False):
    x, sign, inf = planes
    m = x.shape[0]
    xs = np.full((m, 12), 0xA5A5A5A5, np.uint32)
    ys = np.full((m, 12), 0xA5A5A5A5, np.uint32)
    si = np.full(m, 7, np.uint8)
    ok = np.full(m, 7, np.uint8)
    acc = np.zeros(72 * m, np.uint32)
    xw, sw, iw = _u32(x), _u8(sign), _u8(inf)
    lib.decode_g1(wide, _p(xw), _p(sw), _p(iw), m, int(check), _p(xs),
                  _p(ys), _p(si), _p(ok), _p(acc) if with_acc else None, rev)
    got = (_i32(xs), _i32(ys), torch.as_tensor(si.astype(bool)),
           torch.as_tensor(ok.astype(bool)))
    return (got, acc) if with_acc else got


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _jac_affine(words):
    """Jacobian Montgomery G1 words as Fp2 with c1 = 0 (X, Y, Z: 24 words
    each) -> a JAX curve_ref point."""
    rinv = pow(1 << 384, P - 2, P)

    def f(w):
        return sum(int(v) << (32 * i) for i, v in enumerate(w)) * rinv % P

    co = [(f(words[24 * c:24 * c + 12]), f(words[24 * c + 12:24 * c + 24]))
          for c in range(3)]
    assert all(v[1] == 0 for v in co)
    if co[2][0] == 0:
        return jcv.g1_infinity()
    x, y, z = (jfr.Fp(v[0]) for v in co)
    zi = z.inv()
    return jcv.Point(x * zi * zi, y * zi * zi * zi, jcv.B_G1)


def _jax(p):
    if p.is_infinity():
        return jcv.g1_infinity()
    return jcv.Point(jfr.Fp(p.x.v), jfr.Fp(p.y.v), jcv.B_G1)


MALFORMED = 5                            # infinity with x != 0
PADDING = 2


def _raws():
    """Both sign bits (k g, -k g), the generator and -g, infinity and a
    malformed infinity, (0, 2) and (0, -2) of order 3, the order-11
    point, an off-curve x, the non-subgroup pubkey, (r - 1) g."""
    rng = np.random.default_rng(0x61D)
    g = cv.g1_generator()
    gk = g.mul(int(rng.integers(2, 2**62)))
    t3 = order3_g1()
    raws = [cv.g1_compress(p) for p in (gk, -gk, g, -g, cv.g1_infinity(),
                                        cv.g1_infinity(), t3, -t3)]
    raws += [ORDER_11, OFF_CURVE_G1, non_subgroup_pubkey(),
             cv.g1_compress(g.mul(R - 1))]
    assert len({r[0] & 0x20 for r in raws[:2]}) == 2
    assert len({r[0] & 0x20 for r in raws[6:8]}) == 2
    return raws


def _planes():
    raws = _raws()
    x, sign, inf = parse_g1_compressed_many(raws, len(raws) + PADDING)
    x[MALFORMED, 0] = 1
    return raws, (x, sign, inf)


# lane verdicts: without the check, with it (padding lanes are infinity)
NO_CHECK = [True] * 5 + [False] + [True] * 3 + [False] + [True] * 2 + [
    True] * PADDING
CHECK = [True] * 5 + [False] + [False] * 3 + [False, False, True] + [
    True] * PADDING


@pytest.mark.parametrize("check", [False, True])
def test_decode_g1_matches_plain_and_curve_ref(lib, check):
    """Every output word against k_decode_g1_plain, each layout (the wider
    one's last block partly filled) and task order; the points and the
    lane verdicts against curve_ref."""
    raws, planes = _planes()
    m = planes[0].shape[0]
    assert m % 4 == 2
    want = staged.k_decode_g1_plain(*planes, check=check)
    for wide in (0, 1, 2):
        for rev in (0, 1):
            got = _emulated(lib, planes, check, wide, rev)
            assert _same(got, want), (wide, rev)
    # an odd lane count: the last wide or wider block holds one lane
    odd = tuple(t[:m - 1] for t in planes)
    want_odd = staged.k_decode_g1_plain(*odd, check=check)
    for wide in (1, 2):
        assert _same(_emulated(lib, odd, check, wide, 0), want_odd), wide
    assert want[3].tolist() == (CHECK if check else NO_CHECK)
    pts = curve.unpack_g1_affine(staged.to_i64(want[0]),
                                 staged.to_i64(want[1]), want[2])
    ref = []
    for i, raw in enumerate(raws):
        p = jcv.g1_decompress(raw, subgroup_check=False)
        if i == MALFORMED:
            assert not bool(want[3][i]) and pts[i].is_infinity()
            ref.append(False)
            continue
        if p is None:                    # off the curve: no point
            ref.append(False)
            continue
        assert _jax(pts[i]) == p, i
        ref.append(not check or p.is_infinity()
                   or jcv.g1_subgroup_check(p))
    assert want[3].tolist()[:len(raws)] == ref


def test_decode_g1_check_ladder_values(lib):
    """With the check, the accumulator a lane leaves is [|z|]([|z|] P) - P
    = [lambda] P: at the order-3 points (the ladder meets P == Q, P == -Q
    and infinity), the order-11 point (P == Q) and a group point, each
    task order and layout, against curve_ref."""
    g = cv.g1_generator()
    t3 = order3_g1()
    pts = [t3, -t3, small_order(ORDER_11, 11), g.mul(0xC0FFEE)]
    x, sign, inf = parse_g1_compressed_many([cv.g1_compress(p) for p in pts])
    lam = curve.G1_LAMBDA
    want = [_jax(p).mul(lam) for p in pts]
    for wide in (0, 1, 2):
        for rev in (0, 1):
            _, acc = _emulated(lib, (x, sign, inf), True, wide, rev,
                               with_acc=True)
            got = [_jac_affine(acc[72 * i:72 * i + 72])
                   for i in range(len(pts))]
            assert got == want, (wide, rev)
