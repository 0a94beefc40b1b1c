"""The cooperative pairing code of csrc/pair_coop.cuh, emulated on the host.

The header compiles as plain C++ (g++ -x c++): lh_host_group runs the tasks
of each barrier-separated round one after another, which emulates a block
of k_pair.cu.  The emulated Miller product and combine are held word for
word against the plain versions of crypto/bls/cuda/staged.py, each task
order forward and backward (a task that read what another task of its round
writes would make the two differ), and the binary-Euclid inverse against
Fermat's.  One addition step (rounds M_A1..M_A7) is held against the
plain addition_step of crypto/bls/cuda/pairing.py at T = Q, T = -Q and T
at infinity: the exceptional branches of the complete addition, which a
batch of random points never reaches.  Skipped without g++; a CUDA card is
not needed.
"""
import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.cuda import curve, fp, staged
from lighthouse_tpu_torch.runtime.build import CSRC

HARNESS = r"""
#include "pair_coop.cuh"
extern "C" void miller(const uint32_t* xp, const uint32_t* yp,
                       const uint32_t* xq, const uint32_t* yq, int inactive,
                       uint32_t* out, int rev) {
  mill_t* s = new mill_t();
  lh_host_group g{rev};
  mill_prog pr{*s, xp, yp, xq, yq, inactive != 0, out, 0};
  lh_run(g, pr);
  delete s;
}
extern "C" void fin(const uint32_t* f_all, int m, int fe, uint8_t* ok,
                    uint32_t* out, int rev) {
  fin_t* s = new fin_t();
  lh_host_group g{rev};
  fin_prog pr{*s, f_all, m, fe != 0, out, ok, fin_k0(m)};
  lh_run(g, pr);
  delete s;
}
// One addition step: T's squares (M_T1), then M_A1..M_A7 only.
struct add_prog : mill_prog {
  int first() { return M_T1; }
  int next(int rid) {
    if (rid == M_T1) return M_A1;
    if (rid == M_A7) return -1;
    return mill_prog::next(rid);
  }
};
// T from the affine (xt, yt) and lam: kase 0 (xt lam^2, yt lam^3, lam),
// 1 the same with -Y, 2 infinity (0, 1, 0).  out: the step's T (72 words)
// and f = 1 times its line (144 words, w-order: the line b w + c w^3 +
// a w^4), then T before the step (72 words).
extern "C" void add_step(const uint32_t* xp, const uint32_t* yp,
                         const uint32_t* xq, const uint32_t* yq,
                         const uint32_t* xt, const uint32_t* yt,
                         const uint32_t* lam, int kase, int rev,
                         uint32_t* out) {
  g2_t t;
  if (kase == 2) {
    pt_set_inf(t);
  } else {
    fp2_t l, l2, l3, x, y;
    load(l, lam);
    load(x, xt);
    load(y, yt);
    sqr(l2, l);
    mul(l3, l2, l);
    mul(t.x, x, l2);
    mul(t.y, y, l3);
    if (kase == 1) neg(t.y, t.y);
    t.z = l;
  }
  mill_t* s = new mill_t();
  load(s->xp.c0, xp);
  set_zero(s->xp.c1);
  load(s->yp.c0, yp);
  set_zero(s->yp.c1);
  load(s->xq, xq);
  load(s->yq, yq);
  s->X = t.x;
  s->Y = t.y;
  s->Z = t.z;
  f2_one(s->f[0]);
  for (int m = 1; m < 6; m++) set_zero(s->f[m]);
  lh_host_group g{rev};
  add_prog pr{{*s, nullptr, nullptr, nullptr, nullptr, false, nullptr, 0}};
  lh_run(g, pr);
  store(out, s->X);
  store(out + 24, s->Y);
  store(out + 48, s->Z);
  for (int m = 0; m < 6; m++) store(out + 72 + 24 * m, s->f[m]);
  delete s;
  store(out + 216, t.x);
  store(out + 240, t.y);
  store(out + 264, t.z);
}
extern "C" void inv_fp(const uint32_t* a, uint32_t* r) {
  fp_t x, y;
  load(x, a);
  fp_inv_vt(y, x);
  store(r, y);
}
"""

VP = ctypes.c_void_p
R_MONT = 1 << 384


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("pair_host")
    src, so = d / "harness.cpp", d / "libpair_host.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)], check=True)
    h = ctypes.CDLL(str(so))
    h.miller.argtypes = [VP, VP, VP, VP, ctypes.c_int, VP, ctypes.c_int]
    h.fin.argtypes = [VP, ctypes.c_int, ctypes.c_int, VP, VP, ctypes.c_int]
    h.inv_fp.argtypes = [VP, VP]
    h.add_step.argtypes = [VP] * 7 + [ctypes.c_int, ctypes.c_int, VP]
    return h


def _u32(t):
    return np.ascontiguousarray(t.numpy().astype(np.uint32))


def _ptr(a):
    return None if a is None else a.ctypes.data_as(VP)


@pytest.fixture(scope="module")
def batch():
    """Four lanes (pubkey i g1, message point H_i) with an infinity pubkey
    at lane 1, and S = sum of the signatures of the finite lanes: the lanes
    with the closing lane (-g1, S) multiply to a Miller product whose final
    exponentiation is 1."""
    rng = np.random.default_rng(0x9A1)
    n = 4
    ks = [int(k) for k in rng.integers(1, 2**60, n)]
    g1 = cv.g1_generator()
    pks = [g1.mul(k) for k in ks]
    pks[1] = cv.g1_infinity()
    hs = [hr.hash_to_g2(bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
          for _ in range(n)]
    s = cv.g2_infinity()
    for i in (0, 2, 3):
        s = s + hs[i].mul(ks[i])
    xp, yp, pi = curve.pack_g1_affine(pks)
    xq, yq, qi = curve.pack_g2_affine(hs)
    sx, sy, si = curve.pack_g2_affine([s])
    to = staged.to_i32
    lanes = (to(xp), to(yp), pi, to(xq), to(yq), qi)
    return lanes, (to(sx)[0], to(sy)[0], si)


def _miller_product(lib, lanes, closing, rev, fe=False):
    """k_pair_partial (fe False) or k_pair (fe True) of the batch, the
    kernels' two launches emulated: a block a lane, then one block."""
    (wx, wy, winf, hx, hy, hinf), (sx, sy, sinf) = lanes
    fs = []
    for i in range(wx.shape[0]):
        f = np.zeros(144, np.uint32)
        lib.miller(_ptr(_u32(wx[i])), _ptr(_u32(wy[i])), _ptr(_u32(hx[i])),
                   _ptr(_u32(hy[i])), int(bool(winf[i]) or bool(hinf[i])),
                   _ptr(f), rev)
        fs.append(f)
    if closing:                        # no P words: the lane is (-g1, S)
        f = np.zeros(144, np.uint32)
        lib.miller(None, None, _ptr(_u32(sx)), _ptr(_u32(sy)),
                   int(bool(sinf[0])), _ptr(f), rev)
        fs.append(f)
    return _final(lib, np.stack(fs), fe, rev)


def _final(lib, f_all, fe, rev):
    f_all = np.ascontiguousarray(f_all, dtype=np.uint32)
    out = np.zeros(144, np.uint32)
    ok = np.zeros(1, np.uint8)
    lib.fin(_ptr(f_all), f_all.shape[0], int(fe), _ptr(ok), _ptr(out), rev)
    gt = torch.as_tensor(out.view(np.int32)).reshape(staged.F12_SHAPE)
    return (torch.tensor([bool(ok[0])]), gt) if fe else gt


@pytest.mark.parametrize("closing", [True, False])
def test_miller_product_matches_plain(lib, batch, closing):
    lanes, extra = batch
    want = staged.k_pair_partial_plain(*lanes, *(extra if closing else ()),
                                       closing=closing)
    for rev in (0, 1):
        got = _miller_product(lib, batch, closing, rev)
        assert torch.equal(got, want), ("forward", "backward")[rev]


def test_miller_product_of_no_lane_is_one(lib):
    got = _final(lib, np.zeros((0, 144), np.uint32), False, 0)
    one = torch.zeros(staged.F12_SHAPE, dtype=torch.int32)
    one[0, 0, 0] = staged.to_i32(fp.pack([fp.R_MOD_P]))[0]
    assert torch.equal(got, one)


def test_pairing_verdict_matches_plain(lib, batch):
    lanes, extra = batch
    want = staged.k_pair_plain(*lanes, *extra)
    assert bool(want[0])
    for rev in (0, 1):
        got = _miller_product(lib, batch, True, rev, fe=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("parts", [1, 2])
def test_combine_matches_plain(lib, batch, parts):
    """The combine's lane product and final exponentiation over 1 and 2
    shard partials (the batch split after lane 2)."""
    lanes, extra = batch
    halves = [tuple(t[:2] for t in lanes), tuple(t[2:] for t in lanes)]
    if parts == 1:
        stack = staged.k_pair_partial_plain(*lanes, *extra, closing=True)[None]
    else:
        stack = torch.stack([
            staged.k_pair_partial_plain(*halves[0], *extra, closing=True),
            staged.k_pair_partial_plain(*halves[1])])
    want = staged.k_pair_combine_plain(stack)
    assert bool(want[0])
    f_all = _u32(stack.reshape(parts, 144))
    for rev in (0, 1):
        got = _final(lib, f_all, True, rev)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _mont_words(v):
    return _u32(staged.to_i32(fp.pack([v * R_MONT % P])))[0]


@pytest.mark.parametrize("case", ["random", "zero", "one", "p_minus_1"])
def test_binary_euclid_inverse_matches_fermat(lib, case):
    rnd = random.Random(0xE0C1)
    vals = {"random": [rnd.randrange(2, P - 1) for _ in range(64)],
            "zero": [0], "one": [1], "p_minus_1": [P - 1]}[case]
    for a in vals:
        r = np.zeros(12, np.uint32)
        lib.inv_fp(_ptr(_mont_words(a)), _ptr(r))
        assert np.array_equal(r, _mont_words(pow(a, P - 2, P))), hex(a)


@pytest.mark.parametrize("case", ["equal", "negated", "infinity", "generic"])
def test_addition_step_matches_miller_cuh(lib, case):
    """An addition step from T = lam Q (the addition doubles: rounds
    M_S1..M_S3), T = -lam Q (T + Q is infinity), T at infinity (T + Q is
    Q) and T = lam Q' for another point Q': the line word for word against
    the plain addition_step of crypto/bls/cuda/pairing.py (the reference
    since the one-thread Miller loop of miller.cuh, which gave this test
    its name, was removed), and T too, except that at T + Q = infinity,
    where any Z = 0 triple is the point, the step's T is (0, 1, 0); each
    task order."""
    from lighthouse_tpu_torch.crypto.bls.cuda import pairing
    from lighthouse_tpu_torch.crypto.bls.cuda.curve import Jacobian

    rng = np.random.default_rng(0xADD)
    g1 = cv.g1_generator().mul(int(rng.integers(2, 2**60)))
    qs = [hr.hash_to_g2(bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
          for _ in range(2)]
    xp, yp, _ = curve.pack_g1_affine([g1])
    xq, yq, _ = curve.pack_g2_affine(qs)
    xq = _u32(staged.to_i32(xq)).reshape(2, 24)
    yq = _u32(staged.to_i32(yq)).reshape(2, 24)
    rnd = random.Random(0xADD)
    lam = np.concatenate([_mont_words(rnd.randrange(1, P)) for _ in (0, 1)])
    t = 1 if case == "generic" else 0
    kase = {"equal": 0, "negated": 1, "infinity": 2, "generic": 0}[case]
    one = _mont_words(1)

    def limbs(words, shape):
        return torch.as_tensor(words.astype(np.int64)).reshape(shape)

    for rev in (0, 1):
        out = np.zeros(288, np.uint32)
        lib.add_step(_ptr(_u32(staged.to_i32(xp))[0]),
                     _ptr(_u32(staged.to_i32(yp))[0]),
                     _ptr(xq[0]), _ptr(yq[0]), _ptr(xq[t]), _ptr(yq[t]),
                     _ptr(lam), kase, rev, _ptr(out))
        t_in = Jacobian(*(limbs(out[216 + 24 * c:240 + 24 * c], (1, 2, 12))
                          for c in range(3)))
        (a, b, c), t_next = pairing.addition_step(
            t_in, limbs(xq[0], (1, 2, 12)), limbs(yq[0], (1, 2, 12)),
            staged.to_i64(staged.to_i32(xp)), staged.to_i64(staged.to_i32(yp)))
        zero = torch.zeros_like(a)
        line = torch.cat([zero, b, zero, c, a, zero]).reshape(-1)
        where = (case, ("forward", "backward")[rev])
        assert np.array_equal(out[72:216], line.numpy().astype(np.uint32)), \
            where
        want = torch.cat(list(t_next)).reshape(-1).numpy().astype(np.uint32)
        z = out[48:72]
        if case == "negated":          # infinity: (0, 1, 0); plain Z = 0
            assert not want[48:72].any(), where
            assert not z.any() and not out[:24].any(), where
            assert np.array_equal(out[24:36], one) and not out[36:48].any()
            continue
        assert np.array_equal(out[:72], want), where
        if case == "equal":            # 2T: Z3 = 2 Y Z is not 0
            assert z.any()
        elif case == "infinity":       # Q
            assert np.array_equal(out[:24], xq[0])
            assert np.array_equal(out[24:48], yq[0])
