"""The block-cooperative weighting ladders of csrc/points_coop.cuh and
k_each's per-set use of pair_coop.cuh, emulated on the host.

The headers compile as plain C++ (g++ -x c++): lh_host_group runs the tasks
of each barrier-separated round one after another, forward or backward (a
task that read what another task of its round writes would make the two
differ), which emulates a block of k_points.cu or k_each.cu.  One lane's G1
and G2 ladders (pc_ladder), the signature sum and the mask variant's key
sums (pc_reduce, at the kernels' accumulator counts and at 4, where a small
batch already streams), and k_each's two Miller lanes and final
exponentiation a set are composed as the kernels launch them and held word
for word against the plain versions of crypto/bls/cuda/staged.py, and the
weighted points against the JAX package's curve_ref: edge weights 0, 1, 2,
2^32, 2^63 and 2^64 - 1, infinity keys and signatures, padding lanes, a sum
that reaches P == Q and one that reaches P == -Q, and ladders whose
accumulator reaches +-P (a key of order 3).  Skipped without g++; a CUDA
card is not needed.
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
from lighthouse_tpu_torch.crypto.bls import fields_ref as fr
from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
from lighthouse_tpu_torch.runtime.build import CSRC

HARNESS = r"""
#include "k_points.cu"
#include "k_each.cu"

// One block of k_points_ladder_kernel; pk_jac non-null: the mask variant.
extern "C" void ladder(const uint32_t* xp, const uint32_t* yp, int pinf,
                       const uint32_t* pk_jac, int act, const uint32_t* xs,
                       const uint32_t* ys, int sinf, const uint32_t* rand,
                       uint32_t* wx, uint32_t* wy, uint8_t* winf,
                       uint32_t* ws, int rev) {
  pc_state<2>* s = new pc_state<2>();
  lh_host_group g{rev};
  const bool multi = pk_jac != nullptr;
  pc_ladder pr{{*s, 0, 0, false}, xp, yp, pinf != 0, pk_jac,
               multi ? (act != 0 && !sinf) : true, xs, ys, sinf != 0,
               (uint64_t)rand[0] | ((uint64_t)rand[1] << 32), wx, wy, winf,
               ws, 0};
  lh_run(g, pr);
  delete s;
}

template <int J>
void reduce(bool g1, const uint32_t* x, const uint32_t* y,
            const uint8_t* ipk, const uint8_t* mask, int n, uint32_t* ox,
            uint32_t* oy, uint8_t* of, int rev) {
  pc_state<J>* s = new pc_state<J>();
  lh_host_group g{rev};
  pc_reduce<J> pr{{*s, 0, 0, false}, g1, x, y, ipk, mask, n, ox, oy, of};
  lh_run(g, pr);
  delete s;
}

// One block of k_points_sum_kernel (acc 0: SUM_ACC accumulators) or of
// k_points_agg_kernel (AGG_ACC), or the same program over 4.
extern "C" void sum(int acc4, const uint32_t* ws, int n, uint32_t* sx,
                    uint32_t* sy, uint8_t* sinf, int rev) {
  if (acc4) reduce<4>(false, ws, nullptr, nullptr, nullptr, n, sx, sy, sinf,
                      rev);
  else reduce<SUM_ACC>(false, ws, nullptr, nullptr, nullptr, n, sx, sy, sinf,
                       rev);
}
extern "C" void agg(int acc4, const uint32_t* xpk, const uint32_t* ypk,
                    const uint8_t* ipk, const uint8_t* mask, int k,
                    uint32_t* pk_jac, uint8_t* act, int rev) {
  if (acc4) reduce<4>(true, xpk, ypk, ipk, mask, k, pk_jac, nullptr, act,
                      rev);
  else reduce<AGG_ACC>(true, xpk, ypk, ipk, mask, k, pk_jac, nullptr, act,
                       rev);
}

// k_each's set i: the Miller blocks of lanes 2i and 2i + 1, then the final
// block (m = 2), or False without a round where P_i or sig_i is infinity.
extern "C" void each(const uint32_t* xp, const uint32_t* yp,
                     const uint8_t* pinf, const uint32_t* xs,
                     const uint32_t* ys, const uint8_t* sinf,
                     const uint32_t* hx, const uint32_t* hy,
                     const uint8_t* hinf, int n, uint8_t* ok, int rev) {
  mill_t* ms = new mill_t();
  fin_t* fs = new fin_t();
  uint32_t f[288];
  for (int i = 0; i < n; i++) {
    for (int sig = 0; sig < 2; sig++) {
      lh_host_group g{rev};
      mill_prog pr{*ms, sig ? nullptr : xp + 12 * i,
                   sig ? nullptr : yp + 12 * i, (sig ? xs : hx) + 24 * i,
                   (sig ? ys : hy) + 24 * i,
                   sig ? sinf[i] != 0 : (pinf[i] || hinf[i]),
                   f + 144 * sig, 0};
      lh_run(g, pr);
    }
    if (pinf[i] || sinf[i]) {
      ok[i] = 0;
      continue;
    }
    lh_host_group g{rev};
    fin_prog pr{*fs, f, 2, true, f, ok + i, fin_k0(2)};
    lh_run(g, pr);
  }
  delete ms;
  delete fs;
}
"""

VP = ctypes.c_void_p
I = ctypes.c_int
EDGE_WEIGHTS = [0, 1, 2, 1 << 32, 1 << 63, (1 << 64) - 1]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("points_host")
    src, so = d / "harness.cpp", d / "libpoints_host.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)], check=True)
    h = ctypes.CDLL(str(so))
    h.ladder.argtypes = [VP, VP, I, VP, I, VP, VP, I, VP, VP, VP, VP, VP, I]
    h.sum.argtypes = [I, VP, I, VP, VP, VP, I]
    h.agg.argtypes = [I, VP, VP, VP, VP, I, VP, VP, I]
    h.each.argtypes = [VP] * 9 + [I, VP, I]
    return h


def _u32(t):
    return np.ascontiguousarray(t.numpy().astype(np.uint32))


def _u8(t):
    return np.ascontiguousarray(t.numpy().astype(np.uint8))


def _p(a):
    return None if a is None else a.ctypes.data_as(VP)


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a).view(np.int32))


def _port(p):
    """A JAX curve_ref point -> the port's curve_ref point."""
    if p.is_infinity():
        return cv.g2_infinity() if hasattr(p.b, "c0") else cv.g1_infinity()
    if hasattr(p.x, "c0"):
        return cv.Point(fr.Fp2(p.x.c0, p.x.c1), fr.Fp2(p.y.c0, p.y.c1),
                        cv.B_G2)
    return cv.Point(fr.Fp(p.x.v), fr.Fp(p.y.v), cv.B_G1)


def _key(p):
    if p.is_infinity():
        return None
    return ((p.x.c0, p.x.c1, p.y.c0, p.y.c1) if hasattr(p.x, "c0")
            else (p.x.v, p.y.v))


def _rand(weights):
    return _i32(np.array([[w & 0xFFFFFFFF, w >> 32] for w in weights],
                         np.uint32))


def _points_args(pks, sigs, weights):
    xp, yp, pi = curve.pack_g1_affine([_port(p) for p in pks])
    xs, ys, si = curve.pack_g2_affine([_port(p) for p in sigs])
    return [staged.to_i32(xp), staged.to_i32(yp), pi, staged.to_i32(xs),
            staged.to_i32(ys), si, _rand(weights)]


def _emulate(lib, args, acc4, rev, mask=None):
    """k_points' launches emulated: the key sums (mask variant), a ladder
    block a lane, the sum block -> the wrapper's six outputs."""
    xp, yp, pi, xs, ys, si, rand = args
    n = xs.shape[0]
    pk_jac = act = None
    if mask is not None:
        k = mask.shape[1]
        pk_jac = np.zeros((n, 36), np.uint32)
        act = np.zeros(n, np.uint8)
        xk, yk, ik, mk = _u32(xp), _u32(yp), _u8(pi), _u8(mask)
        for i in range(n):
            lib.agg(acc4, _p(xk[i]), _p(yk[i]), _p(ik[i]), _p(mk[i]), k,
                    _p(pk_jac[i]), _p(act[i:]), rev)
    wx = np.zeros((n, 12), np.uint32)
    wy = np.zeros((n, 12), np.uint32)
    winf = np.zeros(n, np.uint8)
    ws = np.zeros((n, 72), np.uint32)
    xs_, ys_, si_, r_ = _u32(xs), _u32(ys), _u8(si), _u32(rand)
    for i in range(n):
        if mask is None:
            lib.ladder(_p(_u32(xp[i])), _p(_u32(yp[i])), int(pi[i]), None, 0,
                       _p(xs_[i]), _p(ys_[i]), int(si_[i]), _p(r_[i]),
                       _p(wx[i]), _p(wy[i]), _p(winf[i:]), _p(ws[i]), rev)
        else:
            lib.ladder(None, None, 0, _p(pk_jac[i]), int(act[i]), _p(xs_[i]),
                       _p(ys_[i]), int(si_[i]), _p(r_[i]), _p(wx[i]),
                       _p(wy[i]), _p(winf[i:]), _p(ws[i]), rev)
    sx = np.zeros(24, np.uint32)
    sy = np.zeros(24, np.uint32)
    sinf = np.zeros(1, np.uint8)
    lib.sum(acc4, _p(ws), n, _p(sx), _p(sy), _p(sinf), rev)
    return (_i32(wx), _i32(wy), torch.as_tensor(winf.astype(bool)),
            _i32(sx).reshape(2, 12), _i32(sy).reshape(2, 12),
            torch.as_tensor(sinf.astype(bool)))


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _lanes(case):
    """(pubkeys, signatures, weights) as JAX curve_ref points.
    edges: every edge weight; an infinity key (2^32) and signature (2^63);
      lanes 1 and 5 weigh -sig and sig by 1 (the sum meets P == -Q), lanes
      3 and 7 one signature by 2 (P == Q): the tree adds lane j + 4 into
      j first, at 4 accumulators and at 64.
    padding: two lanes between padding lanes (infinity, weight 0).
    cancel: sig and -sig by 1: S is infinity.
    small_order: the G1 point (0, 2) of order 3 (and its negation) by 5, 3,
      2^64 - 1 and 6: the ladder's accumulator meets P == Q (5 = 101b:
      P, -P, then P + P), P == -Q (3 = 11b: -P + P) and infinity + P."""
    rng = np.random.default_rng(0x9017)
    g1, g2 = jcv.g1_generator(), jcv.g2_generator()
    ks = [int(k) for k in rng.integers(2, 2**62, 8)]
    pks = [g1.mul(k) for k in ks]
    sigs = [g2.mul(k + 7) for k in ks]
    if case == "edges":
        sigs[1] = -sigs[5]
        sigs[7] = sigs[3]
        pks[4] = jcv.g1_infinity()
        sigs[6] = jcv.g2_infinity()
        weights = [0, 1, (1 << 64) - 1, 2, 1 << 32, 1, 1 << 63, 2]
        assert set(EDGE_WEIGHTS) <= set(weights)
        return pks, sigs, weights
    if case == "padding":
        pad = (jcv.g1_infinity(), jcv.g2_infinity(), 0)
        lanes = [pad, (pks[0], sigs[0], 2**40 + 3), pad,
                 (pks[1], sigs[1], 2**64 - 5), pad]
        return [a for a, _, _ in lanes], [b for _, b, _ in lanes], \
            [w for _, _, w in lanes]
    if case == "small_order":
        t3 = jcv.Point(jfr.Fp(0), jfr.Fp(2), jcv.B_G1)
        assert t3.is_on_curve() and t3.mul(3).is_infinity()
        return [t3, -t3, t3, t3], sigs[:4], [5, 3, (1 << 64) - 1, 6]
    return pks[:2], [sigs[0], -sigs[0]], [1, 1]


@pytest.mark.parametrize("case", ["edges", "padding", "cancel",
                                  "small_order"])
def test_points_match_plain_and_curve_ref(lib, case):
    """The emulated k_points word for word against k_points_plain, each
    task order, at the kernel's accumulator count and at 4; the weighted
    keys and the sum against the JAX curve_ref."""
    pks, sigs, weights = _lanes(case)
    args = _points_args(pks, sigs, weights)
    want = staged.k_points_plain(*args)
    for acc4 in (0, 1):
        for rev in (0, 1):
            got = _emulate(lib, args, acc4, rev)
            assert _same(got, want), (case, acc4, rev)
    w_ref = [p.mul(w) for p, w in zip(pks, weights)]
    s_ref = jcv.g2_infinity()
    for s, w in zip(sigs, weights):
        s_ref = s_ref + s.mul(w)
    wx, wy, winf, sx, sy, sinf = got
    w_got = curve.unpack_g1_affine(staged.to_i64(wx), staged.to_i64(wy), winf)
    s_got = curve.unpack_g2_affine(staged.to_i64(sx)[None],
                                   staged.to_i64(sy)[None], sinf)
    assert [_key(p) for p in w_got] == [_key(p) for p in w_ref]
    assert _key(s_got[0]) == _key(s_ref)
    if case == "cancel":
        assert bool(sinf[0])


def test_mask_variant_matches_plain_and_curve_ref(lib):
    """Four sets of 8 keys: a full set with a repeated key (P == Q in the
    key sum) and a key with its negation (P == -Q), a set with masked-off
    and infinity keys, an empty set, and a set whose signature is
    infinity; word for word against the plain mask variant, each task
    order, at the kernel's accumulator count and at 4 (which streams)."""
    rng = np.random.default_rng(0x3A5C)
    g1, g2 = jcv.g1_generator(), jcv.g2_generator()
    n, k = 4, 8
    keys = [[g1.mul(int(x)) for x in rng.integers(2, 2**62, k)]
            for _ in range(n)]
    keys[0][5] = keys[0][1]
    keys[0][6] = -keys[0][2]
    keys[1][3] = jcv.g1_infinity()
    mask = np.ones((n, k), bool)
    mask[1, [0, 6]] = False
    mask[2] = False
    sigs = [g2.mul(int(x)) for x in rng.integers(2, 2**62, n)]
    sigs[3] = jcv.g2_infinity()
    weights = [(1 << 64) - 1, 2, 1 << 63, 1 << 32]
    flat = [_port(p) for row in keys for p in row]
    x, y, inf = curve.pack_g1_affine(flat)
    xs, ys, si = curve.pack_g2_affine([_port(p) for p in sigs])
    args = [staged.to_i32(x).reshape(n, k, 12),
            staged.to_i32(y).reshape(n, k, 12), inf.reshape(n, k),
            staged.to_i32(xs), staged.to_i32(ys), si, _rand(weights)]
    m = torch.as_tensor(mask)
    want = staged.k_points_plain(*args, mask=m)
    for acc4 in (0, 1):
        for rev in (0, 1):
            got = _emulate(lib, args, acc4, rev, mask=m)
            assert _same(got, want), (acc4, rev)
    agg = []
    for i in range(n):
        a = jcv.g1_infinity()
        for j in range(k):
            if mask[i, j]:
                a = a + keys[i][j]
        agg.append(a)
    active = [mask[i].any() and not sigs[i].is_infinity() for i in range(n)]
    ex, ey, _ = curve.pack_g1_affine([_port(a.mul(w))
                                      for a, w in zip(agg, weights)])
    assert torch.equal(got[0], staged.to_i32(ex))
    assert torch.equal(got[1], staged.to_i32(ey))
    assert got[2].tolist() == [not a or agg[i].is_infinity()
                               for i, a in enumerate(active)]
    s_ref = jcv.g2_infinity()
    for i in range(n):
        if active[i]:
            s_ref = s_ref + sigs[i].mul(weights[i])
    s_got = curve.unpack_g2_affine(staged.to_i64(got[3])[None],
                                   staged.to_i64(got[4])[None], got[5])
    assert _key(s_got[0]) == _key(s_ref)


def test_each_matches_plain(lib):
    """k_each's blocks a set: valid, wrong message, infinity key, infinity
    signature, infinity H (lane 2i off), valid: the plain verdicts, each
    task order."""
    rng = np.random.default_rng(0xEAC4)
    n = 6
    sks = [int(x) for x in rng.integers(2, 2**62, n)]
    msgs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
    hs = [hr.hash_to_g2(m) for m in msgs]
    pks = [cv.g1_generator().mul(k) for k in sks]
    sigs = [h.mul(k) for h, k in zip(hs, sks)]
    hs[1] = hs[0]
    pks[2] = cv.g1_infinity()
    sigs[3] = cv.g2_infinity()
    hs[4] = cv.g2_infinity()
    xp, yp, pi = curve.pack_g1_affine(pks)
    xs, ys, si = curve.pack_g2_affine(sigs)
    hx, hy, hi = curve.pack_g2_affine(hs)
    args = [staged.to_i32(t) if t.dtype == torch.int64 else t
            for t in (xp, yp, pi, xs, ys, si, hx, hy, hi)]
    want = staged.k_each_plain(*args)
    assert want.tolist() == [True, False, False, False, False, True]
    raw = [_u32(t) if t.dtype == torch.int32 else _u8(t) for t in args]
    for rev in (0, 1):
        ok = np.zeros(n, np.uint8)
        lib.each(*(_p(a) for a in raw), n, _p(ok), rev)
        assert ok.astype(bool).tolist() == want.tolist(), rev
