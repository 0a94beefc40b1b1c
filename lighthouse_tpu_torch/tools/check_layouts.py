"""Compare block layouts of wire decoding (csrc/k_decode.cu), the subgroup
checks (k_subgroup in csrc/k_verify.cu), G1 key decoding (k_decode_g1 in
k_verify.cu) and the aggregate sum (k_sign_agg in csrc/k_sign.cu) on one
CUDA card.

Each layout builds its source with nvcc and its -D values (every build at
once, one nvcc each) into lighthouse_tpu_torch/build/layouts/<source
key>/check/; "dec_default", "sub_default", "g1d_default" and "agg_default"
take the sources' own values.  With --parent DIR the k_decode.cu,
k_verify.cu and k_sign.cu of another checkout (DIR, its repository root)
build beside them, so an older kernel is timed in the same call (an older
k_sign.cu of two launches, the one-thread decoding and the tree, gets an
entry that runs its first launch alone, so its time splits).  --kernel
(dec, sub, g1d or agg, repeated) keeps those kernels' layouts only.  Every
layout must equal the plain versions word for word at every lane count of
DECODE_EDGE_LANES on the edge inputs below (k_decode_g1 with its check on
and off; the plain version runs once, at the largest count; a smaller
count is a prefix, and k_decode's all-lanes verdict of a prefix is the AND
of the plain lane verdicts), k_sign_agg at every shape of AGG_EDGE_SHAPES
(the plain version at each).  Then each is timed at TIMED_LANES lanes
(k_subgroup: as many G1 and G2 lanes; k_decode_g1 at G1D_TIMED_LANES keys,
with the check and, at the first and last count, without; k_sign_agg at
AGG_TIMED_SHAPES, and its first pass alone at the two largest; CUDA events
around back-to-back launches behind a sleep kernel, median of 3 batches;
two passes, the layouts interleaved).  Prints each layout's ptxas lines
and blocks an SM, then one JSON line of the results; exits 1 if a layout
failed to build or disagreed.

    python3 -m lighthouse_tpu_torch.tools.check_layouts [--parent DIR]
        [--kernel dec|sub|g1d|agg ...]

The edge inputs (decode_edge_planes, subgroup_edge_planes) and the points
of small order also serve chip_smoke.py and tests/test_torch_decode_host.py.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import subprocess
import sys
import time

from .pair_layouts import device_ms, same

# name -> (source, -D values).  The sources run a block a lane while at
# most *_NARROW_PER_SM lanes fall to an SM and wide blocks beyond; NARROW
# keeps the narrow layout at every count, 0 the wide one.
NARROW = 1 << 20
LAYOUTS = {
    "dec_default": ("k_decode", {}),
    "dec_narrow": ("k_decode", {"DEC_NARROW_PER_SM": NARROW}),
    "dec_narrow_96": ("k_decode", {"DEC_NARROW_PER_SM": NARROW,
                                   "DEC_THREADS": 96}),
    "dec_wide": ("k_decode", {"DEC_NARROW_PER_SM": 0}),
    "dec_wide_1x32": ("k_decode", {"DEC_NARROW_PER_SM": 0,
                                   "DEC_WIDE_LANES": 1}),
    "dec_wide_2x64": ("k_decode", {"DEC_NARROW_PER_SM": 0,
                                   "DEC_WIDE_THREADS": 64}),
    "sub_default": ("k_verify", {}),
    "sub_narrow": ("k_verify", {"SUB_NARROW_PER_SM": NARROW}),
    "sub_wide": ("k_verify", {"SUB_NARROW_PER_SM": 0}),
    "sub_wide_1x32": ("k_verify", {"SUB_NARROW_PER_SM": 0,
                                   "SUB_WIDE_LANES": 1}),
    "sub_wide_2x64": ("k_verify", {"SUB_NARROW_PER_SM": 0,
                                   "SUB_WIDE_THREADS": 64}),
    "g1d_default": ("k_verify", {}),
    "g1d_narrow": ("k_verify", {"G1D_NARROW_PER_SM": NARROW}),
    "g1d_narrow_4": ("k_verify", {"G1D_NARROW_PER_SM": 4}),
    "g1d_wide": ("k_verify", {"G1D_NARROW_PER_SM": 0,
                              "G1D_WIDE_PER_SM": NARROW}),
    "g1d_wider": ("k_verify", {"G1D_NARROW_PER_SM": 0,
                               "G1D_WIDE_PER_SM": 0}),
    "g1d_wider_8x32": ("k_verify", {"G1D_NARROW_PER_SM": 0,
                                    "G1D_WIDE_PER_SM": 0,
                                    "G1D_WIDER_LANES": 8}),
    "g1d_wide_2x64": ("k_verify", {"G1D_NARROW_PER_SM": 0,
                                   "G1D_WIDE_PER_SM": NARROW,
                                   "G1D_WIDE_THREADS": 64}),
    # k_sign_agg: lanes a segment (a block), the powers' window bits, the
    # threads that take a round's products
    "agg_default": ("k_sign", {}),
    "agg_lanes_64_win_3": ("k_sign", {"SA_LANES": 64, "SA_WIN": 3}),
    "agg_lanes_32_win_3": ("k_sign", {"SA_LANES": 32, "SA_WIN": 3}),
    "agg_lanes_32_win_4": ("k_sign", {"SA_LANES": 32, "SA_WIN": 4}),
    "agg_lanes_16_win_3": ("k_sign", {"SA_LANES": 16, "SA_WIN": 3}),
    "agg_lanes_16_win_4": ("k_sign", {"SA_LANES": 16, "SA_WIN": 4}),
    "agg_lanes_32_prod_32": ("k_sign", {"SA_LANES": 32, "SA_WIN": 3,
                                        "SA_PROD_THREADS": 32}),
}
KINDS = ("dec", "sub", "g1d", "agg")
SOURCES = {"dec": "k_decode", "sub": "k_verify", "g1d": "k_verify",
           "agg": "k_sign"}
KERNEL_OF = {"dec": "k_decode", "sub": "k_subgroup", "g1d": "k_decode_g1",
             "agg": "k_sign_agg"}
# One lane, a warp's 32 and either side, the gossip batch's 64 and 65, the
# 1,024-set batch's 1,025 (DEFAULT_MAX_BATCH_ITEMS).
DECODE_EDGE_LANES = (1, 31, 32, 33, 64, 65, 1025)
TIMED_LANES = (64, 132, 264, 528, 1025)
# k_decode_g1: the gossip batch's 64 keys, 2 and 4 lanes an SM, the
# 1,024-set batch's 1,025, the mesh path's 4,096 arena keys.
G1D_TIMED_LANES = (64, 264, 528, 1025, 4096)
OFF_CURVE_X1 = bytes([0x80]) + bytes(47) + (1).to_bytes(48, "big")
# The G1 wire x = 1: 1 + 4 = 5 is not a square in Fp.
OFF_CURVE_G1 = bytes([0x80]) + bytes(46) + b"\x01"
# Points of small order, as wire bytes: [#E / q^2] T for a curve point T
# (G1: x = 4; G2: x = 1 + u), multiplied by q until the next product is
# infinity (q^2 divides the cofactor).  The |z| ladder meets P == Q on the
# G1 point of order 11, P == -Q and infinity + P on the G2 point of order
# 13.
ORDER_11 = bytes.fromhex(
    "b9b3e2c8c6bbf59d3c326b531fc1e639d29200c28624ac604f251a12908c9b7f7353"
    "18617f625954cc71cdf03229b1ef")
ORDER_13 = bytes.fromhex(
    "a32762e5199990da7d4ebc6409c2fdae09b25206fa89dded0a23c05406588284278c"
    "22ea15e6d03cee69a68b7d4704a4043ff79d06a80add8340a1a548d700c5ffeef5b1"
    "4a3e246834d320e323d9fcc76bae16f9f2763ab556905843518bc0c2")
ORDER_23 = bytes.fromhex(
    "81c8529db7e45f16111c0c95106d37fb89a90afb348c9082db6d49fc34ee0077501c"
    "7ac278ed112708313a28768cc52c0503fbc16c24192886d4bb5c5f791e3c3448dc4e"
    "19f0ca8d0bcd6cf6cbe9ccd602478cafaf1d7847458df499807d8ae2")
# k_decode's edge lanes (the others hold valid signatures): the square
# root's corner d1 == 0 (y.c0 == 0) and y.c1 == 0, each of both signs, a
# well-formed and a malformed infinity (x != 0), an off-curve x, the
# non-subgroup signature, points of order 13 and 23; again across the
# block and warp edges.
DECODE_EDGES = {1: "imag_y", 2: "-imag_y", 3: "real_y", 4: "-real_y",
                5: "infinity", 6: "malformed", 7: "off_curve",
                8: "non_subgroup", 9: "order_13", 10: "order_23",
                30: "order_13", 31: "malformed", 32: "imag_y",
                33: "non_subgroup", 63: "off_curve", 64: "real_y",
                1023: "infinity", 1024: "order_23"}
# k_sign_agg: a lane and four (phase 6), one row either side of the
# 64-lane mark, the aggregate path's 32 x 512 and twice its rows.
AGG_EDGE_SHAPES = ((1, 1), (3, 4), (1, 63), (1, 64), (1, 65), (32, 512),
                   (64, 512))
AGG_TIMED_SHAPES = ((1, 1), (3, 4), (32, 512), (64, 512))
AGG_POOL = 1024                      # distinct signatures the rows rotate
# k_subgroup's: G1 the non-subgroup pubkey (also inactive), infinity, the
# points (0, +-2) of order 3, (r - 1) g, the point of order 11; G2 the non-subgroup signature
# (also inactive), the y.c1 == 0 point, infinity, the order-13 and order-23
# points.  An inactive lane holds a point outside the group and passes.
G1_EDGES = {1: "non_subgroup", 2: "infinity", 3: "inactive", 4: "order_3",
            5: "-order_3", 6: "r-1", 7: "order_11", 31: "order_3",
            32: "non_subgroup", 33: "infinity", 63: "order_11",
            64: "-order_3", 1024: "non_subgroup"}
G2_EDGES = {1: "non_subgroup", 2: "real_y", 3: "infinity", 4: "inactive",
            5: "order_13", 6: "order_23", 31: "order_23", 32: "non_subgroup",
            63: "order_13", 1024: "real_y"}
# k_decode_g1's (the others hold keys of both signs): the generator and
# -g, a well-formed and a malformed infinity (x != 0), the points (0, +-2)
# of order 3, the point of order 11, an off-curve x, the non-subgroup
# pubkey; again across the block and warp edges.
DECODE_G1_EDGES = {1: "generator", 2: "-generator", 3: "infinity",
                   4: "malformed", 5: "order_3", 6: "-order_3",
                   7: "order_11", 8: "off_curve", 9: "non_subgroup",
                   30: "malformed", 31: "order_3", 32: "off_curve",
                   33: "non_subgroup", 63: "order_11", 64: "-order_3",
                   1023: "infinity", 1024: "non_subgroup"}


def axis_y_points():
    """The two G2 points at x = a + 2u with a^2 = 2/3, where x^3 + 4(1 + u)
    is in Fp: (y in Fp, y.c1 == 0; y in u Fp, y.c0 == 0: the right-hand
    side is a non-square of Fp, the norm trick's corner d1 == 0)."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp, Fp2

    a = Fp(2 * pow(3, P - 2, P)).sqrt()
    pts = []
    for av in (a.v, (-a).v):
        x = Fp2(av, 2)
        pts.append(cv.Point(x, (x.square() * x + cv.B_G2).sqrt(), cv.B_G2))
    real = [p for p in pts if p.y.c1 == 0]
    imag = [p for p in pts if p.y.c0 == 0]
    assert len(real) == 1 and len(imag) == 1
    return real[0], imag[0]


def order3_g1():
    """(0, 2): on y^2 = x^3 + 4, of order 3 (3 divides the G1 cofactor)."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp

    p = cv.Point(Fp(0), Fp(2), cv.B_G1)
    assert p.is_on_curve() and p.mul(3).is_infinity()
    return p


def small_order(raw: bytes, q: int):
    """The G1 (48 bytes) or G2 (96) point of order q with these bytes."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv

    dec = cv.g1_decompress if len(raw) == 48 else cv.g2_decompress
    p = dec(raw, subgroup_check=False)
    assert not p.is_infinity() and p.mul(q).is_infinity()
    return p


def _vector(name: str, key: str) -> bytes:
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "..", "..", "tests", "vectors",
                        "bls_adversarial.json")
    with open(path) as f:
        case = [c for c in json.load(f)["cases"] if c["name"] == name][0]
    s = case["sets"][0][key]
    return bytes.fromhex(s[0] if isinstance(s, list) else s)


def non_subgroup_signature() -> bytes:
    return _vector("non_subgroup_signature", "signature")


def non_subgroup_pubkey() -> bytes:
    return _vector("non_subgroup_pubkey", "pubkeys")


def _chain(start, step, count: int) -> list:
    """count points start, start + step, ... (one addition each)."""
    pts = [start]
    for _ in range(count - 1):
        pts.append(pts[-1] + step)
    return pts


def decode_edge_planes(rng: random.Random, n: int):
    """k_decode's inputs at n lanes, CPU tensors (x, sign, inf): valid
    signatures of both sign bits with DECODE_EDGES placed (a prefix of a
    larger n is these inputs at fewer lanes)."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk

    g2 = cv.g2_generator()
    pts = _chain(g2.mul(rng.randrange(1, R)), g2, n)
    real, imag = axis_y_points()
    special = {"imag_y": imag, "-imag_y": -imag, "real_y": real,
               "-real_y": -real, "infinity": cv.g2_infinity(),
               "malformed": cv.g2_infinity()}
    raw_of = {"off_curve": OFF_CURVE_X1,
              "non_subgroup": non_subgroup_signature(),
              "order_13": ORDER_13, "order_23": ORDER_23}
    raws = []
    for i, p in enumerate(pts):
        case = DECODE_EDGES.get(i)
        raws.append(raw_of[case] if case in raw_of else
                    cv.g2_compress(special.get(case, p)))
    x, sign, inf = bk.parse_g2_compressed_many(raws, n)
    for i, case in DECODE_EDGES.items():
        if case == "malformed" and i < n:
            x[i, 0, 0] = 1
    return x, sign, inf


def decode_lane_ok(x, sign, inf):
    """The plain lane verdicts of k_decode: on the curve and in G2, or a
    well-formed infinity."""
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged

    pt, ok = curve.g2_decompress(staged.to_i64(x), sign, inf)
    return ok & (curve.g2_subgroup_check(pt) | inf)


def decode_g1_edge_planes(rng: random.Random, n: int):
    """k_decode_g1's inputs at n lanes, CPU tensors (x, sign, inf): keys
    with DECODE_G1_EDGES placed (a prefix of a larger n is these inputs at
    fewer lanes)."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk

    g1 = cv.g1_generator()
    pts = _chain(g1.mul(rng.randrange(1, R)), g1, n)
    t3 = order3_g1()
    special = {"generator": g1, "-generator": -g1,
               "infinity": cv.g1_infinity(), "malformed": cv.g1_infinity(),
               "order_3": t3, "-order_3": -t3}
    raw_of = {"order_11": ORDER_11, "off_curve": OFF_CURVE_G1,
              "non_subgroup": non_subgroup_pubkey()}
    raws = []
    for i, p in enumerate(pts):
        case = DECODE_G1_EDGES.get(i)
        raws.append(raw_of[case] if case in raw_of else
                    cv.g1_compress(special.get(case, p)))
    x, sign, inf = bk.parse_g1_compressed_many(raws, n)
    for i, case in DECODE_G1_EDGES.items():
        if case == "malformed" and i < n:
            x[i, 0] = 1
    return x, sign, inf


def subgroup_edge_planes(rng: random.Random, n: int):
    """k_subgroup's inputs at n G1 and n G2 lanes, CPU tensors (x1, y1,
    inf1, act1, x2, y2, inf2, act2): group points with G1_EDGES and
    G2_EDGES placed (a prefix of a larger n is these inputs at fewer
    lanes)."""
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged

    g1, g2 = cv.g1_generator(), cv.g2_generator()
    p1 = _chain(g1.mul(rng.randrange(1, R)), g1, n)
    p2 = _chain(g2.mul(rng.randrange(1, R)), g2, n)
    nsp = cv.g1_decompress(non_subgroup_pubkey(), subgroup_check=False)
    nss = cv.g2_decompress(non_subgroup_signature(), subgroup_check=False)
    t3 = order3_g1()
    e1 = {"non_subgroup": nsp, "infinity": cv.g1_infinity(),
          "inactive": nsp, "order_3": t3, "-order_3": -t3,
          "r-1": g1.mul(R - 1), "order_11": small_order(ORDER_11, 11)}
    e2 = {"non_subgroup": nss, "real_y": axis_y_points()[0],
          "infinity": cv.g2_infinity(), "inactive": nss,
          "order_13": small_order(ORDER_13, 13),
          "order_23": small_order(ORDER_23, 23)}
    for pts, edges, vals in ((p1, G1_EDGES, e1), (p2, G2_EDGES, e2)):
        for i, case in edges.items():
            if i < n:
                pts[i] = vals[case]
    act1 = torch.tensor([G1_EDGES.get(i) != "inactive" for i in range(n)])
    act2 = torch.tensor([G2_EDGES.get(i) != "inactive" for i in range(n)])
    x1, y1, i1 = curve.pack_g1_affine(p1)
    x2, y2, i2 = curve.pack_g2_affine(p2)
    to = staged.to_i32
    return to(x1), to(y1), i1, act1, to(x2), to(y2), i2, act2


def subgroup_prefix(args, n1: int, n2: int):
    """The inputs of subgroup_edge_planes cut to n1 G1 and n2 G2 lanes."""
    return tuple(t[:n1] for t in args[:4]) + tuple(t[:n2] for t in args[4:])


def agg_pool_planes(rng: random.Random, count: int = AGG_POOL):
    """count distinct signatures' planes (x, sign, inf), CPU tensors: a
    chain of G2 points from a random multiple of the generator."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls import sign_engine as se
    from lighthouse_tpu_torch.crypto.bls.constants import R

    g2 = cv.g2_generator()
    pts = _chain(g2.mul(rng.randrange(1, R)), g2.mul(rng.randrange(1, R)),
                 count)
    x, sign, inf, ok = se.parse_wire_planes([cv.g2_compress(p)
                                             for p in pts])
    assert ok.all()
    return (torch.from_numpy(np.ascontiguousarray(x.view(np.int32))),
            torch.from_numpy(sign), torch.from_numpy(inf))


def agg_rows(pool, m: int, k: int):
    """k_sign_agg's planes (m, k), every lane live: row r, lane i holds
    signature (37 r + i) mod len(pool) of the pool."""
    import torch

    x, sign, inf = pool
    idx = (37 * torch.arange(m)[:, None] + torch.arange(k)[None, :]) % len(x)
    return (x[idx].contiguous(), sign[idx].contiguous(),
            inf[idx].contiguous(), torch.ones((m, k), dtype=torch.bool))


def agg_edge_planes(x, sign, inf, mask):
    """Copies of k_sign_agg planes (m, k) with edge lanes placed across the
    32- and 64-lane segment edges, where the row and lane exist: row 0 a
    masked lane (1), an infinity (2), a repeated signature across 31 | 32,
    an off-curve x (40), sigma and -sigma across 63 | 64, a masked
    off-curve x (70); row 1 the segment [32, 64) a copy of [0, 32) (P == Q
    where the segment sums join) and [96, 128) the negation of [64, 96)
    (infinity there); row 2 off-curve x in the first, a middle and the last
    segment; row 3 infinities across 31 | 32, a live malformed infinity
    (x != 0: ok False) at 33, masked lanes across 63 | 64 and a masked
    malformed infinity at 65."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import sign_engine as se

    x, sign, inf, mask = (t.clone() for t in (x, sign, inf, mask))
    m, k = mask.shape
    ox, osg, _, ok = se.parse_wire_planes([OFF_CURVE_X1])
    assert ok.all()
    off_x = torch.from_numpy(np.ascontiguousarray(ox.view(np.int32))[0])

    def put(r, i, kind, j=None):
        if r >= m or i >= k or (j is not None and j >= k):
            return
        if kind == "masked":
            mask[r, i] = False
        elif kind in ("infinity", "malformed"):
            x[r, i] = 0
            x[r, i, 0, 0] = 1 if kind == "malformed" else 0
            sign[r, i], inf[r, i] = False, True
        elif kind == "off_curve":
            x[r, i] = off_x.to(x.device)
            sign[r, i], inf[r, i] = bool(osg[0]), False
        else:                        # "copy" or "neg" of lane j
            x[r, i], inf[r, i] = x[r, j], inf[r, j]
            sign[r, i] = sign[r, j] ^ (kind == "neg")

    put(0, 1, "masked")
    put(0, 2, "infinity")
    put(0, 32, "copy", 31)
    put(0, 40, "off_curve")
    put(0, 64, "neg", 63)
    put(0, 70, "off_curve")
    put(0, 70, "masked")
    for i in range(32, 64):
        put(1, i, "copy", i - 32)
    for i in range(96, 128):
        put(1, i, "neg", i - 32)
    for i in (0, k // 2 + 5, k - 1):
        put(2, i, "off_curve")
    put(3, 31, "infinity")
    put(3, 32, "infinity")
    put(3, 33, "malformed")
    put(3, 63, "masked")
    put(3, 64, "masked")
    put(3, 65, "malformed")
    put(3, 65, "masked")
    return x, sign, inf, mask


def build_layouts(out_dir: str, parent: str = None,
                  kinds=KINDS) -> dict:
    """One nvcc a layout of `kinds` (and the parent's sources), all at
    once -> name: (source, library path, ptxas lines) or (source, None,
    nvcc's output) for a failed build."""
    from lighthouse_tpu_torch.runtime import build

    os.makedirs(out_dir, exist_ok=True)
    jobs = {name: (src, build.CSRC, defs)
            for name, (src, defs) in LAYOUTS.items()
            if name[:name.index("_")] in kinds}
    shim = {}
    if parent:
        pcsrc = os.path.join(parent, "lighthouse_tpu_torch", "csrc")
        for kind in kinds:
            jobs[f"{kind}_parent"] = (SOURCES[kind], pcsrc, {})
        if "agg" in kinds:
            shim["agg_parent"] = _agg_parent_shim(pcsrc, out_dir)
    procs = {}
    for name, (src, csrc, defs) in jobs.items():
        so = os.path.join(out_dir, f"lib{src}_{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc,
               *(f"-D{k}={v}" for k, v in defs.items()), "-o", so,
               shim.get(name) or os.path.join(csrc, src + ".cu")]
        procs[name] = (src, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (src, so, proc) in procs.items():
        text, _ = proc.communicate()
        out[name] = ((src, so, build._parse_ptxas(text))
                     if proc.returncode == 0 else (src, None, text[-4000:]))
    return out


# The first launch of a k_sign.cu of two launches (one thread a lane
# decodes into the scratch, then one block a row sums) alone, as an entry
# of the name the current source gives its first pass.
PARENT_AGG_SHIM = r"""
#include "k_sign.cu"
extern "C" int k_sign_agg_first_pass_launch(const void* xin, const void* sin,
                                            const void* iin, const void* mask,
                                            int m, int k, void* jac, void* x,
                                            void* sign, void* inf, void* ok,
                                            void* stream) {
  if (m <= 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(ok, 1, (size_t)m, st);
  if (e != cudaSuccess || k <= 0) return (int)e;
  k_sign_agg_decode_kernel<<<lanes_blocks(m * k, 32), 32, 0, st>>>(
      (const uint32_t*)xin, (const uint8_t*)sin, (const uint8_t*)iin,
      (const uint8_t*)mask, (uint32_t*)jac, (uint8_t*)ok, m, k);
  return (int)cudaGetLastError();
}
"""


def _agg_parent_shim(pcsrc: str, out_dir: str):
    """The source to build for a parent's k_sign.cu: a shim that adds the
    first-pass entry to a k_sign.cu of two launches, else None (its own)."""
    with open(os.path.join(pcsrc, "k_sign.cu")) as f:
        text = f.read()
    if ("k_sign_agg_first_pass_launch" in text
            or "k_sign_agg_decode_kernel" not in text):
        return None
    path = os.path.join(out_dir, "k_sign_parent_shim.cu")
    with open(path, "w") as f:
        f.write(PARENT_AGG_SHIM)
    return path


def agg_fn(lib, name, x, sign, inf, mask, first_pass=False):
    """A call of lib's k_sign_agg_launch as the wrapper makes it (or of its
    first pass alone)."""
    import torch
    from lighthouse_tpu_torch.runtime import build

    m, k = mask.shape
    dev = x.device
    jac = torch.empty((m * k, 72), dtype=torch.int32, device=dev)
    ax = torch.empty((m, 2, 12), dtype=torch.int32, device=dev)
    asign = torch.empty((m,), dtype=torch.bool, device=dev)
    ainf = torch.empty((m,), dtype=torch.bool, device=dev)
    ok = torch.empty((m,), dtype=torch.bool, device=dev)
    entry = ("k_sign_agg_first_pass_launch" if first_pass
             else "k_sign_agg_launch")

    def run():
        build.call_lib(lib, name, entry, x, sign, inf, mask, m, k, jac, ax,
                       asign, ainf, ok)
        return ax, asign, ainf, ok
    return run


def decode_fn(lib, name, x, sign, inf):
    """A call of lib's k_decode_launch as the wrapper makes it."""
    import torch
    from lighthouse_tpu_torch.runtime import build

    m, dev = x.shape[0], x.device
    xs = torch.empty((m, 2, 12), dtype=torch.int32, device=dev)
    ys = torch.empty((m, 2, 12), dtype=torch.int32, device=dev)
    si = torch.empty((m,), dtype=torch.bool, device=dev)
    ok = torch.empty((1,), dtype=torch.bool, device=dev)

    def run():
        build.call_lib(lib, name, "k_decode_launch", x, sign, inf, m, xs, ys,
                       si, ok)
        return xs, ys, si, ok
    return run


def subgroup_fn(lib, name, args):
    """A call of lib's k_subgroup_launch as the wrapper makes it."""
    import torch
    from lighthouse_tpu_torch.runtime import build

    x1, y1, i1, a1, x2, y2, i2, a2 = args
    n1, n2, dev = x1.shape[0], x2.shape[0], x1.device
    lanes = torch.empty((n1 + n2,), dtype=torch.bool, device=dev)
    ok = torch.empty((1,), dtype=torch.bool, device=dev)

    def run():
        build.call_lib(lib, name, "k_subgroup_launch", x1, y1, i1, a1, n1, x2,
                       y2, i2, a2, n2, lanes, ok)
        return lanes, ok
    return run


def decode_g1_fn(lib, name, x, sign, inf, check):
    """A call of lib's k_decode_g1_launch as the wrapper makes it."""
    import torch
    from lighthouse_tpu_torch.runtime import build

    m, dev = x.shape[0], x.device
    xs = torch.empty((m, 12), dtype=torch.int32, device=dev)
    ys = torch.empty((m, 12), dtype=torch.int32, device=dev)
    si = torch.empty((m,), dtype=torch.bool, device=dev)
    ok = torch.empty((m,), dtype=torch.bool, device=dev)

    def run():
        build.call_lib(lib, name, "k_decode_g1_launch", x, sign, inf, m,
                       int(bool(check)), xs, ys, si, ok)
        return xs, ys, si, ok
    return run


def occupancy(lib, kernel: str):
    """Blocks an SM holds of `kernel`'s (k_decode, k_subgroup, k_decode_g1,
    k_sign_agg) layouts, narrow first (k_decode_g1: narrow, wide, wider;
    k_sign_agg: its one), from a built library (an older library without
    the entry: None)."""
    fn = getattr(lib, f"{kernel}_occupancy", None)
    if fn is None:
        return None
    out = (ctypes.c_int * {"k_decode_g1": 3, "k_sign_agg": 1}.get(kernel,
                                                                 2))()
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p]
    rc = fn(ctypes.cast(out, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"{kernel}_occupancy: cudaError {rc}")
    return list(out)


class EdgeCases:
    """The edge inputs at the largest count on the card, with the plain
    versions' outputs there; want_*(n) gives a prefix's expected outputs."""

    def __init__(self, rng: random.Random, dev, lanes=DECODE_EDGE_LANES,
                 kinds=KINDS):
        import torch
        from lighthouse_tpu_torch.crypto.bls.cuda import staged

        self.top = top = max(lanes)
        if "dec" in kinds:
            self.dec = tuple(t.to(dev) for t in decode_edge_planes(rng, top))
            self.dec_plain = staged.k_decode_plain(*self.dec)
            self.dec_lane_ok = decode_lane_ok(*self.dec)
            if not torch.equal(self.dec_lane_ok.all().reshape(1),
                               self.dec_plain[3]):
                raise AssertionError("k_decode_plain: ok is not the lanes' "
                                     "AND")
        if "sub" in kinds:
            self.sub = tuple(t.to(dev)
                             for t in subgroup_edge_planes(rng, top))
            self.sub_plain = staged.k_subgroup_plain(*self.sub)
        if "g1d" in kinds:
            self.g1d = tuple(t.to(dev)
                             for t in decode_g1_edge_planes(rng, top))
            self.g1d_plain = {check: staged.k_decode_g1_plain(
                *self.g1d, check=check) for check in (False, True)}
        if "agg" in kinds:
            from lighthouse_tpu_torch.crypto.bls.cuda import signer

            pool = agg_pool_planes(rng)
            self.agg, self.agg_plain = {}, {}
            for m, k in AGG_EDGE_SHAPES:
                planes = tuple(t.to(dev) for t in agg_edge_planes(
                    *agg_rows(pool, m, k)))
                self.agg[m, k] = planes
                self.agg_plain[m, k] = signer.k_sign_agg_plain(*planes)

    def decode_in(self, n):
        return tuple(t[:n] for t in self.dec)

    def want_decode(self, n):
        xs, ys, si, _ = self.dec_plain
        return xs[:n], ys[:n], si[:n], self.dec_lane_ok[:n].all().reshape(1)

    def subgroup_in(self, n1, n2):
        return subgroup_prefix(self.sub, n1, n2)

    def decode_g1_in(self, n):
        return tuple(t[:n] for t in self.g1d)

    def want_decode_g1(self, n, check):
        return tuple(t[:n] for t in self.g1d_plain[check])

    def want_subgroup(self, n1, n2):
        import torch

        lanes = self.sub_plain[0]
        got = torch.cat([lanes[:n1], lanes[self.top:self.top + n2]])
        return got, got.all().reshape(1)

    def subgroup_shapes(self, n):
        """(n1, n2) pairs at n lanes: as many, and n1 != n2 both ways."""
        return [(n, n), (n, n // 2), (n // 2, n)] if n > 1 else [(1, 1),
                                                                (1, 0)]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout's root: time its "
                    "k_decode.cu and k_verify.cu too")
    ap.add_argument("--kernel", action="append", choices=KINDS,
                    help="keep these kernels' layouts only (repeatable)")
    args = ap.parse_args()
    kinds = tuple(args.kernel or KINDS)
    if not torch.cuda.is_available():
        print("check_layouts: no CUDA device", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.runtime import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    built = build_layouts(os.path.join(build.BUILD_ROOT, "layouts",
                                       build.source_key(), "check"),
                          args.parent, kinds)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    failed = [n for n, (_, so, _) in built.items() if so is None]
    for name, (src, so, lines) in built.items():
        if so is None:
            print(f"[build] {name} FAILED:\n{lines}", flush=True)
            continue
        for ln in lines:
            print(f"[ptxas] {name}: {ln}", flush=True)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ec = EdgeCases(random.Random(20261019), dev, kinds=kinds)
    if "g1d" in kinds:               # G1D_TIMED_LANES beyond the edges
        keys = tuple(t.to(dev) for t in decode_g1_edge_planes(
            random.Random(20261020), max(G1D_TIMED_LANES)))
    print(f"[inputs] {time.perf_counter() - t0:.1f} s", flush=True)
    res, runs = {}, {}
    for name, (src, so, lines) in built.items():
        if so is None:
            continue
        lib = ctypes.CDLL(so)
        r = res[name] = {"source": src, "ptxas": lines,
                         "defines": LAYOUTS.get(name, (src, "parent"))[1],
                         "ms": {}}
        kind = name[:name.index("_")]
        r["blocks_per_sm"] = occupancy(lib, KERNEL_OF[kind])
        equal = True
        if kind == "agg":
            for shape in AGG_EDGE_SHAPES:
                equal &= same(agg_fn(lib, name, *ec.agg[shape])(),
                              ec.agg_plain[shape])
            runs[name] = {f"shape_{m}x{k}": agg_fn(lib, name,
                                                   *ec.agg[m, k])
                          for m, k in AGG_TIMED_SHAPES}
            if hasattr(lib, "k_sign_agg_first_pass_launch"):
                for m, k in AGG_TIMED_SHAPES[-2:]:
                    runs[name][f"first_pass_{m}x{k}"] = agg_fn(
                        lib, name, *ec.agg[m, k], first_pass=True)
        elif kind == "g1d":
            for n in DECODE_EDGE_LANES:
                for check in (False, True):
                    equal &= same(decode_g1_fn(lib, name,
                                               *ec.decode_g1_in(n), check)(),
                                  ec.want_decode_g1(n, check))
            runs[name] = {f"lanes_{n}": decode_g1_fn(
                lib, name, *(t[:n] for t in keys), True)
                for n in G1D_TIMED_LANES}
            for n in (G1D_TIMED_LANES[0], G1D_TIMED_LANES[-1]):
                runs[name][f"lanes_{n}_no_check"] = decode_g1_fn(
                    lib, name, *(t[:n] for t in keys), False)
        elif kind == "dec":
            for n in DECODE_EDGE_LANES:
                equal &= same(decode_fn(lib, name, *ec.decode_in(n))(),
                              ec.want_decode(n))
            runs[name] = {f"lanes_{n}": decode_fn(lib, name,
                                                  *ec.decode_in(n))
                          for n in TIMED_LANES}
        else:
            for n in DECODE_EDGE_LANES:
                for n1, n2 in ec.subgroup_shapes(n):
                    equal &= same(subgroup_fn(lib, name,
                                              ec.subgroup_in(n1, n2))(),
                                  ec.want_subgroup(n1, n2))
            runs[name] = {f"lanes_{n}": subgroup_fn(lib, name,
                                                    ec.subgroup_in(n, n))
                          for n in TIMED_LANES}
        r["equal_plain"] = bool(equal)
        if not equal:
            failed.append(name)
        print(f"[layout] {name}: blocks an SM {r.get('blocks_per_sm')}, "
              f"equal to plain {r['equal_plain']}", flush=True)
    for _ in range(2):
        for name, r in res.items():
            for shape, fn in runs[name].items():
                r["ms"].setdefault(shape, []).append(round(device_ms(fn, 3),
                                                           4))
    for name, r in res.items():
        print(f"[ms] {name}: {r['ms']}", flush=True)
    print(json.dumps({"card": card, "layouts": res, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
