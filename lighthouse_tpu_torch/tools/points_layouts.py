"""Compare block layouts of the weighting ladders (csrc/k_points.cu) and of
k_each's final block (csrc/k_each.cu) on one CUDA card.

Each layout builds its source with nvcc and its -D values (every build at
once, one nvcc each) into lighthouse_tpu_torch/build/layouts/<source
key>/points/; "default" takes the sources' own values.  With --parent DIR
the k_points.cu and k_each.cu of another checkout (DIR, its repository
root) build beside them, so an older kernel is timed in the same call.
Every k_points layout must equal the plain version word for word at 64
lanes and on the 4 x 512 mask variant (one with other accumulator counts
also on edge inputs placed for its counts), and the default layout at
1,024 lanes; every k_each layout the plain verdicts at 64 sets and the default's
at 1,024.  Then each is timed at those shapes (CUDA events around
back-to-back launches behind a sleep kernel, median of 3 batches; two
passes, the layouts interleaved).  Prints each layout's ptxas lines and
blocks an SM, then one JSON line of the results; exits 1 if a layout failed
to build or disagreed.

    python3 -m lighthouse_tpu_torch.tools.points_layouts [--parent DIR]

The edge-case inputs below (points_edge_inputs, mask_edge_inputs,
each_edge_inputs) also serve chip_smoke.py.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

from .pair_layouts import device_ms, same

# name -> (source, -D values); "default" and "each_default" are what the
# sources ship.
LAYOUTS = {
    "default": ("k_points", {}),
    "lad_64": ("k_points", {"LAD_THREADS": 64, "LAD_PROD_THREADS": 64}),
    "lad_128": ("k_points", {"LAD_THREADS": 128}),
    "lad_32": ("k_points", {"LAD_THREADS": 32, "LAD_PROD_THREADS": 32}),
    "acc_32": ("k_points", {"SUM_ACC": 32, "AGG_ACC": 32}),
    "sum_256": ("k_points", {"SUM_THREADS": 256, "AGG_THREADS": 256}),
    "sum_448": ("k_points", {"SUM_THREADS": 448, "AGG_THREADS": 448}),
    "each_default": ("k_each", {}),
    "each_fin_448": ("k_each", {"EACH_FIN_THREADS": 448}),
}
EDGE_WEIGHTS = (0, 1, 2, 1 << 32, 1 << 63, (1 << 64) - 1)
# k_points.cu's accumulators of the signature sum and of a set's key sum:
# the edge inputs below place their P == Q and P == -Q cases by them
# (chip_smoke.py checks the built library's, see accumulators).
SUM_ACC = 64
AGG_ACC = 64


def sum_partner(n: int, j: int, acc: int = SUM_ACC):
    """The lane whose weighted signature the sum adds to lane j's first
    (k_points_sum_kernel with `acc` accumulators: lane j + acc streams into
    accumulator j, then the tree adds accumulator j + ceil(w / 2) into j),
    or None."""
    if n > acc:
        return j + acc if j + acc < n else j + acc // 2
    h = (n + 1) // 2
    return j + h if j + h < n else None


def _rand_words(weights):
    import numpy as np
    import torch

    return torch.as_tensor(np.array(
        [[w & 0xFFFFFFFF, w >> 32] for w in weights], np.uint32).view(
            np.int32))


def points_edge_inputs(rng: random.Random, n: int, base, dev,
                       acc: int = SUM_ACC):
    """k_points' seven inputs at n lanes over the base points (pks, sigs:
    curve_ref G1 and G2 points, cycled), with random weights and: lanes 0
    and sum_partner(n, 0) one signature by one weight (the sum meets P ==
    Q), lanes 1 and sum_partner(n, 1) a signature and its negation (P ==
    -Q), the edge weights EDGE_WEIGHTS just before the last lane, an
    infinity key at lane 2 and signature at lane 3, and a padding lane
    (infinity, weight 0) last; the later cases win at small n.  `acc`: the
    sum's accumulators."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged

    pks, sigs = base
    p = [pks[i % len(pks)] for i in range(n)]
    s = [sigs[i % len(sigs)] for i in range(n)]
    w = [rng.getrandbits(64) for _ in range(n)]
    if n >= 4:
        p[2], s[3] = cv.g1_infinity(), cv.g2_infinity()
    for t, wt in enumerate(EDGE_WEIGHTS):
        if n - 2 - t >= 0:
            w[n - 2 - t] = wt
    if n >= 4:
        p[-1], s[-1], w[-1] = cv.g1_infinity(), cv.g2_infinity(), 0
    for j, neg in ((0, False), (1, True)):
        b = sum_partner(n, j, acc)
        if b is None or b >= n:
            continue
        p[j], p[b] = pks[j], pks[j + 1]
        s[j] = sigs[j]
        s[b] = -sigs[j] if neg else sigs[j]
        w[j] = w[b] = rng.getrandbits(64) | 1
    xp, yp, pi = curve.pack_g1_affine(p)
    xs, ys, si = curve.pack_g2_affine(s)
    return tuple(t.to(dev) for t in (
        staged.to_i32(xp), staged.to_i32(yp), pi, staged.to_i32(xs),
        staged.to_i32(ys), si, _rand_words(w)))


def mask_edge_inputs(rng: random.Random, m: int, keys, sigs, dev,
                     acc: int = AGG_ACC):
    """The mask variant's inputs, m sets of len(keys) keys (curve_ref G1
    points; sigs cycled): set 0 full, its key acc a repeat of key 0 and key
    acc + 1 the negation of key 1 (the key sum meets P == Q and P == -Q);
    set 1 with masked-off keys and an infinity key; set 2 empty; set 3 an
    infinity signature; the edge weights, cycled -> (seven inputs, mask)."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged

    k = len(keys)
    rows = [[keys[(j + 37 * i) % k] for j in range(k)] for i in range(m)]
    rows[0][acc] = rows[0][0]
    rows[0][acc + 1] = -rows[0][1]
    mask = np.ones((m, k), bool)
    for i in range(1, m):
        mask[i, rng.randrange(1, k):] = False
    mask[1, 3] = False
    rows[1][5] = cv.g1_infinity()
    mask[2] = False
    s = [sigs[i % len(sigs)] for i in range(m)]
    s[3 % m] = cv.g2_infinity()
    w = [EDGE_WEIGHTS[i % len(EDGE_WEIGHTS)] | (i == 0) for i in range(m)]
    x, y, inf = curve.pack_g1_affine([q for row in rows for q in row])
    xs, ys, si = curve.pack_g2_affine(s)
    args = tuple(t.to(dev) for t in (
        staged.to_i32(x).reshape(m, k, -1), staged.to_i32(y).reshape(m, k, -1),
        inf.reshape(m, k), staged.to_i32(xs), staged.to_i32(ys), si,
        _rand_words(w)))
    return args, torch.as_tensor(mask).to(dev)


def g2_points(rng: random.Random, count: int):
    """count distinct G2 points h g2, (h + 1) g2, ... for a random h (one
    scalar multiplication on the host, then additions)."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import R

    g2 = cv.g2_generator()
    pts = [g2.mul(rng.randrange(1, R))]
    for _ in range(count - 1):
        pts.append(pts[-1] + g2)
    return pts


def each_base(rng: random.Random, count: int = 8):
    """count sets (pk, H, sig) of curve_ref points, sig = sk H for the
    key's sk, H from g2_points (a message point: any G2 point pairs alike):
    the sets k_each's edge inputs cycle."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import R

    sks = [rng.randrange(1, R) for _ in range(count)]
    g = cv.g1_generator()
    return [(g.mul(k), h, h.mul(k))
            for k, h in zip(sks, g2_points(rng, count))]


def each_edge_inputs(n: int, base, dev):
    """k_each's nine inputs at n sets cycling over base, set i by i % 5:
    valid, wrong message (another set's H), infinity key, infinity
    signature, infinity H -> (inputs, expected verdicts)."""
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged

    pks, hs, sigs, want = [], [], [], []
    for i in range(n):
        pk, h, sig = base[i % len(base)]
        kind = i % 5
        if kind == 1:
            h = base[(i + 1) % len(base)][1]
        elif kind == 2:
            pk = cv.g1_infinity()
        elif kind == 3:
            sig = cv.g2_infinity()
        elif kind == 4:
            h = cv.g2_infinity()
        pks.append(pk)
        hs.append(h)
        sigs.append(sig)
        want.append(kind == 0)
    xp, yp, pi = curve.pack_g1_affine(pks)
    xs, ys, si = curve.pack_g2_affine(sigs)
    hx, hy, hi = curve.pack_g2_affine(hs)
    to = staged.to_i32
    args = tuple(t.to(dev) for t in (to(xp), to(yp), pi, to(xs), to(ys), si,
                                     to(hx), to(hy), hi))
    return args, torch.tensor(want)


def build_layouts(out_dir: str, parent: str = None) -> dict:
    """One nvcc a layout (and the parent's two sources), all at once ->
    name: (source, library path, ptxas lines) or (source, None, nvcc's
    output) for a failed build."""
    from lighthouse_tpu_torch.runtime import build

    os.makedirs(out_dir, exist_ok=True)
    jobs = {name: (src, build.CSRC, defs)
            for name, (src, defs) in LAYOUTS.items()}
    if parent:
        pcsrc = os.path.join(parent, "lighthouse_tpu_torch", "csrc")
        jobs["parent"] = ("k_points", pcsrc, {})
        jobs["each_parent"] = ("k_each", pcsrc, {})
    procs = {}
    for name, (src, csrc, defs) in jobs.items():
        so = os.path.join(out_dir, f"lib{src}_{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc,
               *(f"-D{k}={v}" for k, v in defs.items()), "-o", so,
               os.path.join(csrc, src + ".cu")]
        procs[name] = (src, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (src, so, proc) in procs.items():
        text, _ = proc.communicate()
        out[name] = ((src, so, build._parse_ptxas(text))
                     if proc.returncode == 0 else (src, None, text[-4000:]))
    return out


def points_fn(lib, name, args, mask=None):
    """A call of lib's k_points_launch as the wrapper makes it."""
    import torch
    from lighthouse_tpu_torch.runtime import build

    xp, yp, pi, xs, ys, si, rand = args
    n, dev = xs.shape[0], xs.device

    def e(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    wx, wy, winf = e(n, 12), e(n, 12), e(n, dtype=torch.bool)
    sx, sy, sinf = e(2, 12), e(2, 12), e(1, dtype=torch.bool)
    ws = e(n, 72)
    if mask is None:
        k, keys, pk_jac, act = 0, (xp, yp, pi, None, None, None, None), \
            None, None
    else:
        k, keys = mask.shape[1], (None, None, None, xp, yp, pi, mask)
        pk_jac, act = e(n, 36), e(n, dtype=torch.bool)

    def run():
        build.call_lib(lib, name, "k_points_launch", *keys, n, k, xs, ys, si,
                       rand, wx, wy, winf, sx, sy, sinf, pk_jac, act, ws)
        return wx, wy, winf, sx, sy, sinf
    run.ws = ws
    return run


def sum_fn(lib, name, points_run):
    """lib's k_points_sum_launch (launch 3 alone) over the weighted
    signatures that points_run's last call left in its scratch."""
    import torch
    from lighthouse_tpu_torch.runtime import build

    ws = points_run.ws
    dev = ws.device
    sx = torch.empty((2, 12), dtype=torch.int32, device=dev)
    sy = torch.empty((2, 12), dtype=torch.int32, device=dev)
    sinf = torch.empty((1,), dtype=torch.bool, device=dev)

    def run():
        build.call_lib(lib, name, "k_points_sum_launch", ws, ws.shape[0], sx,
                       sy, sinf)
        return sx, sy, sinf
    return run


def each_fn(lib, name, args):
    """A call of lib's k_each_launch as the wrapper makes it."""
    import torch
    from lighthouse_tpu_torch.runtime import build

    n, dev = args[0].shape[0], args[0].device
    f_all = torch.empty((2 * n, 144), dtype=torch.int32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)

    def run():
        build.call_lib(lib, name, "k_each_launch", *args, n, f_all, ok)
        return (ok,)
    return run


def occupancy(lib) -> list:
    """Blocks an SM of a k_points library's [ladder, sum, key-sum]
    kernels (an older library without the entry: [])."""
    import ctypes

    fn = getattr(lib, "k_points_occupancy", None)
    if fn is None:
        return []
    occ = (ctypes.c_int * 3)()
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p]
    rc = fn(ctypes.cast(occ, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"k_points_occupancy: cudaError {rc}")
    return list(occ)


def accumulators(lib):
    """(SUM_ACC, AGG_ACC) of a built k_points library, or None for an older
    library without the entry."""
    import ctypes

    fn = getattr(lib, "k_points_accumulators", None)
    if fn is None:
        return None
    out = (ctypes.c_int * 2)()
    fn.restype, fn.argtypes = None, [ctypes.c_void_p]
    fn(ctypes.cast(out, ctypes.c_void_p))
    return tuple(out)


def main() -> int:
    import ctypes

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout's root: time its "
                    "k_points.cu and k_each.cu too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("points_layouts: no CUDA device", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import staged
    from lighthouse_tpu_torch.runtime import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    built = build_layouts(os.path.join(build.BUILD_ROOT, "layouts",
                                       build.source_key(), "points"),
                          args.parent)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    failed = [n for n, (_, so, _) in built.items() if so is None]
    for name, (src, so, lines) in built.items():
        if so is None:
            print(f"[build] {name} FAILED:\n{lines}", flush=True)
            continue
        for ln in lines:
            print(f"[ptxas] {name}: {ln}", flush=True)

    dev = torch.device("cuda")
    rng = random.Random(20261018)
    g1 = cv.g1_generator()
    ks = [rng.randrange(1, R) for _ in range(8)]
    base = ([g1.mul(k) for k in ks], g2_points(rng, 8))
    keys = [g1.mul(ks[0])]
    for _ in range(511):
        keys.append(keys[-1] + g1)
    ins = {"points_1": (points_edge_inputs(rng, 1, base, dev), None),
           "points_64": (points_edge_inputs(rng, 64, base, dev), None),
           "points_1024": (points_edge_inputs(rng, 1024, base, dev), None),
           "mask_4x512": mask_edge_inputs(rng, 4, keys, base[1], dev)}
    r1 = ins["points_1"][0][6].cpu().view(-1).tolist()
    w1 = (r1[0] & 0xFFFFFFFF) | ((r1[1] & 0xFFFFFFFF) << 32)
    print(f"[points_1] weight {w1:#x}: {w1.bit_length() - 1} doublings, "
          f"{bin(w1).count('1') - 1} additions", flush=True)
    eb = each_base(rng)
    each_in = {n: each_edge_inputs(n, eb, dev) for n in (64, 1024)}
    plain64 = staged.k_each_plain(*each_in[64][0])
    if not torch.equal(plain64.cpu(), each_in[64][1]):
        raise AssertionError("k_each_plain: not the expected verdicts")
    want = {s: staged.k_points_plain(*a, mask=m)
            for s, (a, m) in ins.items() if s != "points_1024"}

    res, runs = {}, {}
    for name, (src, so, lines) in built.items():
        if so is None:
            continue
        lib = ctypes.CDLL(so)
        r = res[name] = {"source": src, "ptxas": lines,
                         "defines": LAYOUTS.get(name, (src, "parent"))[1],
                         "ms": {}}
        if src == "k_points":
            r["blocks_per_sm"] = occupancy(lib)
            runs[name] = {s: points_fn(lib, name, a, m)
                          for s, (a, m) in ins.items()}
            r["equal_plain"] = all(same(runs[name][s](), want[s])
                                   for s in want)
            acc = r["accumulators"] = accumulators(lib)
            if acc not in (None, (SUM_ACC, AGG_ACC)):
                # inputs whose sums meet P == Q and P == -Q at its counts
                own = [(points_edge_inputs(rng, 64, base, dev, acc[0]),
                        None),
                       mask_edge_inputs(rng, 4, keys, base[1], dev, acc[1])]
                r["equal_plain"] &= all(
                    same(points_fn(lib, name, a, m)(),
                         staged.k_points_plain(*a, mask=m)) for a, m in own)
            if hasattr(lib, "k_points_sum_launch"):   # launch 3 alone
                for n in (64, 1024):
                    run = runs[name][f"points_{n}"]
                    run()
                    runs[name][f"sum_{n}"] = sum_fn(lib, name, run)
        else:
            runs[name] = {f"each_{n}": each_fn(lib, name, a)
                          for n, (a, _) in each_in.items()}
            r["equal_plain"] = all(
                same(runs[name][f"each_{n}"](), (w.to(dev),))
                for n, (_, w) in each_in.items())
        print(f"[layout] {name}: {r.get('blocks_per_sm')}, equal to plain "
              f"{r['equal_plain']}", flush=True)
    ref = {s: [t.clone() for t in runs[d][s]()]
           for d, shapes in (("default", ("points_1024",)),
                             ("each_default", ("each_1024",)))
           for s in shapes if d in runs}
    for name, r in res.items():
        s = "points_1024" if r["source"] == "k_points" else "each_1024"
        r["equal_default_1024"] = s in ref and same(runs[name][s](), ref[s])
        if not (r["equal_plain"] and r["equal_default_1024"]):
            failed.append(name)
    for _ in range(2):
        for name, r in res.items():
            for shape, fn in runs[name].items():
                slow = name.endswith("parent") or shape.endswith("1024")
                ms = device_ms(fn, 2 if slow else 5)
                r["ms"].setdefault(shape, []).append(round(ms, 4))
    for name, r in res.items():
        print(f"[ms] {name}: {r['ms']}", flush=True)
    print(json.dumps({"card": card, "layouts": res, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
