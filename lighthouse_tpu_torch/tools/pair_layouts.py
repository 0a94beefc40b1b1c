"""Compare block layouts of the cooperative pairing kernels of
csrc/k_pair.cu on one CUDA card.

Each layout builds k_pair.cu with nvcc and its -D MILLER_THREADS,
MILLER_PROD_THREADS and FIN_THREADS (every build at once, one nvcc each)
into lighthouse_tpu_torch/build/layouts/<source key>/; "default" takes the
source's own values.  Every layout's k_pair at 64 + 1 lanes,
k_pair_partial at 32 + 1 lanes and k_pair_combine of 2 partials must equal
the plain versions word for word, and its k_pair at 1,024 + 1 lanes the
default layout's.  Then each is timed at those shapes (CUDA events around
back-to-back launches behind a sleep kernel, median of 3 batches; the
layouts interleaved, two passes).  Prints each layout's ptxas lines and
blocks an SM, then one JSON line of the results; exits 1 if a layout
failed to build or disagreed.

    python3 -m lighthouse_tpu_torch.tools.pair_layouts
"""
from __future__ import annotations

import ctypes
import json
import os
import random
import statistics
import subprocess
import sys
import time

# name -> -D values; "default" is what k_pair.cu ships.
LAYOUTS = {
    "default": {},
    "miller_1warp": {"MILLER_THREADS": 32, "MILLER_PROD_THREADS": 32},
    "miller_2warp_split": {"MILLER_THREADS": 64, "MILLER_PROD_THREADS": 32},
    "miller_2warp": {"MILLER_THREADS": 64, "MILLER_PROD_THREADS": 64},
    "fin_224": {"FIN_THREADS": 224},
}
SHAPES = ("k_pair_65", "k_pair_1025", "partial_33", "combine_2")


def build_layouts(out_dir: str) -> dict:
    """One nvcc a layout, all at once -> name: (library path, ptxas lines)
    or (None, nvcc's output) for a failed build."""
    from lighthouse_tpu_torch.runtime import build

    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(build.CSRC, "k_pair.cu")
    procs = {}
    for name, defs in LAYOUTS.items():
        so = os.path.join(out_dir, f"libk_pair_{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
               *(f"-D{k}={v}" for k, v in defs.items()), "-o", so, src]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        out[name] = ((so, build._parse_ptxas(text)) if proc.returncode == 0
                     else (None, text[-4000:]))
    return out


def device_ms(fn, reps: int, batches: int = 3) -> float:
    """Device time of one call: the median over batches of the mean of
    reps back-to-back calls between CUDA events, queued behind a sleep
    kernel so the host's enqueue falls outside them."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles, out = 1 << 25, []
    while len(out) < batches:
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        s0.record()
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if host_ms >= s0.elapsed_time(a):
            cycles <<= 1
            continue
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def pair_inputs(rng: random.Random, n: int, dev, base):
    """n lanes cycling over the base pairs (k g1, H(m)) and the closing sum
    S of their signatures: a valid batch."""
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged

    sks, pks, hs = base
    idx = [i % len(pks) for i in range(n)]
    xp, yp, _ = curve.pack_g1_affine([pks[j] for j in idx])
    xq, yq, _ = curve.pack_g2_affine([hs[j] for j in idx])
    s = cv.g2_infinity()
    for j, h in enumerate(hs):
        s = s + h.mul(idx.count(j) * sks[j])
    sx, sy, sinf = curve.pack_g2_affine([s])
    f = torch.zeros(n, dtype=torch.bool)
    return tuple(t.to(dev) for t in (
        staged.to_i32(xp), staged.to_i32(yp), f, staged.to_i32(xq),
        staged.to_i32(yq), f.clone(), staged.to_i32(sx)[0],
        staged.to_i32(sy)[0], sinf))


def occupancy(lib: ctypes.CDLL) -> list:
    """Blocks an SM of a k_pair library's [Miller, final] kernels, as the
    CUDA runtime computes them from registers and shared memory."""
    occ = (ctypes.c_int * 2)()
    fn = lib.k_pair_occupancy
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p]
    rc = fn(ctypes.cast(occ, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"k_pair_occupancy: cudaError {rc}")
    return list(occ)


class Layout:
    """One layout's library: the three entries with their outputs."""

    def __init__(self, name: str, so: str):
        self.name, self.lib = name, ctypes.CDLL(so)

    def occupancy(self) -> list:
        return occupancy(self.lib)

    def pair_fn(self, a):
        import torch
        from lighthouse_tpu_torch.runtime import build

        n, dev = a[0].shape[0], a[0].device
        f_all = torch.empty((n + 1, 144), dtype=torch.int32, device=dev)
        ok = torch.empty((1,), dtype=torch.bool, device=dev)
        gt = torch.empty((2, 3, 2, 12), dtype=torch.int32, device=dev)

        def run():
            build.call_lib(self.lib, self.name, "k_pair_launch", *a, n,
                           f_all, ok, gt)
            return ok, gt
        return run

    def partial_fn(self, a):
        import torch
        from lighthouse_tpu_torch.runtime import build

        n, dev = a[0].shape[0], a[0].device
        f_all = torch.empty((n + 1, 144), dtype=torch.int32, device=dev)
        out = torch.empty((2, 3, 2, 12), dtype=torch.int32, device=dev)

        def run():
            build.call_lib(self.lib, self.name, "k_pair_partial_launch", *a,
                           n, 1, f_all, out)
            return (out,)
        return run

    def combine_fn(self, parts):
        import torch
        from lighthouse_tpu_torch.runtime import build

        dev = parts.device
        ok = torch.empty((1,), dtype=torch.bool, device=dev)
        gt = torch.empty((2, 3, 2, 12), dtype=torch.int32, device=dev)

        def run():
            build.call_lib(self.lib, self.name, "k_pair_combine_launch",
                           parts, parts.shape[0], ok, gt)
            return ok, gt
        return run


def same(xs, ys) -> bool:
    import torch

    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(xs, ys))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pair_layouts: no CUDA device", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import staged
    from lighthouse_tpu_torch.runtime import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    built = build_layouts(os.path.join(build.BUILD_ROOT, "layouts",
                                       build.source_key()))
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    failed = [n for n, (so, _) in built.items() if so is None]
    for name, (so, lines) in built.items():
        if so is None:
            print(f"[build] {name} FAILED:\n{lines}", flush=True)
            continue
        for ln in lines:
            print(f"[ptxas] {name}: {ln}", flush=True)

    dev = torch.device("cuda")
    rng = random.Random(20261018)
    sks = [rng.randrange(1, R) for _ in range(8)]
    g = cv.g1_generator()
    base = (sks, [g.mul(k) for k in sks],
            [hr.hash_to_g2(bytes(rng.randrange(256) for _ in range(32)))
             for _ in range(8)])
    a65, a1025, a33 = (pair_inputs(rng, n, dev, base) for n in (64, 1024, 32))
    want65 = staged.k_pair_plain(*a65)
    if not bool(want65[0]):
        raise AssertionError("the 64-lane batch is not valid")
    want33 = (staged.k_pair_partial_plain(*a33, closing=True),)
    half = tuple(t[:16] for t in a33[:6])
    parts = torch.stack([want33[0], staged.k_pair_partial_plain(*half)])
    want2 = staged.k_pair_combine_plain(parts)

    layouts = [Layout(n, so) for n, (so, _) in built.items() if so]
    res, runs = {}, {}
    for lay in layouts:
        r = res[lay.name] = {"defines": LAYOUTS[lay.name],
                             "blocks_per_sm": lay.occupancy(),
                             "ptxas": built[lay.name][1],
                             "ms": {s: [] for s in SHAPES}}
        runs[lay.name] = {"k_pair_65": lay.pair_fn(a65),
                          "k_pair_1025": lay.pair_fn(a1025),
                          "partial_33": lay.partial_fn(a33),
                          "combine_2": lay.combine_fn(parts)}
        fns = runs[lay.name]
        r["equal_plain"] = (same(fns["k_pair_65"](), want65)
                            and same(fns["partial_33"](), want33)
                            and same(fns["combine_2"](), want2))
        print(f"[layout] {lay.name}: blocks an SM (miller, final) "
              f"{r['blocks_per_sm']}, equal to plain {r['equal_plain']}",
              flush=True)
    ref1025 = [t.clone() for t in runs["default"]["k_pair_1025"]()]
    for lay in layouts:
        r = res[lay.name]
        r["equal_default_1025"] = same(runs[lay.name]["k_pair_1025"](),
                                       ref1025)
        if not (r["equal_plain"] and r["equal_default_1025"]):
            failed.append(lay.name)
    for _ in range(2):
        for lay in layouts:
            for shape in SHAPES:
                reps = 3 if shape == "k_pair_1025" else 10
                ms = device_ms(runs[lay.name][shape], reps)
                res[lay.name]["ms"][shape].append(round(ms, 4))
    for lay in layouts:
        print(f"[ms] {lay.name}: {res[lay.name]['ms']}", flush=True)
    print(json.dumps({"card": card, "layouts": res, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
