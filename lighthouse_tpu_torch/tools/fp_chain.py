"""Time one thread's chain of dependent Fp products on one CUDA card: the
CIOS product of csrc/bls12_381.cuh (``mul``, 64-bit C) against the PTX
carry-chain product and squaring of csrc/fp_ptx.cuh (``fmul``, ``fsqr``);
and the binary-Euclid inverse ``fp_inv_vt`` there.

A small source (below) includes the two headers and is built with nvcc
(runtime/build.py's flags) into lighthouse_tpu_torch/build/fp_chain/<source
key>/.  First every product is held against the others and against Python's
integers on random operands and the edges 0, 1, p - 1 (with each other and
with random ones): fmul(a, b) == mul(a, b) == a b R^-1 mod p and fsqr(a) ==
mul(a, a), and fp_inv_vt(a) == a^-1 R^2 mod p (0 at 0), word for word.
Then one thread (one block) runs CHAIN dependent products x <- x y (or
x <- x^2), timed with CUDA events (median of 5 launches after a warm-up),
for: mul, fmul, mul as a squaring, fsqr, and three independent fmul chains
in one thread (the shape of an Fp2 product; its time is a step of three);
and INV_CHAIN dependent inverses x <- 1/x + y (a step's time depends on
its operand: the mean over random ones).  Prints the card line, the
microseconds a step and one JSON line; exits 1 if a result disagreed.

    python3 -m lighthouse_tpu_torch.tools.fp_chain
"""
from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

CHAIN = 10_000
INV_CHAIN = 1_000

SOURCE = r"""
#include <cuda_runtime.h>
#include "fp_ptx.cuh"

// out[5 i ..]: fmul(a, b), mul(a, b), fsqr(a), mul(a, a), fp_inv_vt(a)
// of pair i.
extern "C" __global__ void fc_check(const uint32_t* a, const uint32_t* b,
                                    uint32_t* out, int m) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  fp_t x, y, r;
  load(x, a + 12 * i);
  load(y, b + 12 * i);
  fmul(r, x, y);
  store(out + 60 * i, r);
  mul(r, x, y);
  store(out + 60 * i + 12, r);
  fsqr(r, x);
  store(out + 60 * i + 24, r);
  mul(r, x, x);
  store(out + 60 * i + 36, r);
  fp_inv_vt(r, x);
  store(out + 60 * i + 48, r);
}

template <int K>
__global__ void fc_chain(const uint32_t* a, const uint32_t* b, uint32_t* out,
                         int n) {
  fp_t x, y, x1, x2;
  load(x, a);
  load(y, b);
  x1 = y;
  x2 = x;
#pragma unroll 1
  for (int i = 0; i < n; i++) {
    if (K == 0) mul(x, x, y);
    if (K == 1) fmul(x, x, y);
    if (K == 2) mul(x, x, x);
    if (K == 3) fsqr(x, x);
    if (K == 4) {
      fmul(x, x, y);
      fmul(x1, x1, y);
      fmul(x2, x2, y);
    }
    if (K == 5) {
      fp_inv_vt(x, x);
      add(x, x, y);
    }
  }
  if (K == 4) {
    add(x, x, x1);
    add(x, x, x2);
  }
  store(out, x);
}

extern "C" int fc_check_launch(const void* a, const void* b, void* out,
                               int m) {
  fc_check<<<(m + 63) / 64, 64>>>((const uint32_t*)a, (const uint32_t*)b,
                                   (uint32_t*)out, m);
  return (int)cudaGetLastError();
}

extern "C" int fc_chain_launch(int kind, const void* a, const void* b,
                               void* out, int n) {
  const uint32_t *pa = (const uint32_t*)a, *pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  switch (kind) {
    case 0: fc_chain<0><<<1, 1>>>(pa, pb, po, n); break;
    case 1: fc_chain<1><<<1, 1>>>(pa, pb, po, n); break;
    case 2: fc_chain<2><<<1, 1>>>(pa, pb, po, n); break;
    case 3: fc_chain<3><<<1, 1>>>(pa, pb, po, n); break;
    case 4: fc_chain<4><<<1, 1>>>(pa, pb, po, n); break;
    default: fc_chain<5><<<1, 1>>>(pa, pb, po, n); break;
  }
  return (int)cudaGetLastError();
}
"""

KINDS = ("mul", "fmul", "mul_sqr", "fsqr", "fmul_x3", "inv_vt")


def build(out_dir: str):
    """nvcc of SOURCE -> (library path, ptxas lines)."""
    from lighthouse_tpu_torch.runtime import build as b

    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "fp_chain.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    so = os.path.join(out_dir, "libfp_chain.so")
    proc = subprocess.run(
        [b.nvcc_path(), *b.NVCC_FLAGS, "-I", b.CSRC, "-o", so, src],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    return so, b._parse_ptxas(proc.stdout + proc.stderr)


def operands(rng: random.Random, m: int):
    """m operand pairs: the edges 0, 1, p - 1 with each other and with
    random values, then random pairs (all below p)."""
    from lighthouse_tpu_torch.crypto.bls.constants import P

    edges = [0, 1, P - 1]
    pairs = [(a, b) for a in edges for b in edges]
    pairs += [(a, rng.randrange(P)) for a in edges]
    pairs += [(rng.randrange(P), b) for b in edges]
    while len(pairs) < m:
        pairs.append((rng.randrange(P), rng.randrange(P)))
    return pairs


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("fp_chain: no CUDA device", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.cuda import fp
    from lighthouse_tpu_torch.runtime import build as b

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    so, ptxas = build(os.path.join(b.BUILD_ROOT, "fp_chain", b.source_key()))
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for ln in ptxas:
        print(f"[ptxas] {ln}", flush=True)
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.fc_check_launch.argtypes = [vp, vp, vp, ctypes.c_int]
    lib.fc_chain_launch.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int]
    lib.fc_check_launch.restype = lib.fc_chain_launch.restype = ctypes.c_int

    rng = random.Random(20261018)
    pairs = operands(rng, 4096)
    dev = torch.device("cuda")

    def limbs(vals):
        return torch.tensor([fp.int_to_limbs(v) for v in vals],
                            dtype=torch.int64).to(torch.int32).to(dev)

    a = limbs([p[0] for p in pairs])
    bb = limbs([p[1] for p in pairs])
    out = torch.empty((len(pairs), 60), dtype=torch.int32, device=dev)
    rc = lib.fc_check_launch(a.data_ptr(), bb.data_ptr(), out.data_ptr(),
                             len(pairs))
    if rc:
        raise RuntimeError(f"fc_check: cudaError {rc}")
    words = out.cpu().to(torch.int64) & 0xFFFFFFFF
    rinv = pow(1 << 384, -1, P)
    r2 = pow(1 << 384, 2, P)
    bad = []
    for i, (x, y) in enumerate(pairs):
        got = [sum(int(words[i, 12 * j + k]) << (32 * k) for k in range(12))
               for j in range(5)]
        want = [x * y * rinv % P, x * y * rinv % P, x * x * rinv % P,
                x * x * rinv % P, pow(x, -1, P) * r2 % P if x else 0]
        if got != want:
            bad.append(i)
    print(f"[check] {len(pairs)} operand pairs, fmul / mul / fsqr / mul "
          f"squaring / fp_inv_vt disagree on {len(bad)}", flush=True)

    x0 = limbs([rng.randrange(P)])
    y0 = limbs([rng.randrange(P)])
    res = torch.empty((1, 12), dtype=torch.int32, device=dev)
    us = {}
    for kind, name in enumerate(KINDS):
        steps = INV_CHAIN if name == "inv_vt" else CHAIN
        times = []
        for rep in range(6):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            rc = lib.fc_chain_launch(kind, x0.data_ptr(), y0.data_ptr(),
                                     res.data_ptr(), steps)
            e1.record()
            e1.synchronize()
            if rc:
                raise RuntimeError(f"fc_chain {name}: cudaError {rc}")
            if rep:                    # the first launch is the warm-up
                times.append(e0.elapsed_time(e1))
        us[name] = statistics.median(times) * 1e3 / steps
        what = {"fmul_x3": "a step of three independent products",
                "inv_vt": "an inverse"}.get(name, "a product")
        print(f"[chain] {name}: {us[name]:.4f} us {what} ({steps} "
              "dependent steps, one thread)", flush=True)
    print(json.dumps({"card": card, "chain": CHAIN, "us_per_step": us,
                      "check_pairs": len(pairs), "check_bad": len(bad),
                      "ptxas": ptxas}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
