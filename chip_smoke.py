#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batch BLS verification on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; the script then exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the four kernels from lighthouse_tpu_torch/csrc with nvcc
     (sm_90a), print build seconds and ptxas register/spill lines;
  3. each kernel against its plain PyTorch version on the card, same inputs
     (n = 8 lanes with padding, infinity and P == Q cases; the mask variant
     with 8 sets of up to 512 keys): bit-exact on every output;
  4. the main path, with every launch counter set to 0 just before:
     crypto.bls.verify_signature_sets on a 64-set gossip batch (True) and
     its swapped twin (False), 4 sets of 48-byte messages (host XMD, True),
     a 512-key sync aggregate plus 3 single sets
     (True) and its tampered twin (False), the empty batch (False), and
     every case of tests/vectors/bls.json and bls_adversarial.json; every
     kernel must have launched;
  5. at the main path's shapes (n = 64; 4 sets x 512 keys): each kernel
     against its plain version again (bit-exact), the kernel's device time
     (back-to-back launches queued behind a sleep kernel, CUDA events), the
     plain version's time, and each kernel's bound: the larger of its
     bytes over the HBM rate and the least work of its function on this
     run's data (see op_model) over the card's 32-bit integer rate (64 per
     clock per SM at the card's maximum SM clock).
The line before the card line is the kernels' JSON; the last line is
{"ok": true, "device": {...}}.  Keys and messages come from --seed.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

REPLACES = {
    "k_xmd": "lighthouse_tpu/crypto/bls/tpu/staged.py:58",
    "k_hash": "lighthouse_tpu/crypto/bls/tpu/staged.py:51",
    "k_points": "lighthouse_tpu/crypto/bls/tpu/staged.py:89",
    "k_pair": "lighthouse_tpu/crypto/bls/tpu/staged.py:104",
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- Bounds: the least work each kernel's function needs --------------------
#
# Operations are 32-bit integer instructions (multiply-add, add, logic,
# shift), which compute capability 9.0 issues at 64 per clock per SM (CUDA
# C++ Programming Guide, arithmetic instruction throughput).  Each function
# is counted with the cheapest standard algorithms we know for it, not with
# the kernels' own: an Fp product is 12 x 12 limb products for a*b and as
# many for the Montgomery reduction (M = 288), an Fp squaring 12 * 13 / 2 + 144
# (S = 222).  Where the work depends on the data (the weights' bits,
# infinity lanes, the SSWU branch) this run's inputs are counted.

M, S = 288, 222
M2, S2 = 3 * M, 2 * M               # Fp2 product (Karatsuba), squaring
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
SHA_ROUND, SHA_SCHED = 14, 10       # with 3-input LOP3 / IADD3
SHA_VAR = 64 * SHA_ROUND + 48 * SHA_SCHED + 8
SHA_CONST = 64 * SHA_ROUND + 8      # a block of constant words: W + K known


def io_bytes(inputs, outputs) -> int:
    """Bytes a call must move: each input read once, each output written
    once."""
    return sum(t.numel() * t.element_size() for t in (*inputs, *outputs))


def _windows(e: int, w: int) -> int:
    """Windows of a left-to-right sliding-window exponentiation."""
    bits, i, n = bin(e)[2:], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        n, i = n + 1, j
    return n


def chain_mults(e: int) -> int:
    """Products of the best sliding window for e (the table included)."""
    return min((2 ** (w - 1) if w > 1 else 0) + _windows(e, w) - 1
               for w in range(1, 8))


def naf_adds(r: int) -> int:
    """Additions of the best width-w NAF ladder for r (table included)."""
    best = None
    for w in range(2, 7):
        v, nz = r, 0
        while v:
            if v & 1:
                d = v % (1 << w)
                d -= (1 << w) if d >= 1 << (w - 1) else 0
                v, nz = v - d, nz + 1
            v >>= 1
        cost = nz - 1 + (2 ** (w - 2) if w > 2 else 0)
        best = cost if best is None else min(best, cost)
    return best


def op_model():
    """Costs in 32-bit instructions of the pieces the functions need."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.cuda import pairing

    def fp_exp(e):
        return (e.bit_length() - 1) * S + chain_mults(e) * M

    c = {"inv": fp_exp(P - 2)}              # one, shared by a batch
    c["inv_share"] = 3 * M                  # Montgomery's trick, a lane
    c["inv2_share"] = 2 * S + c["inv_share"] + 2 * M
    c["inv2"] = c["inv2_share"] + c["inv"]
    # Fp2 sqrt by the norm: sqrt of a0^2 + a1^2 in Fp, then one inverse
    # square root of (a0 + alpha) / 2 gives both coordinates
    c["sqrt2"] = fp_exp((P + 1) // 4) + fp_exp((P - 3) // 4) + 2 * S + 4 * M
    f6m, f6s = 6 * M2, 2 * M2 + 3 * S2
    c["f12m"], c["f12s"] = 3 * f6m, 2 * f6m
    c["sparse"] = 13 * M2                   # line times Fp12
    c["cyc"] = 9 * S2                       # Granger-Scott
    c["frob"], c["frob2"] = 5 * M2, 10 * M
    f6inv = 3 * S2 + 9 * M2 + c["inv2"]
    c["f12inv"] = 2 * f6s + f6inv + 2 * f6m
    c["dbl1"], c["madd1"], c["add1"] = 2 * M + 5 * S, 7 * M + 4 * S, \
        11 * M + 5 * S
    c["dbl2"], c["madd2"], c["add2"] = 2 * M2 + 5 * S2, 7 * M2 + 4 * S2, \
        11 * M2 + 5 * S2
    ax = pairing.ABS_X

    def cycpow(e):
        return (e.bit_length() - 1) * c["cyc"] + chain_mults(e) * c["f12m"]

    c["final_exp"] = (c["f12inv"] + 6 * c["f12m"] + 2 * c["frob2"]
                      + c["frob"] + cycpow(pairing.E1) + 3 * cycpow(ax))
    # shared-accumulator multi-Miller loop: one f^2 a step for all lanes
    c["x_dbls"], c["x_adds"] = ax.bit_length() - 1, bin(ax).count("1") - 1
    c["dbl_line"] = 3 * M2 + 6 * S2 + 4 * M       # affine P, homogeneous T
    c["add_line"] = 11 * M2 + 2 * S2 + 4 * M
    c["miller_f"] = (c["x_dbls"] - 1) * c["f12s"]
    c["miller_lane"] = (c["x_dbls"] * (c["dbl_line"] + c["sparse"])
                        + c["x_adds"] * (c["add_line"] + c["sparse"]))
    # SSWU of one u (x1 from the batched inverse), isogeny to Jacobian
    c["sswu"] = 2 * S2 + c["inv2_share"] + M2 + (S2 + M2) + c["sqrt2"]
    c["sswu_nonsq"] = 3 * M2                      # x2 and g(x2)
    c["iso"] = 2 * S2 + 16 * M2
    mul_x = c["x_dbls"] * c["dbl2"] + c["x_adds"] * c["add2"]
    c["clear"] = 2 * mul_x + c["dbl2"] + 2 * M2 + 4 * M + 5 * c["add2"]
    c["aff1_share"] = c["inv_share"] + S + 3 * M
    c["aff2_share"] = c["inv2_share"] + S2 + 3 * M2
    return c


def k_xmd_ops(n: int) -> int:
    """expand_message_xmd of a 32-byte root to 256 bytes: the Z_pad block's
    state is a constant, so 9 compressions of message-dependent words and
    9 of constant words (the DST tails); 8 x 8 XORs; 4 chunks mod p."""
    return n * (9 * SHA_VAR + 9 * SHA_CONST + 64 + 4 * M)


def k_hash_ops(c, u_plain_rows) -> int:
    """Two maps a message (SSWU, the non-square branch where this run's u
    takes it, 3-isogeny), their sum, cofactor clearing (Budroni-Pintore),
    affine; one batched inversion for the SSWU denominators and one for
    the Z's."""
    from lighthouse_tpu_torch.crypto.bls import fields_ref as fr
    from lighthouse_tpu_torch.crypto.bls.constants import (
        ISO3_A, ISO3_B, ISO3_Z)

    A, B, Z = fr.Fp2(*ISO3_A), fr.Fp2(*ISO3_B), fr.Fp2(*ISO3_Z)
    total = 2 * c["inv"]
    for u0, u1 in u_plain_rows:
        for u in (u0, u1):
            zu2 = Z * fr.Fp2(*u).square()
            tv = zu2.square() + zu2
            x1 = (-B) * A.inv() * (fr.Fp2.one() + tv.inv())
            total += c["sswu"] + c["iso"]
            if not ((x1.square() + A) * x1 + B).is_square():
                total += c["sswu_nonsq"]
        total += c["add2"] + c["clear"] + c["aff2_share"]
    return total


def _msm_g2(c, weights) -> int:
    """sum_i [r_i] sig_i over affine sig_i: the cheaper of Pippenger's
    buckets and one ladder a lane plus the sum."""
    if not weights:
        return 0
    ladders = sum((r.bit_length() - 1) * c["dbl2"] + naf_adds(r) * c["madd2"]
                  for r in weights) + (len(weights) - 1) * c["add2"]
    best = ladders
    bits = max(r.bit_length() for r in weights)
    for w in range(1, 17):
        nwin = -(-bits // w)
        cost = (nwin - 1) * (w * c["dbl2"] + c["add2"])
        for j in range(nwin):
            nz = sum(1 for r in weights if (r >> (j * w)) & ((1 << w) - 1))
            cost += nz * c["madd2"] + 2 * ((1 << w) - 1) * c["add2"]
        best = min(best, cost)
    return best


def k_points_ops(c, rand_words, pinf, sinf, active_keys=None) -> int:
    """G1: one width-w NAF ladder a lane with a key and a nonzero weight;
    G2: the weighted signature sum; one batched inversion for the affine
    outputs; the mask variant first sums each set's keys."""
    weights = [(lo & 0xFFFFFFFF) | ((hi & 0xFFFFFFFF) << 32)
               for lo, hi in rand_words]
    total = c["inv"] + c["aff2_share"]
    for i, r in enumerate(weights):
        if r and not pinf[i]:
            total += ((r.bit_length() - 1) * c["dbl1"]
                      + naf_adds(r) * c["madd1"] + c["aff1_share"])
    total += _msm_g2(c, [r for i, r in enumerate(weights)
                         if r and not sinf[i]])
    if active_keys is not None:
        total += sum(max(k - 1, 0) for k in active_keys) * c["madd1"]
    return total


def k_pair_ops(c, active_lanes: int) -> int:
    """Shared-accumulator multi-Miller loop over the lanes with both points
    finite, then the final exponentiation of the exact GT value."""
    miller = (c["miller_f"] + active_lanes * c["miller_lane"]
              if active_lanes else 0)
    return miller + c["final_exp"]


# --- Inputs -------------------------------------------------------------------


def gen_keys(rng: random.Random, n: int):
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import R

    sks = [rng.randrange(1, R) for _ in range(n)]
    g = cv.g1_generator()
    return sks, [g.mul(s) for s in sks]


def consecutive_keys(rng: random.Random, k: int):
    """k keys sk0, sk0+1, ...: points by repeated addition (cheap)."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import R

    sk0 = rng.randrange(1, R - k - 1)
    g = cv.g1_generator()
    pts = [g.mul(sk0)]
    for _ in range(k - 1):
        pts.append(pts[-1] + g)
    return [sk0 + j for j in range(k)], pts


def timed(fn) -> float:
    """ms of one run of fn on the card, host time in the call included
    (CUDA events around it): for the plain versions, whose time is mostly
    the host launching their many small ops."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def device_ms(fn, reps: int, batches: int = 3) -> float:
    """Device time of one call of fn: the median over `batches` of the
    mean of `reps` back-to-back calls between two CUDA events.  A sleep
    kernel holds the stream while the host enqueues the batch, so the
    wrapper's host work (checks, allocation, ctypes) falls outside the
    events; a batch whose enqueue outlasted the sleep is run again with a
    longer sleep."""
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
            if cycles >= 1 << 36:
                raise RuntimeError("device_ms: enqueue outlasts any sleep")
            cycles <<= 1
            continue
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(xs, ys) -> int:
    import torch

    err = 0
    for x, y in zip(xs, ys):
        x64 = x.to(torch.int64).cpu()
        y64 = y.to(torch.int64).cpu()
        if x64.shape != y64.shape:
            raise AssertionError(
                f"shape {tuple(x64.shape)} != {tuple(y64.shape)}")
        if x64.numel():
            err = max(err, int((x64 - y64).abs().max()))
    return err


# --- Phases -------------------------------------------------------------------


def phase_kernels_vs_plain(rng, dev):
    """Each kernel and its plain version on identical inputs on the card."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    n = 8
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]
    words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)).to(dev)
    u = staged.k_xmd(words)
    out = {"k_xmd": max_abs_err([u], [staged.k_xmd_plain(words)])}
    h = staged.k_hash(u)
    out["k_hash"] = max_abs_err(h, staged.k_hash_plain(u))
    ref_h = [hr.hash_to_g2(m) for m in msgs[:2]]
    got_h = curve.unpack_g2_affine(staged.to_i64(h[0][:2].cpu()),
                                   staged.to_i64(h[1][:2].cpu()),
                                   h[2][:2].cpu())
    if got_h != ref_h:
        raise AssertionError("k_hash disagrees with hash_to_curve_ref")

    sks, pks = gen_keys(rng, n)
    pks[6] = cv.g1_infinity()                       # padding lane
    sigs = [hr.hash_to_g2(msgs[0]).mul(s) for s in sks]
    sigs[3] = sigs[2]                               # P == Q in the sum
    sigs[6] = cv.g2_infinity()
    rand = np.array([[rng.getrandbits(32) | 1, rng.getrandbits(32)]
                     for _ in range(n)], np.uint32)
    rand[3] = rand[2]
    rand[6] = 0
    xp, yp, pi = curve.pack_g1_affine(pks)
    xs, ys, si = curve.pack_g2_affine(sigs)
    args = [staged.to_i32(xp).to(dev), staged.to_i32(yp).to(dev), pi.to(dev),
            staged.to_i32(xs).to(dev), staged.to_i32(ys).to(dev), si.to(dev),
            torch.as_tensor(rand.view(np.int32)).to(dev)]
    pts = staged.k_points(*args)
    out["k_points"] = max_abs_err(pts, staged.k_points_plain(*args))

    # Mask variant: 8 sets of up to 512 keys, one set empty, masked-off
    # keys, an infinity key.
    k = 512
    _, kp = consecutive_keys(rng, k)
    mask = np.zeros((n, k), bool)
    for i in range(n):
        mask[i, : (k if i % 2 == 0 else rng.randrange(1, k))] = True
    mask[5] = False
    mask[1, 7] = False
    flat = [kp[(j + 37 * i) % k] for i in range(n) for j in range(k)]
    flat[2 * k + 3] = cv.g1_infinity()
    x, y, inf = curve.pack_g1_affine(flat)
    margs = [staged.to_i32(x.reshape(n, k, -1)).to(dev),
             staged.to_i32(y.reshape(n, k, -1)).to(dev),
             inf.reshape(n, k).to(dev)] + args[3:] + [
                 torch.as_tensor(mask).to(dev)]
    mp = staged.k_points(*margs[:7], mask=margs[7])
    out["k_points_mask"] = max_abs_err(mp, staged.k_points_plain(
        *margs[:7], mask=margs[7]))

    pair_in = (pts[0], pts[1], pts[2], h[0], h[1], h[2], pts[3], pts[4],
               pts[5])
    kr = staged.k_pair(*pair_in)
    out["k_pair"] = max_abs_err(kr, staged.k_pair_plain(*pair_in))
    torch.cuda.synchronize()
    for name, err in out.items():
        log(f"[vs plain] {name}: max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    return out


def make_sets(rng, bls, n, msg_len=32):
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr

    sks, pks = gen_keys(rng, n)
    sets = []
    for sk, pk in zip(sks, pks):
        m = bytes(rng.randrange(256) for _ in range(msg_len))
        sig = bls.Signature(hr.hash_to_g2(m).mul(sk))
        sets.append(bls.SignatureSet(sig, [bls.PublicKey(pk)], m))
    return sets


def make_sync_aggregate(rng, bls, k=512):
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
    from lighthouse_tpu_torch.crypto.bls.constants import R

    sks, pts = consecutive_keys(rng, k)
    m = bytes(rng.randrange(256) for _ in range(32))
    agg = bls.AggregateSignature(hr.hash_to_g2(m).mul(sum(sks) % R))
    return bls.SignatureSet(agg, [bls.PublicKey(p) for p in pts], m)


def replay_vectors(bls):
    """Every verify case of bls.json and bls_adversarial.json; returns the
    number of cases checked."""
    vec = os.path.join(HERE, "tests", "vectors")
    with open(os.path.join(vec, "bls.json")) as f:
        doc = json.load(f)
    checked = 0

    def sets_of(raw):
        return [bls.SignatureSet(
            bls.Signature.from_bytes(bytes.fromhex(s["signature"])),
            [bls.PublicKey.from_bytes(bytes.fromhex(h)) for h in s["pubkeys"]],
            bytes.fromhex(s["message"])) for s in raw]

    for case in doc["batch_verify"]:
        got = bls.verify_signature_sets(sets_of(case["sets"]))
        if got != case["valid"]:
            raise AssertionError(f"bls.json batch_verify: {got}")
        checked += 1
    fav = doc["fast_aggregate_verify"]
    agg = bls.AggregateSignature.from_bytes(bytes.fromhex(fav["aggregate"]))
    pks = [bls.PublicKey.from_bytes(bytes.fromhex(h)) for h in fav["pubkeys"]]
    got = bls.get_backend().fast_aggregate_verify(
        agg, bytes.fromhex(fav["message"]), pks)
    if got != fav["valid"]:
        raise AssertionError(f"bls.json fast_aggregate_verify: {got}")
    checked += 1
    av = doc["aggregate_verify"]
    agg = bls.AggregateSignature.from_bytes(bytes.fromhex(av["aggregate"]))
    pks = [bls.PublicKey.from_bytes(bytes.fromhex(h)) for h in av["pubkeys"]]
    got = bls.get_backend().aggregate_verify(
        agg, [bytes.fromhex(m) for m in av["messages"]], pks)
    if got != av["valid"]:
        raise AssertionError(f"bls.json aggregate_verify: {got}")
    checked += 1
    for s in doc["sign"]:
        sig = bls.Signature.from_bytes(bytes.fromhex(s["signature"]))
        pk = bls.PublicKey.from_bytes(bytes.fromhex(s["pubkey"]))
        if not sig.verify(pk, bytes.fromhex(s["message"])):
            raise AssertionError("bls.json sign vector does not verify")
        checked += 1

    with open(os.path.join(vec, "bls_adversarial.json")) as f:
        cases = json.load(f)["cases"]
    for case in cases:
        expect = case["expect"]
        try:
            sets = sets_of(case["sets"])
        except bls.BlsError as e:
            kind = ("invalid_pubkey" if "public key" in str(e)
                    else "invalid_signature")
            if expect != kind:
                raise AssertionError(f"{case['name']}: {kind}, want {expect}")
            checked += 1
            continue
        if expect in ("invalid_pubkey", "invalid_signature"):
            raise AssertionError(f"{case['name']}: decoded, want {expect}")
        got = bls.verify_signature_sets(sets)
        if got != (expect == "valid"):
            raise AssertionError(f"{case['name']}: verify={got}, want {expect}")
        checked += 1
    return checked


def phase_main_path(rng, bls, staged):
    """Through crypto.bls.verify_signature_sets, counters from 0."""
    gossip = make_sets(rng, bls, 64)
    swapped = list(gossip)
    swapped[10] = bls.SignatureSet(gossip[11].signature, gossip[10].pubkeys,
                                   gossip[10].message)
    sync = make_sync_aggregate(rng, bls)
    singles = make_sets(rng, bls, 3)
    tampered = bls.SignatureSet(sync.signature, sync.pubkeys,
                                bytes(b ^ 1 for b in sync.message))

    odd = make_sets(rng, bls, 4, msg_len=48)        # host XMD path

    staged.reset_launches()
    t0 = time.perf_counter()
    results = {
        "gossip_64": bls.verify_signature_sets(gossip),
        "host_xmd_4": bls.verify_signature_sets(odd),
        "gossip_64_swapped": bls.verify_signature_sets(swapped),
        "sync_512_plus_3": bls.verify_signature_sets([sync] + singles),
        "sync_512_tampered": bls.verify_signature_sets([tampered] + singles),
        "empty": bls.verify_signature_sets([]),
    }
    results["vector_cases"] = replay_vectors(bls)
    launches = staged.launch_counts()
    seconds = time.perf_counter() - t0
    want = {"gossip_64": True, "host_xmd_4": True,
            "gossip_64_swapped": False,
            "sync_512_plus_3": True, "sync_512_tampered": False,
            "empty": False}
    for key, expect in want.items():
        log(f"[main path] {key}: {results[key]} (want {expect})")
        if results[key] is not expect:
            raise AssertionError(f"{key}: got {results[key]}")
    log(f"[main path] vector cases passed: {results['vector_cases']}")
    log(f"[main path] launches: {launches} ({seconds:.1f} s)")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return gossip, sync, singles, launches


def phase_timing(rng, bls, staged, gossip, sync, singles, dev, card):
    """At the main path's shapes (n = 64; the mask variant 4 sets x 512
    keys): each kernel against its plain version (bit-exact), the kernel's
    device time, the plain version's time and the bounds."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, fp
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    be = bls.get_backend()
    n = len(gossip)
    xp, yp, pi = be._g1([s.pubkeys[0].point for s in gossip])
    xs, ys, si = be._g2([s.signature.point for s in gossip])
    msgs = [s.message for s in gossip]
    words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)).to(dev)
    rand_np = bk.random_weights(n, n)
    rand = torch.as_tensor(rand_np.view(np.int32)).to(dev)
    u = staged.k_xmd(words)
    h = staged.k_hash(u)
    pts = staged.k_points(xp, yp, pi, xs, ys, si, rand)
    pair_in = (pts[0], pts[1], pts[2], h[0], h[1], h[2], pts[3], pts[4],
               pts[5])

    # the mask variant at the sync-aggregate shape: the sync set and the
    # single sets beside it, 512 keys a set
    sets4 = [sync] + singles
    m, k = len(sets4), 512
    mask = np.zeros((m, k), bool)
    flat = []
    for i, s in enumerate(sets4):
        mask[i, : len(s.pubkeys)] = True
        flat += [pk.point for pk in s.pubkeys] + [cv.g1_infinity()] * (
            k - len(s.pubkeys))
    x, y, inf = curve.pack_g1_affine(flat)
    mxs, mys, msi = be._g2([s.signature.point for s in sets4])
    mrand_np = bk.random_weights(m, m)
    margs = (staged.to_i32(x.reshape(m, k, -1)).to(dev),
             staged.to_i32(y.reshape(m, k, -1)).to(dev),
             inf.reshape(m, k).to(dev), mxs, mys, msi,
             torch.as_tensor(mrand_np.view(np.int32)).to(dev))
    mmask = torch.as_tensor(mask).to(dev)

    c = op_model()
    rate = 64 * card["sms"] * card["max_sm_mhz"] * 1e6   # instructions/s
    uv = fp.unpack(u.cpu())
    u_rows = [((uv[4 * i], uv[4 * i + 1]), (uv[4 * i + 2], uv[4 * i + 3]))
              for i in range(n)]
    active_pair = (int((~(pts[2] | h[2])).sum())
                   + int(not bool(pts[5][0])))
    ops = {
        "k_xmd": k_xmd_ops(n),
        "k_hash": k_hash_ops(c, u_rows),
        "k_points": k_points_ops(c, rand_np.astype(np.int64).tolist(),
                                 pi.cpu().tolist(), si.cpu().tolist()),
        "k_pair": k_pair_ops(c, active_pair),
        "k_points_mask": k_points_ops(
            c, mrand_np.astype(np.int64).tolist(), [False] * m,
            msi.cpu().tolist(), [len(s.pubkeys) for s in sets4]),
    }
    calls = {
        "k_xmd": (lambda: staged.k_xmd(words),
                  lambda: staged.k_xmd_plain(words), (words,), 50),
        "k_hash": (lambda: staged.k_hash(u), lambda: staged.k_hash_plain(u),
                   (u,), 5),
        "k_points": (lambda: staged.k_points(xp, yp, pi, xs, ys, si, rand),
                     lambda: staged.k_points_plain(xp, yp, pi, xs, ys, si,
                                                   rand),
                     (xp, yp, pi, xs, ys, si, rand), 5),
        "k_pair": (lambda: staged.k_pair(*pair_in),
                   lambda: staged.k_pair_plain(*pair_in), pair_in, 5),
        "k_points_mask": (lambda: staged.k_points(*margs, mask=mmask),
                          lambda: staged.k_points_plain(*margs, mask=mmask),
                          (*margs, mmask), 5),
    }
    rows = {}
    for name, (kern, plain, ins, reps) in calls.items():
        out = as_tuple(kern())
        err = max_abs_err(out, as_tuple(plain()))
        log(f"[vs plain] {name} at the main path's shape: max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 "at the main path's shape")
        ms = device_ms(kern, reps)
        plain_ms = timed(plain)
        ops_ms = ops[name] / rate * 1e3
        bytes_ms = io_bytes(ins, out) / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                      "bound_ms": max(ops_ms, bytes_ms),
                      "bound_by": "operations" if ops_ms >= bytes_ms
                      else "bytes", "ops": ops[name]}
        log(f"[timing] {name}: {ms:.4f} ms, plain {plain_ms:.1f} ms, "
            f"bound {rows[name]['bound_ms']:.5f} ms "
            f"({rows[name]['bound_by']}; ops {ops[name]} -> {ops_ms:.5f} "
            f"ms, bytes {bytes_ms:.6f} ms)")

    # End to end: the 64-set gossip batch through verify_signature_sets.
    bls.verify_signature_sets(gossip)
    e2e = []
    for _ in range(3):
        t0 = time.perf_counter()
        ok = bls.verify_signature_sets(gossip)
        e2e.append(time.perf_counter() - t0)
        if not ok:
            raise AssertionError("gossip batch failed while timing")
    med = statistics.median(e2e)
    four = sum(rows[nm]["ms"] for nm in REPLACES)
    log(f"[timing] verify_signature_sets({n} sets): {med * 1e3:.1f} ms "
        f"median of 3 -> {n / med:.1f} sets/s (information only); the "
        f"four kernels' device times sum to {four:.1f} ms")
    return rows, med


def card_info():
    import torch

    props = torch.cuda.get_device_properties(0)
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return {"sms": props.multi_processor_count, "max_sm_mhz": mhz}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls.cuda import staged
    from lighthouse_tpu_torch.runtime import build

    dev = torch.device("cuda")
    rng = random.Random(args.seed)
    name_power = nvidia_smi("name,power.limit")
    log(f"[card] {name_power}")
    card = card_info()
    log(f"[card] SMs {card['sms']}, max SM clock {card['max_sm_mhz']} MHz")

    t0 = time.perf_counter()
    info = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v['seconds']} s" for k, v in info.items()
                    if not k.startswith("_")))
    for k in build.KERNELS:
        for ln in info[k]["ptxas"]:
            if "registers" in ln or " 0 bytes spill stores" not in ln:
                log(f"[ptxas] {k}: {ln}")

    errs = phase_kernels_vs_plain(rng, dev)
    bls.set_backend("cuda")
    gossip, sync, singles, launches = phase_main_path(rng, bls, staged)
    rows, e2e_s = phase_timing(rng, bls, staged, gossip, sync, singles, dev,
                               card)

    kernels = []
    for nm in REPLACES:
        row = rows[nm]
        edge = errs[nm]
        main_err = row["max_abs_err"]
        if nm == "k_points":
            edge = max(edge, errs["k_points_mask"])
            main_err = max(main_err, rows["k_points_mask"]["max_abs_err"])
        entry = {
            "name": nm, "route": "cuda",
            "source": f"lighthouse_tpu_torch/csrc/{nm}.cu",
            "replaces": REPLACES[nm], "launches": launches[nm],
            "max_abs_err": max(edge, main_err),
            "max_abs_err_edge_cases": edge, "max_abs_err_main_shape": main_err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "ok": True, "ms_median": row["ms"],
        }
        if nm == "k_points":
            entry["mask_variant"] = dict(rows["k_points_mask"], n=4, k=512)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels, "sets_per_s_64": 64 / e2e_s}),
          flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
