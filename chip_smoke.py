#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's BLS verification (single-device and over a
mesh of shards) and signing, its SSZ state roots and shuffle, its epoch
transition and KZG checks, on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; the script then exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from lighthouse_tpu_torch/csrc with nvcc (sm_90a),
     one process a source, and print build seconds and ptxas
     register/spill lines; every kernel of k_pair.cu and k_each.cu (the
     cooperative pairing of pair_coop.cuh) and of k_points.cu (the
     cooperative ladders of points_coop.cuh) must show a 0-byte stack frame
     and no spill, k_hash_kernel (the lane machine of hash_g2.cuh) too, and
     k_sign_root_kernel and k_sign_field_kernel no spill and a stack under
     the default 1 KB a thread, and k_decode_kernel, k_subgroup_kernel
     and k_decode_g1_kernel (the cooperative checks of check_coop.cuh,
     each layout), k_ring_sum_kernel (points_coop.cuh's sum),
     k_ring_mul_kernel (pair_coop.cuh's final block) and k_sign_agg_kernel
     (check_coop.cuh's decoding and points_coop.cuh's engine) a 0-byte
     stack frame and no spill;
  3. each kernel against its plain PyTorch version on the card, same inputs
     (n = 8 lanes with padding, infinity and P == Q cases; the mask variant
     with 8 sets of up to 512 keys; k_decode with both sign bits, points
     with y.c1 == 0, infinity and padding lanes, an off-curve x and the
     non-subgroup signature of bls_adversarial.json, each lane also alone;
     k_each with valid, wrong-message and infinity lanes; the arena scatter
     with repeated rows, the gather of row 0 and the last row):
     bit-exact on every output;
  then the pubkey arena is filled with ARENA_KEYS = 2^20 keys (about
  mainnet's validator count: i G by a running host sum, through the
  cache's own insert path) and uploaded to the card;
  4. the main path, with every launch counter set to 0 just before:
     crypto.bls.verify_signature_sets on a 64-set gossip batch (True, keys
     cold in the arena) and its swapped twin (False), the same batch as
     wire bytes (LazySignature: decoded on the card, keys warm: no arena
     sync) (True) and its twins with a non-subgroup and an off-curve
     signature (False), 4 sets of 48-byte messages (host XMD, True), a
     512-key sync aggregate plus 3 single sets (True) and its tampered twin
     (False), the empty batch (False), _verify_many on 64 sets with one
     tampered lane (exactly that lane False), and every case of
     tests/vectors/bls.json and bls_adversarial.json twice, with decoded
     and with wire signatures; no wire signature may have been decoded on
     the host, and every kernel must have launched;
  5. at the main path's shapes (n = 64; 4 sets x 512 keys; 4,096 dirty rows
     into the filled arena; gathers of 64 and 4 x 512 rows): each kernel
     against its plain version again (bit-exact), the kernel's device time
     (back-to-back launches queued behind a sleep kernel, CUDA events), the
     plain version's time, one PyTorch call's time where one computes the
     same function (library), and each kernel's bound: the larger of its
     bytes over the HBM rate and the least work of its function on this
     run's data (see op_model) over the card's 32-bit integer rate (64 per
     clock per SM at the card's maximum SM clock); information only, the
     gossip batch end to end decoded and as wire bytes, and _verify_many
     on its 64 sets;
  6. (with phase 3) the signer's kernels and the secret arena's against
     their plain versions at n = 8: scalars 1, 2, r - 1, one with bit 254
     set, a zero-scalar padding row; k_sign_field on messages that are not
     32 bytes; k_sign_agg at (3, 4) with a repeated signature, sigma and
     -sigma, masked lanes and an off-curve x (ok False); a scatter with
     repeated rows, a gather of row 0 and the last row;
  7. the signer's main path, every launch counter set to 0 just before:
     crypto.bls.sign_engine.sign_batch (threshold 1) on the duty cohorts
     SIGN_COHORTS with keys SecretKey(0x5ee0 + 7 i), each cold (n x 32
     arena bytes synced) then warm (0 bytes, the same signatures), a stride
     sample of 64 lanes byte-equal to the host's SecretKey.sign; a mixed
     cohort of roots and longer messages; the 4,096 cohort verified on the
     card as wire bytes (True) and with two signatures swapped (False);
     aggregate_batch over 32 committees of 512 member signatures,
     byte-equal to the host's AggregateSignature.from_signatures on 2 rows,
     every aggregate verified by fast_aggregate_verify on the card,
     k_sign_agg's counter up by one for the call; every signing kernel
     must have launched;
  8. at the sign path's shapes (k_sign_root on 256 lanes, k_sign_field on
     the mixed cohort's 32 longer messages, k_sign_agg at (32, 512), the
     secret arena's scatter of 4,096 rows and gather of 4,096) the
     comparisons, times and bounds of phase 5; k_sign_agg also at 32 x 512
     with off-curve, infinity, masked and malformed lanes placed across its
     segment edges (check_layouts.agg_edge_planes) and at 1 x 1, 1 x 63,
     1 x 64, 1 x 65 and 64 x 512: bit-exact, the edge rows' ok as
     expected (information only: its device time at 64 x 512);
     sign_batch end to end per cohort (warm) and aggregate_batch; and,
     information only, k_sign_root
     on 256 lanes of scalar 1 against 256 lanes of scalar r - 1 and the
     ptxas lines of k_sign.cu;
  9. (with phase 3) the hash engine's kernels against their plain versions
     and hashlib lane by lane: k_pairs and k_entry on 8 and 7 lanes with an
     all-zero and an all-0xFF message, k_level on the zero-hash chain and
     on 14 random nodes, k_digest at m = 1, 2, 3, 4 blocks;
  10. the state-root path, every hash launch counter set to 0 just before:
     a MAINNET BeaconStateDeneb of STATE_VALIDATORS = 2^20 validators from
     --seed, its hash_tree_root on the "cuda" backend cold, then after a
     block-sized change (128 balances, one validator slashed and exiting,
     a randao mix, a block root and a state root) warm; the 2^20-index
     90-round shuffle forward and inverted and the 512-member sync sample;
     each equal to the hashlib backend's answer (a HostOracle, with
     caches of its own); every hash kernel must have launched and no call
     at or above the threshold may have been answered by hashlib; then the
     JAX bench's 2^17-leaf merkleize with its per-level table;
  11. at the state-root path's shapes (k_pairs on 4,194,304 lanes, k_entry
     on 32,768, k_level from 32,768 nodes to 16,384, k_digest on 368,730
     one-block seeds) the comparisons, times and bounds of phase 5, a
     stride sample of lanes against hashlib, and hashlib's host time for
     the same digests (information only);
  12. (with phase 3) the epoch engine's k_sums and k_state against their
     plain versions at n = 8 (epoch_edge_lanes: FAR_FUTURE_EPOCH exits and
     withdrawable epochs, activation exactly at prev and at cur, slashed
     lanes with wd == slash_wd and slash_wd + 1, all 8 flag values, a
     balance below its penalties, both hysteresis edges, the envelope edge
     eff 2^40 and score 2^26; leak off and on): bit-exact;
  13. the epoch path, every launch counter set to 0 just before: phase 10's
     state at the last slot of its epoch with bench.py's registry features
     planted, through state_transition.per_epoch.process_epoch on the
     "cuda" engine, and its post-state root on the "cuda" hash backend
     through the root plane and k_pairs; the scalar path on a copy, rooted
     on hashlib with caches of its own: equal roots and SSZ bytes, k_sums
     and k_state launched once each; the engine's stage rows; then a
     MINIMAL state of 64 validators at a sync-committee boundary (real
     keys repeated) on the engine and on the scalar path: equal roots and
     next sync committees, k_digest launched;
  14. at the epoch path's shapes (the 2^20 lanes and scalars phase 13 handed
     its kernels) the comparisons, times and bounds of phase 5, with the
     card's 64-bit division routines counted from the SASS (cuobjdump);
  15. (with phase 3) k_blob_eval against its plain version and the
     reference: (3, 8) with a random z, a domain hit and z = 0; z = 1;
     (1, 1) and (1, 2) with a hit; an all-zero blob; elements r - 1:
     bit-exact;
  16. the KZG path at full width, every launch counter set to 0 just
     before: MAINNET blobs of 4,096 elements (setup.make_blob from --seed)
     with the dev setup's commitments and proofs, through
     crypto.kzg.verify_blob_kzg_proof_batch on "cuda": 6 blobs (a block's
     max_blobs_per_block) True, with two proofs swapped False, with one
     element changed False, 2 blobs True; each verdict equal to the
     "python" backend's; each blob's y from eval_blobs equal to
     reference.evaluate_polynomial; k_blob_eval and k_pair launched once a
     call; the end-to-end ms and stage rows of 2 and 6 blobs;
  17. at the KZG path's shape (6, 4,096): k_blob_eval against its plain
     version, its device time, the plain version's time and its bound
     (kzg_work); and, information only, k_pair's device time at the
     path's 2 lanes (+1 off);
  18. (with phase 3) the mesh kernels against their plain versions at
     n = 8: k_subgroup on G1 and G2 lanes with non-subgroup points, an
     on-curve G2 point with y in Fp, infinity and a lane that is off;
     k_decode_g1 on both sign bits, infinity and an infinity lane with
     x != 0, the non-subgroup key, an off-curve x, the points (0, +-2) of
     order 3 and the point of order 11, with and without its subgroup
     check, each on-curve lane equal to curve_ref; k_pair_partial with the
     closing lane on and off, k_pair_combine of three partials and of one
     (equal to k_pair); k_ring_mul of two partials, 1 b, a 1 (equal to b
     and a), every coefficient p - 1 on both sides and on one, and 1 1;
     k_ring_sum of no point, one point,
     one infinity, P + P, P - P, two infinities, three equal points, four
     infinities, four points with an infinity and five points (equal to
     curve_ref): bit-exact; then k_pair, k_pair_partial
     (closing lane on and off) and k_pair_combine at the cooperative
     kernels' layout edges, PAIR_EDGE_LANES = 1, 31, 32, 33, 65 and 1,025
     lanes, valid, with mixed-infinity and with all-infinity lanes, and
     the combine of 1, 2 and 4 partials: bit-exact, verdicts as expected;
     then k_hash at HASH_EDGE_MSGS = 1, 31, 32, 33, 64, 65 and 1,025
     messages with the edge field elements of hash_edge_u in the input,
     and k_sign_root and k_sign_field at SIGN_EDGE_LANES = 1, 33, 256 and
     4,096 lanes with the edge scalars and zero-scalar padding rows:
     bit-exact (information only: k_hash's device time at 1,025 messages,
     the signers' at 4,096 lanes); then k_points at POINTS_EDGE_LANES = 1,
     31, 32, 33, 64, 65 and 1,025 lanes with the edge weights 0, 1,
     2, 2^32, 2^63 and 2^64 - 1, infinity keys and signatures, a padding
     lane, and a weighted signature met by an equal one (P == Q) and by its
     negation (P == -Q) in the sum; its mask variant at 4 x 512 and 8 x 512
     with an empty set, masked-off and infinity keys, an infinity signature
     and a key sum meeting P == Q and P == -Q; k_each at EACH_EDGE_SETS =
     1, 64, 65 and 1,024 sets of valid, wrong-message, infinity-key,
     infinity-signature and infinity-H sets: bit-exact, verdicts as
     expected (information only: k_points' device time at 1,024 lanes,
     k_each's at 1,024 sets); then k_decode at DECODE_EDGE_LANES = 1, 31,
     32, 33, 64, 65 and 1,025 lanes (prefixes of one input: valid
     signatures with the square root's corner d1 == 0 and y.c1 == 0 of both
     signs, a well-formed and a malformed infinity, an off-curve x, the
     non-subgroup signature and G2 points of order 13 and 23 across the
     block and warp edges) and k_subgroup at as many G1 and G2 lanes and
     with n1 != n2 both ways (the non-subgroup key and signature, also
     inactive, infinity, the G1 points (0, +-2) of order 3, (r - 1) g,
     the y.c1 == 0 point, the order-13 and order-23 points) and k_decode_g1
     at as many keys, with and without its check (the generator and -g,
     a well-formed and a malformed infinity, the points of order 3 and 11,
     an off-curve x, the non-subgroup key; also at 4,096 keys, its third
     layout), each against its plain version run once at 1,025 lanes
     (k_decode's verdict of a prefix the AND of the plain lane verdicts;
     its edge lanes also alone): bit-exact (information only: the three
     kernels' device times at 1,025 lanes);
  19. (after phase 7) the mesh path, every launch counter set to 0 just
     before: on meshes of 1, 2 and 4 shards on the card (MESH_SIZES; a
     shard a stream) and one shard a card when several are visible, a
     CudaBackend with mesh_min_sets 1 answers through
     crypto.bls.verify_signature_sets the 64-set gossip batch decoded and
     as wire bytes, their twins with two signatures swapped at the shard
     boundary, a non-subgroup signature there and an off-curve one at the
     first lane, 62 wire sets (padded on 4 shards) and a twin spoiled
     next to the padding, 8 sets of 48-byte messages (host hash_to_field)
     decoded and as wire bytes and a wrong-message twin, the 512-key sync
     aggregate with 3 single sets and its tampered twin, and 1,024 signed
     sets of phase 7 as wire bytes (DEFAULT_MAX_BATCH_ITEMS) and a swapped
     twin: each verdict equal to the single-device route's and to the
     expected value, no wire signature decoded on the host, a warm batch
     syncing no arena row; sharded_verify_batch_fn and ring_verify_batch_fn
     and verify_batch_kernel(check_subgroups=True) on the gossip batch with
     its keys decoded on the card by k_decode_g1, valid (True) and with
     the non-subgroup key at the boundary (False); mesh_stats() counts no
     degradation and every mesh kernel launched; then k_decode_g1 on 4,096
     of the arena's keys equal to curve_ref.g1_decompress;
  20. at the mesh path's shapes (k_subgroup on 64 + 64 lanes, k_decode_g1
     on 64 keys, k_pair_partial on a 2-shard mesh's shard 0: 32 lanes and
     the closing lane, k_pair_combine of 2 partials, k_ring_mul and
     k_ring_sum on 2 values) the comparisons, times and bounds of phase 5;
     information only, k_decode_g1's device time without its check at 64
     keys and with it at phase 19's 4,096 keys, k_ring_sum's at 4 shards'
     sums (both also against their plain versions), verify_batch_kernel's
     device time at 64 sets with and without its subgroup checks, the mesh
     steps (sharded and ring on every mesh, verify_batch_kernel as the
     single-device control) on the valid gossip batch, median of
     MESH_STEP_REPS calls, and the 64-set and 1,024-set wire batches end to
     end on every mesh and on the single-device route.
The slow host oracles (phases 7, 10, 13 and 16: two aggregate rows summed
on the host, the hashlib roots and shuffles, the scalar epoch rooted on
hashlib, the "python" KZG backend) run in forked child processes while
the card goes on (HostOracle: host Python only); after the KZG phases,
the last to run, the script joins each and checks its answer before it
prints the results.  The line before the card line is the
kernels' JSON (27 kernels); the last line is {"ok": true, "device": {...}}.  Keys, messages, blobs and the
states come from --seed, except the signer's, which are bench.py's.
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

# The wire edge cases: x = 1 (x^3 + 4(1 + u) is not a square in Fp2), the
# on-curve points outside the groups of bls_adversarial.json, and the G2
# points whose y lies in Fp or in u Fp.
from lighthouse_tpu_torch.tools.check_layouts import (  # noqa: E402
    OFF_CURVE_X1, ORDER_11, axis_y_points, non_subgroup_pubkey,
    non_subgroup_signature, order3_g1)

REPLACES = {
    "k_xmd": "lighthouse_tpu/crypto/bls/tpu/staged.py:58",
    "k_hash": "lighthouse_tpu/crypto/bls/tpu/staged.py:51",
    "k_points": "lighthouse_tpu/crypto/bls/tpu/staged.py:89",
    "k_pair": "lighthouse_tpu/crypto/bls/tpu/staged.py:104",
    "k_decode": "lighthouse_tpu/crypto/bls/tpu/staged.py:66",
    "k_and": "lighthouse_tpu/crypto/bls/tpu/staged.py:81",
    "k_each": "lighthouse_tpu/crypto/bls/tpu/backend.py:90",
    "k_scatter_rows": "lighthouse_tpu/crypto/bls/tpu/pubkey_cache.py:74",
    "k_gather_rows": "lighthouse_tpu/parallel/sharded_verify.py:374",
    "k_sign_root": "lighthouse_tpu/crypto/bls/tpu/signer.py:113",
    "k_sign_field": "lighthouse_tpu/crypto/bls/tpu/signer.py:122",
    "k_sign_agg": "lighthouse_tpu/crypto/bls/tpu/signer.py:143",
    "k_scatter_sk_rows": "lighthouse_tpu/crypto/bls/tpu/seckey_cache.py:67",
    "k_gather_sk_rows": "lighthouse_tpu/crypto/bls/tpu/signer.py:229",
    "k_pairs": "lighthouse_tpu/crypto/sha256/kernel.py:190",
    "k_entry": "lighthouse_tpu/crypto/sha256/kernel.py:162",
    "k_level": "lighthouse_tpu/crypto/sha256/kernel.py:175",
    "k_digest": "lighthouse_tpu/crypto/sha256/kernel.py:201",
    "k_sums": "lighthouse_tpu/state_transition/epoch_engine/kernels.py:90",
    "k_state": "lighthouse_tpu/state_transition/epoch_engine/kernels.py:118",
    "k_blob_eval": "lighthouse_tpu/crypto/kzg/kernels.py:76",
    "k_subgroup": "lighthouse_tpu/crypto/bls/tpu/verify.py:116",
    "k_decode_g1": "lighthouse_tpu/crypto/bls/tpu/curve.py:684",
    "k_pair_partial": "lighthouse_tpu/parallel/sharded_verify.py:269",
    "k_pair_combine": "lighthouse_tpu/parallel/sharded_verify.py:295",
    "k_ring_mul": "lighthouse_tpu/parallel/ring.py:37",
    "k_ring_sum": "lighthouse_tpu/parallel/ring.py:61",
}
SOURCES = {"k_and": "k_decode.cu", "k_scatter_rows": "k_arena.cu",
           "k_gather_rows": "k_arena.cu", "k_sign_root": "k_sign.cu",
           "k_sign_field": "k_sign.cu", "k_sign_agg": "k_sign.cu",
           "k_scatter_sk_rows": "k_arena.cu",
           "k_gather_sk_rows": "k_arena.cu", "k_pairs": "k_sha256.cu",
           "k_entry": "k_sha256.cu", "k_level": "k_sha256.cu",
           "k_digest": "k_sha256.cu", "k_sums": "k_epoch.cu",
           "k_state": "k_epoch.cu", "k_blob_eval": "k_kzg.cu",
           "k_subgroup": "k_verify.cu", "k_decode_g1": "k_verify.cu",
           "k_pair_partial": "k_pair.cu", "k_pair_combine": "k_pair.cu",
           "k_ring_mul": "k_ring.cu", "k_ring_sum": "k_ring.cu"}
SLICE_1 = ("k_xmd", "k_hash", "k_points", "k_pair")
VERIFY_KERNELS = SLICE_1 + ("k_decode", "k_and", "k_each", "k_scatter_rows",
                            "k_gather_rows")
SIGN_KERNELS = ("k_sign_root", "k_sign_field", "k_sign_agg",
                "k_scatter_sk_rows", "k_gather_sk_rows")
SHA_KERNELS = ("k_pairs", "k_entry", "k_level", "k_digest")
EPOCH_KERNELS = ("k_sums", "k_state")
KZG_KERNELS = ("k_blob_eval",)
GOSSIP = 64          # MAX_GOSSIP_ATTESTATION_BATCH (chain/beacon_processor.py)
SYNC_KEYS = 512      # sync_committee_size (types/spec.py)
ARENA_KEYS = 1 << 20  # pubkeys in the arena: about mainnet's validator count
# The signer's duty cohorts and keys (bench.py:496-505: BENCH_SIGN_SIZES,
# SecretKey(0x5ee0 + 7 i), 32-byte roots i.to_bytes(32, "little")), its
# stride sample against the host (BENCH_SIGN_PARITY), a mixed cohort of
# roots and longer messages (the k_sign_field launch), and the
# aggregate-and-proof batch of a 32,768-key client: 32 aggregators, each
# summing a 512-member committee (mainnet, types/spec.py:75-78, :251).
SIGN_COHORTS = (256, 1024, 4096)
SIGN_KEY0, SIGN_KEY_STEP = 0x5EE0, 7
SIGN_PARITY = 64
MIXED_COHORT = 64
AGG_ROWS, AGG_K = 32, 512
# main-path lanes: swapped signatures (with the next), the non-subgroup
# and off-curve wire signatures, the tampered _verify_many message
LANES = {"swap": 10, "non_subgroup": 10, "off_curve": 20, "each": 17}
# The pairing kernels' layout edges: one lane, a warp's 32 lanes and either
# side, the 64-set batch's 65, the 1,024-set batch's 1,025
# (DEFAULT_MAX_BATCH_ITEMS); and the combine's 1, 2 and 4 partials.
PAIR_EDGE_LANES = (1, 31, 32, 33, 65, 1025)
PAIR_EDGE_PARTIALS = (1, 2, 4)
# The two-thread hash and signing kernels' edges (blocks of 32 threads, 16
# messages or lanes): one message, a block's 16 and either side in
# threads, the gossip batch's 64, 65 and 1,025; signing: one lane, 33, the
# 256 and 4,096 cohorts.  Signing scalars: the base-|z| digit edges, r - 1,
# r, r + 1 and 2^255 - 1 (k mod r is one masked subtraction), then random
# ones, and zero-scalar padding rows at the end.
HASH_EDGE_MSGS = (1, 31, 32, 33, 64, 65, 1025)
# The cooperative ladders' and k_each's edges (a block a lane; the sum's 64
# accumulators): one lane, a warp's 32 and either side, the gossip batch's
# 64 and 65, the 1,024-set batch's 1,025 (DEFAULT_MAX_BATCH_ITEMS; 1,024
# lanes are timed); the mask variant's sync-aggregate shape and 8 sets;
# k_each's sets likewise.
POINTS_EDGE_LANES = (1, 31, 32, 33, 64, 65, 1025)
# k_decode's and k_subgroup's edges (a block a lane): the same counts.
DECODE_EDGE_LANES = (1, 31, 32, 33, 64, 65, 1025)
MASK_EDGE_SETS = (4, 8)
EACH_EDGE_SETS = (1, 64, 65, 1024)
SIGN_EDGE_LANES = (1, 33, 256, 4096)
ABS_Z = 0xD201000000010000
SIGN_EDGE_PADDING = 3
# The state-root path: a MAINNET Deneb state of 2^20 validators (about
# mainnet's count; types/spec.py:85 limits the registry to 2^40), its
# 90-round shuffle (shuffle_round_count, types/spec.py:213), and the JAX
# bench's 2^17-leaf merkleize (bench.py:140-206).  The kernels' main shapes:
# the grove's first level (2^20 validators x 8 field roots / 2), the
# randao_mixes entry level (65,536 chunks / 2), its first chained level,
# and the shuffle's one-block seeds (90 + 90 x 4,096).
STATE_VALIDATORS = 1 << 20
SHUFFLE_ROUNDS = 90
MERKLE_LEAVES = 1 << 17
SHA_SHAPES = {"k_pairs": 4 * STATE_VALIDATORS, "k_entry": 32_768,
              "k_level": 16_384}
# The KZG path: a block's blob sidecars (types/spec.py:64-65: 4,096
# elements a blob, at most 6 blobs a block).
BLOB_ELEMENTS = 4096
MAX_BLOBS = 6
VECTORS = os.path.join(HERE, "tests", "vectors")


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
# A SHA-256 round is 14 instructions with 3-input LOP3 / IADD3: 6 rotates
# (SHF) and 4 LOP3 (the two Sigmas, Ch, Maj) on the integer ALU pipe, and 4
# additions, which ptxas may run as IMAD on the FMA pipe; a schedule step
# is 10, 8 of them on the ALU pipe; the 8 state additions close a block.
# A block therefore needs max(its ALU instructions, all its instructions /
# 2) slots at the ALU pipe's 64 a clock (k_pairs ran faster than all its
# instructions at 64 a clock would allow).
SHA_ROUND, SHA_SCHED, SHA_ROUND_ALU, SHA_SCHED_ALU = 14, 10, 10, 8
SHA_VAR = max(64 * SHA_ROUND_ALU + 48 * SHA_SCHED_ALU,
              (64 * SHA_ROUND + 48 * SHA_SCHED + 8) // 2)
SHA_CONST = max(64 * SHA_ROUND_ALU,   # a block of constant words: W + K known
                (64 * SHA_ROUND + 8) // 2)


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

    # One Fp inversion, shared by a batch: the cheaper of Fermat's a^(p - 2)
    # and the binary extended Euclid (variable time; the pairing's final
    # exponentiation runs it): about 2 x 381 halvings, each a 12-limb shift
    # of u or v and a halving mod p of its cofactor (36), and 381
    # subtractions, each a 12-limb compare and subtraction and a modular
    # one (48).
    bits = P.bit_length()
    c = {"inv": min(fp_exp(P - 2), 2 * bits * 36 + bits * 48)}
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
    # G2 decompression of a lane: x to Montgomery (2 M), x^3 + b, the Fp2
    # square root, the sign on the real value (2 M off Montgomery), and
    # psi(P) == -[|z|] P: psi (2 M2), a ladder over |z| with mixed
    # additions (P is affine), a compare of affine psi(P) (Z = 1) with a
    # Jacobian point (Z^2, Z^3, X Z^2, Y Z^3)
    c["psi_check"] = (2 * M2 + c["x_dbls"] * c["dbl2"]
                      + c["x_adds"] * c["madd2"] + S2 + 3 * M2)
    c["decode"] = 4 * M + S2 + M2 + c["sqrt2"] + c["psi_check"]
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


def k_decode_ops(c, inf) -> int:
    """Each finite lane decoded and subgroup-checked; a decompressed point
    is affine already (Z = 1), so no inversion."""
    return sum(1 for i in inf if not i) * c["decode"]


def k_each_ops(c, p_inf, s_inf, h_inf) -> int:
    """A lane whose key or signature is infinity is False without work;
    the others need a shared 2-pair Miller loop (one pair where H is
    infinity) and one final exponentiation."""
    total = 0
    for pi, si, hi in zip(p_inf, s_inf, h_inf):
        if not (pi or si):
            total += (c["miller_f"] + (1 + (not hi)) * c["miller_lane"]
                      + c["final_exp"])
    return total


def g2_mul_ops(c, k: int) -> int:
    """[k] P on G2 for one scalar: the cheaper of a width-w NAF ladder over
    k and the 4-dimensional GLS split (psi acts as [z] on G2, z = -|z|:
    k = sum_i d_i |z|^i with four digits below |z| < 2^64, the 15 sums of
    +-psi^i(P) as a table, one joint 64-step ladder)."""
    from lighthouse_tpu_torch.crypto.bls.cuda import pairing

    if k == 0:
        return 0
    wnaf = (k.bit_length() - 1) * c["dbl2"] + naf_adds(k) * c["add2"]
    z, v, digits = pairing.ABS_X, k, []
    for _ in range(4):
        digits.append(v % z)
        v //= z
    bits = max(d.bit_length() for d in digits)
    cols = sum(1 for j in range(bits) if any((d >> j) & 1 for d in digits))
    gls = (3 * 2 * M2 + 11 * c["add2"] + max(bits - 1, 0) * c["dbl2"]
           + cols * c["add2"])
    return min(wnaf, gls)


def k_sign_ops(c, scalars, u_rows, xmd: bool) -> int:
    """Signing n lanes: (XMD of a root,) hash to G2 without its affine
    conversion, [k] H(m) for this run's scalars, and the compression (one
    batched inversion; x and y off Montgomery form)."""
    n = len(scalars)
    total = k_hash_ops(c, u_rows) - n * c["aff2_share"] - c["inv"]
    total += k_xmd_ops(n) if xmd else 0
    total += sum(g2_mul_ops(c, k) for k in scalars)
    return total + c["inv"] + n * (c["aff2_share"] + 4 * M)


def k_sign_agg_ops(c, live_finite) -> int:
    """Each live finite lane decompressed (x to Montgomery form, x^3 + b,
    the Fp2 square root, the sign on the real value; no subgroup check),
    each row summed with mixed additions, the row sums compressed with one
    batched inversion.  ``live_finite``: such lanes a row."""
    dec = 4 * M + S2 + M2 + c["sqrt2"]
    total = c["inv"]
    for nl in live_finite:
        total += (nl * dec + max(nl - 1, 0) * c["madd2"] + c["aff2_share"]
                  + 4 * M)
    return total


# --- Inputs ------------------------------------------------------------------


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


class HostOracle:
    """fn() in a forked child process while the caller goes on with the
    card: for the slow host oracles (hashlib roots, the scalar epoch, host
    curve sums, the python KZG backend).  The child runs host Python only,
    never the card (a forked child cannot reach it); its answer comes back
    through a pipe.  `check(answer)` runs in this process when main() joins
    the oracle (join_host_oracles), before the results are printed."""

    def __init__(self, label: str, fn, check):
        import multiprocessing as mp
        import warnings

        self.label, self.check = label, check
        sys.stdout.flush()
        sys.stderr.flush()
        ctx = mp.get_context("fork")
        self._recv, send = ctx.Pipe(duplex=False)

        def child():
            try:
                if "torch" in sys.modules:     # no CPU thread pool after fork
                    sys.modules["torch"].set_num_threads(1)
                out = ("ok", fn())
            except BaseException as e:          # raised again in the parent
                out = ("error", f"{type(e).__name__}: {e}")
            send.send(out)

        self.proc = ctx.Process(target=child, daemon=True)
        with warnings.catch_warnings():
            # Python 3.12 warns on a fork of a process with threads (the
            # card's runtime has some); the child never calls into it
            warnings.simplefilter("ignore", DeprecationWarning)
            self.proc.start()
        send.close()
        HOST_ORACLES.append(self)

    def join(self):
        try:
            kind, answer = self._recv.recv()
        except EOFError:
            kind, answer = "error", "the child died without an answer"
        self.proc.join()
        if kind != "ok":
            raise AssertionError(f"{self.label}: host oracle failed: "
                                 f"{answer} (exit code {self.proc.exitcode})")
        self.check(answer)


HOST_ORACLES = []


def join_host_oracles():
    """Join every host oracle in the order started and run its check."""
    t = time.perf_counter()
    while HOST_ORACLES:
        HOST_ORACLES.pop(0).join()
    log(f"[host oracles] joined, {time.perf_counter() - t:.1f} s waited")


def stop_host_oracles():
    """End every child still running (a phase raised before the join)."""
    for o in HOST_ORACLES:
        if o.proc.is_alive():
            o.proc.terminate()
        o.proc.join()


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


# --- Phases ------------------------------------------------------------------


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
    k = SYNC_KEYS
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


def phase_new_kernels_vs_plain(rng, dev):
    """The kernels of the wire path, per-set verification and the arena,
    each against its plain version on identical inputs on the card."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    out = {}
    # k_decode: both sign bits, y.c1 == 0 of both signs, infinity, an
    # off-curve x, the non-subgroup vector, one padding lane
    msg = bytes(rng.randrange(256) for _ in range(32))
    sig = hr.hash_to_g2(msg).mul(rng.randrange(1, R))
    ry = axis_y_points()[0]
    raws = [cv.g2_compress(p) for p in (sig, -sig, ry, -ry,
                                        cv.g2_infinity())]
    raws += [OFF_CURVE_X1, non_subgroup_signature()]
    if raws[0][0] & 0x20 == raws[1][0] & 0x20:
        raise AssertionError("k_decode inputs: one sign bit only")
    x, sign, inf = (t.to(dev) for t in bk.parse_g2_compressed_many(raws, 8))
    dec = staged.k_decode(x, sign, inf)
    out["k_decode"] = max_abs_err(dec, staged.k_decode_plain(x, sign, inf))
    lane_ok = [bool(staged.k_decode(x[i:i + 1], sign[i:i + 1],
                                    inf[i:i + 1])[3]) for i in range(8)]
    pt, plain_ok = curve.g2_decompress(staged.to_i64(x), sign, inf)
    plain_ok = (plain_ok & (curve.g2_subgroup_check(pt) | inf)).tolist()
    want = [True, True, False, False, True, False, False, True]
    log(f"[vs plain] k_decode lanes alone: {lane_ok} (plain {plain_ok})")
    if lane_ok != plain_ok or lane_ok != want or bool(dec[3]):
        raise AssertionError("k_decode lane verdicts disagree")
    got = curve.unpack_g2_affine(staged.to_i64(dec[0][2:4].cpu()),
                                 staged.to_i64(dec[1][2:4].cpu()),
                                 dec[2][2:4].cpu())
    if got != [cv.g2_decompress(r, subgroup_check=False)
               for r in raws[2:4]] or any(p.y.c1 for p in got):
        raise AssertionError("k_decode: wrong y where y.c1 == 0")

    t = torch.ones(1, dtype=torch.bool, device=dev)
    f = torch.zeros(1, dtype=torch.bool, device=dev)
    ands = [(staged.k_and(a, b), staged.k_and_plain(a, b))
            for a in (t, f) for b in (t, f)]
    out["k_and"] = max(max_abs_err([k], [p]) for k, p in ands)
    if [bool(k) for k, _ in ands] != [True, False, False, False]:
        raise AssertionError("k_and truth table")

    # k_each: valid, wrong message, infinity key, infinity signature,
    # valid, all infinity, another key's signature, valid
    n = 8
    sks = [rng.randrange(1, R) for _ in range(n)]
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]
    hs = [hr.hash_to_g2(m) for m in msgs]
    pks = [cv.g1_generator().mul(k) for k in sks]
    sigs = [h.mul(k) for h, k in zip(hs, sks)]
    h_msgs = list(msgs)
    h_msgs[1] = msgs[0]
    pks[2] = pks[5] = cv.g1_infinity()
    sigs[3] = sigs[5] = cv.g2_infinity()
    sigs[6] = hs[6].mul(sks[7])
    words = torch.as_tensor(h2.pack_msg_words(h_msgs).view(np.int32)).to(dev)
    hx, hy, hinf = staged.k_hash(staged.k_xmd(words))
    xp, yp, pi = curve.pack_g1_affine(pks)
    xs, ys, si = curve.pack_g2_affine(sigs)
    args = (staged.to_i32(xp).to(dev), staged.to_i32(yp).to(dev),
            pi.to(dev), staged.to_i32(xs).to(dev), staged.to_i32(ys).to(dev),
            si.to(dev), hx, hy, hinf)
    each = staged.k_each(*args)
    out["k_each"] = max_abs_err([each], [staged.k_each_plain(*args)])
    want = [True, False, False, False, True, False, False, True]
    if each.tolist() != want:
        raise AssertionError(f"k_each verdicts {each.tolist()}")

    # the arena: a scatter with repeated rows, a gather of row 0 and the
    # last row
    g = torch.Generator().manual_seed(rng.randrange(1 << 30))
    rows, d = 4096, 64

    def words_of(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             dtype=torch.int32)

    ax, ay = words_of(rows, 12), words_of(rows, 12)
    ax[0] = ay[0] = 0
    idx = torch.randperm(rows - 1, generator=g)[:d].to(torch.int64) + 1
    idx[-4:] = idx[:4]
    vx, vy = words_of(d, 12), words_of(d, 12)
    vx[-4:], vy[-4:] = vx[:4], vy[:4]
    kern = [ax.to(dev), ay.to(dev)]
    plain = [ax.to(dev), ay.to(dev)]
    sargs = (idx.to(dev), vx.to(dev), vy.to(dev))
    staged.k_scatter_rows(*kern, *sargs)
    staged.k_scatter_rows_plain(*plain, *sargs)
    out["k_scatter_rows"] = max_abs_err(kern, plain)
    sel = torch.tensor([0, rows - 1, int(idx[5]), 0, rows - 1, 17],
                       dtype=torch.int64, device=dev)
    gat = staged.k_gather_rows(*kern, sel)
    out["k_gather_rows"] = max_abs_err(
        gat, staged.k_gather_rows_plain(*kern, sel))
    if gat[2].tolist() != [True, False, False, True, False, False]:
        raise AssertionError("k_gather_rows: infinity flags")
    torch.cuda.synchronize()
    for name, err in out.items():
        log(f"[vs plain] {name}: max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    return out


def _madd(X1, Y1, Z1, x2, y2, p):
    """Jacobian + affine G1 addition (madd-2007-bl) on ints, P != +-Q."""
    Z1Z1 = Z1 * Z1 % p
    U2 = x2 * Z1Z1 % p
    S2 = y2 * Z1 * Z1Z1 % p
    H = (U2 - X1) % p
    HH = H * H % p
    I4 = 4 * HH % p
    J = H * I4 % p
    r = 2 * (S2 - Y1) % p
    V = X1 * I4 % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * Y1 * J) % p
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p
    return X3, Y3, Z3


def arena_keys(bls, start: int, count: int, chunk: int = 1 << 16,
               step: int = 1):
    """PublicKeys of (start + step i) g1 for i < count, in chunks: a running
    Jacobian sum, each chunk made affine with one inversion."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp

    g = cv.g1_generator()
    gs = g.mul(step)
    gx, gy = gs.x.v, gs.y.v
    first = g.mul(start)
    X, Y, Z = first.x.v, first.y.v, 1
    done = 0
    while done < count:
        k = min(chunk, count - done)
        jac = []
        for _ in range(k):
            jac.append((X, Y, Z))
            X, Y, Z = _madd(X, Y, Z, gx, gy, P)
        pre, acc = [], 1
        for _, _, z in jac:
            pre.append(acc)
            acc = acc * z % P
        inv = pow(acc, P - 2, P)
        keys = [None] * k
        for i in range(k - 1, -1, -1):
            x, y, z = jac[i]
            zi = inv * pre[i] % P
            inv = inv * z % P
            zi2 = zi * zi % P
            keys[i] = bls.PublicKey(cv.Point(Fp(x * zi2 % P),
                                             Fp(y * zi2 * zi % P), cv.B_G1))
        done += k
        yield keys


def phase_arena_fill(rng, bls, dev, count: int):
    """Fill the process-wide pubkey arena with `count` keys through its own
    insert path, then mirror it on the card (one full upload)."""
    import torch
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import pubkey_cache

    cache = pubkey_cache.get_cache()
    t0 = time.perf_counter()
    for keys in arena_keys(bls, rng.randrange(2, R // 2), count):
        cache.rows_for(keys)
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ax, _ay = cache.device_view(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    info = {"keys": count, "entries": len(cache),
            "arena_rows": int(ax.shape[0]),
            "card_mib": 2 * ax.numel() * ax.element_size() / 2**20,
            "fill_s": fill_s, "upload_s": upload_s}
    log(f"[arena] {count} keys filled in {fill_s:.1f} s; {info['arena_rows']}"
        f" rows ({info['card_mib']:.0f} MiB) on the card, uploaded in "
        f"{upload_s:.2f} s")
    if len(cache) < count:
        raise AssertionError("arena holds fewer keys than were filled")
    return info


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


def as_wire(bls, sets):
    """The sets with their signatures as undecoded wire bytes."""
    return [bls.SignatureSet(bls.LazySignature(s.signature.to_bytes()),
                             s.pubkeys, s.message) for s in sets]


def replay_vectors(bls, wire=False):
    """Every verify case of bls.json and bls_adversarial.json, signatures
    decoded on the host or (``wire``) as LazySignature bytes; returns the
    number of cases checked."""
    with open(os.path.join(VECTORS, "bls.json")) as f:
        doc = json.load(f)
    checked = 0

    def sig_of(hexed):
        raw = bytes.fromhex(hexed)
        return (bls.LazySignature(raw) if wire
                else bls.Signature.from_bytes(raw))

    def sets_of(raw):
        return [bls.SignatureSet(
            sig_of(s["signature"]),
            [bls.PublicKey.from_bytes(bytes.fromhex(h)) for h in s["pubkeys"]],
            bytes.fromhex(s["message"])) for s in raw]

    for case in doc["batch_verify"]:
        sets = sets_of(case["sets"])
        got = bls.verify_signature_sets(sets)
        if got != case["valid"]:
            raise AssertionError(f"bls.json batch_verify: {got}")
        if wire and any(s.signature.decoded() for s in sets):
            raise AssertionError("bls.json batch_verify: decoded on the host")
        checked += 1
    fav = doc["fast_aggregate_verify"]
    agg = sig_of(fav["aggregate"])
    pks = [bls.PublicKey.from_bytes(bytes.fromhex(h)) for h in fav["pubkeys"]]
    got = bls.get_backend().fast_aggregate_verify(
        agg, bytes.fromhex(fav["message"]), pks)
    if got != fav["valid"]:
        raise AssertionError(f"bls.json fast_aggregate_verify: {got}")
    checked += 1
    av = doc["aggregate_verify"]
    agg = sig_of(av["aggregate"])
    pks = [bls.PublicKey.from_bytes(bytes.fromhex(h)) for h in av["pubkeys"]]
    got = bls.get_backend().aggregate_verify(
        agg, [bytes.fromhex(m) for m in av["messages"]], pks)
    if got != av["valid"]:
        raise AssertionError(f"bls.json aggregate_verify: {got}")
    checked += 1
    for s in doc["sign"]:
        sig = sig_of(s["signature"])
        pk = bls.PublicKey.from_bytes(bytes.fromhex(s["pubkey"]))
        if not sig.verify(pk, bytes.fromhex(s["message"])):
            raise AssertionError("bls.json sign vector does not verify")
        checked += 1

    with open(os.path.join(VECTORS, "bls_adversarial.json")) as f:
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
        # wire bytes are checked at verify time: a bad signature is False
        if expect == "invalid_pubkey" or (expect == "invalid_signature"
                                          and not wire):
            raise AssertionError(f"{case['name']}: decoded, want {expect}")
        got = bls.verify_signature_sets(sets)
        if got != (expect == "valid"):
            raise AssertionError(f"{case['name']}: verify={got}, want {expect}")
        if wire and any(s.signature.decoded() for s in sets):
            raise AssertionError(f"{case['name']}: decoded on the host")
        checked += 1
    return checked


def phase_main_path(rng, bls, staged):
    """Through crypto.bls, counters from 0."""
    from lighthouse_tpu_torch.crypto.bls.cuda import pubkey_cache

    gossip = make_sets(rng, bls, GOSSIP)
    sw, ns, oc, ea = (LANES[k] for k in ("swap", "non_subgroup",
                                         "off_curve", "each"))
    swapped = list(gossip)
    swapped[sw] = bls.SignatureSet(gossip[sw + 1].signature,
                                   gossip[sw].pubkeys, gossip[sw].message)
    wire = as_wire(bls, gossip)
    wire_nonsub, wire_offcurve = list(wire), list(wire)
    wire_nonsub[ns] = bls.SignatureSet(
        bls.LazySignature(non_subgroup_signature()), wire[ns].pubkeys,
        wire[ns].message)
    wire_offcurve[oc] = bls.SignatureSet(
        bls.LazySignature(OFF_CURVE_X1), wire[oc].pubkeys, wire[oc].message)
    sync = make_sync_aggregate(rng, bls, SYNC_KEYS)
    singles = make_sets(rng, bls, 3)
    tampered = bls.SignatureSet(sync.signature, sync.pubkeys,
                                bytes(b ^ 1 for b in sync.message))
    odd = make_sets(rng, bls, 4, msg_len=48)        # host XMD path
    each_msgs = [s.message for s in gossip]
    each_msgs[ea] = bytes(b ^ 1 for b in each_msgs[ea])

    be = bls.get_backend()
    cache = pubkey_cache.get_cache()
    staged.reset_launches()
    t0 = time.perf_counter()
    sync0 = cache.sync_stats()
    results = {"gossip_64": bls.verify_signature_sets(gossip)}
    sync1 = cache.sync_stats()
    results["gossip_64_wire"] = bls.verify_signature_sets(wire)
    sync2 = cache.sync_stats()
    results.update({
        "gossip_64_wire_non_subgroup": bls.verify_signature_sets(wire_nonsub),
        "gossip_64_wire_off_curve": bls.verify_signature_sets(wire_offcurve),
        "host_xmd_4": bls.verify_signature_sets(odd),
        "gossip_64_swapped": bls.verify_signature_sets(swapped),
        "sync_512_plus_3": bls.verify_signature_sets([sync] + singles),
        "sync_512_tampered": bls.verify_signature_sets([tampered] + singles),
        "empty": bls.verify_signature_sets([]),
    })
    many = be._verify_many([s.pubkeys[0].point for s in gossip], each_msgs,
                           [s.signature.point for s in gossip])
    results["vector_cases"] = replay_vectors(bls)
    results["vector_cases_wire"] = replay_vectors(bls, wire=True)
    launches = staged.launch_counts()
    seconds = time.perf_counter() - t0
    want = {"gossip_64": True, "gossip_64_wire": True,
            "gossip_64_wire_non_subgroup": False,
            "gossip_64_wire_off_curve": False, "host_xmd_4": True,
            "gossip_64_swapped": False,
            "sync_512_plus_3": True, "sync_512_tampered": False,
            "empty": False}
    for key, expect in want.items():
        log(f"[main path] {key}: {results[key]} (want {expect})")
        if results[key] is not expect:
            raise AssertionError(f"{key}: got {results[key]}")
    want_many = [i != ea for i in range(GOSSIP)]
    log(f"[main path] _verify_many({GOSSIP}, lane {ea} tampered): False at "
        f"{[i for i, v in enumerate(many) if not v]}")
    if many != want_many:
        raise AssertionError("_verify_many: wrong per-set verdicts")
    decoded = [s.signature.decoded()
               for s in wire + wire_nonsub + wire_offcurve]
    if any(decoded):
        raise AssertionError(f"{sum(decoded)} wire signatures were decoded "
                             "on the host")
    cold = {k: sync1[k] - sync0[k] for k in sync0}
    warm = {k: sync2[k] - sync1[k] for k in sync0}
    log(f"[main path] arena sync: cold batch {cold}, the same keys warm "
        f"{warm}")
    if cold["device_sync_rows"] != GOSSIP or warm["device_sync_rows"]:
        raise AssertionError(f"arena sync: want {GOSSIP} rows cold, 0 warm")
    log(f"[main path] vector cases passed: {results['vector_cases']}, as "
        f"wire bytes: {results['vector_cases_wire']}")
    launches = {name: launches[name] for name in VERIFY_KERNELS}
    log(f"[main path] launches: {launches} ({seconds:.1f} s)")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return {"gossip": gossip, "wire": wire, "sync": sync,
            "singles": singles, "each_msgs": each_msgs,
            "launches": launches, "sync_cold": cold, "sync_warm": warm}


def time_calls(calls, ops, rate, where: str) -> dict:
    """For each kernel of `calls` (its call, its plain version's, its
    inputs or byte count, its repetitions and its library call if any):
    kernel against plain version (bit-exact, or raise), the kernel's device
    time, the plain version's time, the library call's time, and the bound
    from `ops` (32-bit instructions at `rate` a second) and the bytes."""
    rows = {}
    for name, call in calls.items():
        kern, plain, reps = call["kern"], call["plain"], call["reps"]
        out = as_tuple(kern())
        ref = []                       # the plain run is timed once
        plain_ms = timed(lambda: ref.append(plain()))
        err = max_abs_err(out, as_tuple(ref[0]))
        log(f"[vs plain] {name} at {where}: max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {where}")
        ms = device_ms(kern, reps)
        lib = call.get("library")
        lib_ms = device_ms(lib, reps) if lib else None
        ops_ms = ops[name] / rate * 1e3
        nbytes = call.get("bytes") or io_bytes(call["ins"], out)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "max_abs_err": err, "bound_ms": max(ops_ms, bytes_ms),
                      "bound_by": "operations" if ops_ms >= bytes_ms
                      else "bytes", "ops": ops[name], "bytes": nbytes}
        log(f"[timing] {name}: {ms:.4f} ms, plain {plain_ms:.1f} ms, "
            f"library {lib_ms if lib_ms is None else round(lib_ms, 5)} ms, "
            f"bound {rows[name]['bound_ms']:.6f} ms "
            f"({rows[name]['bound_by']}; ops {ops[name]} -> {ops_ms:.6f} "
            f"ms, bytes {nbytes} -> {bytes_ms:.6f} ms)")
    return rows


def phase_timing(rng, bls, staged, main, dev, card):
    """At the main path's shapes (n = 64; the mask variant 4 sets x 512
    keys; 4,096 dirty rows into the filled arena; gathers of 64 and 4 x 512
    rows): each kernel against its plain version (bit-exact), the kernel's
    device time, the plain version's time, the library call's time where
    there is one, and the bounds."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, fp, pubkey_cache
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    gossip, wire = main["gossip"], main["wire"]
    sync, singles = main["sync"], main["singles"]
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
    m, k = len(sets4), SYNC_KEYS
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
    calls = {k: {"kern": v[0], "plain": v[1], "ins": v[2], "reps": v[3]}
             for k, v in calls.items()}

    # k_decode at the wire batch's shape, k_and on its two verdicts
    x, sign, inf = (t.to(dev) for t in bk.parse_g2_compressed_many(
        [s.signature.to_bytes() for s in wire]))
    ops["k_decode"] = k_decode_ops(c, inf.cpu().tolist())
    calls["k_decode"] = {
        "kern": lambda: staged.k_decode(x, sign, inf),
        "plain": lambda: staged.k_decode_plain(x, sign, inf),
        "ins": (x, sign, inf), "reps": 5}
    va, vb = staged.k_pair(*pair_in)[0], staged.k_decode(x, sign, inf)[3]
    ops["k_and"] = 1
    calls["k_and"] = {
        "kern": lambda: staged.k_and(va, vb),
        "plain": lambda: staged.k_and_plain(va, vb), "ins": (va, vb),
        "reps": 50, "library": lambda: torch.logical_and(va, vb)}

    # k_each at the _verify_many shape of the main path
    exp, eyp, epi = be._g1([s.pubkeys[0].point for s in gossip])
    ewords = torch.as_tensor(h2.pack_msg_words(main["each_msgs"]).view(
        np.int32)).to(dev)
    eh = staged.k_hash(staged.k_xmd(ewords))
    eargs = (exp, eyp, epi, xs, ys, si, *eh)
    ops["k_each"] = k_each_ops(c, epi.cpu().tolist(), si.cpu().tolist(),
                               eh[2].cpu().tolist())
    calls["k_each"] = {
        "kern": lambda: staged.k_each(*eargs),
        "plain": lambda: staged.k_each_plain(*eargs), "ins": eargs,
        "reps": 3}

    # the arena: 4,096 dirty rows scattered into copies of the filled
    # mirror (a scatter writes in place; repeating it changes nothing), and
    # the gathers of the main path's key rows
    cache = pubkey_cache.get_cache()
    live_x, live_y = cache.device_view(dev)
    rows_n = live_x.shape[0]
    g = torch.Generator(device=dev).manual_seed(rng.randrange(1 << 30))
    d = 4096
    sidx = torch.randperm(rows_n - 1, generator=g, device=dev)[:d] + 1
    svx = torch.randint(-2**31, 2**31 - 1, (d, 12), generator=g, device=dev,
                        dtype=torch.int32)
    svy = torch.randint(-2**31, 2**31 - 1, (d, 12), generator=g, device=dev,
                        dtype=torch.int32)
    arenas = {who: (live_x.clone(), live_y.clone())
              for who in ("kern", "plain", "library")}
    row_bytes = 2 * 12 * 4
    ops["k_scatter_rows"] = 0
    calls["k_scatter_rows"] = {
        "kern": lambda: staged.k_scatter_rows(*arenas["kern"], sidx, svx,
                                              svy),
        "plain": lambda: staged.k_scatter_rows_plain(*arenas["plain"], sidx,
                                                     svx, svy),
        # idx and the values read, the rows written
        "bytes": d * 8 + 2 * d * row_bytes, "reps": 20,
        "library": lambda: (arenas["library"][0].index_copy_(0, sidx, svx),
                            arenas["library"][1].index_copy_(0, sidx, svy))}
    gather_rows = {
        "k_gather_rows": cache.rows_for([s.pubkeys[0] for s in gossip]),
        "k_gather_rows_4x512": cache.rows_for(
            [pk for st in [sync] + singles
             for pk in st.pubkeys + [None] * (k - len(st.pubkeys))]),
    }
    for name, rws in gather_rows.items():
        rt = torch.from_numpy(rws).to(dev)
        ops[name] = 0
        calls[name] = {
            "kern": lambda rt=rt: staged.k_gather_rows(live_x, live_y, rt),
            "plain": lambda rt=rt: staged.k_gather_rows_plain(live_x, live_y,
                                                              rt),
            # the indices and the rows read, the rows and flags written
            "bytes": len(rws) * (8 + 2 * row_bytes + 1), "reps": 50,
            "library": lambda rt=rt: (torch.index_select(live_x, 0, rt),
                                      torch.index_select(live_y, 0, rt))}

    rows = time_calls(calls, ops, rate, "the main path's shape")
    for name in ("k_gather_rows", "k_gather_rows_4x512"):
        rows[name]["rows"] = len(gather_rows[name])
    rows["k_scatter_rows"].update(rows=d, arena_rows=rows_n)
    for who in ("plain", "library"):
        if max_abs_err(arenas["kern"], arenas[who]):
            raise AssertionError(f"k_scatter_rows: arena differs from {who}")

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
    four = sum(rows[nm]["ms"] for nm in SLICE_1)
    log(f"[timing] verify_signature_sets({n} sets): {med * 1e3:.1f} ms "
        f"median of 3 -> {n / med:.1f} sets/s (information only); the "
        f"four kernels' device times sum to {four:.1f} ms")

    # Information only: the wire batch end to end (host parse, every
    # kernel, one readback), and what decoding its signatures on the host
    # would cost instead.
    wire_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        ok = bls.verify_signature_sets(wire)
        wire_s.append(time.perf_counter() - t0)
        if not ok:
            raise AssertionError("wire batch failed while timing")
    if any(s.signature.decoded() for s in wire):
        raise AssertionError("wire batch decoded on the host while timing")
    raws = [s.signature.to_bytes() for s in wire]
    t0 = time.perf_counter()
    for raw in raws:
        if cv.g2_decompress(raw) is None:
            raise AssertionError("host decompression rejected a signature")
    host_decode_s = time.perf_counter() - t0
    wire_med = statistics.median(wire_s)
    kern = rows["k_decode"]["ms"] + rows["k_and"]["ms"] + four
    log(f"[timing] wire verify_signature_sets({n} sets): "
        f"{wire_med * 1e3:.1f} ms median of 3 (information only; k_decode "
        f"{rows['k_decode']['ms']:.2f} ms, all kernels {kern:.1f} ms); host "
        f"curve_ref.g2_decompress of the same {n} signatures: "
        f"{host_decode_s * 1e3:.1f} ms")
    # Information only: the per-set verdicts of the 64 sets end to end
    # (the backend's _verify_many: host pack, k_xmd, k_hash, k_each, one
    # readback), with the main path's tampered lane.
    pk_pts = [s.pubkeys[0].point for s in gossip]
    sig_pts = [s.signature.point for s in gossip]
    many_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        many = be._verify_many(pk_pts, main["each_msgs"], sig_pts)
        many_s.append(time.perf_counter() - t0)
        if many != [i != LANES["each"] for i in range(n)]:
            raise AssertionError("_verify_many failed while timing")
    many_med = statistics.median(many_s)
    log(f"[timing] _verify_many({n} sets): {many_med * 1e3:.1f} ms median "
        f"of 3 (information only; k_each {rows['k_each']['ms']:.2f} ms)")
    info = {"gossip_64_ms": med * 1e3, "wire_64_ms": wire_med * 1e3,
            "verify_many_64_ms": many_med * 1e3,
            "host_g2_decompress_64_ms": host_decode_s * 1e3}
    return rows, info


# --- The signer --------------------------------------------------------------


def _sk_words(ks, dev):
    """Secret scalars -> (n, 8) int32 little-endian words on dev."""
    import torch

    return torch.tensor([[(k >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
                         for k in ks], dtype=torch.int64).to(
                             torch.int32).to(dev)


def _root_words(msgs, dev):
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    return torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)).to(dev)


def _agg_args(rows, live, dev):
    """(m, k) rows of wire signatures and their live mask -> the planes of
    k_sign_agg on dev."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import sign_engine as se

    x, sign, inf, ok = se.parse_wire_planes([r for row in rows for r in row])
    if not ok.all():
        raise AssertionError("k_sign_agg inputs: a malformed encoding")
    m, k = len(rows), len(rows[0])
    return (torch.from_numpy(x.view(np.int32)).reshape(m, k, 2, 12).to(dev),
            torch.from_numpy(sign).reshape(m, k).to(dev),
            torch.from_numpy(inf).reshape(m, k).to(dev),
            torch.as_tensor(np.array(live, dtype=bool)).to(dev))


def _wire(planes):
    from lighthouse_tpu_torch.crypto.bls import sign_engine as se

    return [bytes(r) for r in se.compress_to_wire(*planes)]


def phase_sign_kernels_vs_plain(rng, dev):
    """The signer's kernels and the secret arena's, each against its plain
    version on identical inputs on the card, n = 8 with the edge cases."""
    import torch
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2
    from lighthouse_tpu_torch.crypto.bls.cuda import signer, staged

    out = {}
    # k_sign_root: scalars 1, 2, r - 1, one with bit 254 set, the zero
    # padding row, random ones
    ks = [1, 2, R - 1, (1 << 254) | rng.getrandbits(250), 0,
          rng.randrange(1, R), rng.randrange(1, R), R - 2]
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in ks]
    w, words = _sk_words(ks, dev), _root_words(msgs, dev)
    got = signer.k_sign_root(w, words)
    out["k_sign_root"] = max_abs_err(got, signer.k_sign_root_plain(w, words))
    inf_wire = bls.INFINITY_SIGNATURE
    want = [cv.g2_compress(hr.hash_to_g2(m).mul(k)) if k else inf_wire
            for k, m in zip(ks[:5], msgs[:5])]
    if _wire(got)[:5] != want:
        raise AssertionError("k_sign_root disagrees with host signing")
    # k_sign_field: messages that are not 32 bytes, the same scalars
    other = [b"", bytes(range(48)), bytes(100), b"a"] + [
        bytes(rng.randrange(256) for _ in range(33 + i)) for i in range(4)]
    u = staged.to_i32(h2.hash_to_field(other)).to(dev)
    got = signer.k_sign_field(w, u)
    out["k_sign_field"] = max_abs_err(got, signer.k_sign_field_plain(w, u))
    want = [cv.g2_compress(hr.hash_to_g2(m).mul(k))
            for k, m in zip(ks[:2], other[:2])]
    if _wire(got)[:2] != want or _wire(got)[4] != inf_wire:
        raise AssertionError("k_sign_field disagrees with host signing")
    # k_sign_agg at (3, 4): a repeated signature, sigma and -sigma, masked
    # lanes, an off-curve x (ok False)
    sigs = [hr.hash_to_g2(msgs[i]).mul(ks[i]) for i in (0, 2, 3)]
    raw = [cv.g2_compress(p) for p in sigs]
    rows = [[raw[0], raw[0], raw[1], raw[2]],
            [raw[1], cv.g2_compress(-sigs[1]), raw[2], raw[0]],
            [OFF_CURVE_X1, raw[0], raw[1], raw[2]]]
    live = [[True, True, True, False], [True, True, False, False],
            [True] * 4]
    args = _agg_args(rows, live, dev)
    got = signer.k_sign_agg(*args)
    out["k_sign_agg"] = max_abs_err(got, signer.k_sign_agg_plain(*args))
    if got[3].tolist() != [True, True, False] or _wire(got[:3])[:2] != [
            cv.g2_compress(sigs[0] + sigs[0] + sigs[1]), inf_wire]:
        raise AssertionError("k_sign_agg disagrees with the host sum")
    # the secret arena: a scatter with repeated rows, a gather of row 0
    # and the last row
    g = torch.Generator().manual_seed(rng.randrange(1 << 30))
    rows_n, d = 4096, 64
    a = torch.randint(-2**31, 2**31 - 1, (rows_n, 8), generator=g,
                      dtype=torch.int32)
    a[0] = 0
    idx = torch.randperm(rows_n - 1, generator=g)[:d].to(torch.int64) + 1
    idx[-4:] = idx[:4]
    v = torch.randint(-2**31, 2**31 - 1, (d, 8), generator=g,
                      dtype=torch.int32)
    v[-4:] = v[:4]
    kern, plain = a.to(dev), a.to(dev)
    staged.k_scatter_sk_rows(kern, idx.to(dev), v.to(dev))
    staged.k_scatter_sk_rows_plain(plain, idx.to(dev), v.to(dev))
    out["k_scatter_sk_rows"] = max_abs_err([kern], [plain])
    sel = torch.tensor([0, rows_n - 1, int(idx[5]), 0, 17], dtype=torch.int64,
                       device=dev)
    got = staged.k_gather_sk_rows(kern, sel)
    out["k_gather_sk_rows"] = max_abs_err(
        [got], [staged.k_gather_sk_rows_plain(kern, sel)])
    if got[0].any() or not torch.equal(got[2], v[5].to(dev)):
        raise AssertionError("k_gather_sk_rows: wrong rows")
    torch.cuda.synchronize()
    for name, err in out.items():
        log(f"[vs plain] {name}: max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    return out


def sign_keys(bls, count: int):
    """SecretKey(0x5ee0 + 7 i) and its PublicKey for i < count (the
    PublicKeys as a running host sum, pk_i = pk_{i-1} + 7 g1)."""
    sks = [bls.SecretKey(SIGN_KEY0 + SIGN_KEY_STEP * i) for i in range(count)]
    pks = [pk for chunk in arena_keys(bls, SIGN_KEY0, count,
                                      step=SIGN_KEY_STEP) for pk in chunk]
    return sks, pks


def phase_sign_path(rng, bls, dev):
    """The signer's main path, through crypto.bls.sign_engine with threshold
    1 (as bench.py's signing bench), every launch counter set to 0 just
    before: each cohort of SIGN_COHORTS cold (its keys' rows synced to the
    mirror on the card: n x 32 bytes) and warm (0 bytes, the same
    signatures), a stride sample of SIGN_PARITY lanes byte-equal to the
    host's SecretKey.sign; a mixed cohort of roots and longer messages (two
    launches, the order kept); the 4,096 cohort verified on the card as wire
    bytes (True) and with two signatures swapped (False); 32 committees of
    512 members signing their committee's root, summed by aggregate_batch
    at (32, 512): byte-equal to the host's AggregateSignature.from_signatures
    on 2 rows (a HostOracle), and all 32 verified by fast_aggregate_verify
    on the card."""
    from lighthouse_tpu_torch.crypto.bls import sign_engine as se
    from lighthouse_tpu_torch.crypto.bls.cuda import (seckey_cache, signer,
                                                      staged)

    n_keys = max(AGG_ROWS * AGG_K, max(SIGN_COHORTS))
    t0 = time.perf_counter()
    sks, pks = sign_keys(bls, n_keys)
    pk_bytes = [pk.to_bytes() for pk in pks]
    keys_s = time.perf_counter() - t0
    msgs = [i.to_bytes(32, "little") for i in range(max(SIGN_COHORTS))]
    log(f"[sign] {n_keys} keys and pubkeys built in {keys_s:.1f} s")

    se.reset_engine()
    se.configure(threshold=1)
    staged.reset_launches()
    signer.reset_launches()
    t_path = time.perf_counter()
    cohorts, sigs_of = {}, {}
    for n in SIGN_COHORTS:
        # a fresh arena sized for the cohort, mirrored on the card: a cold
        # cohort then syncs exactly its own rows
        cache = seckey_cache.reset_cache(initial_rows=n + 1)
        cache.device_view(dev)
        entries = [(sks[i], msgs[i], pk_bytes[i]) for i in range(n)]
        t0 = time.perf_counter()
        cold = se.sign_batch(entries)
        cold_ms = (time.perf_counter() - t0) * 1e3
        cold_call = se.last_call()
        t0 = time.perf_counter()
        warm = se.sign_batch(entries)
        warm_ms = (time.perf_counter() - t0) * 1e3
        warm_call = se.last_call()
        if (cold_call["backend"], warm_call["backend"]) != ("cuda", "cuda"):
            raise AssertionError(f"sign cohort {n}: not on the card")
        if cold_call["sync_bytes"] != n * 32 or warm_call["sync_bytes"]:
            raise AssertionError(
                f"sign cohort {n}: synced {cold_call['sync_bytes']} bytes "
                f"cold, {warm_call['sync_bytes']} warm (want {n * 32}, 0)")
        if warm != cold:
            raise AssertionError(f"sign cohort {n}: warm != cold")
        idx = list(range(0, n, n // SIGN_PARITY))
        t0 = time.perf_counter()
        refs = [sks[i].sign(msgs[i]).to_bytes() for i in idx]
        host_ms = (time.perf_counter() - t0) * 1e3 / len(idx)
        bad = [i for i, ref in zip(idx, refs) if cold[i] != ref]
        if bad:
            raise AssertionError(f"sign cohort {n}: lanes {bad} differ "
                                 "from host signing")
        cohorts[n] = {"cold_ms": cold_ms, "warm_ms": warm_ms,
                      "cold_sync_bytes": cold_call["sync_bytes"],
                      "warm_sync_bytes": warm_call["sync_bytes"],
                      "stages_warm": warm_call["stages"],
                      "sample": len(idx), "host_sign_ms": host_ms}
        sigs_of[n] = cold
        log(f"[sign] cohort {n}: cold {cold_ms:.1f} ms "
            f"({cold_call['sync_bytes']} bytes synced), warm {warm_ms:.1f} ms "
            f"(0 bytes), {len(idx)} "
            f"lanes byte-equal to host signing ({host_ms:.1f} ms each)")

    # a mixed cohort: roots and longer messages, one launch each
    nm = MIXED_COHORT
    mixed_msgs = [msgs[i] if i % 2 == 0 else msgs[i] + b"\x2a" * (i % 7 + 1)
                  for i in range(nm)]
    entries = [(sks[i], mixed_msgs[i], pk_bytes[i]) for i in range(nm)]
    mixed = se.sign_batch(entries)
    if se.last_call()["backend"] != "cuda":
        raise AssertionError("mixed cohort: not on the card")
    for i in (0, 1, 2, nm - 1):
        if mixed[i] != sks[i].sign(mixed_msgs[i]).to_bytes():
            raise AssertionError(f"mixed cohort: lane {i} differs")
    log(f"[sign] mixed cohort of {nm} (two launches): sampled lanes "
        "byte-equal to host signing")

    # the round trip: the largest cohort verified on the card, wire bytes
    n = max(SIGN_COHORTS)
    sigs = sigs_of[n]
    sets = [bls.SignatureSet(bls.LazySignature(sigs[i]), [pks[i]], msgs[i])
            for i in range(n)]
    t0 = time.perf_counter()
    ok = bls.verify_signature_sets(sets)
    verify_ms = (time.perf_counter() - t0) * 1e3
    sw = LANES["swap"]
    swapped = list(sets)
    swapped[sw], swapped[sw + 1] = (
        bls.SignatureSet(sets[sw + 1].signature, sets[sw].pubkeys,
                         sets[sw].message),
        bls.SignatureSet(sets[sw].signature, sets[sw + 1].pubkeys,
                         sets[sw + 1].message))
    bad = bls.verify_signature_sets(swapped)
    log(f"[sign] cohort {n} verified on the card as wire bytes: {ok} "
        f"({verify_ms:.1f} ms); two signatures swapped: {bad}")
    if ok is not True or bad is not False:
        raise AssertionError("sign -> verify round trip failed")
    if any(s.signature.decoded() for s in sets + swapped):
        raise AssertionError("round trip: a signature decoded on the host")

    # aggregate-and-proof: AGG_ROWS committees of AGG_K members, each
    # signing its committee's root
    cache = seckey_cache.reset_cache(initial_rows=n_keys + 1)
    cache.device_view(dev)
    roots = [(1 << 40 | c).to_bytes(32, "little") for c in range(AGG_ROWS)]
    members = se.sign_batch([(sks[i], roots[i // AGG_K], pk_bytes[i])
                             for i in range(AGG_ROWS * AGG_K)])
    groups = [members[c * AGG_K:(c + 1) * AGG_K] for c in range(AGG_ROWS)]
    host_rows = (0, AGG_ROWS - 1)

    def host_sums():
        t = time.perf_counter()
        sums = [bls.AggregateSignature.from_signatures(
            [bls.Signature.from_bytes(s) for s in groups[c]]).to_bytes()
            for c in host_rows]
        return sums, time.perf_counter() - t

    def check_host_sums(answer):
        sums, host_s = answer
        for c, host in zip(host_rows, sums):
            if aggs[c] != host:
                raise AssertionError(f"aggregate row {c} differs from the "
                                     "host")
        log(f"[sign] aggregate_batch rows {host_rows} byte-equal to the host "
            f"sum ({host_s:.1f} s on the host, in a child process)")

    before = signer.k_sign_agg.launches
    t0 = time.perf_counter()
    aggs = se.aggregate_batch(groups)
    agg_ms = (time.perf_counter() - t0) * 1e3
    if se.last_call()["backend"] != "cuda":
        raise AssertionError("aggregate_batch: not on the card")
    if signer.k_sign_agg.launches != before + 1:
        raise AssertionError("aggregate_batch: k_sign_agg's counter rose by "
                             f"{signer.k_sign_agg.launches - before}, not 1")
    # forked after the timed call: a fork's copy-on-write faults land in
    # the process that forked
    HostOracle("aggregate_batch host sums", host_sums, check_host_sums)
    be = bls.get_backend()
    verdicts = [be.fast_aggregate_verify(
        bls.AggregateSignature.from_bytes(aggs[c]), roots[c],
        pks[c * AGG_K:(c + 1) * AGG_K]) for c in range(AGG_ROWS)]
    wrong = be.fast_aggregate_verify(
        bls.AggregateSignature.from_bytes(aggs[0]), roots[1], pks[:AGG_K])
    log(f"[sign] aggregate_batch({AGG_ROWS} x {AGG_K}): {agg_ms:.1f} ms; "
        f"fast_aggregate_verify on the card: {sum(verdicts)}/{AGG_ROWS} "
        f"True, wrong root {wrong} (rows {host_rows} against the host sum "
        "when the host oracles are joined)")
    if not all(verdicts) or wrong is not False:
        raise AssertionError("aggregates do not verify")

    launches = {**staged.launch_counts(), **signer.launch_counts()}
    seconds = time.perf_counter() - t_path
    log(f"[sign] launches: {launches} ({seconds:.1f} s)")
    for name in SIGN_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the sign path")
    return {"sks": sks, "pks": pks, "msgs": msgs, "mixed_msgs": mixed_msgs,
            "sigs": sigs_of[max(SIGN_COHORTS)], "groups": groups, "cohorts": cohorts, "launches": launches,
            "verify_4096_ms": verify_ms, "aggregate_ms": agg_ms,
            "keys_s": keys_s}


# k_sign_agg's shapes beyond the path's: the path's rows with edge lanes
# placed across its segment edges, one row either side of the 64-lane
# mark, a lane, and twice the rows.
AGG_EDGE_SHAPES = ((AGG_ROWS, AGG_K), (1, 1), (1, 63), (1, 64), (1, 65),
                   (2 * AGG_ROWS, AGG_K))


def agg_edge_shapes(agg_args) -> dict:
    """k_sign_agg against its plain version (bit-exact, or raise) at
    AGG_EDGE_SHAPES, cut from the aggregate rows (the doubled rows: the
    rows and their lanes rotated by one) with check_layouts.agg_edge_planes
    placed: off-curve lanes (row 0 at 40; row 2 in the first, a middle and
    the last segment), infinities, masked lanes, malformed infinities, a
    repeat across 31 | 32 and sigma, -sigma across 63 | 64; rows 0, 2 and 3
    must come back ok False, the rest True.  Information only: the device
    time at the doubled rows."""
    import torch
    from lighthouse_tpu_torch.crypto.bls.cuda import signer
    from lighthouse_tpu_torch.tools.check_layouts import agg_edge_planes

    twice = tuple(torch.cat([t, t.roll(1, dims=1)]) for t in agg_args)
    errs, big = {}, None
    for m, k in AGG_EDGE_SHAPES:
        src = twice if m > AGG_ROWS else agg_args
        planes = agg_edge_planes(*(t[:m, :k] for t in src))
        got = signer.k_sign_agg(*planes)
        err = max_abs_err(got, signer.k_sign_agg_plain(*planes))
        errs[f"{m}x{k}"] = err
        log(f"[vs plain] k_sign_agg at {m} x {k} with edge lanes: "
            f"max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"k_sign_agg disagrees with its plain "
                                 f"version at {m} x {k} with edge lanes")
        if k > 65 and got[3].tolist()[:5] != [False, True, False, False,
                                               True]:
            raise AssertionError(f"k_sign_agg at {m} x {k}: ok "
                                 f"{got[3].tolist()[:5]} on the edge rows")
        if m > AGG_ROWS:
            big = planes
    ms = device_ms(lambda: signer.k_sign_agg(*big), 3)
    log(f"[timing] k_sign_agg at {2 * AGG_ROWS} x {AGG_K}: {ms:.4f} ms "
        "(information only)")
    return {"max_abs_err_edge_shapes": errs,
            f"ms_{2 * AGG_ROWS}x{AGG_K}": ms}


def phase_sign_timing(rng, bls, sign, dev, card):
    """At the sign path's shapes (k_sign_root on the 256 cohort, k_sign_field
    on the mixed cohort's longer messages, k_sign_agg at (32, 512), the
    secret arena's scatter of 4,096 rows and gather of 4,096): each kernel
    against its plain version (bit-exact), its device time, the plain
    version's time, the library call where one computes the same function,
    and the bound; then sign_batch end to end per cohort, aggregate_batch,
    and (information only) k_sign_root on 256 lanes of scalar 1 against 256
    lanes of scalar r - 1."""
    import torch
    from lighthouse_tpu_torch.crypto.bls import sign_engine as se
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import (fp, seckey_cache,
                                                      signer, staged)
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    c = op_model()
    rate = 64 * card["sms"] * card["max_sm_mhz"] * 1e6
    sks, msgs = sign["sks"], sign["msgs"]
    n = min(SIGN_COHORTS)
    ks = [sk.k for sk in sks[:n]]
    w, words = _sk_words(ks, dev), _root_words(msgs[:n], dev)
    uv = fp.unpack(staged.k_xmd(words).cpu())
    u_rows = [((uv[4 * i], uv[4 * i + 1]), (uv[4 * i + 2], uv[4 * i + 3]))
              for i in range(n)]
    lanes = [i for i, m in enumerate(sign["mixed_msgs"]) if len(m) != 32]
    fw = _sk_words([sks[i].k for i in lanes], dev)
    u = staged.to_i32(h2.hash_to_field(
        [sign["mixed_msgs"][i] for i in lanes])).to(dev)
    fuv = fp.unpack(u.cpu())
    fu_rows = [((fuv[4 * i], fuv[4 * i + 1]), (fuv[4 * i + 2], fuv[4 * i + 3]))
               for i in range(len(lanes))]
    agg_args = _agg_args(sign["groups"], [[True] * AGG_K] * AGG_ROWS, dev)
    ops = {"k_sign_root": k_sign_ops(c, ks, u_rows, True),
           "k_sign_field": k_sign_ops(c, [sks[i].k for i in lanes], fu_rows,
                                      False),
           "k_sign_agg": k_sign_agg_ops(
               c, (~agg_args[2]).sum(dim=1).tolist())}
    calls = {
        "k_sign_root": {"kern": lambda: signer.k_sign_root(w, words),
                        "plain": lambda: signer.k_sign_root_plain(w, words),
                        "ins": (w, words), "reps": 3},
        "k_sign_field": {"kern": lambda: signer.k_sign_field(fw, u),
                         "plain": lambda: signer.k_sign_field_plain(fw, u),
                         "ins": (fw, u), "reps": 3},
        "k_sign_agg": {"kern": lambda: signer.k_sign_agg(*agg_args),
                       "plain": lambda: signer.k_sign_agg_plain(*agg_args),
                       "ins": agg_args, "reps": 5},
    }
    # the secret arena: 4,096 dirty rows scattered into copies of the live
    # mirror (a scatter writes in place; repeating it changes nothing) and
    # the gather of the largest cohort's rows
    cache = seckey_cache.get_cache()
    live, rows_n = cache.device_view(dev)
    g = torch.Generator(device=dev).manual_seed(rng.randrange(1 << 30))
    d = max(SIGN_COHORTS)
    sidx = torch.randperm(rows_n - 1, generator=g, device=dev)[:d] + 1
    sv = torch.randint(-2**31, 2**31 - 1, (d, 8), generator=g, device=dev,
                       dtype=torch.int32)
    arenas = {who: live.clone() for who in ("kern", "plain", "library")}
    row_bytes = 8 * 4
    ops["k_scatter_sk_rows"] = ops["k_gather_sk_rows"] = 0
    calls["k_scatter_sk_rows"] = {
        "kern": lambda: staged.k_scatter_sk_rows(arenas["kern"], sidx, sv),
        "plain": lambda: staged.k_scatter_sk_rows_plain(arenas["plain"],
                                                        sidx, sv),
        "bytes": d * (8 + 2 * row_bytes), "reps": 20,
        "library": lambda: arenas["library"].index_copy_(0, sidx, sv)}
    grows = torch.from_numpy(cache.rows_for(
        [(pk.to_bytes(), sk.k) for sk, pk in zip(sks[:d], sign["pks"][:d])]
    )).to(dev)
    calls["k_gather_sk_rows"] = {
        "kern": lambda: staged.k_gather_sk_rows(live, grows),
        "plain": lambda: staged.k_gather_sk_rows_plain(live, grows),
        "bytes": d * (8 + 2 * row_bytes), "reps": 50,
        "library": lambda: torch.index_select(live, 0, grows)}

    rows = time_calls(calls, ops, rate, "the sign path's shape")
    rows["k_sign_root"]["lanes"] = n
    rows["k_sign_field"]["lanes"] = len(lanes)
    rows["k_sign_agg"]["shape"] = [AGG_ROWS, AGG_K]
    rows["k_sign_agg"].update(agg_edge_shapes(agg_args))
    rows["k_scatter_sk_rows"].update(rows=d, arena_rows=rows_n)
    rows["k_gather_sk_rows"]["rows"] = d
    for who in ("plain", "library"):
        if max_abs_err([arenas["kern"]], [arenas[who]]):
            raise AssertionError(f"k_scatter_sk_rows: arena differs from "
                                 f"{who}")

    # Information only: a constant-sequence ladder takes the same time for
    # every scalar
    w_one = _sk_words([1] * n, dev)
    w_big = _sk_words([R - 1] * n, dev)
    one_ms = device_ms(lambda: signer.k_sign_root(w_one, words), 3)
    big_ms = device_ms(lambda: signer.k_sign_root(w_big, words), 3)
    log(f"[timing] k_sign_root on {n} lanes of scalar 1: {one_ms:.4f} ms; "
        f"of scalar r - 1: {big_ms:.4f} ms (information only: equal within "
        "noise for a constant-sequence ladder)")

    # End to end: warm cohorts through sign_batch, then aggregate_batch
    e2e = {}
    for nc in SIGN_COHORTS:
        cache = seckey_cache.reset_cache(initial_rows=nc + 1)
        entries = [(sks[i], msgs[i], sign["pks"][i].to_bytes())
                   for i in range(nc)]
        se.sign_batch(entries)                          # cold
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            se.sign_batch(entries)
            ts.append(time.perf_counter() - t0)
        if se.last_call()["sync_bytes"]:
            raise AssertionError("warm cohort synced arena bytes")
        med = statistics.median(ts)
        e2e[nc] = {"ms": med * 1e3, "sigs_per_s": nc / med,
                   "stages": se.last_call()["stages"]}
        log(f"[timing] sign_batch({nc}) warm: {med * 1e3:.1f} ms median of "
            f"3 -> {nc / med:.0f} signatures/s (stages {e2e[nc]['stages']})")
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        se.aggregate_batch(sign["groups"])
        ts.append(time.perf_counter() - t0)
    agg_ms = statistics.median(ts) * 1e3
    log(f"[timing] aggregate_batch({AGG_ROWS} x {AGG_K}): {agg_ms:.1f} ms "
        "median of 3")
    info = {"sign_e2e": e2e, "aggregate_ms": agg_ms,
            "k_sign_root_scalar_1_ms": one_ms,
            "k_sign_root_scalar_r_minus_1_ms": big_ms}
    return rows, info


# --- The hash engine ---------------------------------------------------------


def _le_words(data: bytes, shape, dev):
    """Little-endian words of `data` as an int32 tensor on dev."""
    import numpy as np
    import torch

    return torch.from_numpy(np.frombuffer(data, "<i4").reshape(shape)
                            .copy()).to(dev)


def _digest_bytes(out) -> list:
    """(n, 8) int32 digest words -> n 32-byte digests."""
    raw = out.cpu().numpy().tobytes()
    return [raw[32 * i:32 * (i + 1)] for i in range(out.shape[0])]


def _state_bytes(state) -> list:
    """(n, 8) int32 natural-value state -> n 32-byte digests."""
    import numpy as np

    raw = state.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
    return [raw[32 * i:32 * (i + 1)] for i in range(state.shape[0])]


def phase_sha_kernels_vs_plain(rng, dev):
    """The hash engine's kernels and their plain versions on the card, and
    hashlib lane by lane: k_pairs and k_entry on 8 and on 7 lanes (an
    all-zero and an all-0xFF message among random ones); k_level on the
    zero-hash chain (8 zero chunks pairs up to ZERO_HASHES[4]) and from 14
    random nodes to 7; k_digest at m = 1, 2, 3, 4 blocks.  Bit-exact."""
    import hashlib

    import torch
    from lighthouse_tpu_torch.crypto.sha256 import padding
    from lighthouse_tpu_torch.crypto.sha256.cuda import kernel as hk
    from lighthouse_tpu_torch.ssz.hash import ZERO_HASHES

    sha = hashlib.sha256
    out = {k: 0 for k in SHA_KERNELS}
    for n in (8, 7):
        msgs = [bytes(64), b"\xff" * 64] + [
            bytes(rng.randrange(256) for _ in range(64)) for _ in range(n - 2)]
        words = _le_words(b"".join(msgs), (n, 16), dev)
        pairs, entry = hk.k_pairs(words), hk.k_entry(words)
        out["k_pairs"] = max(out["k_pairs"], max_abs_err(
            [pairs], [hk.k_pairs_plain(words)]))
        out["k_entry"] = max(out["k_entry"], max_abs_err(
            [entry], [hk.k_entry_plain(words)]))
        want = [sha(m).digest() for m in msgs]
        if _digest_bytes(pairs) != want or _state_bytes(entry) != want:
            raise AssertionError(f"k_pairs / k_entry != hashlib at n = {n}")

    # the zero-hash chain: every level must be ZERO_HASHES[d + 1]
    x = hk.k_entry(_le_words(bytes(8 * 64), (8, 16), dev))
    if _state_bytes(x) != [ZERO_HASHES[1]] * 8:
        raise AssertionError("k_entry of zero chunks != ZERO_HASHES[1]")
    for d in (1, 2, 3):
        y = hk.k_level(x)
        out["k_level"] = max(out["k_level"], max_abs_err(
            [y], [hk.k_level_plain(x)]))
        if _state_bytes(y) != [ZERO_HASHES[d + 1]] * y.shape[0]:
            raise AssertionError(f"k_level at depth {d} != ZERO_HASHES")
        x = y
    state = _le_words(bytes(rng.randrange(256) for _ in range(14 * 32)),
                      (14, 8), dev)                  # any natural words
    y = hk.k_level(state)
    out["k_level"] = max(out["k_level"], max_abs_err(
        [y], [hk.k_level_plain(state)]))
    leaves = _state_bytes(state)
    if _state_bytes(y) != [sha(leaves[2 * j] + leaves[2 * j + 1]).digest()
                           for j in range(7)]:
        raise AssertionError("k_level != hashlib on 14 random nodes")

    for m, length in ((1, 55), (2, 64), (3, 150), (4, 247)):
        msgs = [bytes(length), b"\xff" * length] + [
            bytes(rng.randrange(256) for _ in range(length - j))
            for j in range(6)]
        if any(padding.block_count(len(x)) != m for x in msgs):
            raise AssertionError(f"k_digest inputs do not pad to {m} blocks")
        blocks = padding.msgs_to_blocks(msgs)
        b = _le_words(blocks.tobytes(), blocks.shape, dev)
        got = hk.k_digest(b)
        out["k_digest"] = max(out["k_digest"], max_abs_err(
            [got], [hk.k_digest_plain(b)]))
        if _digest_bytes(got) != [sha(x).digest() for x in msgs]:
            raise AssertionError(f"k_digest != hashlib at m = {m}")
    torch.cuda.synchronize()
    for name, err in out.items():
        log(f"[vs plain] {name}: max_abs_err={err} (and equal to hashlib)")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    return out


def swap_tree_caches(store: dict) -> dict:
    """Swap the hash caches of every SSZ List class (its element-root memo
    and its layer cache) with those in `store`, and return the ones swapped
    out: two backends then root the same states with caches of their own."""
    from lighthouse_tpu_torch.ssz import core

    out = {}
    for cls in list(core._PARAM_CACHE.values()):
        if not (isinstance(cls, type) and issubclass(cls, core.List)):
            continue
        for attr in ("_elem_memo", "_tree_cache"):
            if attr in cls.__dict__:
                out[(cls, attr)] = cls.__dict__[attr]
                delattr(cls, attr)
            if (cls, attr) in store:
                setattr(cls, attr, store[(cls, attr)])
    return out


def build_state(seed: int, n: int):
    """A MAINNET Deneb state of n validators from `seed`: distinct pubkeys
    and eth1 withdrawal credentials, effective balances of 31-32 ETH and
    balances around them, activation epochs spread over the chain's life,
    a few exited and slashed validators, filled participation lists and
    inactivity scores, random randao mixes and block / state roots."""
    import numpy as np
    from lighthouse_tpu_torch import types as ty

    g = np.random.default_rng(seed)
    T = ty.SpecTypes(ty.MAINNET)
    epoch = 269_568 + int(g.integers(0, 10_000))   # after Deneb on mainnet
    far = ty.FAR_FUTURE_EPOCH
    gwei = 10 ** 9
    pk = g.integers(0, 256, (n, 48), dtype=np.uint8)
    pk[:, :4] = np.arange(n, dtype=">u4").view(np.uint8).reshape(n, 4)
    pk[:, 0] |= 0x80                                # compressed flag
    wc = np.zeros((n, 32), np.uint8)
    wc[:, 0] = 1                                    # eth1 credentials
    wc[:, 12:] = g.integers(0, 256, (n, 20), dtype=np.uint8)
    wc[:, 12:16] = np.arange(n, dtype=">u4").view(np.uint8).reshape(n, 4)
    eff = np.where(g.random(n) < 0.97, 32, 31) * gwei
    bal = eff + g.integers(0, gwei // 20, n)
    act = g.integers(0, epoch - 256, n)
    exits = g.random(n) < 0.01
    slashed = g.random(n) < 0.001
    validators = []
    for i in range(n):
        ex = int(act[i]) + 300 if exits[i] else far
        validators.append(ty.Validator(
            pubkey=pk[i].tobytes(), withdrawal_credentials=wc[i].tobytes(),
            effective_balance=int(eff[i]), slashed=bool(slashed[i]),
            activation_eligibility_epoch=max(int(act[i]) - 5, 0),
            activation_epoch=int(act[i]), exit_epoch=ex,
            withdrawable_epoch=ex if ex == far else ex + 256))

    def roots(k):
        raw = g.integers(0, 256, (k, 32), dtype=np.uint8).tobytes()
        return [raw[32 * j:32 * (j + 1)] for j in range(k)]

    E = ty.MAINNET
    committee = [validators[int(j)].pubkey for j in g.integers(0, n, 512)]
    state = T.BeaconStateDeneb(
        genesis_time=1_606_824_023, genesis_validators_root=roots(1)[0],
        slot=epoch * E.slots_per_epoch + 5,
        fork=ty.Fork(previous_version=b"\x03\x00\x00\x00",
                     current_version=b"\x04\x00\x00\x00", epoch=269_568),
        latest_block_header=ty.BeaconBlockHeader(
            slot=epoch * E.slots_per_epoch + 4, proposer_index=7,
            parent_root=roots(1)[0], body_root=roots(1)[0]),
        block_roots=roots(E.slots_per_historical_root),
        state_roots=roots(E.slots_per_historical_root),
        historical_roots=roots(758),
        eth1_data=ty.Eth1Data(deposit_root=roots(1)[0], deposit_count=n,
                              block_hash=roots(1)[0]),
        eth1_deposit_index=n,
        randao_mixes=roots(E.epochs_per_historical_vector),
        slashings=[int(x) * gwei for x in
                   (g.random(E.epochs_per_slashings_vector) < 0.01)],
        previous_epoch_participation=g.integers(0, 8, n).tolist(),
        current_epoch_participation=g.integers(0, 8, n).tolist(),
        justification_bits=[True, True, True, False],
        previous_justified_checkpoint=ty.Checkpoint(epoch=epoch - 2,
                                                    root=roots(1)[0]),
        current_justified_checkpoint=ty.Checkpoint(epoch=epoch - 1,
                                                   root=roots(1)[0]),
        finalized_checkpoint=ty.Checkpoint(epoch=epoch - 2,
                                           root=roots(1)[0]),
        inactivity_scores=np.where(g.random(n) < 0.05,
                                   g.integers(1, 64, n), 0).tolist(),
        current_sync_committee=T.SyncCommittee(
            pubkeys=committee, aggregate_pubkey=committee[0]),
        next_sync_committee=T.SyncCommittee(
            pubkeys=committee[::-1], aggregate_pubkey=committee[1]),
        next_withdrawal_index=int(g.integers(0, 10 ** 8)),
        next_withdrawal_validator_index=int(g.integers(0, n)),
        historical_summaries=[ty.HistoricalSummary(
            block_summary_root=r, state_summary_root=r) for r in roots(64)],
    )
    state.validators = validators
    state.balances = [int(b) for b in bal]
    return T, state


def block_change(g, state, E):
    """A block-sized change: 128 balances, one validator's slashed flag and
    exit epoch, one randao mix, one block root and one state root."""
    n = len(state.validators)
    for i in g.integers(0, n, 128):
        state.balances[int(i)] += int(g.integers(1, 10 ** 7))
    v = state.validators[int(g.integers(0, n))]
    v.slashed = True
    v.exit_epoch = state.slot // E.slots_per_epoch + 5
    state.randao_mixes[int(g.integers(0, E.epochs_per_historical_vector))] \
        = bytes(g.integers(0, 256, 32, dtype="uint8"))
    state.block_roots[state.slot % E.slots_per_historical_root] = bytes(32)
    state.state_roots[state.slot % E.slots_per_historical_root] = b"\x01" * 32
    state.slot += 1


def _shuffles(state, seed: bytes, E, spec):
    """The shuffle of every validator index forward and inverted, and the
    512-member sync committee sample (rejection sampling by balance)."""
    import numpy as np
    from lighthouse_tpu_torch.state_transition.epoch_engine import shuffle

    n = len(state.validators)
    fwd = shuffle.batched_shuffle_indices(n, seed, spec.shuffle_round_count)
    inv = shuffle.batched_shuffle_indices(n, seed, spec.shuffle_round_count,
                                          invert=True)
    eff = np.array([v.effective_balance for v in state.validators],
                   dtype=np.uint64)
    sync = shuffle.sample_sync_committee_indices(
        np.arange(n, dtype=np.uint64), eff, seed, E.sync_committee_size,
        spec.max_effective_balance, spec.shuffle_round_count)
    return fwd, inv, sync


def phase_state_root_path(seed: int, dev):
    """The state-root and shuffle path through the port's SSZ and hash
    engine, launch counters from 0.  The hashlib oracle runs in a
    HostOracle on a state it builds from the same seed (with caches of its
    own): the cold root, the same block change (the same generator), the
    warm root and the shuffles.  Returns its record, the types and the
    state (the epoch path goes on from it)."""
    import numpy as np
    from lighthouse_tpu_torch import types as ty
    from lighthouse_tpu_torch.crypto.sha256 import api as hapi
    from lighthouse_tpu_torch.crypto.sha256.cuda import kernel as hk

    E, spec = ty.MAINNET, ty.ChainSpec.mainnet()
    ms = {}

    def states():
        T, state = build_state(seed, STATE_VALIDATORS)
        g = np.random.default_rng(seed + 1)
        return T, state, g, bytes(g.integers(0, 256, 32, dtype=np.uint8))

    def timed_root(state, key, into):
        t = time.perf_counter()
        root = type(state).hash_tree_root(state)
        into[key] = (time.perf_counter() - t) * 1e3
        return root

    def oracle_run():
        hapi.configure(backend="hashlib")
        _, state, g, shuffle_seed = states()
        t_ms = {}
        roots = {"cold": timed_root(state, "hashlib_cold", t_ms)}
        block_change(g, state, E)
        roots["warm"] = timed_root(state, "hashlib_warm", t_ms)
        t = time.perf_counter()
        shuffles = _shuffles(state, shuffle_seed, E, spec)
        t_ms["hashlib_shuffles"] = (time.perf_counter() - t) * 1e3
        return roots, shuffles, t_ms

    record = {}

    def check(answer):
        oracle, oracle_shuffles, t_ms = answer
        ms.update(t_ms)
        for key in ("cold", "warm"):
            log(f"[state root] {key}: cuda {got[key].hex()} "
                f"({ms['cuda_' + key]:.0f} ms), hashlib {oracle[key].hex()} "
                f"({ms['hashlib_' + key]:.0f} ms, in a child process)")
            if got[key] != oracle[key]:
                raise AssertionError(f"{key} state root differs from hashlib")
        for name, a, b in zip(("forward", "inverted"), shuffles[:2],
                              oracle_shuffles[:2]):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name} shuffle differs from hashlib")
        if shuffles[2] != oracle_shuffles[2]:
            raise AssertionError("sync committee sample differs from hashlib")
        log(f"[state root] shuffle of {STATE_VALIDATORS} indices (90 rounds) "
            f"forward and inverted and the {E.sync_committee_size}-member "
            f"sync sample equal hashlib's ({ms['cuda_shuffles']:.0f} ms on "
            f"cuda, {ms['hashlib_shuffles']:.0f} ms on hashlib)")

    # forked before this process builds its state: the child builds its
    # own from the seed, so neither roots the other's objects and no
    # copy-on-write fault lands in the card's timings
    HostOracle("state roots and shuffles on hashlib", oracle_run, check)
    t0 = time.perf_counter()
    T, state, g, shuffle_seed = states()
    build_s = time.perf_counter() - t0
    log(f"[state root] MAINNET BeaconStateDeneb with {STATE_VALIDATORS} "
        f"validators built in {build_s:.1f} s")
    swap_tree_caches({})               # the card's roots: caches of their own
    hapi.reset_engine()                    # cuda, threshold 1024, counts 0
    status0 = hapi.engine_status()
    got = {"cold": timed_root(state, "cuda_cold", ms)}
    status1 = hapi.engine_status()
    block_change(g, state, E)
    got["warm"] = timed_root(state, "cuda_warm", ms)
    status2 = hapi.engine_status()
    t = time.perf_counter()
    shuffles = _shuffles(state, shuffle_seed, E, spec)
    ms["cuda_shuffles"] = (time.perf_counter() - t) * 1e3
    status3 = hapi.engine_status()
    launches = hk.launch_counts()
    hapi.reset_engine()
    log(f"[state root] cuda: cold {got['cold'].hex()} "
        f"({ms['cuda_cold']:.0f} ms), warm {got['warm'].hex()} "
        f"({ms['cuda_warm']:.0f} ms), shuffles {ms['cuda_shuffles']:.0f} ms "
        "(against hashlib when the host oracles are joined)")
    if sorted(shuffles[0].tolist()) != list(range(STATE_VALIDATORS)) or \
            not np.array_equal(shuffles[1][shuffles[0]],
                               np.arange(STATE_VALIDATORS)):
        raise AssertionError("shuffle is not a permutation with its inverse")
    if len(shuffles[2]) != E.sync_committee_size:
        raise AssertionError("sync committee sample of the wrong size")

    def delta(a, b, key):
        return {k: b[key][k] - a[key][k] for k in a[key]}

    per_root = {"cold": delta(status0, status1, "transfer"),
                "warm": delta(status1, status2, "transfer"),
                "shuffles": delta(status2, status3, "transfer")}
    digests = {"cold": delta(status0, status1, "digests"),
               "warm": delta(status1, status2, "digests"),
               "shuffles": delta(status2, status3, "digests")}
    widest = status3["widest"]
    log(f"[state root] launches {launches}; bytes to / from the card "
        f"{per_root}; digests by backend {digests}; widest call answered "
        f"by hashlib {widest['hashlib']} (threshold {status3['threshold']})")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    if widest["hashlib"] >= status3["threshold"]:
        raise AssertionError("a level at or above the threshold was "
                             "answered by hashlib")
    record.update({"launches": launches, "ms": ms, "transfer": per_root,
                   "digests": digests, "widest": widest, "build_s": build_s,
                   "roots": {k: v.hex() for k, v in got.items()}})
    return record, T, state


def merkleize_levels(leaves: int) -> dict:
    """The JAX bench's hash section (bench.py:140-206) on the card: a
    2^17-leaf merkleize through reduce_levels with per-level stats and the
    host tail, best of 3, against hashlib's root."""
    import hashlib

    from lighthouse_tpu_torch.crypto.sha256 import api as hapi
    from lighthouse_tpu_torch.ssz.hash import ZERO_HASHES, merkleize

    depth = (leaves - 1).bit_length()
    buf = b"".join(hashlib.sha256(i.to_bytes(8, "little")).digest()
                   for i in range(leaves))
    hapi.configure(backend="hashlib")
    t0 = time.perf_counter()
    want = merkleize(buf)
    hashlib_ms = (time.perf_counter() - t0) * 1e3
    hapi.configure(backend="cuda")
    if merkleize(buf) != want:
        raise AssertionError("merkleize on cuda differs from hashlib")
    best, levels = None, None
    for _ in range(3):
        rows = []
        t0 = time.perf_counter()
        level, d = hapi.reduce_levels(buf, 0, ZERO_HASHES, depth, stats=rows)
        while d < depth:
            t1 = time.perf_counter()
            if (len(level) // 32) % 2:
                level = bytes(level) + ZERO_HASHES[d]
            pairs = len(level) // 64
            level = hapi.hash_pairs(level)
            d += 1
            rows.append({"pairs": pairs, "backend": hapi.backend_for(pairs),
                         "ms": round((time.perf_counter() - t1) * 1e3, 3)})
        wall = (time.perf_counter() - t0) * 1e3
        if level[:32] != want:
            raise AssertionError("reduce_levels root differs from hashlib")
        if best is None or wall < best:
            best, levels = wall, rows
    if any(r["backend"] != "cuda" for r in levels
           if r["pairs"] >= hapi.batch_threshold()):
        raise AssertionError("a wide merkleize level was not on cuda")
    hapi.reset_engine()
    log(f"[merkleize] {leaves} leaves: cuda {best:.2f} ms, hashlib "
        f"{hashlib_ms:.2f} ms; levels {levels}")
    return {"leaves": leaves, "cuda_ms": best, "hashlib_ms": hashlib_ms,
            "levels": levels}


def phase_sha_timing(rng, dev, card):
    """At the main path's shapes (k_pairs on the 2^20 grove's first level,
    4,194,304 lanes; k_entry on randao_mixes' 32,768 pairs; k_level from
    32,768 nodes to 16,384; k_digest on the 2^20 shuffle's 368,730
    one-block seeds): each kernel against its plain version (bit-exact), a
    sample of lanes against hashlib, its device time, the plain version's
    time, the bound, and (information) hashlib's time for the same
    digests.  No PyTorch call computes SHA-256: library_ms is null."""
    import hashlib

    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.sha256 import padding
    from lighthouse_tpu_torch.crypto.sha256.cuda import kernel as hk

    rate = 64 * card["sms"] * card["max_sm_mhz"] * 1e6
    gen = torch.Generator(device=dev).manual_seed(rng.randrange(1 << 30))

    def rand_words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    pw = rand_words(SHA_SHAPES["k_pairs"], 16)
    ew = rand_words(SHA_SHAPES["k_entry"], 16)
    lv = rand_words(2 * SHA_SHAPES["k_level"], 8)
    seeds = shuffle_messages(bytes(rng.randrange(256) for _ in range(32)))
    n = len(seeds)
    blocks = padding.msgs_to_blocks(seeds)
    dw = _le_words(blocks.tobytes(), blocks.shape, dev)
    pair_ops = SHA_VAR + SHA_CONST
    ops = {"k_pairs": pw.shape[0] * pair_ops, "k_entry": ew.shape[0] * pair_ops,
           "k_level": lv.shape[0] // 2 * pair_ops, "k_digest": n * SHA_VAR}
    calls = {
        "k_pairs": {"kern": lambda: hk.k_pairs(pw),
                    "plain": lambda: hk.k_pairs_plain(pw), "ins": (pw,),
                    "reps": 5},
        "k_entry": {"kern": lambda: hk.k_entry(ew),
                    "plain": lambda: hk.k_entry_plain(ew), "ins": (ew,),
                    "reps": 50},
        "k_level": {"kern": lambda: hk.k_level(lv),
                    "plain": lambda: hk.k_level_plain(lv), "ins": (lv,),
                    "reps": 50},
        "k_digest": {"kern": lambda: hk.k_digest(dw),
                     "plain": lambda: hk.k_digest_plain(dw), "ins": (dw,),
                     "reps": 20},
    }
    rows = time_calls(calls, ops, rate, "the state-root path's shape")

    # a stride sample of lanes against hashlib, and hashlib's time for all
    sha = hashlib.sha256
    host = {}
    for name, words in (("k_pairs", pw), ("k_entry", ew), ("k_level", lv)):
        raw = (words.cpu().numpy().tobytes() if name != "k_level" else
               words.cpu().numpy().view(np.uint32).astype(">u4").tobytes())
        lanes = len(raw) // 64
        t = time.perf_counter()
        digests = [sha(raw[64 * i:64 * (i + 1)]).digest()
                   for i in range(lanes)]
        host[name] = (time.perf_counter() - t) * 1e3
        out = hk.KERNELS[name](words)
        got = (_digest_bytes(out) if name == "k_pairs" else _state_bytes(out))
        step = max(lanes // 4096, 1)
        if got[::step] != digests[::step]:
            raise AssertionError(f"{name} != hashlib at the main shape")
    t = time.perf_counter()
    digests = [sha(m).digest() for m in seeds]
    host["k_digest"] = (time.perf_counter() - t) * 1e3
    if _digest_bytes(hk.k_digest(dw))[::97] != digests[::97]:
        raise AssertionError("k_digest != hashlib at the main shape")
    for name in SHA_KERNELS:
        rows[name]["lanes"] = list(calls[name]["ins"][0].shape)
        rows[name]["hashlib_ms"] = host[name]
        log(f"[timing] {name}: hashlib for the same digests "
            f"{host[name]:.1f} ms (host, information only)")
    return rows


def shuffle_messages(seed: bytes) -> list:
    """The one-block messages of a 2^20-index, 90-round shuffle in one
    digest_many call: the 90 pivot seeds and 90 x 4,096 source seeds
    (state_transition/epoch_engine/shuffle.py)."""
    rounds, chunks = SHUFFLE_ROUNDS, (STATE_VALIDATORS + 255) // 256
    msgs = [seed + bytes([r]) for r in range(rounds)]
    msgs += [seed + bytes([r]) + c.to_bytes(4, "little")
             for r in range(rounds) for c in range(chunks)]
    return msgs



# --- The epoch transition ----------------------------------------------------

EPOCH_PREV = 270_000       # a mainnet epoch after Deneb
GWEI = 10 ** 9


def epoch_edge_lanes():
    """Eight lanes of the epoch kernels' edge cases (uint64 planes as numpy
    arrays) and two k_state scalar vectors, leak off and on.  Lanes:
    0 a full participant; 1 activated exactly at prev, no flags, a balance
    below its penalties (the saturating subtract); 2 activated exactly at
    cur; 3 slashed with wd == slash_wd (the sweep hits); 4 slashed, exited
    at prev, wd == slash_wd + 1 (eligible, no sweep); 5 pending activation
    with b + down == eff; 6 exited with eff + up == b (the hysteresis
    edges, no update); 7 the envelope edge, eff 2^40 and score 2^26 out of
    target (eff * score wraps).  FAR_FUTURE_EPOCH exits and withdrawable
    epochs on lanes 0, 1, 2, 5 and 7; the previous flags take all 8
    values, the current flags too."""
    import math

    import numpy as np

    far = (1 << 64) - 1
    prev, cur = EPOCH_PREV, EPOCH_PREV + 1
    slash_wd = cur + 8192 // 2      # MAINNET epochs_per_slashings_vector
    down, up = GWEI // 4, GWEI // 4 * 5
    lanes = [  # eff, bal, slashed, act, exit, wd, score, pflags, cflags
        (32 * GWEI, 32 * GWEI + 123_456_789, 0, 0, far, far, 0, 7, 0),
        (32 * GWEI, 1000, 0, prev, far, far, 5, 0, 1),
        (31 * GWEI, 31 * GWEI + GWEI // 2, 0, cur, far, far, 3, 1, 2),
        (32 * GWEI, 32 * GWEI, 1, 0, cur + 10, slash_wd, 40, 2, 3),
        (32 * GWEI, 32 * GWEI, 1, 0, prev, slash_wd + 1, 7, 3, 4),
        (31 * GWEI, 31 * GWEI - down, 0, far, far, far, 0, 4, 5),
        (31 * GWEI, 31 * GWEI + up, 0, 0, prev - 1, prev + 300, 9, 6, 6),
        (1 << 40, 32 * GWEI, 0, 0, far, far, 1 << 26, 5, 7),
    ]
    cols = list(zip(*lanes))
    u64 = lambda c: np.array(c, dtype=np.uint64)
    planes = {"eff": u64(cols[0]), "bal": u64(cols[1]),
              "slashed": np.array(cols[2], dtype=np.uint8),
              "act": u64(cols[3]), "exitp": u64(cols[4]), "wd": u64(cols[5]),
              "scores": u64(cols[6]),
              "pflags": np.array(cols[7], dtype=np.uint8),
              "cflags": np.array(cols[8], dtype=np.uint8)}
    total_active = sum(e for e, _, _, a, x, *_ in lanes if a <= cur < x)
    scalars = []
    for leak in (0, 1):
        s = [0] * 18
        s[0], s[1], s[2] = prev, cur, leak
        s[3] = GWEI * 64 // math.isqrt(total_active)   # per increment
        s[4] = total_active // GWEI
        s[5:8] = [total_active // GWEI // k for k in (2, 3, 4)]
        s[8], s[9], s[10] = 4, 16, 4 * 2 ** 24        # bias, recovery
        s[11], s[12] = min(3 * 64 * GWEI, total_active), total_active
        s[13], s[14], s[15], s[16], s[17] = (GWEI, 32 * GWEI, down, up,
                                              slash_wd)
        scalars.append(s)
    return planes, scalars


def _epoch_args(planes, scal, dev):
    """The two kernels' arguments on dev from numpy planes and a scalar
    vector."""
    from lighthouse_tpu_torch.state_transition.epoch_engine.cuda import (
        kernel as ek)

    t = {k: ek.plane(v, dev) for k, v in planes.items()}
    sums = (t["eff"], t["act"], t["exitp"], t["slashed"], t["pflags"],
            t["cflags"], ek.scalar_tensor(scal[:2]))
    state = (t["eff"], t["bal"], t["slashed"], t["act"], t["exitp"], t["wd"],
             t["scores"], t["pflags"], ek.scalar_tensor(scal))
    return sums, state


def u64_err(xs, ys) -> int:
    """max |x - y| over int64 tensors of uint64 bit patterns, exact."""
    import numpy as np

    err = 0
    for x, y in zip(xs, ys):
        a = x.cpu().numpy().view(np.uint64)
        b = y.cpu().numpy().view(np.uint64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {a.shape} != {b.shape}")
        if a.size:
            err = max(err, int(np.where(a > b, a - b, b - a).max()))
    return err


def phase_epoch_kernels_vs_plain(dev):
    """k_sums and k_state against their plain versions on the card at
    n = 8 (epoch_edge_lanes, leak off and on): bit-exact."""
    import torch
    from lighthouse_tpu_torch.state_transition.epoch_engine.cuda import (
        kernel as ek)

    planes, scalar_sets = epoch_edge_lanes()
    out = {"k_sums": 0, "k_state": 0}
    for scal in scalar_sets:
        sums, state = _epoch_args(planes, scal, dev)
        out["k_sums"] = max(out["k_sums"], u64_err(
            [ek.k_sums(*sums)], [ek.k_sums_plain(*sums)]))
        out["k_state"] = max(out["k_state"], u64_err(
            ek.k_state(*state), ek.k_state_plain(*state)))
    torch.cuda.synchronize()
    for name, err in out.items():
        log(f"[vs plain] {name}: max_abs_err={err} (n = 8 edge lanes, leak "
            "off and on)")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    return out


def plant_epoch_features(state, E, spec):
    """Move the state to the last slot of its epoch (one epoch on where the
    next would start a sync-committee period: its pubkeys are random bytes,
    which cannot be aggregated) and plant the registry features of
    bench.py's epoch state: pending activations, exits in flight,
    slashing-sweep hits, eligibility marks and at most 16 ejection
    candidates."""
    far = (1 << 64) - 1
    cur = state.slot // E.slots_per_epoch
    if (cur + 1) % E.epochs_per_sync_committee_period == 0:
        cur += 1
    state.slot = (cur + 1) * E.slots_per_epoch - 1
    vals, n = state.validators, len(state.validators)
    finalized = state.finalized_checkpoint.epoch
    for i in range(1, n, 1009):                 # pending activation
        v = vals[i]
        v.activation_eligibility_epoch = finalized - 1
        v.activation_epoch = v.exit_epoch = v.withdrawable_epoch = far
    for i in range(2, n, 997):                  # exit in flight
        if vals[i].exit_epoch == far:
            vals[i].exit_epoch = cur + 3
            vals[i].withdrawable_epoch = cur + 3 + 256
    for i in range(3, n, 991):                  # slashings-sweep hit
        vals[i].slashed = True
        vals[i].withdrawable_epoch = cur + E.epochs_per_slashings_vector // 2
    for i in range(4, min(n, 983 * 16), 983):   # ejection candidate
        vals[i].effective_balance = spec.ejection_balance
    for i in range(5, n, 1013):                 # eligibility mark
        v = vals[i]
        v.activation_eligibility_epoch = v.activation_epoch = far
        v.exit_epoch = v.withdrawable_epoch = far
        v.effective_balance = spec.max_effective_balance
    return cur


def _launch_units():
    """Every module that counts kernel launches."""
    from lighthouse_tpu_torch.crypto.bls.cuda import signer, staged
    from lighthouse_tpu_torch.crypto.kzg.cuda import kernel as kk
    from lighthouse_tpu_torch.crypto.sha256.cuda import kernel as hk
    from lighthouse_tpu_torch.state_transition.epoch_engine.cuda import (
        kernel as ek)

    return staged, signer, hk, ek, kk


def reset_all_launches():
    for mod in _launch_units():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in _launch_units():
        out.update(mod.launch_counts())
    return out


class capture_epoch_inputs:
    """Within the block, record the planes and scalars the epoch engine
    hands to run_sums / run_state (copied: the engine reuses its snapshot
    afterwards), for the timing phase at the main path's shapes."""

    def __enter__(self):
        from lighthouse_tpu_torch.state_transition.epoch_engine.cuda import (
            kernel as ek)

        self.ek, self.orig = ek, (ek.run_sums, ek.run_state)
        self.planes, self.scalars = {}, None
        run_sums, run_state = self.orig

        def sums(soa, prev, cur, device):
            self.planes.update(
                eff=soa.effective_balance.copy(), bal=soa.balance.copy(),
                slashed=soa.slashed.astype("uint8"),
                act=soa.activation_epoch.copy(), exitp=soa.exit_epoch.copy(),
                scores=soa.inactivity_scores.copy(),
                pflags=soa.previous_flags.copy(),
                cflags=soa.current_flags.copy())
            return run_sums(soa, prev, cur, device)

        def state(soa, wd_post, scalars, device):
            self.planes["wd"] = wd_post.copy()
            self.scalars = [int(s) for s in scalars]
            return run_state(soa, wd_post, scalars, device)

        ek.run_sums, ek.run_state = sums, state
        return self

    def __exit__(self, *exc):
        self.ek.run_sums, self.ek.run_state = self.orig
        return False


def phase_epoch_path(T, state):
    """The altair-family epoch transition at full width: the phase 10
    state (MAINNET Deneb, 2^20 validators) with plant_epoch_features,
    through per_epoch.process_epoch on the "cuda" engine, every launch
    counter from 0; its post-state root on the "cuda" hash backend through
    the root plane and k_pairs.  The oracle, a HostOracle forked after the
    engine ran: the port's scalar path (backend "python", hashes on
    hashlib) on a copy taken before, rooted on hashlib with caches of its
    own.  Equal
    SSZ bytes, equal roots, one launch each of k_sums and k_state."""
    from lighthouse_tpu_torch import types as ty
    from lighthouse_tpu_torch.crypto.sha256 import api as hapi
    from lighthouse_tpu_torch.state_transition import per_epoch
    from lighthouse_tpu_torch.state_transition.epoch_engine import api as eapi

    E, spec = ty.MAINNET, ty.ChainSpec.mainnet()
    S = type(state)
    cur = plant_epoch_features(state, E, spec)
    ms = {}
    t = time.perf_counter()
    scalar = state.copy()
    ms["copy"] = (time.perf_counter() - t) * 1e3

    def scalar_path():
        t_ms = {}
        eapi.reset_engine()
        eapi.configure(backend="python")
        hapi.configure(backend="hashlib")
        t = time.perf_counter()
        per_epoch.process_epoch(scalar, T, E, spec)
        t_ms["scalar_epoch"] = (time.perf_counter() - t) * 1e3
        answered = eapi.engine_status()["answered"]["python"]
        swap_tree_caches({})
        t = time.perf_counter()
        root = S.hash_tree_root(scalar)
        t_ms["scalar_root_hashlib"] = (time.perf_counter() - t) * 1e3
        return answered, root, S.encode(scalar), t_ms

    def check(answer):
        answered, oracle, oracle_bytes, t_ms = answer
        ms.update(t_ms)
        log(f"[epoch] scalar path (in a child process) {ms['scalar_epoch']:.0f}"
            f" ms; scalar state's root {oracle.hex()} on hashlib (caches of "
            f"its own) {ms['scalar_root_hashlib']:.0f} ms")
        if answered != 1:
            raise AssertionError("the scalar path did not answer the oracle")
        if root != oracle:
            raise AssertionError("post-epoch root differs from the scalar "
                                 "path's")
        t = time.perf_counter()
        same_bytes = S.encode(state) == oracle_bytes
        ms["encode_compare"] = (time.perf_counter() - t) * 1e3
        if not same_bytes:
            raise AssertionError("post-epoch SSZ bytes differ from the scalar "
                                 "path's")

    eapi.reset_engine()               # "cuda" on the card, threshold 4096
    hapi.reset_engine()               # "cuda", threshold 1024
    reset_all_launches()
    with capture_epoch_inputs() as cap:
        t = time.perf_counter()
        per_epoch.process_epoch(state, T, E, spec)
        ms["engine_epoch"] = (time.perf_counter() - t) * 1e3
    stages = eapi.last_stage_rows()
    t = time.perf_counter()
    root = S.hash_tree_root(state)
    ms["engine_root_plane_cuda"] = (time.perf_counter() - t) * 1e3
    launches = all_launches()
    status = eapi.engine_status()
    hash_status = hapi.engine_status()
    plane_used = state.validators._roots is not None
    hapi.reset_engine()
    eapi.reset_engine()
    # forked after the engine's timed epoch and root: a fork's
    # copy-on-write faults land in the process that forked
    HostOracle("the scalar epoch on hashlib", scalar_path, check)

    log(f"[epoch] epoch {cur} of {len(state.validators)} validators: engine "
        f"{ms['engine_epoch']:.0f} ms, stages "
        + ", ".join(f"{r['stage']} {r['ms']:.1f}" for r in stages))
    log(f"[epoch] post-epoch root {root.hex()} on cuda through the plane "
        f"{ms['engine_root_plane_cuda']:.0f} ms (against the scalar path "
        f"when the host oracles are joined); launches {launches}")
    if status["answered"]["cuda"] != 1 or status["faults"]:
        raise AssertionError(f"the cuda engine did not answer: {status}")
    for name in ("k_sums", "k_state"):
        if launches[name] != 1:
            raise AssertionError(f"{name} launched {launches[name]} times")
    if not plane_used or launches["k_pairs"] == 0:
        raise AssertionError("the post-epoch root did not use the plane on "
                             "k_pairs")
    return {"epoch": cur, "validators": len(state.validators), "ms": ms,
            "stages": stages, "launches": launches, "root": root.hex(),
            "hash_digests": hash_status["digests"],
            "transfer": hash_status["transfer"]}, cap


def minimal_sync_state(seed: int):
    """A MINIMAL Deneb state of 64 validators at the last slot of epoch 7
    (the next epoch starts a sync-committee period) from `seed`: four real
    pubkeys repeated, random balances, participation, scores and roots."""
    import numpy as np
    from lighthouse_tpu_torch import types as ty
    from lighthouse_tpu_torch.crypto.bls import SecretKey

    g = np.random.default_rng(seed)
    E, T = ty.MINIMAL, ty.SpecTypes(ty.MINIMAL)
    keys = [SecretKey(k).public_key().to_bytes() for k in (1, 2, 3, 4)]
    n, cur, far = 64, E.epochs_per_sync_committee_period - 1, (1 << 64) - 1

    def roots(k):
        raw = g.integers(0, 256, (k, 32), dtype=np.uint8).tobytes()
        return [raw[32 * j:32 * (j + 1)] for j in range(k)]

    committee = [keys[i % 4] for i in range(E.sync_committee_size)]
    return T, T.BeaconStateDeneb(
        genesis_time=1_600_000_000, slot=(cur + 1) * E.slots_per_epoch - 1,
        genesis_validators_root=roots(1)[0],
        block_roots=roots(E.slots_per_historical_root),
        state_roots=roots(E.slots_per_historical_root),
        randao_mixes=roots(E.epochs_per_historical_vector),
        validators=[ty.Validator(
            pubkey=keys[i % 4], withdrawal_credentials=roots(1)[0],
            effective_balance=32 * GWEI, exit_epoch=far,
            withdrawable_epoch=far) for i in range(n)],
        balances=[int(b) for b in g.integers(15 * GWEI, 40 * GWEI, n)],
        previous_epoch_participation=g.integers(0, 8, n).tolist(),
        current_epoch_participation=g.integers(0, 8, n).tolist(),
        inactivity_scores=g.integers(0, 50, n).tolist(),
        justification_bits=[True, True, False, False],
        finalized_checkpoint=ty.Checkpoint(epoch=cur - 2, root=roots(1)[0]),
        current_sync_committee=T.SyncCommittee(pubkeys=committee,
                                               aggregate_pubkey=keys[0]),
        next_sync_committee=T.SyncCommittee(pubkeys=committee[::-1],
                                            aggregate_pubkey=keys[1]))


def phase_epoch_sync_boundary(seed: int):
    """minimal_sync_state through the "cuda" engine (threshold 1) and the
    scalar path: equal roots and next sync committees.  The hash engine's
    threshold is 16 here, so the sample's 20 shuffle seeds and 64
    candidate digests ride k_digest and the plane's levels k_pairs."""
    from lighthouse_tpu_torch import types as ty
    from lighthouse_tpu_torch.crypto.sha256 import api as hapi
    from lighthouse_tpu_torch.state_transition import per_epoch
    from lighthouse_tpu_torch.state_transition.epoch_engine import api as eapi

    E, spec = ty.MINIMAL, ty.ChainSpec.minimal()
    T, state = minimal_sync_state(seed)
    S = type(state)
    scalar = state.copy()
    eapi.reset_engine()
    eapi.configure(threshold=1)
    hapi.reset_engine()
    hapi.configure(threshold=16)
    reset_all_launches()
    t = time.perf_counter()
    per_epoch.process_epoch(state, T, E, spec)
    root = S.hash_tree_root(state)
    engine_ms = (time.perf_counter() - t) * 1e3
    launches = all_launches()
    eapi.configure(backend="python")
    hapi.configure(backend="hashlib")
    t = time.perf_counter()
    per_epoch.process_epoch(scalar, T, E, spec)
    oracle = S.hash_tree_root(scalar)
    scalar_ms = (time.perf_counter() - t) * 1e3
    status = eapi.engine_status()
    hapi.reset_engine()
    eapi.reset_engine()
    log(f"[epoch] MINIMAL sync boundary: engine {engine_ms:.0f} ms, scalar "
        f"{scalar_ms:.0f} ms (both with the committee's aggregation on the "
        f"host); launches {launches}")
    if status["answered"] != {"cuda": 1, "python": 1}:
        raise AssertionError(f"sync boundary not answered as asked: {status}")
    if root != oracle or state.next_sync_committee != \
            scalar.next_sync_committee:
        raise AssertionError("sync-boundary epoch differs from the scalar "
                             "path")
    for name in ("k_sums", "k_state", "k_digest", "k_pairs"):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched at the boundary")
    return {"engine_ms": engine_ms, "scalar_ms": scalar_ms,
            "launches": launches, "root": root.hex()}


def sass_div64_instructions(sass: str = None) -> dict:
    """Instructions of the card's 64-bit division and remainder routines in
    the built k_epoch library (cuobjdump -sass): each runtime uint64 `/` and
    `%` of k_state calls one (after an inline test that sends operands of 32
    bits to a short path), a subroutine of the kernel's function.  Counted
    from each call target to its return, by function and target address."""
    import re

    if sass is None:
        from lighthouse_tpu_torch.runtime import build

        so = os.path.join(build.BUILD_ROOT, build.source_key(),
                          "libk_epoch.so")
        tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", so], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    counts = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split()[0]
        name = re.search(r"k_\w+?_kernel", name).group(0)
        code = [(int(a, 16), op) for a, op in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        for target in sorted(set(re.findall(r"CALL\.REL\.NOINC (0x[0-9a-f]+)",
                                            body))):
            n = 0
            for addr, op in code:
                if addr >= int(target, 16):
                    n += 1
                    if op.split()[0].startswith("RET"):
                        break
            counts[f"{name}@{target}"] = n
    if not counts:
        raise AssertionError("no 64-bit division routine in the k_epoch SASS")
    return counts


# 32-bit instructions of the epoch functions outside the divisions (64-bit
# add, subtract, compare, select and logic at 2, a 64-bit product at 3, an
# 8-bit flag test at 1), counted from kernels.py's dataflow; each is charged
# only on the lanes that need it.
SUMS_LANE = 4 * 2 + 4           # four epoch compares, flag and slashed tests
SUMS_ADD = 2                    # a 64-bit add into one of the six sums
STATE_LANE = 6 * 2 + 6 + 23     # compares, flag logic, balance write and
                                # hysteresis (b - q incr, min, selects)
STATE_ELIGIBLE = 8 + 3          # score update, the base reward product
STATE_REWARD = 2 * 3 + 2        # two products and an add a rewarded flag
STATE_PENALTY = 3 + 2 + 2       # a product, a shift and an add a missed flag
STATE_INACTIVITY = 3 + 2        # eff * score and the add
STATE_SLASH = 3 + 3 + 4         # two products, the saturating subtract


def epoch_work(planes, scal, new_bal, div_instr: int) -> dict:
    """The least work of k_sums and k_state on these lanes: the ALU
    instructions above on the lanes that need them, and each division a lane
    needs (eff / incr and the inactivity penalty on eligible lanes, a reward
    quotient a rewarded flag, the slashing quotient on sweep hits, b % incr
    on hysteresis updates) at `div_instr` instructions."""
    import numpy as np

    prev, cur, leak = (np.uint64(scal[0]), np.uint64(scal[1]), scal[2] != 0)
    eff, act, exitp, wd = (planes[k] for k in ("eff", "act", "exitp", "wd"))
    slashed = planes["slashed"] != 0
    pf, cf = planes["pflags"], planes["cflags"]
    n = len(eff)
    active_cur = (act <= cur) & (cur < exitp)
    active_prev = (act <= prev) & (prev < exitp)
    unslashed = ~slashed
    flag = [((pf >> f) & 1).astype(bool) & active_prev & unslashed
            for f in range(3)]
    adds = (2 * int(active_cur.sum()) + sum(int(x.sum()) for x in flag)
            + int((active_cur & unslashed & ((cf >> 1) & 1).astype(bool))
                  .sum()))
    sums_ops = n * SUMS_LANE + adds * SUMS_ADD

    eligible = active_prev | (slashed & (prev + np.uint64(1) < wd))
    miss_target = eligible & ~flag[1]
    rewarded = 0 if leak else sum(int((eligible & x).sum()) for x in flag)
    missed = sum(int((eligible & ~x).sum()) for x in flag[:2])
    hits = slashed & (wd == np.uint64(scal[17]))
    update = ((new_bal + np.uint64(scal[15]) < eff)
              | (eff + np.uint64(scal[16]) < new_bal))
    divisions = (int(eligible.sum()) + int(miss_target.sum()) + rewarded
                 + int(hits.sum()) + int((hits & ~eligible).sum())
                 + int(update.sum()))
    state_ops = (n * STATE_LANE + int(eligible.sum()) * STATE_ELIGIBLE
                 + rewarded * STATE_REWARD + missed * STATE_PENALTY
                 + int(miss_target.sum()) * STATE_INACTIVITY
                 + int(hits.sum()) * STATE_SLASH + divisions * div_instr)
    return {"k_sums": sums_ops, "k_state": state_ops,
            "k_state_divisions": divisions}


def phase_epoch_timing(cap, dev, card):
    """At the epoch path's shapes (the 2^20 lanes and scalars the engine
    handed its kernels in phase 13): each kernel against its plain version
    (bit-exact), its device time, the plain version's time and the bound
    (bytes over the HBM rate, or the least work of epoch_work over the
    32-bit rate, whichever is larger).  No PyTorch call computes either
    function: library_ms is null."""
    from lighthouse_tpu_torch.state_transition.epoch_engine.cuda import (
        kernel as ek)

    rate = 64 * card["sms"] * card["max_sm_mhz"] * 1e6
    planes, scal = cap.planes, cap.scalars
    sums, state = _epoch_args(planes, scal, dev)
    for name, kern, plain, args in (
            ("k_sums", ek.k_sums, ek.k_sums_plain, sums),
            ("k_state", ek.k_state, ek.k_state_plain, state)):
        err = u64_err(as_tuple(kern(*args)), as_tuple(plain(*args)))
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 "at the epoch path's shape")
    new_bal = ek.k_state(*state)[1].cpu().numpy().view("uint64")
    div = sass_div64_instructions()
    div_instr = min(div.values())       # the least work: the shorter one
    work = epoch_work(planes, scal, new_bal, div_instr)
    log(f"[timing] 64-bit division routines in k_epoch's SASS: {div}; "
        f"k_state needs {work['k_state_divisions']} divisions on "
        f"{len(planes['eff'])} lanes")
    calls = {
        "k_sums": {"kern": lambda: ek.k_sums(*sums),
                   "plain": lambda: ek.k_sums_plain(*sums), "ins": sums,
                   "reps": 50},
        "k_state": {"kern": lambda: ek.k_state(*state),
                    "plain": lambda: ek.k_state_plain(*state), "ins": state,
                    "reps": 20},
    }
    rows = time_calls(calls, work, rate, "the epoch path's shape")
    for name in calls:
        rows[name]["lanes"] = len(planes["eff"])
    rows["k_state"].update(divisions=work["k_state_divisions"],
                           div64_instructions=div)
    return rows


# --- The KZG path ------------------------------------------------------------


def _blob_args(polys, zs, dev):
    """(poly, z, roots, inv_n) of k_blob_eval on dev from canonical ints."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.kzg.cuda import kernel as kk

    words = kk.ints_to_words(polys)
    poly = torch.from_numpy(words.view(np.int32)).to(dev)
    z = torch.from_numpy(kk.fr.ints_to_limbs(zs).view(np.int32)).to(dev)
    roots, inv_n = kk.domain(len(polys[0]), dev)
    return poly, z, roots, inv_n


def phase_kzg_kernels_vs_plain(rng, dev):
    """k_blob_eval against its plain version and the reference on edge
    cases: (3, 8) with a random z, z = w^3 and z = 0; z = 1 = w^0; (1, 1)
    and (1, 2) with z on the domain; an all-zero blob; elements r - 1."""
    import torch
    from lighthouse_tpu_torch.crypto.kzg import reference as ref
    from lighthouse_tpu_torch.crypto.kzg.cuda import kernel as kk

    R = ref.R

    def rand(n):
        return [rng.randrange(R) for _ in range(n)]

    w8 = ref.roots_of_unity(8)
    cases = {
        "3x8 random z, z = w^3, z = 0": ([rand(8) for _ in range(3)],
                                          [rng.randrange(R), w8[3], 0]),
        "z = 1": ([rand(8) for _ in range(2)], [1, 1]),
        "1x1 hit": ([rand(1)], [1]),
        "1x1": ([rand(1)], [rng.randrange(R)]),
        "1x2 hit": ([rand(2)], [R - 1]),
        "1x2": ([rand(2)], [rng.randrange(R)]),
        "zero blob": ([[0] * 16, rand(16)], [rng.randrange(R), 0]),
        "r - 1": ([[R - 1] * 64, [R - 1] * 64], [rng.randrange(R), 0]),
    }
    err = 0
    for what, (polys, zs) in cases.items():
        args = _blob_args(polys, zs, dev)
        y = kk.k_blob_eval(*args)
        e = max_abs_err([y], [kk.k_blob_eval_plain(*args)])
        want = [ref.evaluate_polynomial(p, z) for p, z in zip(polys, zs)]
        if kk.fr.unpack(y.cpu()) != want:
            raise AssertionError(f"k_blob_eval != reference on {what}")
        err = max(err, e)
    torch.cuda.synchronize()
    log(f"[vs plain] k_blob_eval: max_abs_err={err} ({len(cases)} edge "
        "cases, each also equal to reference.evaluate_polynomial)")
    if err != 0:
        raise AssertionError("k_blob_eval disagrees with its plain version")
    return {"k_blob_eval": err}


def phase_kzg_path(seed: int, dev):
    """The blob sidecars of a block at MAINNET width through
    crypto.kzg.verify_blob_kzg_proof_batch, every launch counter from 0;
    the python backend's verdicts on the same cases in a HostOracle."""
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.kzg import reference as ref
    from lighthouse_tpu_torch.crypto.kzg import setup as kset
    from lighthouse_tpu_torch.crypto.kzg.cuda import kernel as kk

    kzg.reset_engine()
    t = time.perf_counter()
    blobs = [kset.make_blob(BLOB_ELEMENTS, b"chip-smoke-kzg-%d-%d" % (seed, i))
             for i in range(MAX_BLOBS)]
    cs = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    ps = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]
    gen_ms = (time.perf_counter() - t) * 1e3
    changed = bytearray(blobs[3])
    changed[32 * (BLOB_ELEMENTS // 4 + 1) + 31] ^= 1   # element 1,025
    cases = {
        "6_valid": (blobs, cs, ps, True),
        "6_swapped_proofs": (blobs, cs, [ps[0], ps[2], ps[1]] + ps[3:],
                             False),
        "6_changed_element": (blobs[:3] + [bytes(changed)] + blobs[4:], cs,
                              ps, False),
        "2_valid": (blobs[:2], cs[:2], ps[:2], True),
    }
    rows = {name: {} for name in cases}

    def python_backend():
        kzg.configure(backend="python")
        out = {}
        for name, (b, c, p, want) in cases.items():
            t = time.perf_counter()
            verdict = kzg.verify_blob_kzg_proof_batch(b, c, p)
            out[name] = {"python_ms": (time.perf_counter() - t) * 1e3,
                         "python_verdict": verdict,
                         "python_backend": kzg.last_call()["backend"]}
        return out

    def check(answer):
        for name, (b, c, p, want) in cases.items():
            r = answer[name]
            log(f"[kzg] {name}: python backend {r['python_verdict']} in "
                f"{r['python_ms']:.1f} ms (in a child process)")
            if r.pop("python_backend") != "python" or \
                    r["python_verdict"] is not want:
                raise AssertionError(f"kzg {name}: the python backend says "
                                     f"{r['python_verdict']}")
            rows[name].update(r)

    HostOracle("the python KZG backend", python_backend, check)
    reset_all_launches()
    for name, (b, c, p, want) in cases.items():
        t = time.perf_counter()
        verdict = kzg.verify_blob_kzg_proof_batch(b, c, p)
        ms = (time.perf_counter() - t) * 1e3
        call = kzg.last_call()
        if call["backend"] != "cuda" or verdict is not want:
            raise AssertionError(f"kzg {name}: {verdict} on "
                                 f"{call['backend']}, expected {want}")
        rows[name].update(verdict=verdict, ms=ms, stages=call["stages"])
    launches = all_launches()
    status = kzg.engine_status()
    kzg.reset_engine()

    words, _ok = kk.blob_words(blobs)
    zs = [ref.compute_challenge(b, c) for b, c in zip(blobs, cs)]
    ys = kk.eval_blobs(words, zs)
    polys = [ref.blob_to_field_elements(b) for b in blobs]
    if ys != [ref.evaluate_polynomial(p, z) for p, z in zip(polys, zs)]:
        raise AssertionError("eval_blobs != reference.evaluate_polynomial")
    # the 6-blob batch's 2-pairing check, as the facade hands it to k_pair
    rlc = ref.batch_rlc_powers(cs, zs, ys, ps)
    lhs, proof_acc = ref._batch_pairing_inputs(
        [ref.parse_g1(c) for c in cs], zs, ys, [ref.parse_g1(p) for p in ps],
        rlc)
    pair_args = kzg.pairing_args(lhs, proof_acc, kset.dev_setup().tau_g2(),
                                 dev)
    for name, r in rows.items():
        log(f"[kzg] {name}: {r['verdict']} in {r['ms']:.1f} ms on cuda ("
            + ", ".join(f"{x['stage']} {x['ms']:.1f}" for x in r["stages"])
            + ")")
    log(f"[kzg] blobs, commitments and proofs generated on the host in "
        f"{gen_ms:.0f} ms; launches {launches}; status {status}")
    for name in ("k_blob_eval", "k_pair"):
        if launches[name] != len(cases):
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{len(cases)} cuda calls")
    return {"cases": rows, "launches": launches, "gen_ms": gen_ms,
            "e2e_ms": {"2": rows["2_valid"]["ms"], "6": rows["6_valid"]["ms"]},
            "eval_args": (words, zs), "pair_args": pair_args}


FR_M = 8 * 8 + 8 * 8              # an Fr product: a * b and its reduction
FR_S = 8 * 9 // 2 + 8 * 8         # an Fr squaring
FR_ADD = 2 * 8                    # a modular add or subtract


def kzg_work(b: int, n: int) -> int:
    """Least 32-bit instructions of k_blob_eval on B blobs of N elements:
    an element takes 3 products for the batch inversion, 2 for p_i w^i /
    d_i, a subtraction and an addition; a blob log2 N squarings for z^N,
    its subtraction and 2 products; the batch one Fermat inversion."""
    from lighthouse_tpu_torch.crypto.bls.constants import R

    inv = (R - 2).bit_length() - 1
    inv = inv * FR_S + chain_mults(R - 2) * FR_M
    per_element = 5 * FR_M + 2 * FR_ADD
    per_blob = (n.bit_length() - 1) * FR_S + FR_ADD + 2 * FR_M
    return b * n * per_element + b * per_blob + inv


def phase_kzg_timing(path, dev, card):
    """At the KZG path's shape (the 6 x 4,096 blobs of phase 16 and their
    challenges): k_blob_eval against its plain version (bit-exact), its
    device time, the plain version's time and its bound (bytes: the blobs,
    the domain table, z in and y out, over the HBM rate; work: kzg_work
    over the 32-bit rate).  No PyTorch call computes it: library_ms is
    null.  Information only: k_pair's device time at the path's 2 lanes
    (+1 off)."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls.cuda import staged
    from lighthouse_tpu_torch.crypto.kzg.cuda import kernel as kk

    rate = 64 * card["sms"] * card["max_sm_mhz"] * 1e6
    words, zs = path["eval_args"]
    b, n = words.shape[:2]
    poly = torch.from_numpy(words.view(np.int32)).to(dev)
    z = torch.from_numpy(kk.fr.ints_to_limbs(zs).view(np.int32)).to(dev)
    roots, inv_n = kk.domain(n, dev)
    args = (poly, z, roots, inv_n)
    calls = {"k_blob_eval": {
        "kern": lambda: kk.k_blob_eval(*args),
        "plain": lambda: kk.k_blob_eval_plain(*args),
        "bytes": b * n * 32 + n * 32 + b * 64, "reps": 20}}
    rows = time_calls(calls, {"k_blob_eval": kzg_work(b, n)}, rate,
                      "the KZG path's shape")
    rows["k_blob_eval"]["shape"] = [b, n]
    pair = path["pair_args"]
    pair_ms = device_ms(lambda: staged.k_pair(*pair), 10)
    log(f"[timing] k_pair at the KZG path's 2 lanes (+1 off): {pair_ms:.3f} "
        "ms device time (information only)")
    return rows, pair_ms


# --- The mesh path -----------------------------------------------------------
#
# The mesh-primary route (parallel/sharded_verify.py, parallel/ring.py): a
# mesh of 1, 2 and 4 shards on the one card (MESH_SIZES; a shard is a
# stream), and one shard a card when more than one card is visible.  The
# batches: the 64-set gossip batch, decoded and as wire bytes, 8 sets of
# 48-byte messages (the host hash_to_field variants), the 512-key sync
# aggregate beside 3 single sets, and 1,024 signed sets
# (DEFAULT_MAX_BATCH_ITEMS, parallel/dispatcher.py:56) as wire bytes; their
# bad lanes sit at a shard boundary (MESH_BOUNDARY), at the first lane and
# next to padding (a 62-set batch on 4 shards pads to 64).

MESH_SIZES = (1, 2, 4)
MESH_BATCH = 1024
MESH_BOUNDARY = GOSSIP // 2          # the first lane of shard 1 (2 shards)
MESH_ODD = 62                        # pads to 64 on 4 shards
DECODE_G1_KEYS = 4096
MESH_STEP_REPS = 30                  # resolves ~1 ms on a ~20 ms step
MESH_KERNELS = ("k_subgroup", "k_decode_g1", "k_pair_partial",
                "k_pair_combine", "k_ring_mul", "k_ring_sum")


def off_curve_g1() -> bytes:
    """The compressed bytes of the smallest x where x^3 + 4 is not a square
    in Fp: no G1 point has that x."""
    from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp

    x = 1
    while (Fp(x) * Fp(x) * Fp(x) + Fp(4)).sqrt() is not None:
        x += 1
    raw = x.to_bytes(48, "big")
    return bytes([raw[0] | 0x80]) + raw[1:]


def g1_check_ops(c) -> int:
    """phi(P) == [lambda] P for an affine P, the less work of two ways:
    a width-w NAF ladder over the 128-bit lambda with mixed additions, or
    (what k_subgroup runs) lambda = |z|^2 - 1 as [|z|]([|z|] P) - P: a
    ladder over |z| with mixed additions, one with full additions (its
    base is Jacobian), and a mixed addition of -P; then beta x and a
    compare of affine phi(P) with a Jacobian point."""
    from lighthouse_tpu_torch.crypto.bls.cuda import curve

    lam = curve.G1_LAMBDA
    by_lambda = ((lam.bit_length() - 1) * c["dbl1"]
                 + naf_adds(lam) * c["madd1"])
    by_z = (2 * c["x_dbls"] * c["dbl1"] + c["x_adds"] * (c["madd1"]
                                                          + c["add1"])
            + c["madd1"])
    return M + min(by_lambda, by_z) + S + 3 * M


def k_subgroup_ops(c, g1_live: int, g2_live: int) -> int:
    """Each active finite lane's check: G1 by phi, G2 by psi."""
    return g1_live * g1_check_ops(c) + g2_live * c["psi_check"]


def k_decode_g1_ops(c, finite: int, check: bool) -> int:
    """Each finite lane: x to Montgomery form, x^3 + 4, the square root
    a^((p + 1) / 4) and its check, the sign on the real value; with
    ``check`` the G1 subgroup check."""
    from lighthouse_tpu_torch.crypto.bls.constants import P

    sqrt = (((P + 1) // 4).bit_length() - 1) * S + chain_mults(
        (P + 1) // 4) * M
    return finite * (3 * M + 2 * S + sqrt + (g1_check_ops(c) if check
                                              else 0))


def phase_mesh_kernels_vs_plain(rng, dev):
    """k_subgroup, k_decode_g1, k_pair_partial / k_pair_combine and
    k_ring_mul / k_ring_sum against their plain versions at n = 8 with edge
    lanes, bit-exact on every output."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    out = {}
    g = cv.g1_generator()
    k = rng.randrange(1, R)
    gk = g.mul(k)
    nsp = cv.g1_decompress(non_subgroup_pubkey(), subgroup_check=False)
    nss = cv.g2_decompress(non_subgroup_signature(), subgroup_check=False)
    h = hr.hash_to_g2(bytes(rng.randrange(256) for _ in range(32)))
    # k_subgroup: a lane that is off passes whatever it holds
    g1 = [g, gk, nsp, cv.g1_infinity(), nsp, -gk, g.mul(R - 1), nsp]
    g2 = [h.mul(k), nss, axis_y_points()[0], cv.g2_infinity(), nss, -h,
          cv.g2_generator(), h]
    act = torch.tensor([True] * 4 + [False] + [True] * 3, device=dev)
    x1, y1, i1 = (t.to(dev) for t in be_planes(curve.pack_g1_affine(g1)))
    x2, y2, i2 = (t.to(dev) for t in be_planes(curve.pack_g2_affine(g2)))
    sub_in = (x1, y1, i1, act, x2, y2, i2, act)
    sub = staged.k_subgroup(*sub_in)
    out["k_subgroup"] = max_abs_err(sub, staged.k_subgroup_plain(*sub_in))
    want = ([True, True, False, True, True, True, True, False]
            + [True, False, False, True, True, True, True, True])
    if sub[0].tolist() != want or bool(sub[1]):
        raise AssertionError(f"k_subgroup lanes {sub[0].tolist()}")

    # k_decode_g1: both signs, the generator, infinity, the non-subgroup
    # key, an off-curve x, -g, 2g, the points (0, +-2) of order 3, the
    # point of order 11 and an infinity lane with x != 0; with and without
    # the subgroup check
    t3 = order3_g1()
    raws = [cv.g1_compress(p) for p in (gk, -gk, g, cv.g1_infinity())]
    raws += [non_subgroup_pubkey(), off_curve_g1(),
             cv.g1_compress(g.mul(R - 1)), cv.g1_compress(g.mul(2)),
             cv.g1_compress(t3), cv.g1_compress(-t3), ORDER_11,
             cv.g1_compress(cv.g1_infinity())]
    if raws[0][0] & 0x20 == raws[1][0] & 0x20:
        raise AssertionError("k_decode_g1 inputs: one sign bit only")
    planes = list(bk.parse_g1_compressed_many(raws))
    planes[0][11, 0] = 1                  # infinity with x != 0
    planes = [t.to(dev) for t in planes]
    errs = []
    for check, want in (
            (False, [True] * 5 + [False] + [True] * 5 + [False]),
            (True, [True] * 4 + [False, False, True, True] + [False] * 4)):
        dec = staged.k_decode_g1(*planes, check=check)
        errs.append(max_abs_err(dec, staged.k_decode_g1_plain(
            *planes, check=check)))
        if dec[3].tolist() != want:
            raise AssertionError(f"k_decode_g1 (check={check}) lanes "
                                 f"{dec[3].tolist()}")
    out["k_decode_g1"] = max(errs)
    got = curve.unpack_g1_affine(staged.to_i64(dec[0].cpu()),
                                 staged.to_i64(dec[1].cpu()), dec[2].cpu())
    for i in (0, 1, 2, 3, 4, 6, 7, 8, 9, 10):
        if got[i] != cv.g1_decompress(raws[i], subgroup_check=False):
            raise AssertionError(f"k_decode_g1 lane {i} != curve_ref")

    # k_pair_partial / k_pair_combine on 8 lanes with padding, infinity
    # and P == Q (phase 3's shape), closing lane on and off; the combine of
    # the closing partial equals k_pair (ok and the GT value)
    n = 8
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]
    sks, pks = gen_keys(rng, n)
    pks[6] = cv.g1_infinity()
    sigs = [hr.hash_to_g2(m).mul(s) for m, s in zip(msgs, sks)]
    sigs[3] = sigs[2]
    sigs[6] = cv.g2_infinity()
    words = torch.as_tensor(h2.pack_msg_words(msgs).view(np.int32)).to(dev)
    hh = staged.k_hash(staged.k_xmd(words))
    rand = torch.as_tensor(bk.random_weights(n, n - 1).view(np.int32)).to(dev)
    xp, yp, pi = (t.to(dev) for t in be_planes(curve.pack_g1_affine(pks)))
    xs, ys, si = (t.to(dev) for t in be_planes(curve.pack_g2_affine(sigs)))
    pts = staged.k_points(xp, yp, pi, xs, ys, si, rand)
    lanes = (pts[0], pts[1], pts[2], *hh)
    errs, parts = [], []
    for closing in (True, False):
        extra = pts[3:] if closing else ()
        part = staged.k_pair_partial(*lanes, *extra, closing=closing)
        errs.append(max_abs_err([part], [staged.k_pair_partial_plain(
            *lanes, *extra, closing=closing)]))
        parts.append(part)
    out["k_pair_partial"] = max(errs)
    stack = torch.stack([parts[0], parts[1], parts[1]])
    comb = staged.k_pair_combine(stack)
    errs = [max_abs_err(comb, staged.k_pair_combine_plain(stack))]
    whole = staged.k_pair_combine(parts[0][None])
    errs.append(max_abs_err(whole, staged.k_pair(*lanes, *pts[3:])))
    out["k_pair_combine"] = max(errs)

    # k_ring: an Fp12 hop; G2 sums of no point, one point, one infinity,
    # P + P, P + (-P), inf + inf, three equal points (an odd tree), four
    # infinities, four points with an infinity and five points (one
    # streamed past the accumulators)
    # k_ring_mul on two partials and on edge operands: 1 b, a 1 (equal to
    # b and a), every coefficient p - 1 on both sides and on one
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.cuda import fp

    def f12(vals):
        return staged.to_i32(fp.pack_mont(vals, dev)).reshape(staged.F12_SHAPE)

    one, top = f12([1] + [0] * 11), f12([P - 1] * 12)
    errs = []
    for a, b in ((parts[0], parts[1]), (one, parts[1]), (parts[0], one),
                 (top, top), (top, parts[0]), (one, one)):
        mul = staged.k_ring_mul(a, b)
        errs.append(max_abs_err([mul], [staged.k_ring_mul_plain(a, b)]))
        if a is one and not torch.equal(mul, b):
            raise AssertionError("k_ring_mul: 1 * b is not b")
        if b is one and not torch.equal(mul, a):
            raise AssertionError("k_ring_mul: a * 1 is not a")
    out["k_ring_mul"] = max(errs)
    errs = []
    inf2 = cv.g2_infinity()
    q = h.mul(5)
    for group in ([], [h], [inf2], [h, h], [h, -h], [inf2] * 2, [h, h, h],
                  [inf2] * 4, [h, nss.mul(3), inf2, -h],
                  [h, q, -q, nss, h]):
        gx, gy, gi = (t.to(dev) for t in be_planes(
            curve.pack_g2_affine(group)))
        got = staged.k_ring_sum(gx, gy, gi)
        errs.append(max_abs_err(got, staged.k_ring_sum_plain(gx, gy, gi)))
        ref = cv.g2_infinity()
        for p in group:
            ref = ref + p
        aff = curve.unpack_g2_affine(staged.to_i64(got[0][None].cpu()),
                                     staged.to_i64(got[1][None].cpu()),
                                     got[2].cpu())[0]
        if aff != ref:
            raise AssertionError("k_ring_sum disagrees with curve_ref")
    out["k_ring_sum"] = max(errs)
    torch.cuda.synchronize()
    for name, err in out.items():
        log(f"[vs plain] {name}: max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    return out


def pair_edge_lanes(base, n, mode, dev):
    """n pairing lanes cycling over the base pairs (k g1, H) with the
    closing sum S of their signatures (a valid batch); mode "mixed" sets
    infinity flags on some keys and message points, "allinf" on every key
    and on S."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged

    pks, hs, sigs = base
    idx = [i % len(pks) for i in range(n)]
    xp, yp, _ = curve.pack_g1_affine([pks[j] for j in idx])
    xq, yq, _ = curve.pack_g2_affine([hs[j] for j in idx])
    winf = torch.zeros(n, dtype=torch.bool)
    hinf = torch.zeros(n, dtype=torch.bool)
    if mode == "mixed":
        winf[torch.arange(n) % 5 == 2] = True
        hinf[torch.arange(n) % 7 == 3] = True
    elif mode == "allinf":
        winf[:] = True
    s = cv.g2_infinity()
    for j, c in enumerate(np.bincount(idx, minlength=len(pks))):
        if c:
            s = s + sigs[j].mul(int(c))
    sx, sy, sinf = curve.pack_g2_affine([s])
    if mode == "allinf":
        sinf[:] = True
    to = staged.to_i32
    return tuple(t.to(dev) for t in (to(xp), to(yp), winf, to(xq), to(yq),
                                     hinf, to(sx)[0], to(sy)[0], sinf))


def phase_pair_edges_vs_plain(rng, dev):
    """k_pair, k_pair_partial (closing on and off) and k_pair_combine
    against their plain versions at the cooperative kernels' layout edges
    (PAIR_EDGE_LANES; valid, mixed-infinity and all-infinity lanes; the
    combine of PAIR_EDGE_PARTIALS partials): bit-exact, verdicts as
    expected."""
    import torch
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve_ref as hr
    from lighthouse_tpu_torch.crypto.bls.cuda import staged

    t0 = time.perf_counter()
    sks, pks = gen_keys(rng, 8)
    hs = [hr.hash_to_g2(bytes(rng.randrange(256) for _ in range(32)))
          for _ in range(8)]
    base = (pks, hs, [h.mul(k) for h, k in zip(hs, sks)])
    out = {"k_pair": 0, "k_pair_partial": 0, "k_pair_combine": 0}
    for n in PAIR_EDGE_LANES:
        parts = []
        for mode in ("valid", "mixed", "allinf"):
            a = pair_edge_lanes(base, n, mode, dev)
            got = staged.k_pair(*a)
            out["k_pair"] = max(out["k_pair"], max_abs_err(
                got, staged.k_pair_plain(*a)))
            holes = bool(a[2].any() or a[5].any())
            if bool(got[0]) != (mode == "allinf" or not holes):
                raise AssertionError(f"k_pair verdict at {n} lanes, {mode}")
            for closing in (True, False):
                extra = a[6:] if closing else ()
                part = staged.k_pair_partial(*a[:6], *extra, closing=closing)
                out["k_pair_partial"] = max(
                    out["k_pair_partial"], max_abs_err(
                        [part], [staged.k_pair_partial_plain(
                            *a[:6], *extra, closing=closing)]))
                parts.append(part)
        for s in PAIR_EDGE_PARTIALS:
            stack = torch.stack(parts[:s])
            out["k_pair_combine"] = max(out["k_pair_combine"], max_abs_err(
                staged.k_pair_combine(stack),
                staged.k_pair_combine_plain(stack)))
    torch.cuda.synchronize()
    for name, err in out.items():
        log(f"[vs plain] {name} at {PAIR_EDGE_LANES} lanes: "
            f"max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    log(f"[pair edges] {time.perf_counter() - t0:.1f} s")
    return out


def hash_edge_u():
    """Field elements for k_hash's edges (plain (c0, c1) pairs): 0 (tv = 0,
    the exceptional x1), 1, p - 1, c0 = 0 (sgn0 decided on c1, twice), p - 1
    in both coordinates, and one on each side of SSWU's square test."""
    from lighthouse_tpu_torch.crypto.bls import fields_ref as fr
    from lighthouse_tpu_torch.crypto.bls.constants import (
        ISO3_A, ISO3_B, ISO3_Z, P)

    A, B, Z = fr.Fp2(*ISO3_A), fr.Fp2(*ISO3_B), fr.Fp2(*ISO3_Z)
    rnd = random.Random(0x5511)
    out, sides = [(0, 0), (1, 0), (P - 1, 0), (0, 1), (0, 12345),
                  (P - 1, P - 1)], {}
    while len(sides) < 2:
        u = (rnd.randrange(P), rnd.randrange(P))
        zu2 = Z * fr.Fp2(*u).square()
        tv = zu2.square() + zu2
        x1 = (-B) * A.inv() * (fr.Fp2.one() + tv.inv())
        sides.setdefault(((x1.square() + A) * x1 + B).is_square(), u)
    return out + [sides[True], sides[False]]


def phase_hash_sign_edges_vs_plain(rng, dev):
    """k_hash at HASH_EDGE_MSGS messages with the edge elements of
    hash_edge_u placed in the input (u0 and u1 of the first rows), and
    k_sign_root and k_sign_field at SIGN_EDGE_LANES lanes with the edge
    scalars and zero-scalar padding rows (k_sign_field on the roots'
    hash-to-field output, so one plain run serves both), each against its
    plain version: bit-exact.  Returns the worst errors and, information only, k_hash's
    device time at 1,025 messages and the signers' at 4,096 lanes."""
    import torch
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.cuda import fp, signer, staged
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    t0 = time.perf_counter()
    edge_u = hash_edge_u()
    out = {"k_hash": 0, "k_sign_root": 0, "k_sign_field": 0}
    info = {}

    def u_rows(n):
        msgs = [bytes(rng.randrange(256) for _ in range(32))
                for _ in range(n)]
        return staged.to_i32(h2.hash_to_field(msgs))

    for n in HASH_EDGE_MSGS:
        u = u_rows(n)
        for i, (c0, c1) in enumerate(edge_u):
            row, half = (i // 2) % n, i % 2
            u[row, half] = staged.to_i32(fp.pack([c0, c1]))
        u = u.to(dev)
        err = max_abs_err(staged.k_hash(u), staged.k_hash_plain(u))
        out["k_hash"] = max(out["k_hash"], err)
        if n == max(HASH_EDGE_MSGS):
            info["k_hash_ms"] = device_ms(lambda: staged.k_hash(u), 3)
    edge_k = [1, 2, ABS_Z - 1, ABS_Z, ABS_Z ** 2, R - 1, R, R + 1,
              (1 << 255) - 1]
    for n in SIGN_EDGE_LANES:
        ks = [edge_k[i] if i < len(edge_k) else rng.randrange(1, R)
              for i in range(n)]
        pad = min(SIGN_EDGE_PADDING, n - 1)
        ks[n - pad:] = [0] * pad
        w = _sk_words(ks, dev)
        words = _root_words([bytes(rng.randrange(256) for _ in range(32))
                             for _ in range(n)], dev)
        # k_sign_root's plain version is k_sign_field's on k_xmd's plain
        # output: one plain run holds both kernels on the same lanes
        u = staged.k_xmd_plain(words)
        want = signer.k_sign_field_plain(w, u)
        for name, data in (("k_sign_root", words), ("k_sign_field", u)):
            kern = getattr(signer, name)
            got = kern(w, data)
            out[name] = max(out[name], max_abs_err(got, want))
            if not bool(got[2][n - pad:].all()):
                raise AssertionError(f"{name}: a zero scalar is not "
                                     "infinity")
            if n == max(SIGN_EDGE_LANES):
                info[f"{name}_ms"] = device_ms(lambda: kern(w, data), 2)
    torch.cuda.synchronize()
    log(f"[vs plain] k_hash at {HASH_EDGE_MSGS} messages (edge elements "
        f"{len(edge_u)}): max_abs_err={out['k_hash']}; k_sign_root and "
        f"k_sign_field at {SIGN_EDGE_LANES} lanes (edge and zero scalars): "
        f"max_abs_err={out['k_sign_root']}, {out['k_sign_field']}")
    for name, err in out.items():
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    info.update(messages=max(HASH_EDGE_MSGS), lanes=max(SIGN_EDGE_LANES))
    log(f"[timing] k_hash at {max(HASH_EDGE_MSGS)} messages "
        f"{info['k_hash_ms']:.4f} ms; k_sign_root and k_sign_field at "
        f"{max(SIGN_EDGE_LANES)} lanes {info['k_sign_root_ms']:.4f} / "
        f"{info['k_sign_field_ms']:.4f} ms (information only)")
    log(f"[hash sign edges] {time.perf_counter() - t0:.1f} s")
    return out, info


def phase_points_each_edges_vs_plain(rng, dev):
    """k_points at POINTS_EDGE_LANES lanes (points_layouts.
    points_edge_inputs: edge weights, infinity keys and signatures, a
    padding lane, P == Q and P == -Q in the sum), its mask variant at
    MASK_EDGE_SETS x 512 keys (mask_edge_inputs: an empty set, masked-off
    and infinity keys, an infinity signature, P == Q and P == -Q in a key
    sum), and k_each at EACH_EDGE_SETS sets (each_edge_inputs), each
    against its plain version: bit-exact, k_each's verdicts as expected.
    Returns the worst errors and, information only, k_points' device time
    at 1,024 lanes and k_each's at 1,024 sets."""
    import torch
    from lighthouse_tpu_torch.crypto.bls.cuda import staged
    from lighthouse_tpu_torch.tools import points_layouts as pl

    t0 = time.perf_counter()
    _, pks = gen_keys(rng, 8)
    sigs = pl.g2_points(rng, 8)
    out = {"k_points": 0, "k_points_mask": 0, "k_each": 0}
    info = {}
    for n in POINTS_EDGE_LANES:
        a = pl.points_edge_inputs(rng, n, (pks, sigs), dev)
        out["k_points"] = max(out["k_points"], max_abs_err(
            staged.k_points(*a), staged.k_points_plain(*a)))
    a = pl.points_edge_inputs(rng, 1024, (pks, sigs), dev)
    info["k_points_1024_ms"] = device_ms(lambda: staged.k_points(*a), 3)
    _, keys = consecutive_keys(rng, SYNC_KEYS)
    for m in MASK_EDGE_SETS:
        a, mask = pl.mask_edge_inputs(rng, m, keys, sigs, dev)
        out["k_points_mask"] = max(out["k_points_mask"], max_abs_err(
            staged.k_points(*a, mask=mask),
            staged.k_points_plain(*a, mask=mask)))
    base = pl.each_base(rng)
    for n in EACH_EDGE_SETS:
        a, want = pl.each_edge_inputs(n, base, dev)
        got = staged.k_each(*a)
        out["k_each"] = max(out["k_each"], max_abs_err(
            [got], [staged.k_each_plain(*a)]))
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"k_each verdicts at {n} sets")
        if n == 1024:
            info["k_each_1024_ms"] = device_ms(lambda: staged.k_each(*a), 2)
    torch.cuda.synchronize()
    log(f"[vs plain] k_points at {POINTS_EDGE_LANES} lanes, the mask variant "
        f"at {MASK_EDGE_SETS} x {SYNC_KEYS}, k_each at {EACH_EDGE_SETS} sets "
        f"(edge cases): max_abs_err={out}")
    for name, err in out.items():
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    info.update(lanes=1024, sets=1024)
    log(f"[timing] k_points at 1,024 lanes {info['k_points_1024_ms']:.4f} "
        f"ms; k_each at 1,024 sets {info['k_each_1024_ms']:.4f} ms "
        f"(information only)")
    log(f"[points each edges] {time.perf_counter() - t0:.1f} s")
    return out, info


def phase_decode_subgroup_edges_vs_plain(rng, dev):
    """k_decode at DECODE_EDGE_LANES lanes, k_subgroup at as many G1 and
    G2 lanes and with n1 != n2, and k_decode_g1 at as many keys with and
    without its check (check_layouts.EdgeCases: prefixes of one input with
    the edge lanes placed), each against its plain version run once at the
    largest count, and k_decode_g1 at DECODE_G1_KEYS edge keys (its third
    layout): bit-exact; k_decode's edge lanes alone against the plain
    lane verdicts.  Returns the worst errors and, information only, the
    kernels' device times at 1,025 lanes."""
    import torch
    from lighthouse_tpu_torch.crypto.bls.cuda import staged
    from lighthouse_tpu_torch.tools import check_layouts as cl

    t0 = time.perf_counter()
    ec = cl.EdgeCases(rng, dev, DECODE_EDGE_LANES)
    out = {"k_decode": 0, "k_subgroup": 0, "k_decode_g1": 0}
    for n in DECODE_EDGE_LANES:
        out["k_decode"] = max(out["k_decode"], max_abs_err(
            staged.k_decode(*ec.decode_in(n)), ec.want_decode(n)))
        for check in (False, True):
            out["k_decode_g1"] = max(out["k_decode_g1"], max_abs_err(
                staged.k_decode_g1(*ec.decode_g1_in(n), check=check),
                ec.want_decode_g1(n, check)))
        for n1, n2 in ec.subgroup_shapes(n):
            out["k_subgroup"] = max(out["k_subgroup"], max_abs_err(
                staged.k_subgroup(*ec.subgroup_in(n1, n2)),
                ec.want_subgroup(n1, n2)))
    # k_decode_g1's third layout (four keys a block) from DECODE_G1_KEYS on
    wide = tuple(t.to(dev) for t in cl.decode_g1_edge_planes(
        rng, DECODE_G1_KEYS))
    for check in (False, True):
        out["k_decode_g1"] = max(out["k_decode_g1"], max_abs_err(
            staged.k_decode_g1(*wide, check=check),
            staged.k_decode_g1_plain(*wide, check=check)))
    x, sign, inf = ec.dec
    for i in cl.DECODE_EDGES:
        if i < ec.top:
            got = bool(staged.k_decode(x[i:i + 1], sign[i:i + 1],
                                       inf[i:i + 1])[3])
            if got != bool(ec.dec_lane_ok[i]):
                raise AssertionError(f"k_decode lane {i} "
                                     f"({cl.DECODE_EDGES[i]}) alone: {got}")
    top = ec.top
    info = {"lanes": top,
            "k_decode_ms": device_ms(lambda: staged.k_decode(
                *ec.decode_in(top)), 3),
            "k_subgroup_ms": device_ms(lambda: staged.k_subgroup(
                *ec.subgroup_in(top, top)), 3),
            "k_decode_g1_ms": device_ms(lambda: staged.k_decode_g1(
                *ec.decode_g1_in(top), check=True), 3)}
    torch.cuda.synchronize()
    log(f"[vs plain] k_decode at {DECODE_EDGE_LANES} lanes, k_subgroup "
        f"at as many G1 and G2 lanes (edge cases, n1 != n2) and k_decode_g1 "
        f"at as many keys and {DECODE_G1_KEYS} (check on and off): "
        f"max_abs_err={out}")
    for name, err in out.items():
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    log(f"[timing] k_decode at {top} lanes {info['k_decode_ms']:.4f} ms; "
        f"k_subgroup at {top} + {top} lanes {info['k_subgroup_ms']:.4f} ms; "
        f"k_decode_g1 at {top} keys (check) {info['k_decode_g1_ms']:.4f} ms "
        f"(information only)")
    log(f"[decode subgroup edges] {time.perf_counter() - t0:.1f} s")
    return out, info


def be_planes(planes):
    """(x, y, inf) of curve.pack_* (int64 limbs) -> int32 limbs, bool."""
    from lighthouse_tpu_torch.crypto.bls.cuda import staged

    x, y, inf = planes
    return staged.to_i32(x), staged.to_i32(y), inf


def mesh_direct_inputs(bls, gossip, dev, bad_lane=None):
    """The eight tensors of the mesh step for the gossip batch, the keys
    decoded on the card from their compressed bytes (k_decode_g1 with its
    subgroup check; ``bad_lane`` takes the non-subgroup key, decoded without
    it) -> (inputs, the lanes' decode verdicts)."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, staged
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2

    raws = [s.pubkeys[0].to_bytes() for s in gossip]
    if bad_lane is not None:
        raws[bad_lane] = non_subgroup_pubkey()
    planes = [t.to(dev) for t in bk.parse_g1_compressed_many(raws)]
    xp, yp, pi, okp = staged.k_decode_g1(*planes, check=bad_lane is None)
    xs, ys, si = (t.to(dev) for t in be_planes(curve.pack_g2_affine(
        [s.signature.point for s in gossip])))
    words = torch.as_tensor(h2.pack_msg_words(
        [s.message for s in gossip]).view(np.int32)).to(dev)
    u = staged.k_xmd(words)
    n = len(gossip)
    rand = torch.as_tensor(bk.random_weights(n, n).view(np.int32)).to(dev)
    return (xp, yp, pi, xs, ys, si, u, rand), okp


def fresh_wire(bls, sets):
    """The sets with a new LazySignature for each wire signature (a lazy
    signature that one route decoded on the host stays decoded)."""
    return [bls.SignatureSet(bls.LazySignature(s.signature.to_bytes()),
                             s.pubkeys, s.message)
            if isinstance(s.signature, bls.LazySignature) else s
            for s in sets]


def phase_mesh_path(rng, bls, dev, main, sign):
    """The mesh-primary route at full width, every launch counter set to 0
    just before: each batch through crypto.bls.verify_signature_sets on a
    CudaBackend over meshes of MESH_SIZES shards on the card (and one shard
    a card when several are visible), its verdict equal to the
    single-device route's and to the expected value; the mesh steps
    sharded_verify_batch_fn and ring_verify_batch_fn, and the monolithic
    verify_batch_kernel(check_subgroups=True), called directly on the
    gossip batch with keys decoded on the card (k_decode_g1), valid and
    with a non-subgroup key at the shard boundary; no degradation counted;
    every new kernel launched; a warm mesh batch syncs no arena row; and
    k_decode_g1 on DECODE_G1_KEYS of the arena's keys equal to
    curve_ref.g1_decompress."""
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
    from lighthouse_tpu_torch.crypto.bls.cuda import (curve, pubkey_cache,
                                                      staged, verify)
    from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend
    from lighthouse_tpu_torch.parallel import ring
    from lighthouse_tpu_torch.parallel import sharded_verify as sv

    gossip, sync, singles = main["gossip"], main["sync"], main["singles"]
    b = MESH_BOUNDARY
    wire = as_wire(bls, gossip)

    def replace(sets, lane, sig=None, msg=None):
        out = list(sets)
        s = out[lane]
        out[lane] = bls.SignatureSet(sig if sig is not None else s.signature,
                                     s.pubkeys,
                                     msg if msg is not None else s.message)
        return out

    swapped = replace(replace(gossip, b - 1, gossip[b].signature), b,
                      gossip[b - 1].signature)
    odd = make_sets(rng, bls, 8, msg_len=48)
    n_big = MESH_BATCH
    big = [bls.SignatureSet(bls.LazySignature(sign["sigs"][i]),
                            [sign["pks"][i]], sign["msgs"][i])
           for i in range(n_big)]
    tampered = bls.SignatureSet(sync.signature, sync.pubkeys,
                                bytes(x ^ 1 for x in sync.message))
    cases = {
        "gossip_64": (gossip, True),
        "gossip_64_swapped_boundary": (swapped, False),
        "gossip_64_wire": (wire, True),
        "gossip_64_wire_non_subgroup_boundary": (replace(
            wire, b, bls.LazySignature(non_subgroup_signature())), False),
        "gossip_64_wire_off_curve_first": (replace(
            wire, 0, bls.LazySignature(OFF_CURVE_X1)), False),
        "gossip_62_wire": (wire[:MESH_ODD], True),
        "gossip_62_wire_swapped_last": (replace(
            wire[:MESH_ODD], MESH_ODD - 1, wire[0].signature), False),
        "field_8": (odd, True),
        "field_8_wire": (as_wire(bls, odd), True),
        "field_8_wrong_message": (replace(odd, 4, msg=odd[5].message),
                                  False),
        "sync_512_plus_3": ([sync] + singles, True),
        "sync_512_tampered": ([tampered] + singles, False),
        "wire_1024": (big, True),
        "wire_1024_swapped_boundary": (replace(replace(
            big, n_big // 2 - 1, big[n_big // 2].signature), n_big // 2,
            big[n_big // 2 - 1].signature), False),
    }
    single_be = CudaBackend(name="cuda-single", device=dev, mesh=False)
    bls.register_backend(single_be)
    bls.set_backend("cuda-single")
    single = {name: bls.verify_signature_sets(fresh_wire(bls, sets))
              for name, (sets, _) in cases.items()}
    meshes = [(f"{s} shards on {dev}", sv.make_mesh([dev] * s))
              for s in MESH_SIZES]
    if torch.cuda.device_count() > 1:
        meshes.append(("every card", sv.make_mesh(
            [f"cuda:{i}" for i in range(torch.cuda.device_count())])))

    cache = pubkey_cache.get_cache()
    reset_all_launches()
    sv.reset_mesh_stats()
    t0 = time.perf_counter()
    verdicts, direct, warm_sync = {}, {}, None
    valid_in, okp = mesh_direct_inputs(bls, gossip, dev)
    bad_in, _ = mesh_direct_inputs(bls, gossip, dev, bad_lane=b)
    if not bool(okp.all()):
        raise AssertionError("k_decode_g1 rejected a gossip key")
    for label, mesh in meshes:
        be = CudaBackend(name=f"cuda-mesh-{label}", device=dev, mesh=mesh,
                         mesh_min_sets=1)
        bls.register_backend(be)
        bls.set_backend(be.name)
        for name, (sets, want) in cases.items():
            sets = fresh_wire(bls, sets)
            before = cache.sync_stats()
            got = bls.verify_signature_sets(sets)
            if name == "gossip_64_wire":
                after = cache.sync_stats()
                warm_sync = {k: after[k] - before[k] for k in after}
            if any(isinstance(s.signature, bls.LazySignature)
                   and s.signature.decoded() for s in sets):
                raise AssertionError(f"mesh {label} {name}: a wire "
                                     "signature decoded on the host")
            verdicts[(label, name)] = got
            if got is not want or got is not single[name]:
                raise AssertionError(
                    f"mesh {label} {name}: {got} (single-device "
                    f"{single[name]}, want {want})")
        for fn_name, fn in (("sharded", sv.sharded_verify_batch_fn),
                            ("ring", ring.ring_verify_batch_fn)):
            step = fn(mesh)
            got = (bool(step(*valid_in).item()),
                   bool(step(*bad_in).item()))
            direct[(label, fn_name)] = got
            if got != (True, False):
                raise AssertionError(f"{fn_name}_verify_batch_fn on {label}:"
                                     f" {got}, want (True, False)")
        if warm_sync["device_sync_rows"]:
            raise AssertionError(f"mesh {label}: a warm batch synced "
                                 f"{warm_sync}")
        log(f"[mesh] {label}: {len(cases)} batches equal to the "
            f"single-device route; direct steps {direct[(label, 'sharded')]}"
            f" / {direct[(label, 'ring')]}; warm arena sync {warm_sync}")
    kern = (bool(verify.verify_batch_kernel(*valid_in,
                                            check_subgroups=True).item()),
            bool(verify.verify_batch_kernel(*bad_in,
                                            check_subgroups=True).item()))
    if kern != (True, False):
        raise AssertionError(f"verify_batch_kernel(check_subgroups=True): "
                             f"{kern}")
    launches = {nm: n for nm, n in all_launches().items()}
    stats = sv.mesh_stats()
    seconds = time.perf_counter() - t0
    bls.set_backend("cuda")
    log(f"[mesh] verify_batch_kernel(check_subgroups=True) at {GOSSIP}: "
        f"{kern}; mesh_stats {stats}; launches "
        f"{ {nm: launches[nm] for nm in MESH_KERNELS} } ({seconds:.1f} s)")
    if any(stats["degradations"].values()) or stats["mesh_faults"]:
        raise AssertionError(f"mesh path degraded: {stats}")
    for nm in MESH_KERNELS:
        if launches[nm] == 0:
            raise AssertionError(f"{nm} never launched on the mesh path")

    # k_decode_g1 on DECODE_G1_KEYS of the arena's keys against curve_ref
    raws = list(cache._index.keys())[:DECODE_G1_KEYS]
    planes = [t.to(dev) for t in bk.parse_g1_compressed_many(raws)]
    dec = staged.k_decode_g1(*planes, check=True)
    got = curve.unpack_g1_affine(staged.to_i64(dec[0].cpu()),
                                 staged.to_i64(dec[1].cpu()), dec[2].cpu())
    t1 = time.perf_counter()
    ref = [cv.g1_decompress(r, subgroup_check=False) for r in raws]
    host_s = time.perf_counter() - t1
    if got != ref or not bool(dec[3].all()):
        raise AssertionError("k_decode_g1 disagrees with curve_ref on the "
                             "arena's keys")
    log(f"[mesh] k_decode_g1 on {len(raws)} arena keys equal to "
        f"curve_ref.g1_decompress ({host_s:.1f} s on the host), all in G1")
    return {"cases": cases, "meshes": meshes, "valid_in": valid_in,
            "big": big, "launches": launches,
            "verdicts": {f"{k[0]}/{k[1]}": v for k, v in verdicts.items()},
            "mesh_stats": stats, "warm_sync": warm_sync, "seconds": seconds,
            "decode_keys": len(raws), "decode_planes": planes}


def phase_mesh_timing(bls, path, dev, card):
    """At the mesh path's shapes: k_subgroup on the gossip batch's 64 keys
    and 64 signatures, k_decode_g1 on its 64 keys (with the subgroup
    check), k_pair_partial on shard 0 of a 2-shard mesh (32 lanes and the
    closing lane), k_pair_combine on 2 partials, k_ring_mul and k_ring_sum
    on 2 values: the comparisons, times and bounds of phase 5; information
    only, k_decode_g1 without its check at 64 keys and with it at phase
    19's keys, and k_ring_sum of 4 shards' sums.  Then the monolithic
    verify_batch_kernel at 64 sets and verify_batch_multi_kernel at 4 x
    512 keys, with and without their subgroup checks: device time,
    bound and the plain version's time; and, information only, the mesh
    steps (sharded_verify_batch_fn and ring_verify_batch_fn on each mesh,
    verify_batch_kernel(check_subgroups=True) as the single-device
    control) on the valid gossip batch, wall time to the verdict, median
    and quartiles of MESH_STEP_REPS calls, and the 64-set and 1,024-set
    wire batches end to end on each mesh and on the single-device route."""
    import numpy as np
    import torch
    from lighthouse_tpu_torch.crypto.bls import curve_ref as cv
    from lighthouse_tpu_torch.crypto.bls.cuda import backend as bk
    from lighthouse_tpu_torch.crypto.bls.cuda import curve, fp, staged, verify
    from lighthouse_tpu_torch.crypto.bls.cuda import hash_to_g2 as h2
    from lighthouse_tpu_torch.crypto.bls.cuda.backend import CudaBackend
    from lighthouse_tpu_torch.parallel import ring
    from lighthouse_tpu_torch.parallel import sharded_verify as sv

    c = op_model()
    rate = 64 * card["sms"] * card["max_sm_mhz"] * 1e6
    xp, yp, pi, xs, ys, si, u, rand = path["valid_in"]
    n = xp.shape[0]
    act = ~(pi & si)
    sub_in = (xp, yp, pi, act, xs, ys, si, act)
    gossip = path["cases"]["gossip_64"][0]
    planes = [t.to(dev) for t in bk.parse_g1_compressed_many(
        [s.pubkeys[0].to_bytes() for s in gossip])]
    q = n // 2
    hx, hy, hinf = staged.k_hash(u[:q])
    pts = staged.k_points(xp[:q], yp[:q], pi[:q], xs[:q], ys[:q], si[:q],
                          rand[:q])
    lanes = (pts[0], pts[1], pts[2], hx, hy, hinf)
    part0 = staged.k_pair_partial(*lanes, *pts[3:], closing=True)
    part1 = staged.k_pair_partial(*lanes)
    parts = torch.stack([part0, part1])
    two = [pts[3:], staged.k_points(xp[q:], yp[q:], pi[q:], xs[q:], ys[q:],
                                    si[q:], rand[q:])[3:]]
    rx = torch.stack([t[0] for t in two])
    ry = torch.stack([t[1] for t in two])
    ri = torch.cat([t[2] for t in two])
    live_pair = int((~(pts[2] | hinf)).sum())
    ops = {
        "k_subgroup": k_subgroup_ops(c, int((~pi & act).sum()),
                                     int((~si & act).sum())),
        "k_decode_g1": k_decode_g1_ops(c, n, True),
        "k_pair_partial": c["miller_f"] + (live_pair + 1) * c[
            "miller_lane"],
        "k_pair_combine": c["f12m"] + c["final_exp"],
        "k_ring_mul": c["f12m"],
        "k_ring_sum": max(int((~ri).sum()) - 1, 0) * c["add2"] + c["inv2"]
        + S2 + 3 * M2,
    }
    calls = {
        "k_subgroup": (lambda: staged.k_subgroup(*sub_in),
                       lambda: staged.k_subgroup_plain(*sub_in), sub_in, 5),
        "k_decode_g1": (lambda: staged.k_decode_g1(*planes, check=True),
                        lambda: staged.k_decode_g1_plain(*planes, check=True),
                        planes, 5),
        "k_pair_partial": (
            lambda: staged.k_pair_partial(*lanes, *pts[3:], closing=True),
            lambda: staged.k_pair_partial_plain(*lanes, *pts[3:],
                                                closing=True),
            (*lanes, *pts[3:]), 5),
        "k_pair_combine": (lambda: staged.k_pair_combine(parts),
                           lambda: staged.k_pair_combine_plain(parts),
                           (parts,), 5),
        "k_ring_mul": (lambda: staged.k_ring_mul(part0, part1),
                       lambda: staged.k_ring_mul_plain(part0, part1),
                       (part0, part1), 50),
        "k_ring_sum": (lambda: staged.k_ring_sum(rx, ry, ri),
                       lambda: staged.k_ring_sum_plain(rx, ry, ri),
                       (rx, ry, ri), 20),
    }
    calls = {k: {"kern": v[0], "plain": v[1], "ins": v[2], "reps": v[3]}
             for k, v in calls.items()}
    rows = time_calls(calls, ops, rate, "the mesh path's shape")
    rows["k_subgroup"]["lanes"] = [n, n]
    rows["k_decode_g1"]["lanes"] = n
    rows["k_pair_partial"]["lanes"] = q + 1
    rows["k_pair_combine"]["partials"] = 2
    rows["k_ring_sum"]["points"] = 2
    # Information only: k_decode_g1 without its check at the 64 keys and
    # with it at phase 19's DECODE_G1_KEYS arena keys; k_ring_sum of four
    # shards' signature sums (a quarter of the batch each), each also
    # against its plain version
    keys = path["decode_planes"]
    r4 = [staged.k_points(*(t[i * n // 4:(i + 1) * n // 4] for t in (
        xp, yp, pi, xs, ys, si, rand)))[3:] for i in range(4)]
    r4 = (torch.stack([t[0] for t in r4]), torch.stack([t[1] for t in r4]),
          torch.cat([t[2] for t in r4]))
    extra = {"k_decode_g1": (
        ("ms_no_check", lambda: staged.k_decode_g1(*planes),
         lambda: staged.k_decode_g1_plain(*planes)),
        (f"ms_{len(keys[0])}_keys", lambda: staged.k_decode_g1(
            *keys, check=True), None)),
        "k_ring_sum": (("ms_4_points", lambda: staged.k_ring_sum(*r4),
                        lambda: staged.k_ring_sum_plain(*r4)),)}
    for nm, items in extra.items():
        for key, kern, plain in items:
            if plain is not None:
                err = max_abs_err(as_tuple(kern()), as_tuple(plain()))
                if err != 0:
                    raise AssertionError(f"{nm} ({key}) disagrees with its "
                                         "plain version")
            rows[nm][key] = device_ms(kern, 5)
    m = len(keys[0])
    log(f"[timing] k_decode_g1 without its check at {n} keys "
        f"{rows['k_decode_g1']['ms_no_check']:.4f} ms, with it at {m} keys "
        f"{rows['k_decode_g1'][f'ms_{m}_keys']:.4f} ms; k_ring_sum at 4 "
        f"points {rows['k_ring_sum']['ms_4_points']:.4f} ms (information "
        f"only)")

    # The monolithic kernels (sequences of the launches above): device
    # time with and without subgroup checks, the plain version's time, and
    # the sum of their launches' bounds; verify_batch_multi_kernel at the
    # sync aggregate's shape (4 sets x 512 keys)
    sets4 = path["cases"]["sync_512_plus_3"][0]
    k = SYNC_KEYS
    mask = torch.zeros((len(sets4), k), dtype=torch.bool)
    flat = []
    for i, st in enumerate(sets4):
        mask[i, :len(st.pubkeys)] = True
        flat += [pk.point for pk in st.pubkeys] + [cv.g1_infinity()] * (
            k - len(st.pubkeys))
    mx, my, mi = (t.to(dev) for t in be_planes(curve.pack_g1_affine(flat)))
    m4 = len(sets4)
    mxs, mys, msi = (t.to(dev) for t in be_planes(curve.pack_g2_affine(
        [st.signature.point for st in sets4])))
    mu = staged.to_i32(h2.hash_to_field([st.message for st in sets4])).to(dev)
    mrand_np = bk.random_weights(m4, m4)
    margs = (mx.view(m4, k, -1), my.view(m4, k, -1), mi.view(m4, k),
             mask.to(dev), mxs, mys, msi, mu,
             torch.as_tensor(mrand_np.view(np.int32)).to(dev))
    uv = fp.unpack(u.cpu())
    u_rows = [((uv[4 * i], uv[4 * i + 1]), (uv[4 * i + 2], uv[4 * i + 3]))
              for i in range(n)]
    muv = fp.unpack(mu.cpu())
    mu_rows = [((muv[4 * i], muv[4 * i + 1]), (muv[4 * i + 2],
                                                 muv[4 * i + 3]))
               for i in range(m4)]
    base = {
        "verify_batch_kernel": k_hash_ops(c, u_rows) + k_points_ops(
            c, rand.cpu().to(torch.int64).tolist(), pi.cpu().tolist(),
            si.cpu().tolist()) + k_pair_ops(c, n + 1),
        "verify_batch_multi_kernel": k_hash_ops(c, mu_rows) + k_points_ops(
            c, mrand_np.astype(np.int64).tolist(), [False] * m4,
            [False] * m4, [len(st.pubkeys) for st in sets4])
        + k_pair_ops(c, m4 + 1),
    }
    checks = {"verify_batch_kernel": k_subgroup_ops(c, n, n),
              "verify_batch_multi_kernel": k_subgroup_ops(
                  c, sum(len(st.pubkeys) for st in sets4), m4)}
    fns = {"verify_batch_kernel": (verify.verify_batch_kernel,
                                   verify.verify_batch, path["valid_in"]),
           "verify_batch_multi_kernel": (verify.verify_batch_multi_kernel,
                                         verify.verify_batch_multi, margs)}
    mono = {}
    for name, (kern, plain, args) in fns.items():
        row = {}
        for check in (False, True):
            if not bool(kern(*args, check_subgroups=check).item()):
                raise AssertionError(f"{name}(check_subgroups={check}) "
                                     "fails a valid batch")
            row[f"ms_check_subgroups={check}"] = device_ms(
                lambda check=check: kern(*args, check_subgroups=check), 3)
            row[f"bound_ms_check_subgroups={check}"] = (
                base[name] + (checks[name] if check else 0)) / rate * 1e3
        row["plain_ms"] = timed(lambda: plain(*args))
        mono[name] = row
    log(f"[timing] the monolithic kernels (information only): {mono}")
    steps = {"single": lambda *a: verify.verify_batch_kernel(
        *a, check_subgroups=True)}
    for label, mesh in path["meshes"]:
        steps[f"sharded/{label}"] = sv.sharded_verify_batch_fn(mesh)
        steps[f"ring/{label}"] = ring.ring_verify_batch_fn(mesh)
    step_ms = {}
    for name, step in steps.items():
        step(*path["valid_in"]).item()
        times = []
        for _ in range(MESH_STEP_REPS):
            t0 = time.perf_counter()
            ok = bool(step(*path["valid_in"]).item())
            times.append((time.perf_counter() - t0) * 1e3)
            if not ok:
                raise AssertionError(f"mesh step {name} failed timing")
        q = statistics.quantiles(times, n=4)
        step_ms[name] = {"median": statistics.median(times), "q1": q[0],
                         "q3": q[2]}
    log(f"[timing] mesh steps at {n} valid sets, wall ms to the verdict, "
        f"median of {MESH_STEP_REPS} (information only): {step_ms}")
    e2e = {}
    batches = {"wire_64": path["cases"]["gossip_64_wire"][0],
               "wire_1024": path["big"]}
    routes = [("single", CudaBackend(name="t-single", device=dev,
                                     mesh=False))]
    routes += [(label, CudaBackend(name=f"t-{label}", device=dev, mesh=mesh,
                                   mesh_min_sets=1))
               for label, mesh in path["meshes"]]
    for label, be in routes:
        bls.register_backend(be)
        bls.set_backend(be.name)
        for bname, sets in batches.items():
            sets = fresh_wire(bls, sets)
            bls.verify_signature_sets(sets)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                ok = bls.verify_signature_sets(sets)
                times.append((time.perf_counter() - t0) * 1e3)
                if not ok:
                    raise AssertionError(f"{label} {bname} failed timing")
            e2e[f"{label}/{bname}"] = statistics.median(times)
    bls.set_backend("cuda")
    log(f"[timing] verify_signature_sets end to end, median of 3 ms "
        f"(information only): {e2e}")
    return rows, {"monolithic": mono, "step_ms": step_ms, "e2e_ms": e2e}


def ptxas_summary(lines) -> dict:
    """Registers and stack of each kernel of a source, and its spills."""
    import re

    kernels = [re.sub(r"^ptxas info\s*:\s*", "", ln) for ln in lines
               if "registers" in ln]
    spills = sum(int(m) for ln in lines
                 for m in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                     ln))
    return {"kernels": kernels, "spill_bytes": spills}


def coop_ptxas_check(src: str, lines) -> dict:
    """The ptxas lines of a cooperative source (k_pair.cu, k_each.cu,
    k_points.cu): every kernel a 0-byte stack frame and no spill (the
    block-cooperative programs need no per-thread stack)."""
    import re

    summary = ptxas_summary(lines)
    frames = [int(m) for ln in lines
              for m in re.findall(r"(\d+) bytes stack frame", ln)]
    summary["stack_frames"] = frames
    if not frames or any(frames) or summary["spill_bytes"]:
        raise AssertionError(f"{src}.cu: stack or spills in {lines}")
    return summary


def hash_sign_ptxas_check() -> dict:
    """The lane machine's kernels from their build logs: k_hash_kernel a
    0-byte stack frame and no spill; k_sign_root_kernel and
    k_sign_field_kernel no spill and a stack (their own frame, or the
    cumulative size with XMD's calls where ptxas prints it) under the
    default 1 KB a thread, so no launch sets a stack limit."""
    from lighthouse_tpu_torch.runtime import build

    funcs = {}
    for src in ("k_hash", "k_sign"):
        funcs.update(build.ptxas_functions(build.build_log(src)))
    out = {}
    for kern in ("k_hash_kernel", "k_sign_root_kernel",
                 "k_sign_field_kernel"):
        hits = [v for k, v in funcs.items() if kern in k]
        if len(hits) != 1 or "stack_frame" not in hits[0]:
            raise AssertionError(f"ptxas: no properties for {kern}")
        f = hits[0]
        stack = max(f["stack_frame"], f.get("cumulative_stack", 0))
        out[kern] = dict(f, stack=stack)
        bad = (stack != 0 if kern == "k_hash_kernel" else stack >= 1024)
        if bad or f["spill"]:
            raise AssertionError(f"ptxas: {kern} stack {stack} bytes, "
                                 f"spills {f['spill']} bytes")
    return out


def check_ptxas_check() -> dict:
    """k_decode_kernel, k_subgroup_kernel and k_decode_g1_kernel
    (check_coop.cuh), k_ring_sum_kernel (points_coop.cuh), k_ring_mul_kernel
    (pair_coop.cuh's final block) and k_sign_agg_kernel (check_coop.cuh's
    decoding, points_coop.cuh's engine) from their build logs: a 0-byte
    stack frame and no spill, each layout's."""
    from lighthouse_tpu_torch.runtime import build

    funcs = {}
    for src in ("k_decode", "k_verify", "k_ring", "k_sign"):
        funcs.update(build.ptxas_functions(build.build_log(src)))
    out = {}
    for kern in ("k_decode_kernel", "k_subgroup_kernel",
                 "k_decode_g1_kernel", "k_ring_sum_kernel",
                 "k_ring_mul_kernel", "k_sign_agg_kernel"):
        # one instantiation a layout (narrow and wide)
        hits = {k: v for k, v in funcs.items() if kern in k}
        if not hits or any("stack_frame" not in f for f in hits.values()):
            raise AssertionError(f"ptxas: no properties for {kern}")
        for name, f in hits.items():
            if (f["stack_frame"] or f.get("cumulative_stack", 0)
                    or f["spill"]):
                raise AssertionError(f"ptxas: {name} stack "
                                     f"{f['stack_frame']} bytes, spills "
                                     f"{f['spill']} bytes")
        out[kern] = list(hits.values())
    return out


def card_info():
    import torch

    props = torch.cuda.get_device_properties(0)
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return {"sms": props.multi_processor_count, "max_sm_mhz": mhz}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls.cuda import staged
    from lighthouse_tpu_torch.runtime import build
    from lighthouse_tpu_torch.tools import (check_layouts, pair_layouts,
                                            points_layouts)

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

    sign_ptxas = ptxas_summary(info["k_sign"]["ptxas"])
    log(f"[ptxas] k_sign.cu (information only): {sign_ptxas}")
    lane_ptxas = hash_sign_ptxas_check()
    log(f"[ptxas] k_hash.cu and k_sign.cu lane machines: {lane_ptxas}")
    check_ptxas = check_ptxas_check()
    check_ptxas["blocks_per_sm"] = [
        check_layouts.occupancy(build.lib(src), kern)
        for src, kern in (("k_decode", "k_decode"),
                          ("k_verify", "k_subgroup"),
                          ("k_verify", "k_decode_g1"),
                          ("k_sign", "k_sign_agg"))]
    log(f"[ptxas] k_decode_kernel, k_subgroup_kernel, k_decode_g1_kernel, "
        f"k_ring_sum_kernel, k_ring_mul_kernel and k_sign_agg_kernel (blocks "
        f"an SM): {check_ptxas}")
    pair_ptxas = coop_ptxas_check("k_pair", info["k_pair"]["ptxas"])
    pair_ptxas["blocks_per_sm"] = pair_layouts.occupancy(build.lib("k_pair"))
    log(f"[ptxas] k_pair.cu (blocks an SM: Miller, final): {pair_ptxas}")
    each_ptxas = coop_ptxas_check("k_each", info["k_each"]["ptxas"])
    log(f"[ptxas] k_each.cu: {each_ptxas}")
    points_ptxas = coop_ptxas_check("k_points", info["k_points"]["ptxas"])
    points_ptxas["blocks_per_sm"] = points_layouts.occupancy(
        build.lib("k_points"))
    acc = points_ptxas["accumulators"] = points_layouts.accumulators(
        build.lib("k_points"))
    log(f"[ptxas] k_points.cu (blocks an SM: ladder, sum, key sum): "
        f"{points_ptxas}")
    if acc != (points_layouts.SUM_ACC, points_layouts.AGG_ACC):
        # the edge phase's P == Q and P == -Q inputs are placed by these
        raise AssertionError(f"k_points.cu's accumulators {acc} are not the "
                             "edge inputs' (points_layouts.SUM_ACC, AGG_ACC)")

    errs = phase_kernels_vs_plain(rng, dev)
    errs.update(phase_new_kernels_vs_plain(rng, dev))
    errs.update(phase_sign_kernels_vs_plain(rng, dev))
    errs.update(phase_sha_kernels_vs_plain(rng, dev))
    errs.update(phase_epoch_kernels_vs_plain(dev))
    errs.update(phase_kzg_kernels_vs_plain(rng, dev))
    errs.update(phase_mesh_kernels_vs_plain(rng, dev))
    for nm, err in phase_pair_edges_vs_plain(rng, dev).items():
        errs[nm] = max(errs[nm], err)
    hs_errs, hs_info = phase_hash_sign_edges_vs_plain(rng, dev)
    for nm, err in hs_errs.items():
        errs[nm] = max(errs[nm], err)
    pe_errs, pe_info = phase_points_each_edges_vs_plain(rng, dev)
    for nm, err in pe_errs.items():
        errs[nm] = max(errs[nm], err)
    ds_errs, ds_info = phase_decode_subgroup_edges_vs_plain(rng, dev)
    for nm, err in ds_errs.items():
        errs[nm] = max(errs[nm], err)
    bls.set_backend("cuda")
    arena = phase_arena_fill(rng, bls, dev, ARENA_KEYS)
    main_path = phase_main_path(rng, bls, staged)
    rows, e2e = phase_timing(rng, bls, staged, main_path, dev, card)
    sign = phase_sign_path(rng, bls, dev)
    sign_rows, sign_e2e = phase_sign_timing(rng, bls, sign, dev, card)
    rows.update(sign_rows)
    t_mesh = time.perf_counter()
    mesh_path = phase_mesh_path(rng, bls, dev, main_path, sign)
    mesh_rows, mesh_info = phase_mesh_timing(bls, mesh_path, dev, card)
    rows.update(mesh_rows)
    log(f"[mesh] phases 19-20: {time.perf_counter() - t_mesh:.1f} s")
    hash_path, T, state = phase_state_root_path(args.seed, dev)
    merkle = merkleize_levels(MERKLE_LEAVES)
    rows.update(phase_sha_timing(rng, dev, card))
    epoch_path, cap = phase_epoch_path(T, state)
    del state
    epoch_sync = phase_epoch_sync_boundary(args.seed)
    rows.update(phase_epoch_timing(cap, dev, card))
    t_kzg = time.perf_counter()
    kzg_path = phase_kzg_path(args.seed, dev)
    kzg_rows, kzg_pair_ms = phase_kzg_timing(kzg_path, dev, card)
    rows.update(kzg_rows)
    log(f"[kzg] phases 16-17: {time.perf_counter() - t_kzg:.1f} s")
    join_host_oracles()
    launches = dict(main_path["launches"])
    launches.update({nm: sign["launches"][nm] for nm in SIGN_KERNELS})
    launches.update(hash_path["launches"])
    launches.update({nm: epoch_path["launches"][nm] for nm in EPOCH_KERNELS})
    launches.update({nm: kzg_path["launches"][nm] for nm in KZG_KERNELS})
    launches.update({nm: mesh_path["launches"][nm] for nm in MESH_KERNELS})

    kernels = []
    for nm in REPLACES:
        row = rows[nm]
        edge = errs[nm]
        main_err = row["max_abs_err"]
        if nm == "k_points":
            edge = max(edge, errs["k_points_mask"])
            main_err = max(main_err, rows["k_points_mask"]["max_abs_err"])
        if nm == "k_gather_rows":
            main_err = max(main_err,
                           rows["k_gather_rows_4x512"]["max_abs_err"])
        entry = {
            "name": nm, "route": "cuda",
            "source": "lighthouse_tpu_torch/csrc/"
                      + SOURCES.get(nm, f"{nm}.cu"),
            "replaces": REPLACES[nm], "launches": launches[nm],
            "max_abs_err": max(edge, main_err),
            "max_abs_err_edge_cases": edge, "max_abs_err_main_shape": main_err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "ok": True,
            "ms_median": row["ms"],
        }
        if nm == "k_points":
            entry["mask_variant"] = dict(rows["k_points_mask"], n=4,
                                         k=SYNC_KEYS)
            entry["ms_1024_lanes"] = pe_info["k_points_1024_ms"]
        if nm == "k_each":
            entry["ms_1024_sets"] = pe_info["k_each_1024_ms"]
        if nm in ("k_decode", "k_subgroup", "k_decode_g1"):
            entry["ms_1025_lanes"] = ds_info[f"{nm}_ms"]
        for key, val in row.items():
            if nm in ("k_decode_g1", "k_ring_sum") and key.startswith(
                    "ms_") and key != "ms":
                entry[key] = val
        if nm == "k_gather_rows":
            entry["rows"] = row["rows"]
            entry["shape_4x512"] = rows["k_gather_rows_4x512"]
        if nm in ("k_scatter_rows", "k_scatter_sk_rows"):
            entry.update(rows=row["rows"], arena_rows=row["arena_rows"])
        if nm == "k_gather_sk_rows":
            entry["rows"] = row["rows"]
        if nm in ("k_sign_root", "k_sign_field"):
            entry["lanes"] = row["lanes"]
        if nm == "k_sign_agg":
            entry["shape"] = row["shape"]
            entry["max_abs_err_edge_shapes"] = row[
                "max_abs_err_edge_shapes"]
            entry[f"ms_{2 * AGG_ROWS}x{AGG_K}"] = row[
                f"ms_{2 * AGG_ROWS}x{AGG_K}"]
            edge = max(edge, *row["max_abs_err_edge_shapes"].values())
            entry["max_abs_err_edge_cases"] = edge
            entry["max_abs_err"] = max(edge, main_err)
        if nm in SHA_KERNELS:
            entry.update(lanes=row["lanes"], hashlib_ms=row["hashlib_ms"])
        if nm in EPOCH_KERNELS:
            entry["lanes"] = row["lanes"]
        if nm == "k_state":
            entry.update(divisions=row["divisions"],
                         div64_instructions=row["div64_instructions"])
        if nm in KZG_KERNELS:
            entry["shape"] = row["shape"]
        for key in ("lanes", "partials", "points"):
            if nm in MESH_KERNELS and key in row:
                entry[key] = row[key]
        kernels.append(entry)
    log("[pair] at the path shapes: k_pair "
        f"{rows['k_pair']['ms']} ms (65 lanes), k_pair_partial "
        f"{rows['k_pair_partial']['ms']} ms (32 + 1 lanes), k_pair_combine "
        f"{rows['k_pair_combine']['ms']} ms (2 partials)")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "kernels": kernels, "sets_per_s_64": GOSSIP * 1e3
        / e2e["gossip_64_ms"],
        "info": dict(e2e, arena=arena, sync_cold=main_path["sync_cold"],
                     sync_warm=main_path["sync_warm"],
                     sign=dict(sign_e2e, cohorts=sign["cohorts"],
                               verify_4096_ms=sign["verify_4096_ms"],
                               keys_s=sign["keys_s"],
                               ptxas_k_sign=sign_ptxas),
                     ptxas_k_pair=pair_ptxas,
                     ptxas_k_each=each_ptxas,
                     ptxas_k_points=points_ptxas,
                     ptxas_lane_machine=lane_ptxas,
                     ptxas_check=check_ptxas,
                     decode_subgroup_edges=ds_info,
                     hash_sign_edges=hs_info,
                     points_each_edges=pe_info,
                     state_root=dict(hash_path, merkleize=merkle),
                     epoch=dict(epoch_path, sync_boundary=epoch_sync),
                     kzg={"cases": kzg_path["cases"],
                          "e2e_ms": kzg_path["e2e_ms"],
                          "gen_ms": kzg_path["gen_ms"],
                          "launches": kzg_path["launches"],
                          "k_pair_2_lanes_ms": kzg_pair_ms},
                     mesh=dict(mesh_info,
                               meshes=[lb for lb, _ in mesh_path["meshes"]],
                               verdicts=mesh_path["verdicts"],
                               mesh_stats=mesh_path["mesh_stats"],
                               warm_sync=mesh_path["warm_sync"],
                               launches={nm: mesh_path["launches"][nm]
                                         for nm in MESH_KERNELS},
                               decode_g1_keys=mesh_path["decode_keys"]),
                     script_s=time.perf_counter() - t_start)}),
          flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_host_oracles()
