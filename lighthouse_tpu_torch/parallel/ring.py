"""The ring form of the mesh step: the counterpart of
``lighthouse_tpu/parallel/ring.py``.

``sharded_verify`` combines its per-shard partials (one G2 point and one
Fp12 element a shard) by gathering them onto shard 0.  The ring moves each
shard's partial one hop around the ring, shard i to shard i + 1, and every
shard folds the arriving value into its accumulator; after mesh.size - 1
hops every shard holds the full sum or product (the reference's
``lax.ppermute`` scan).  A hop is a copy onto the next shard's device (none
on the same card), ordered with CUDA events, and a fold is one launch on the
receiving shard's stream: k_ring_mul for the Fp12 product, k_ring_sum over
the accumulator and the arriving point for the G2 sum (complete additions:
two shards may hold equal sums, or both infinity).
"""
from __future__ import annotations

import torch

from ..crypto.bls.cuda import staged
from .sharded_verify import Mesh, _step, move, on


def _ring(mesh: Mesh, values, fold):
    """After mesh.size - 1 hops, every shard's fold of all the values."""
    acc, moving = list(values), list(values)
    s = mesh.size
    for _ in range(s - 1):
        moving = [move(moving[(j - 1) % s], mesh.shards[(j - 1) % s],
                       mesh.shards[j]) for j in range(s)]
        for j, shard in enumerate(mesh.shards):
            with on(shard):
                acc[j] = fold(acc[j], moving[j])
    return acc


def ring_reduce_fp12(mesh: Mesh, parts) -> list:
    """parts[i]: shard i's Fp12 partial (2, 3, 2, 12) -> the product of all
    of them on every shard (k_ring_mul a hop)."""
    return _ring(mesh, parts, staged.k_ring_mul)


def _add_affine(a, b):
    (ax, ay, ai), (bx, by, bi) = a, b
    return staged.k_ring_sum(torch.stack([ax, bx]), torch.stack([ay, by]),
                             torch.cat([ai, bi]))


def ring_sum_g2(mesh: Mesh, points) -> list:
    """points[i]: shard i's affine G2 point (x, y (2, 12), inf (1,)) -> the
    affine sum of all of them on every shard (k_ring_sum a hop)."""
    packed = []
    for shard, (x, y, i) in zip(mesh.shards, points):
        with on(shard):
            packed.append(torch.cat([x.reshape(-1), y.reshape(-1),
                                     i.to(x.dtype)]))

    def unpack(t):
        return (t[:24].reshape(2, 12), t[24:48].reshape(2, 12),
                t[48:].to(torch.bool))

    def fold(acc, moving):
        sx, sy, si = _add_affine(unpack(acc), unpack(moving))
        return torch.cat([sx.reshape(-1), sy.reshape(-1), si.to(sx.dtype)])

    out = []
    for shard, t in zip(mesh.shards, _ring(mesh, packed, fold)):
        with on(shard):                   # the shard's stream wrote t
            out.append(unpack(t))
    return out


def ring_verify_batch_fn(mesh: Mesh):
    """The mesh step with ring combines in place of the gathers (reference
    :80): the semantics of ``sharded_verify_batch_fn``, subgroup checks
    on, padding lanes with both points at infinity."""
    return _step(mesh, ring=True)
