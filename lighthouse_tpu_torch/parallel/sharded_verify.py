"""Mesh-primary BLS batch verification over a mesh of shards.

Counterpart of ``lighthouse_tpu/parallel/sharded_verify.py``.  The JAX
package shards a batch over the ``dp`` axis of a ``jax.sharding.Mesh`` and
runs one SPMD program under ``shard_map``; here a ``Mesh`` is an ordered
tuple of shards, each a ``torch.device`` with a CUDA stream of its own
(``make_mesh``; the same card may appear several times, which is how one
card runs the multi-device program), and the step is a sequence of the
hand-written launches of ``crypto/bls/cuda/staged.py`` issued on each
shard's stream:

  * per shard: (k_decode and k_xmd on the wire / root variants) k_hash,
    k_points (the weighting ladders and the shard's G2 signature sum), the
    subgroup checks of the plain step (k_subgroup), and the shard's Miller
    product (k_pair_partial);
  * across shards: the shards' signature sums gathered onto shard 0 and
    summed (k_ring_sum), which feeds the closing lane (-g1, sum) of shard
    0's Miller product only -- the other shards' closing lane is off; the
    Fp12 partials gathered onto shard 0, one final exponentiation and the
    is-one test (k_pair_combine); the shards' other verdicts ANDed in there
    (k_and: the ``pmin`` of the reference).  One readback.

A gather is a copy of each shard's value onto the combining shard's device
(no copy when it is the same card).  Cross-shard order is kept with CUDA
events (``Stream.wait_event``), never a host synchronisation, and a tensor
read on a stream other than the one it was allocated on is kept alive with
``Tensor.record_stream``.  ``parallel/ring.py`` has the ring form of the
same step.  On the CPU (``make_mesh(["cpu"] * k)``) the shards have no
stream and the launches are the kernels' plain versions, in shard order.

Routing (``mesh_wanted``): the backend forms a mesh over every visible
CUDA device when there is more than one (``get_mesh``), for batches of at
least ``DEFAULT_MESH_MIN_SETS`` sets; it has no environment variables (the
reference reads LIGHTHOUSE_TPU_BLS_MESH / _MESH_MIN): a caller pins the
route with ``CudaBackend(mesh=False)`` or passes its own mesh.  A batch is
padded to a multiple of the shard count with infinity lanes and zero
weights (no power-of-two floor: that was a TPU compile-shape rule).

The ladder (``sharded_verify_with_fallback``): a mesh fault, at dispatch or
at the readback, retries the same batch on one device with the monolithic
kernel (``verify_batch_kernel(check_subgroups=True)``); a fault there too
raises ``BackendFault``.  ``mesh_stats()`` counts dispatches, faults and
degradation hops in a plain dict (the port has no metrics registry).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence

import torch

from ..crypto.bls.cuda import staged

DEFAULT_MESH_MIN_SETS = 64


# --- The mesh ------------------------------------------------------------------


class Shard(NamedTuple):
    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]   # None on the CPU


class Mesh:
    """An ordered tuple of shards; shard 0 combines."""

    __slots__ = ("shards",)

    def __init__(self, shards: Sequence[Shard]):
        if not shards:
            raise ValueError("a mesh needs at least one shard")
        self.shards = tuple(shards)

    @property
    def size(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self.shards)

    @property
    def home(self) -> Shard:
        return self.shards[0]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices) -> Mesh:
    """A mesh over ``devices`` (a list of devices or names; one may repeat:
    shards on one card).  Every CUDA shard gets a stream of its own; all
    shards lie on CUDA devices or all on the CPU."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if not kinds <= {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError(f"a mesh is all CUDA or all CPU: {devs}")
    shards = []
    for i, d in enumerate(devs):
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: no CUDA device")
            d = torch.device("cuda", d.index if d.index is not None
                             else torch.cuda.current_device())
            shards.append(Shard(i, d, torch.cuda.Stream(device=d)))
        else:
            shards.append(Shard(i, d, None))
    return Mesh(shards)


def on(shard: Shard):
    """The context that issues work on the shard's stream."""
    if shard.stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(shard.stream)


def _event(shard: Shard):
    ev = torch.cuda.Event()
    ev.record(shard.stream)
    return ev


def begin(mesh: Mesh) -> None:
    """Order every shard's stream after the work already issued on its
    device's current stream (arena syncs, the caller's inputs)."""
    for shard in mesh.shards:
        if shard.stream is not None:
            shard.stream.wait_stream(torch.cuda.current_stream(shard.device))


def join(mesh: Mesh) -> None:
    """Order each device's current stream after every shard's work, so a
    readback (``.item()``) or the next arena sync on it comes after."""
    for shard in mesh.shards:
        if shard.stream is not None:
            torch.cuda.current_stream(shard.device).wait_stream(shard.stream)


def finish(mesh: Mesh, out: torch.Tensor) -> torch.Tensor:
    """``join`` the mesh; ``out`` (the step's verdict, on the home shard)
    may then be read on the current stream."""
    join(mesh)
    if mesh.home.stream is not None:
        out.record_stream(torch.cuda.current_stream(mesh.home.device))
    return out


def move(t: torch.Tensor, src: Shard, dst: Shard) -> torch.Tensor:
    """``t`` (written on src's stream) for use on dst's stream: no copy on
    the same device, else a copy issued after src's work."""
    if src.stream is None:
        return t.to(dst.device)
    if src.stream != dst.stream:
        dst.stream.wait_event(_event(src))
    if t.device == dst.device:
        t.record_stream(dst.stream)
        return t
    with torch.cuda.stream(src.stream), torch.cuda.stream(dst.stream):
        return t.to(dst.device, non_blocking=True)


def shard_inputs(mesh: Mesh, arrays) -> list:
    """Cut each array (host or device tensor) into ``mesh.size`` equal
    slices along its leading axis and place slice i on shard i (copied on
    the shard's stream) -> [tuple of slices] per shard."""
    m = arrays[0].shape[0]
    if m % mesh.size:
        raise ValueError(f"{m} lanes do not split over {mesh.size} shards")
    q = m // mesh.size
    out = []
    for shard in mesh.shards:
        lo = shard.index * q
        with on(shard):
            part = []
            for a in arrays:
                s = a[lo:lo + q]
                t = s.to(shard.device).contiguous()
                if (shard.stream is not None and a.device.type == "cuda"
                        and t.data_ptr() == s.data_ptr()):
                    t.record_stream(shard.stream)
                part.append(t)
        out.append(tuple(part))
    return out


def pad_lanes(n: int, mesh: Mesh) -> int:
    """The padded lane count: n rounded up to a multiple of the shards."""
    return -(-n // mesh.size) * mesh.size


# --- Routing -------------------------------------------------------------------

_MESH_CACHE: dict = {}


def mesh_enabled() -> bool:
    """Auto: a mesh exists when more than one CUDA device is visible."""
    return torch.cuda.is_available() and torch.cuda.device_count() > 1


def get_mesh() -> Optional[Mesh]:
    """The process-wide mesh over every visible CUDA device (one shard a
    card), or None on a box with one card or none."""
    if not mesh_enabled():
        return None
    if "mesh" not in _MESH_CACHE:
        _MESH_CACHE["mesh"] = make_mesh(
            [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    return _MESH_CACHE["mesh"]


def mesh_wanted(n_sets: int, mesh: Optional[Mesh] = None,
                min_sets: int = DEFAULT_MESH_MIN_SETS) -> Optional[Mesh]:
    """The mesh to dispatch ``n_sets`` over, or None when the batch belongs
    on the single-device route (no mesh, or fewer sets than the threshold
    or than the shards)."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None or n_sets < max(min_sets, mesh.size):
        return None
    return mesh


def device_xmd_ok(msgs) -> bool:
    """True when every message is a 32-byte signing root (SHA-256 XMD on the
    card, k_xmd); False sends the batch through host hash_to_field limbs
    (the ``_field`` variants), still on the mesh."""
    return all(len(m) == 32 for m in msgs)


# --- Counters ------------------------------------------------------------------

_STATS = {"dispatches": 0, "mesh_faults": 0,
          "degradations": {"mesh_to_single": 0, "single_to_cpu": 0},
          "last_shards": 0, "last_sets_per_shard": 0}


def note_mesh_dispatch(n_shards: int, sets_per_shard: int) -> None:
    _STATS["dispatches"] += 1
    _STATS["last_shards"] = n_shards
    _STATS["last_sets_per_shard"] = sets_per_shard


def note_degradation(hop: str) -> None:
    if hop == "mesh_to_single":
        _STATS["mesh_faults"] += 1
    _STATS["degradations"][hop] += 1


def mesh_stats() -> dict:
    return {**_STATS, "degradations": dict(_STATS["degradations"])}


def reset_mesh_stats() -> None:
    _STATS.update(dispatches=0, mesh_faults=0, last_shards=0,
                  last_sets_per_shard=0)
    _STATS["degradations"] = {"mesh_to_single": 0, "single_to_cpu": 0}


# --- The cross-shard tail ------------------------------------------------------


def _gather(mesh: Mesh, values) -> list:
    """values[i] (on shard i) -> all of them on the home shard."""
    home = mesh.home
    return [move(v, shard, home) for v, shard in zip(values, mesh.shards)]


def _flat_xy(shard: Shard, x, y) -> torch.Tensor:
    """x and y of an affine G2 point as one (48,) tensor, on the shard's
    stream (which wrote them)."""
    with on(shard):
        return torch.cat([x.reshape(-1), y.reshape(-1)])


def _cross_chip_pair(mesh: Mesh, lanes, sums, verdicts=(), ring=False):
    """The shared tail of every mesh step.  ``lanes[i]`` = (wx, wy, winf,
    hx, hy, hinf) of shard i, ``sums[i]`` = its affine G2 signature sum
    (sx, sy, sinf), ``verdicts[i]`` = the (1,) verdicts it adds (decode,
    subgroup).  The signature sums are combined (gathered and summed by
    k_ring_sum, or the ring's hops) and feed shard 0's closing lane; the
    other shards' Miller products run without it; the Fp12 partials are
    combined (gathered, or the ring) and k_pair_combine decides; the
    verdicts are ANDed in.  Returns the (1,) verdict on the home shard."""
    from . import ring as ring_mod

    home = mesh.home
    parts = [None] * mesh.size
    # The shards that do not close go first: nothing of theirs waits on
    # the cross-shard sum.
    for shard in mesh.shards[1:]:
        with on(shard):
            parts[shard.index] = staged.k_pair_partial(*lanes[shard.index])
    if ring:
        sx, sy, sinf = ring_mod.ring_sum_g2(mesh, sums)[0]
    else:
        got = _gather(mesh, [_flat_xy(shard, x, y)
                             for shard, (x, y, _) in zip(mesh.shards, sums)])
        infs = _gather(mesh, [i for _, _, i in sums])
        with on(home):
            xy = torch.stack(got).reshape(mesh.size, 2, 2, -1)
            sx, sy, sinf = staged.k_ring_sum(
                xy[:, 0].contiguous(), xy[:, 1].contiguous(),
                torch.cat(infs))
    with on(home):
        parts[0] = staged.k_pair_partial(*lanes[0], sx, sy, sinf,
                                         closing=True)
    if ring:
        f_all = ring_mod.ring_reduce_fp12(mesh, parts)[0][None]
    else:
        with on(home):
            f_all = torch.stack(_gather(mesh, parts))
    extra = [move(v, shard, home)
             for shard, vs in zip(mesh.shards, verdicts) for v in vs]
    with on(home):
        ok, _gt = staged.k_pair_combine(f_all)
        for v in extra:                    # the reference's pmin
            ok = staged.k_and(ok, v)
    return finish(mesh, ok)


def _firehose_shard_body(xp, yp, p_inf, xs, ys, s_inf, u_plain, rand):
    """One shard's hash to G2 and weighting ladders (reference :299) ->
    (lanes, the shard's affine signature sum).  The keys come
    pre-validated, so no subgroup check runs here: the plain step adds
    k_subgroup, the wire variant k_decode."""
    hx, hy, hinf = staged.k_hash(u_plain)
    wx, wy, winf, sx, sy, sinf = staged.k_points(xp, yp, p_inf, xs, ys,
                                                 s_inf, rand)
    return (wx, wy, winf, hx, hy, hinf), (sx, sy, sinf)


def _step(mesh: Mesh, ring: bool):
    def step(xp, yp, p_inf, xs, ys, s_inf, u_plain, rand):
        begin(mesh)
        lanes, sums, verdicts = [], [], []
        parts = shard_inputs(mesh, (xp, yp, p_inf, xs, ys, s_inf, u_plain,
                                    rand))
        for shard, (xp_, yp_, pi_, xs_, ys_, si_, u_, r_) in zip(
                mesh.shards, parts):
            with on(shard):
                ln, sm = _firehose_shard_body(xp_, yp_, pi_, xs_, ys_, si_,
                                              u_, r_)
                # infinity is in both subgroups; a lane with both points
                # at infinity is padding
                active = ~(pi_ & si_)
                _l, sub_ok = staged.k_subgroup(xp_, yp_, pi_, active, xs_,
                                               ys_, si_, active)
            lanes.append(ln)
            sums.append(sm)
            verdicts.append((sub_ok,))
        return _cross_chip_pair(mesh, lanes, sums, verdicts, ring=ring)

    return step


def sharded_verify_batch_fn(mesh: Mesh):
    """The mesh step with subgroup checks (reference :62): returns
    step(xp, yp, p_inf, xs, ys, s_inf, u_plain, rand) -> (1,) bool on the
    home shard, for the tensors of ``verify.verify_batch`` with a lane count
    that the shard count divides."""
    return _step(mesh, ring=False)


def firehose_fn(mesh: Mesh, wire: bool, device_xmd: bool = True):
    """The mesh-primary single-key program (reference :315).  Returns

        run(keys, <signature inputs>, msg_in, rand) -> (1,) bool

    ``keys`` are the shards' pubkey lanes gathered from the arena on their
    devices (``PackedPubkeyCache.pack_rows_device(pubkeys, mesh)``: one
    (x, y, inf) a shard).  The signature inputs are the wire planes
    (``wire``: x (m, 2, 12) canonical plain limbs, sign, inf (m,); k_decode
    on each shard, its verdict ANDed in) or affine signatures (xs, ys, s_inf).
    ``msg_in`` is (m, 8) root words (``device_xmd``: k_xmd on each shard) or
    host hash_to_field limbs (m, 2, 2, 12) (the ``_field`` variants)."""

    def run(keys, s0, s1, s2, msg_in, rand):
        begin(mesh)
        lanes, sums, verdicts = [], [], []
        parts = shard_inputs(mesh, (s0, s1, s2, msg_in, rand))
        for shard, (xp, yp, p_inf), (a, b, c, msg, r) in zip(
                mesh.shards, keys, parts):
            with on(shard):
                if wire:
                    xs, ys, s_inf, ok_dec = staged.k_decode(a, b, c)
                    verdicts.append((ok_dec,))
                else:
                    xs, ys, s_inf = a, b, c
                    verdicts.append(())
                u = staged.k_xmd(msg) if device_xmd else msg
                ln, sm = _firehose_shard_body(xp, yp, p_inf, xs, ys, s_inf,
                                              u, r)
            lanes.append(ln)
            sums.append(sm)
        return _cross_chip_pair(mesh, lanes, sums, verdicts)

    return run


def multi_fn(mesh: Mesh):
    """The mesh-primary multi-key (sync-aggregate) program (reference :387):

        run(keys, mask, xs, ys, s_inf, u_plain, rand) -> (1,) bool

    ``keys`` are the shards' (q, k) key planes gathered from the arena
    (q sets a shard), ``mask`` (m, k) the live keys; the keys are summed a
    set on the card (k_points' mask variant).  A set with no key or an
    infinity signature is padding: its weighted key and its hash lane are
    off (``winf | ~active``, the reference's ``h_mask``)."""

    def run(keys, mask, xs, ys, s_inf, u_plain, rand):
        begin(mesh)
        lanes, sums = [], []
        parts = shard_inputs(mesh, (mask, xs, ys, s_inf, u_plain, rand))
        for shard, (xpk, ypk, ipk), (mk, xs_, ys_, si_, u, r) in zip(
                mesh.shards, keys, parts):
            with on(shard):
                active = mk.any(dim=1) & ~si_
                hx, hy, hinf = staged.k_hash(u)
                wx, wy, winf, sx, sy, sinf = staged.k_points(
                    xpk, ypk, ipk, xs_, ys_, si_, r, mask=mk)
                hinf = hinf | ~active
            lanes.append((wx, wy, winf, hx, hy, hinf))
            sums.append((sx, sy, sinf))
        return _cross_chip_pair(mesh, lanes, sums)

    return run


# --- The ladder ----------------------------------------------------------------


def _single_step(mesh: Mesh):
    from ..crypto.bls.cuda.verify import verify_batch_kernel

    def single(*inputs):
        dev = mesh.home.device
        return verify_batch_kernel(*(t.to(dev) for t in inputs),
                                   check_subgroups=True)

    return single


def ladder(mesh: Mesh, sets_per_shard: int, dispatch, single):
    """Call ``dispatch()`` (the mesh step) now and return a
    ``VerifyFuture``.  A fault of the mesh step, at dispatch or at the
    readback, retries the batch with ``single()`` (one device); a fault
    there too raises ``BackendFault``.  A ``BlsError`` is a verdict: it
    passes through and is never counted as a degradation."""
    from ..crypto.bls.api import BackendFault, BlsError
    from ..crypto.bls.cuda.backend import VerifyFuture

    pending, mesh_exc = None, None
    try:
        pending = dispatch()
        note_mesh_dispatch(mesh.size, sets_per_shard)
    except BlsError:
        raise
    except Exception as e:                      # noqa: BLE001 - the ladder
        mesh_exc = e

    def fetch() -> bool:
        e_mesh = mesh_exc
        if e_mesh is None:
            try:
                return bool(pending.item())
            except BlsError:
                raise
            except Exception as e:              # noqa: BLE001
                e_mesh = e
        note_degradation("mesh_to_single")
        try:
            return bool(single().item())
        except BlsError:
            raise
        except Exception as e_single:           # noqa: BLE001
            note_degradation("single_to_cpu")
            raise BackendFault("mesh_step", e_single) from e_mesh

    return VerifyFuture(fetch)


def sharded_verify_with_fallback_async(mesh: Mesh, inputs, step=None,
                                       single_step=None):
    """The ladder over the mesh step (reference :482): the mesh step with
    subgroup checks, then on a fault the monolithic kernel
    ``verify_batch_kernel(check_subgroups=True)`` on the home shard's
    device.  ``inputs`` are the eight tensors of
    ``sharded_verify_batch_fn``; ``step`` / ``single_step`` replace the
    two (tests inject faults)."""
    step = step if step is not None else sharded_verify_batch_fn(mesh)
    single = single_step if single_step is not None else _single_step(mesh)
    return ladder(mesh, inputs[0].shape[0] // mesh.size,
                  lambda: step(*inputs), lambda: single(*inputs))


def sharded_verify_with_fallback(mesh: Mesh, inputs, step=None,
                                 single_step=None) -> bool:
    """The synchronous form of the ladder."""
    return sharded_verify_with_fallback_async(
        mesh, inputs, step=step, single_step=single_step).result()
