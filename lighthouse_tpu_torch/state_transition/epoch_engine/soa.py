"""Struct-of-arrays registry snapshot and the contiguous leaf-buffer
handoff that feeds re-rooting after an engine-processed epoch.

Two halves:

  * `RegistrySoA` — the validator registry flattened into parallel
    numpy arrays (effective_balance, balance, slashed, the four
    lifecycle epochs, participation flags, inactivity scores).  One
    pass over the Python objects per epoch; every kernel and host
    sweep after that is a vector op.
  * `RegistryList` / `validator_root_plane` — after the engine writes
    a processed epoch back, `state.validators` is wrapped in a list
    subclass that carries a device-computed plane of per-validator
    hash_tree_roots.  `ssz.List._leaves` consumes it directly, so
    re-rooting a 2^20-entry registry skips the per-element encode +
    memo walk and goes straight into the incremental layer cache.
    Any mutation (list ops here, field writes via the hooks in
    `helpers` / `per_epoch`) drops the plane and the ordinary SSZ path
    takes over.

A copy of ``lighthouse_tpu/state_transition/epoch_engine/soa.py`` on the
port's hash engine: the plane's four pair-hash levels go through
``crypto/sha256/api.hash_pairs``, so wide ones run on ``k_pairs``.
``RegistrySoA.from_arrays`` builds a snapshot from planes made elsewhere
(the JAX package's snapshot in the tests).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

U64 = np.uint64

#: Validators per hash-engine batch when building the root plane —
#: bounds peak plane memory to ~32 MiB (chunk * 8 leaves * 32 bytes).
ROOT_PLANE_CHUNK = 1 << 17


class RegistrySoA:
    """One-pass struct-of-arrays snapshot of the registry + the epoch
    vectors that ride with it (balances, participation, inactivity
    scores)."""

    #: The planes and their dtypes.
    PLANES = {
        "effective_balance": U64, "balance": U64, "slashed": bool,
        "activation_eligibility_epoch": U64, "activation_epoch": U64,
        "exit_epoch": U64, "withdrawable_epoch": U64,
        "previous_flags": np.uint8, "current_flags": np.uint8,
        "inactivity_scores": U64,
    }
    __slots__ = ("n", *PLANES)

    @classmethod
    def from_arrays(cls, **planes) -> "RegistrySoA":
        """A snapshot from its ten planes, given by name (for example
        another snapshot's), each copied into its dtype."""
        if set(planes) != set(cls.PLANES):
            raise ValueError(f"planes {sorted(planes)}, expected "
                             f"{sorted(cls.PLANES)}")
        soa = cls()
        for name, dtype in cls.PLANES.items():
            setattr(soa, name, np.array(planes[name], dtype=dtype))
        soa.n = len(soa.balance)
        if any(len(getattr(soa, name)) != soa.n for name in cls.PLANES):
            raise ValueError("planes of different lengths")
        return soa

    @classmethod
    def snapshot(cls, state) -> "RegistrySoA":
        soa = cls()
        vals = state.validators
        n = soa.n = len(vals)
        soa.effective_balance = np.asarray(
            [v.effective_balance for v in vals], U64
        )
        soa.slashed = np.asarray([bool(v.slashed) for v in vals], bool)
        soa.activation_eligibility_epoch = np.asarray(
            [v.activation_eligibility_epoch for v in vals], U64
        )
        soa.activation_epoch = np.asarray(
            [v.activation_epoch for v in vals], U64
        )
        soa.exit_epoch = np.asarray([v.exit_epoch for v in vals], U64)
        soa.withdrawable_epoch = np.asarray(
            [v.withdrawable_epoch for v in vals], U64
        )
        # Plain int lists post-coercion: numpy's C fast path applies.
        soa.balance = np.asarray(state.balances, U64)
        soa.previous_flags = np.asarray(
            state.previous_epoch_participation, np.uint8
        )
        soa.current_flags = np.asarray(
            state.current_epoch_participation, np.uint8
        )
        soa.inactivity_scores = np.asarray(state.inactivity_scores, U64)
        assert len(soa.balance) == n and len(soa.inactivity_scores) == n
        assert len(soa.previous_flags) == n and len(soa.current_flags) == n
        return soa

    def active_mask(self, epoch: int) -> np.ndarray:
        e = U64(epoch)
        return (self.activation_epoch <= e) & (e < self.exit_epoch)


class RegistryList(list):
    """`state.validators` after an engine-processed epoch: a plain
    list of Validator objects plus a lazily-built plane of their
    device-computed hash_tree_roots.  The plane survives repeated
    re-roots and dies on ANY mutation — list ops are overridden here;
    field writes go through `_invalidate()` hooks at the block/epoch
    entry points."""

    __slots__ = ("_root_thunk", "_roots")

    def __init__(self, *a):
        super().__init__(*a)
        self._root_thunk = None
        self._roots = None

    def _set_root_source(self, thunk) -> None:
        self._root_thunk = thunk
        self._roots = None

    def _invalidate(self) -> None:
        self._root_thunk = None
        self._roots = None

    def _leaf_roots(self) -> Optional[List[bytes]]:
        """The per-element root list `ssz.List._leaves` consumes, or
        None once invalidated.  Built at most once per thunk — the
        plane build itself rides the hash engine."""
        if self._roots is None and self._root_thunk is not None:
            thunk, self._root_thunk = self._root_thunk, None
            self._roots = thunk()
        return self._roots

    def _mutating(name):
        base = getattr(list, name)

        def op(self, *a, **kw):
            self._invalidate()
            return base(self, *a, **kw)

        op.__name__ = name
        return op

    append = _mutating("append")
    extend = _mutating("extend")
    insert = _mutating("insert")
    remove = _mutating("remove")
    pop = _mutating("pop")
    clear = _mutating("clear")
    sort = _mutating("sort")
    reverse = _mutating("reverse")
    __setitem__ = _mutating("__setitem__")
    __delitem__ = _mutating("__delitem__")
    __iadd__ = _mutating("__iadd__")
    __imul__ = _mutating("__imul__")
    del _mutating


def _u64_leaf_plane(plane: np.ndarray, slot: int, arr: np.ndarray) -> None:
    plane[:, slot, :8] = (
        np.ascontiguousarray(arr.astype("<u8")).view(np.uint8)
        .reshape(len(arr), 8)
    )


def validator_root_plane(validators, soa: RegistrySoA) -> List[bytes]:
    """Per-validator hash_tree_roots as a list of 32-byte entries,
    computed in wide hash-engine batches: each validator's 8 field
    leaves (pubkey root via one pair hash, five uint64 planes, the
    bool, the raw credentials chunk) reduce through three pair-hash
    levels (4n -> 2n -> n).  `soa` supplies the POST-epoch numeric
    fields; pubkey/withdrawal_credentials come from the objects (epoch
    processing never touches them)."""
    from ...crypto.sha256 import api as hash_api

    n = len(validators)
    out: List[bytes] = []
    for lo in range(0, n, ROOT_PLANE_CHUNK):
        hi = min(lo + ROOT_PLANE_CHUNK, n)
        m = hi - lo
        plane = np.zeros((m, 8, 32), np.uint8)
        # Leaf 0: Bytes48 root = H(pubkey || 16 zero bytes).
        blocks = np.zeros((m, 64), np.uint8)
        pk = b"".join(bytes(validators[i].pubkey) for i in range(lo, hi))
        blocks[:, :48] = np.frombuffer(pk, np.uint8).reshape(m, 48)
        leaf0 = hash_api.hash_pairs(blocks.tobytes())
        plane[:, 0, :] = np.frombuffer(leaf0, np.uint8).reshape(m, 32)
        # Leaf 1: raw 32-byte withdrawal credentials.
        wc = b"".join(
            bytes(validators[i].withdrawal_credentials)
            for i in range(lo, hi)
        )
        plane[:, 1, :] = np.frombuffer(wc, np.uint8).reshape(m, 32)
        _u64_leaf_plane(plane, 2, soa.effective_balance[lo:hi])
        plane[:, 3, 0] = soa.slashed[lo:hi].astype(np.uint8)
        _u64_leaf_plane(plane, 4, soa.activation_eligibility_epoch[lo:hi])
        _u64_leaf_plane(plane, 5, soa.activation_epoch[lo:hi])
        _u64_leaf_plane(plane, 6, soa.exit_epoch[lo:hi])
        _u64_leaf_plane(plane, 7, soa.withdrawable_epoch[lo:hi])
        level = plane.reshape(-1).tobytes()          # 4m pairs
        level = hash_api.hash_pairs(level)           # 2m pairs
        level = hash_api.hash_pairs(level)           # m pairs
        level = hash_api.hash_pairs(level)           # m roots
        out.extend(level[i:i + 32] for i in range(0, 32 * m, 32))
    return out


def install_root_plane(state, soa: RegistrySoA) -> None:
    """Wrap `state.validators` in a `RegistryList` whose root plane is
    built (lazily, through the hash engine) from the post-epoch SoA
    arrays.  `Container.copy()` rebuilds plain lists, so the wrapper
    never leaks into copies."""
    wrapped = RegistryList(state.validators)
    wrapped._set_root_source(
        lambda: validator_root_plane(wrapped, soa)
    )
    state.validators = wrapped
