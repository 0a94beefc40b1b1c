"""Slot / Epoch / committee arithmetic helpers.

Equivalent of the reference's `Slot`/`Epoch` newtypes and free helpers
(Lighthouse's consensus/types/src/slot_epoch.rs) plus the misc helpers
from the spec (`compute_*`).  Slots/epochs are plain ints here.  A copy
of ``lighthouse_tpu/types/primitives.py`` on the port's ``ssz`` and
``types``.
"""
from __future__ import annotations

from ..ssz import Bytes32, Container, hash_bytes
from .containers import ForkData, SigningData
from .spec import EthSpec, FAR_FUTURE_EPOCH


def slot_to_epoch(slot: int, preset: EthSpec) -> int:
    return slot // preset.slots_per_epoch


compute_epoch_at_slot = slot_to_epoch


def epoch_start_slot(epoch: int, preset: EthSpec) -> int:
    return epoch * preset.slots_per_epoch


def compute_activation_exit_epoch(epoch: int, spec) -> int:
    return epoch + 1 + spec.max_seed_lookahead


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return ForkData.hash_tree_root(
        ForkData(
            current_version=current_version,
            genesis_validators_root=genesis_validators_root,
        )
    )


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: int,
    fork_version: bytes,
    genesis_validators_root: bytes,
) -> bytes:
    """32-byte domain = type tag (4B LE) + fork-data-root prefix (28B).
    Reference: chain_spec.rs compute_domain / signature_sets.rs domains."""
    tag = int(domain_type).to_bytes(4, "little")
    root = compute_fork_data_root(fork_version, genesis_validators_root)
    return tag + root[:28]


def compute_signing_root(ssz_type, obj, domain: bytes) -> bytes:
    """hash_tree_root(SigningData(object_root, domain)) — the message every
    consensus signature actually signs (signature_sets.rs)."""
    return SigningData.hash_tree_root(
        SigningData(
            object_root=ssz_type.hash_tree_root(obj),
            domain=domain,
        )
    )


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_eligible_for_activation_queue(v, spec) -> bool:
    return (
        v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and v.effective_balance == spec.max_effective_balance
    )


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and (
        v.activation_epoch <= epoch < v.withdrawable_epoch
    )


def is_slashable_attestation_data(d1, d2) -> bool:
    """Double vote or surround vote (spec; reference
    per_block_processing/is_valid_indexed_attestation + slasher)."""
    double = d1 != d2 and d1.target.epoch == d2.target.epoch
    surround = (
        d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    )
    return double or surround
