"""BeaconState accessors and mutators (spec helpers).

Equivalent of the accessor layer the reference spreads across
`consensus/types/src/beacon_state.rs` (get_* methods) and
`consensus/state_processing/src/common/` (increase/decrease balance,
slash_validator, ...).  All functions are pure Python over the SSZ
containers; committee work is vectorized through ..shuffle.  A copy of
``lighthouse_tpu/state_transition/helpers.py`` on the port's types, with
the root-plane hooks (``_invalidate``) of the validator mutators kept.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

from ..types.spec import ChainSpec, EthSpec, FAR_FUTURE_EPOCH
from ..types.primitives import (
    compute_activation_exit_epoch,
    compute_domain,
    epoch_start_slot,
    is_active_validator,
    slot_to_epoch,
)
from .shuffle import compute_shuffled_index, shuffle_indices


def _h(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def current_epoch(state, preset: EthSpec) -> int:
    return slot_to_epoch(state.slot, preset)


def previous_epoch(state, preset: EthSpec) -> int:
    cur = current_epoch(state, preset)
    return cur - 1 if cur > 0 else 0


def get_active_validator_indices(state, epoch: int) -> List[int]:
    return [
        i for i, v in enumerate(state.validators)
        if is_active_validator(v, epoch)
    ]


def get_randao_mix(state, epoch: int, preset: EthSpec) -> bytes:
    return state.randao_mixes[epoch % preset.epochs_per_historical_vector]


def get_block_root_at_slot(state, slot: int, preset: EthSpec) -> bytes:
    assert slot < state.slot <= slot + preset.slots_per_historical_root
    return state.block_roots[slot % preset.slots_per_historical_root]


def get_block_root(state, epoch: int, preset: EthSpec) -> bytes:
    return get_block_root_at_slot(state, epoch_start_slot(epoch, preset), preset)


def get_seed(state, epoch: int, domain_type: int, preset: EthSpec,
             spec: ChainSpec) -> bytes:
    mix = get_randao_mix(
        state,
        epoch + preset.epochs_per_historical_vector
        - spec.min_seed_lookahead - 1,
        preset,
    )
    return _h(
        int(domain_type).to_bytes(4, "little")
        + int(epoch).to_bytes(8, "little")
        + mix
    )


def get_validator_churn_limit(state, preset: EthSpec, spec: ChainSpec) -> int:
    active = len(get_active_validator_indices(state, current_epoch(state, preset)))
    return max(spec.min_per_epoch_churn_limit, active // spec.churn_limit_quotient)


def get_total_balance(state, indices, spec: ChainSpec) -> int:
    return max(
        spec.effective_balance_increment,
        sum(state.validators[i].effective_balance for i in indices),
    )


def get_total_active_balance(state, preset: EthSpec, spec: ChainSpec) -> int:
    return get_total_balance(
        state,
        get_active_validator_indices(state, current_epoch(state, preset)),
        spec,
    )


def get_domain(state, domain_type: int, epoch: int | None, preset: EthSpec,
               spec: ChainSpec) -> bytes:
    if epoch is None:
        epoch = current_epoch(state, preset)
    fork_version = (
        state.fork.previous_version
        if epoch < state.fork.epoch
        else state.fork.current_version
    )
    return compute_domain(domain_type, fork_version, state.genesis_validators_root)


def increase_balance(state, index: int, delta: int) -> None:
    state.balances[index] += delta


def decrease_balance(state, index: int, delta: int) -> None:
    state.balances[index] = max(0, state.balances[index] - delta)


# --- Committees (reference beacon_state/committee_cache.rs) -----------------


class CommitteeCache:
    """Per-epoch committee assignment: the shuffled active set chunked into
    slots_per_epoch * committees_per_slot committees.

    Built once per (state, epoch) and reused — mirrors
    consensus/types/src/beacon_state/committee_cache.rs, with the shuffle
    vectorized (one permutation array instead of per-index calls)."""

    def __init__(self, state, epoch: int, preset: EthSpec, spec: ChainSpec):
        self.epoch = epoch
        self.preset = preset
        self.active = get_active_validator_indices(state, epoch)
        n = len(self.active)
        self.committees_per_slot = max(
            1,
            min(
                preset.max_committees_per_slot,
                n // preset.slots_per_epoch // preset.target_committee_size,
            ),
        )
        seed = get_seed(state, epoch, spec.domain_beacon_attester, preset, spec)
        perm = shuffle_indices(n, seed, spec.shuffle_round_count)
        self.shuffled = [self.active[int(p)] for p in perm]
        # position lookup: validator index -> (slot, committee idx, pos)
        self._position = {}
        count = self.committees_per_slot * preset.slots_per_epoch
        self._bounds = [
            (n * i // count, n * (i + 1) // count) for i in range(count)
        ]
        for ci, (s, e) in enumerate(self._bounds):
            slot = epoch_start_slot(epoch, preset) + ci // self.committees_per_slot
            idx = ci % self.committees_per_slot
            for pos, v in enumerate(self.shuffled[s:e]):
                self._position[v] = (slot, idx, pos)

    def committee(self, slot: int, index: int) -> Sequence[int]:
        ci = (
            (slot % self.preset.slots_per_epoch) * self.committees_per_slot
            + index
        )
        s, e = self._bounds[ci]
        return self.shuffled[s:e]

    def committees_at_slot(self, slot: int):
        return [
            self.committee(slot, i) for i in range(self.committees_per_slot)
        ]

    def attester_position(self, validator_index: int):
        return self._position.get(validator_index)


def get_beacon_committee(state, slot: int, index: int, preset: EthSpec,
                         spec: ChainSpec) -> Sequence[int]:
    epoch = slot_to_epoch(slot, preset)
    return CommitteeCache(state, epoch, preset, spec).committee(slot, index)


def get_committee_count_per_slot(state, epoch: int, preset: EthSpec) -> int:
    n = len(get_active_validator_indices(state, epoch))
    return max(
        1,
        min(
            preset.max_committees_per_slot,
            n // preset.slots_per_epoch // preset.target_committee_size,
        ),
    )


def compute_proposer_index(state, indices, seed: bytes, spec: ChainSpec) -> int:
    assert indices
    total = len(indices)
    i = 0
    while True:
        cand = indices[compute_shuffled_index(
            i % total, total, seed, spec.shuffle_round_count
        )]
        random_byte = _h(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[cand].effective_balance
        if eb * 255 >= spec.max_effective_balance * random_byte:
            return cand
        i += 1


def get_beacon_proposer_index(state, preset: EthSpec, spec: ChainSpec,
                              slot: int | None = None) -> int:
    if slot is None:
        slot = state.slot
    epoch = slot_to_epoch(slot, preset)
    seed = _h(
        get_seed(state, epoch, spec.domain_beacon_proposer, preset, spec)
        + int(slot).to_bytes(8, "little")
    )
    return compute_proposer_index(
        state, get_active_validator_indices(state, epoch), seed, spec
    )


# --- Validator lifecycle mutators -------------------------------------------


def initiate_validator_exit(state, index: int, preset: EthSpec,
                            spec: ChainSpec) -> None:
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    # Mutates validator fields: drop any engine-installed root plane.
    inval = getattr(state.validators, "_invalidate", None)
    if inval is not None:
        inval()
    exit_epochs = [
        w.exit_epoch for w in state.validators
        if w.exit_epoch != FAR_FUTURE_EPOCH
    ]
    exit_queue_epoch = max(
        exit_epochs
        + [compute_activation_exit_epoch(current_epoch(state, preset), spec)]
    )
    churn = len([
        w for w in state.validators if w.exit_epoch == exit_queue_epoch
    ])
    if churn >= get_validator_churn_limit(state, preset, spec):
        exit_queue_epoch += 1
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = (
        exit_queue_epoch + spec.min_validator_withdrawability_delay
    )


def _slashing_quotients(fork_name: str, spec: ChainSpec):
    if fork_name == "base":
        return (
            spec.min_slashing_penalty_quotient,
            spec.proportional_slashing_multiplier,
            spec.whistleblower_reward_quotient,
        )
    if fork_name == "altair":
        return (
            spec.min_slashing_penalty_quotient_altair,
            spec.proportional_slashing_multiplier_altair,
            spec.whistleblower_reward_quotient,
        )
    return (
        spec.min_slashing_penalty_quotient_bellatrix,
        spec.proportional_slashing_multiplier_bellatrix,
        spec.whistleblower_reward_quotient,
    )


def slash_validator(state, index: int, preset: EthSpec, spec: ChainSpec,
                    whistleblower: int | None = None) -> None:
    """Spec slash_validator (reference common/slash_validator.rs)."""
    epoch = current_epoch(state, preset)
    initiate_validator_exit(state, index, preset, spec)
    inval = getattr(state.validators, "_invalidate", None)
    if inval is not None:
        inval()
    v = state.validators[index]
    v.slashed = True
    v.withdrawable_epoch = max(
        v.withdrawable_epoch, epoch + preset.epochs_per_slashings_vector
    )
    state.slashings[epoch % preset.epochs_per_slashings_vector] += (
        v.effective_balance
    )
    quot, _, whistle_q = _slashing_quotients(state.fork_name, spec)
    decrease_balance(state, index, v.effective_balance // quot)

    proposer = get_beacon_proposer_index(state, preset, spec)
    if whistleblower is None:
        whistleblower = proposer
    whistle_reward = v.effective_balance // whistle_q
    if state.fork_name == "base":
        proposer_reward = whistle_reward // spec.proposer_reward_quotient
    else:
        # Altair+: proposer gets PROPOSER_WEIGHT/WEIGHT_DENOMINATOR share.
        proposer_reward = whistle_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    increase_balance(state, proposer, proposer_reward)
    increase_balance(state, whistleblower, whistle_reward - proposer_reward)


# --- Altair participation constants -----------------------------------------

TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64

PARTICIPATION_FLAG_WEIGHTS = (
    TIMELY_SOURCE_WEIGHT,
    TIMELY_TARGET_WEIGHT,
    TIMELY_HEAD_WEIGHT,
)


def has_flag(flags: int, index: int) -> bool:
    return bool((flags >> index) & 1)


def add_flag(flags: int, index: int) -> int:
    return flags | (1 << index)


def integer_squareroot(n: int) -> int:
    import math

    return math.isqrt(n)
