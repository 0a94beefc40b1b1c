"""Epoch processing — the per-epoch half of the pure STF.

Equivalent of Lighthouse's consensus/state_processing/src/
per_epoch_processing.rs:31 (process_epoch) with the base (phase0)
pending-attestation flavor and the altair+ participation-flag flavor
(altair/participation_cache.rs); plus registry updates, slashings,
effective-balance hysteresis, resets, and sync-committee rotation.

A copy of ``lighthouse_tpu/state_transition/per_epoch.py`` on the port's
types, helpers and BLS api.  Altair-family states go through the port's
epoch engine first (``epoch_engine/api.py``: the ``"cuda"`` backend by
default); the scalar loops are the spec path and the engine's routing
target.  ``get_base_reward_altair`` and ``get_base_reward_per_increment``
are copied from the reference's ``per_block.py``, which is not ported.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..types.primitives import (
    FAR_FUTURE_EPOCH,
    compute_activation_exit_epoch,
    epoch_start_slot,
    is_active_validator,
)
from ..types.spec import ChainSpec, EthSpec, GENESIS_EPOCH
from .helpers import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    current_epoch,
    decrease_balance,
    get_active_validator_indices,
    get_block_root,
    get_block_root_at_slot,
    get_randao_mix,
    get_seed,
    get_total_balance,
    get_validator_churn_limit,
    has_flag,
    increase_balance,
    initiate_validator_exit,
    integer_squareroot,
    previous_epoch,
    _slashing_quotients,
)
from .shuffle import compute_shuffled_index

BASE_REWARDS_PER_EPOCH = 4  # phase0 spec constant
HYSTERESIS_QUOTIENT = 4
HYSTERESIS_DOWNWARD_MULTIPLIER = 1
HYSTERESIS_UPWARD_MULTIPLIER = 5


def _h(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def get_base_reward_per_increment(state, preset, spec) -> int:
    from .helpers import get_total_active_balance

    return (
        spec.effective_balance_increment * spec.base_reward_factor
        // integer_squareroot(get_total_active_balance(state, preset, spec))
    )


def get_base_reward_altair(state, index: int, preset, spec,
                           per_increment: Optional[int] = None) -> int:
    """Pass `per_increment` (constant for a whole epoch) when calling in a
    loop — recomputing it scans the entire registry each time."""
    if per_increment is None:
        per_increment = get_base_reward_per_increment(state, preset, spec)
    increments = (
        state.validators[index].effective_balance
        // spec.effective_balance_increment
    )
    return increments * per_increment


def get_finality_delay(state, preset) -> int:
    return previous_epoch(state, preset) - state.finalized_checkpoint.epoch


def is_in_inactivity_leak(state, preset, spec) -> bool:
    return get_finality_delay(state, preset) > spec.min_epochs_to_inactivity_penalty


def get_eligible_validator_indices(state, preset) -> List[int]:
    prev = previous_epoch(state, preset)
    return [
        i for i, v in enumerate(state.validators)
        if is_active_validator(v, prev)
        or (v.slashed and prev + 1 < v.withdrawable_epoch)
    ]


class EpochSweeps:
    """The registry-sized index sets and balance sums the altair epoch
    stages share, computed in ONE pass over the validators.

    Before this cache, justification, inactivity updates, and the
    rewards loop each re-derived the eligible list and the per-flag
    unslashed-participating sets with separate O(n) sweeps (five
    registry scans per epoch at the old layout's :317/:399 loops);
    `process_epoch` now builds one `EpochSweeps` and threads it
    through.  Each consumer still accepts `sweeps=None` and rebuilds
    locally, so direct callers (tests, `compute_unrealized_checkpoints`)
    keep their signatures.

    All balances carry `get_total_balance`'s `max(increment, sum)`
    floor already applied."""

    __slots__ = (
        "eligible", "unslashed_participating", "total_active_balance",
        "prev_flag_balances", "current_target_balance",
    )

    def __init__(self, state, preset, spec):
        prev = previous_epoch(state, preset)
        cur = current_epoch(state, preset)
        prev_part = state.previous_epoch_participation
        cur_part = state.current_epoch_participation
        increment = spec.effective_balance_increment
        eligible: List[int] = []
        flag_sets: tuple = (set(), set(), set())
        flag_bals = [0, 0, 0]
        cur_target_bal = 0
        total = 0
        for i, v in enumerate(state.validators):
            active_prev = is_active_validator(v, prev)
            active_cur = is_active_validator(v, cur)
            eff = v.effective_balance
            if active_cur:
                total += eff
            if active_prev or (v.slashed and prev + 1 < v.withdrawable_epoch):
                eligible.append(i)
            if not v.slashed:
                if active_prev:
                    bits = prev_part[i]
                    for f in range(len(flag_sets)):
                        if has_flag(bits, f):
                            flag_sets[f].add(i)
                            flag_bals[f] += eff
                if active_cur and has_flag(
                    cur_part[i], TIMELY_TARGET_FLAG_INDEX
                ):
                    cur_target_bal += eff
        self.eligible = eligible
        self.unslashed_participating = flag_sets
        self.total_active_balance = max(increment, total)
        self.prev_flag_balances = [max(increment, b) for b in flag_bals]
        self.current_target_balance = max(increment, cur_target_bal)


# =============================================================================
# Phase0 (base) pending-attestation machinery
# =============================================================================


def get_matching_source_attestations(state, epoch, preset):
    if epoch == current_epoch(state, preset):
        return list(state.current_epoch_attestations)
    if epoch == previous_epoch(state, preset):
        return list(state.previous_epoch_attestations)
    raise ValueError("epoch out of range")


def get_matching_target_attestations(state, epoch, preset):
    root = get_block_root(state, epoch, preset)
    return [
        a for a in get_matching_source_attestations(state, epoch, preset)
        if a.data.target.root == root
    ]


def get_matching_head_attestations(state, epoch, preset):
    return [
        a for a in get_matching_target_attestations(state, epoch, preset)
        if a.data.beacon_block_root
        == get_block_root_at_slot(state, a.data.slot, preset)
    ]


def get_attesting_indices_from_cache(state, data, bits, cache):
    committee = cache.committee(data.slot, data.index)
    return {v for v, b in zip(committee, bits) if b}


def get_unslashed_attesting_indices(state, attestations, caches) -> Set[int]:
    out: Set[int] = set()
    for a in attestations:
        out |= get_attesting_indices_from_cache(
            state, a.data, a.aggregation_bits, caches
        )
    return {i for i in out if not state.validators[i].slashed}


def get_attesting_balance(state, attestations, caches, spec) -> int:
    return get_total_balance(
        state, get_unslashed_attesting_indices(state, attestations, caches),
        spec,
    )


def get_base_reward_phase0(state, index, total_balance, spec) -> int:
    return (
        state.validators[index].effective_balance
        * spec.base_reward_factor
        // integer_squareroot(total_balance)
        // BASE_REWARDS_PER_EPOCH
    )


# =============================================================================
# Justification & finalization (shared weighing; per-flavor inputs)
# =============================================================================


def weigh_justification_and_finalization(
    state, total_active, prev_target, cur_target, preset
) -> None:
    """Spec weigh_justification_and_finalization (reference
    per_epoch_processing/justification_and_finalization.rs)."""
    from ..types.containers import Checkpoint

    prev_epoch = previous_epoch(state, preset)
    cur_epoch = current_epoch(state, preset)
    old_prev = state.previous_justified_checkpoint
    old_cur = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = state.justification_bits
    bits.pop()  # shift: drop oldest
    bits.insert(0, False)
    if prev_target * 3 >= total_active * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=prev_epoch, root=get_block_root(state, prev_epoch, preset)
        )
        bits[1] = True
    if cur_target * 3 >= total_active * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=cur_epoch, root=get_block_root(state, cur_epoch, preset)
        )
        bits[0] = True
    state.justification_bits = bits

    # Finalization rules (2nd/3rd/4th most recent epochs).
    if all(bits[1:4]) and old_prev.epoch + 3 == cur_epoch:
        state.finalized_checkpoint = old_prev
    if all(bits[1:3]) and old_prev.epoch + 2 == cur_epoch:
        state.finalized_checkpoint = old_prev
    if all(bits[0:3]) and old_cur.epoch + 2 == cur_epoch:
        state.finalized_checkpoint = old_cur
    if all(bits[0:2]) and old_cur.epoch + 1 == cur_epoch:
        state.finalized_checkpoint = old_cur


def process_justification_and_finalization(state, preset, spec, caches=None,
                                           sweeps=None):
    if current_epoch(state, preset) <= GENESIS_EPOCH + 1:
        return
    if state.fork_name == "base":
        total = get_total_balance(
            state,
            get_active_validator_indices(
                state, current_epoch(state, preset)
            ),
            spec,
        )
        prev_target = get_attesting_balance(
            state,
            get_matching_target_attestations(
                state, previous_epoch(state, preset), preset
            ),
            caches,
            spec,
        )
        cur_target = get_attesting_balance(
            state,
            get_matching_target_attestations(
                state, current_epoch(state, preset), preset
            ),
            caches,
            spec,
        )
    else:
        if sweeps is None:
            sweeps = EpochSweeps(state, preset, spec)
        total = sweeps.total_active_balance
        prev_target = sweeps.prev_flag_balances[TIMELY_TARGET_FLAG_INDEX]
        cur_target = sweeps.current_target_balance
    weigh_justification_and_finalization(
        state, total, prev_target, cur_target, preset
    )


# =============================================================================
# Altair participation helpers
# =============================================================================


def get_unslashed_participating_indices(
    state, flag_index: int, epoch: int, preset
) -> Set[int]:
    if epoch == current_epoch(state, preset):
        participation = state.current_epoch_participation
    else:
        participation = state.previous_epoch_participation
    return {
        i for i, v in enumerate(state.validators)
        if is_active_validator(v, epoch)
        and has_flag(participation[i], flag_index)
        and not v.slashed
    }


def process_inactivity_updates(state, preset, spec, sweeps=None) -> None:
    if current_epoch(state, preset) == GENESIS_EPOCH:
        return
    if sweeps is not None:
        target_idx = sweeps.unslashed_participating[
            TIMELY_TARGET_FLAG_INDEX
        ]
        eligible = sweeps.eligible
    else:
        target_idx = get_unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX,
            previous_epoch(state, preset), preset,
        )
        eligible = get_eligible_validator_indices(state, preset)
    leak = is_in_inactivity_leak(state, preset, spec)
    for i in eligible:
        if i in target_idx:
            state.inactivity_scores[i] -= min(1, state.inactivity_scores[i])
        else:
            state.inactivity_scores[i] += spec.inactivity_score_bias
        if not leak:
            state.inactivity_scores[i] -= min(
                spec.inactivity_score_recovery_rate,
                state.inactivity_scores[i],
            )


def _inactivity_quotient(fork_name: str, spec) -> int:
    if fork_name == "altair":
        return spec.inactivity_penalty_quotient_altair
    return spec.inactivity_penalty_quotient_bellatrix


def process_rewards_and_penalties_altair(state, preset, spec,
                                         sweeps=None) -> None:
    if current_epoch(state, preset) == GENESIS_EPOCH:
        return
    if sweeps is None:
        sweeps = EpochSweeps(state, preset, spec)
    total = sweeps.total_active_balance
    per_increment = (
        spec.effective_balance_increment * spec.base_reward_factor
        // integer_squareroot(total)
    )
    total_increments = total // spec.effective_balance_increment
    eligible = sweeps.eligible
    leak = is_in_inactivity_leak(state, preset, spec)

    rewards = [0] * len(state.validators)
    penalties = [0] * len(state.validators)

    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = sweeps.unslashed_participating[flag_index]
        part_increments = (
            sweeps.prev_flag_balances[flag_index]
            // spec.effective_balance_increment
        )
        for i in eligible:
            base = get_base_reward_altair(state, i, preset, spec, per_increment)
            if i in participating:
                if not leak:
                    numer = base * weight * part_increments
                    rewards[i] += numer // (total_increments * WEIGHT_DENOMINATOR)
            elif flag_index != TIMELY_HEAD_FLAG_INDEX:
                penalties[i] += base * weight // WEIGHT_DENOMINATOR

    # Inactivity penalties (always applied, scaled by score).
    target_idx = sweeps.unslashed_participating[TIMELY_TARGET_FLAG_INDEX]
    quot = _inactivity_quotient(state.fork_name, spec)
    for i in eligible:
        if i not in target_idx:
            penalty = (
                state.validators[i].effective_balance
                * state.inactivity_scores[i]
                // (spec.inactivity_score_bias * quot)
            )
            penalties[i] += penalty

    for i in range(len(state.validators)):
        increase_balance(state, i, rewards[i])
        decrease_balance(state, i, penalties[i])


# =============================================================================
# Phase0 rewards & penalties
# =============================================================================


def process_rewards_and_penalties_base(state, preset, spec, caches) -> None:
    if current_epoch(state, preset) == GENESIS_EPOCH:
        return
    prev = previous_epoch(state, preset)
    total = get_total_balance(
        state,
        get_active_validator_indices(state, current_epoch(state, preset)),
        spec,
    )
    eligible = get_eligible_validator_indices(state, preset)
    leak = is_in_inactivity_leak(state, preset, spec)
    increment = spec.effective_balance_increment

    rewards = [0] * len(state.validators)
    penalties = [0] * len(state.validators)

    src_atts = get_matching_source_attestations(state, prev, preset)
    tgt_atts = get_matching_target_attestations(state, prev, preset)
    head_atts = get_matching_head_attestations(state, prev, preset)

    def component(attestations):
        unslashed = get_unslashed_attesting_indices(
            state, attestations, caches
        )
        att_bal = get_total_balance(state, unslashed, spec)
        for i in eligible:
            base = get_base_reward_phase0(state, i, total, spec)
            if i in unslashed:
                if leak:
                    rewards[i] += base
                else:
                    rewards[i] += (
                        base * (att_bal // increment) // (total // increment)
                    )
            else:
                penalties[i] += base
        return unslashed

    component(src_atts)
    tgt_unslashed = component(tgt_atts)
    component(head_atts)

    # Inclusion delay rewards (earliest inclusion per attester).
    earliest: Dict[int, object] = {}
    for a in src_atts:
        for i in get_attesting_indices_from_cache(
            state, a.data, a.aggregation_bits, caches
        ):
            if state.validators[i].slashed:
                continue
            if i not in earliest or a.inclusion_delay < earliest[i].inclusion_delay:
                earliest[i] = a
    for i, a in earliest.items():
        base = get_base_reward_phase0(state, i, total, spec)
        proposer_reward = base // spec.proposer_reward_quotient
        rewards[a.proposer_index] += proposer_reward
        max_attester = base - proposer_reward
        rewards[i] += max_attester // a.inclusion_delay

    # Inactivity leak penalties.
    if leak:
        for i in eligible:
            base = get_base_reward_phase0(state, i, total, spec)
            proposer_reward = base // spec.proposer_reward_quotient
            penalties[i] += BASE_REWARDS_PER_EPOCH * base - proposer_reward
            if i not in tgt_unslashed:
                penalties[i] += (
                    state.validators[i].effective_balance
                    * get_finality_delay(state, preset)
                    // spec.inactivity_penalty_quotient
                )

    for i in range(len(state.validators)):
        increase_balance(state, i, rewards[i])
        decrease_balance(state, i, penalties[i])


# =============================================================================
# Registry / slashings / resets (all forks)
# =============================================================================


def process_registry_updates(state, preset, spec) -> None:
    epoch = current_epoch(state, preset)
    for i, v in enumerate(state.validators):
        if (
            v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
            and v.effective_balance == spec.max_effective_balance
        ):
            v.activation_eligibility_epoch = epoch + 1
        if is_active_validator(v, epoch) and (
            v.effective_balance <= spec.ejection_balance
        ):
            initiate_validator_exit(state, i, preset, spec)

    queue = sorted(
        (
            i for i, v in enumerate(state.validators)
            if v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
            and v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (
            state.validators[i].activation_eligibility_epoch, i
        ),
    )
    for i in queue[: get_validator_churn_limit(state, preset, spec)]:
        state.validators[i].activation_epoch = (
            compute_activation_exit_epoch(epoch, spec)
        )


def process_slashings(state, preset, spec) -> None:
    epoch = current_epoch(state, preset)
    total = get_total_balance(
        state, get_active_validator_indices(state, epoch), spec
    )
    _, mult, _ = _slashing_quotients(state.fork_name, spec)
    adjusted = min(sum(state.slashings) * mult, total)
    increment = spec.effective_balance_increment
    for i, v in enumerate(state.validators):
        if (
            v.slashed
            and epoch + preset.epochs_per_slashings_vector // 2
            == v.withdrawable_epoch
        ):
            penalty_numerator = v.effective_balance // increment * adjusted
            penalty = penalty_numerator // total * increment
            decrease_balance(state, i, penalty)


def process_eth1_data_reset(state, preset) -> None:
    next_epoch = current_epoch(state, preset) + 1
    if next_epoch % preset.epochs_per_eth1_voting_period == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(state, spec) -> None:
    increment = spec.effective_balance_increment
    hysteresis_increment = increment // HYSTERESIS_QUOTIENT
    down = hysteresis_increment * HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis_increment * HYSTERESIS_UPWARD_MULTIPLIER
    for i, v in enumerate(state.validators):
        balance = state.balances[i]
        if (
            balance + down < v.effective_balance
            or v.effective_balance + up < balance
        ):
            v.effective_balance = min(
                balance - balance % increment, spec.max_effective_balance
            )


def process_slashings_reset(state, preset) -> None:
    next_epoch = current_epoch(state, preset) + 1
    state.slashings[next_epoch % preset.epochs_per_slashings_vector] = 0


def process_randao_mixes_reset(state, preset) -> None:
    epoch = current_epoch(state, preset)
    next_epoch = epoch + 1
    state.randao_mixes[
        next_epoch % preset.epochs_per_historical_vector
    ] = get_randao_mix(state, epoch, preset)


def process_historical_roots_update(state, types, preset) -> None:
    """Phase0..merge: append HistoricalBatch root; capella+: append
    HistoricalSummary (process_historical_summaries_update)."""
    next_epoch = current_epoch(state, preset) + 1
    if next_epoch % (
        preset.slots_per_historical_root // preset.slots_per_epoch
    ) != 0:
        return
    if hasattr(state, "historical_summaries"):
        from ..types.containers import HistoricalSummary
        from ..ssz import Bytes32, Vector

        roots_t = Vector[Bytes32, preset.slots_per_historical_root]
        state.historical_summaries.append(HistoricalSummary(
            block_summary_root=roots_t.hash_tree_root(state.block_roots),
            state_summary_root=roots_t.hash_tree_root(state.state_roots),
        ))
    else:
        batch = types.HistoricalBatch(
            block_roots=state.block_roots, state_roots=state.state_roots
        )
        state.historical_roots.append(
            types.HistoricalBatch.hash_tree_root(batch)
        )


def process_participation_record_updates(state) -> None:
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []


def process_participation_flag_updates(state) -> None:
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = [0] * len(state.validators)


# =============================================================================
# Sync committees (altair+)
# =============================================================================

MAX_EFFECTIVE_BALANCE_SHIFT = None  # placeholder for electra-era changes


def get_next_sync_committee_indices(state, preset, spec) -> List[int]:
    epoch = current_epoch(state, preset) + 1
    active = get_active_validator_indices(state, epoch)
    seed = get_seed(state, epoch, spec.domain_sync_committee, preset, spec)
    indices: List[int] = []
    i = 0
    n = len(active)
    while len(indices) < preset.sync_committee_size:
        shuffled = compute_shuffled_index(
            i % n, n, seed, spec.shuffle_round_count
        )
        candidate = active[shuffled]
        random_byte = _h(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * 255 >= spec.max_effective_balance * random_byte:
            indices.append(candidate)
        i += 1
    return indices


def get_next_sync_committee(state, types, preset, spec, indices=None):
    """`indices=None` runs the scalar rejection sampler; the epoch
    engine passes its batched-shuffle result (bit-identical by the
    differential suite) and shares the aggregation below."""
    from ..crypto.bls.api import AggregatePublicKey, PublicKey

    if indices is None:
        indices = get_next_sync_committee_indices(state, preset, spec)
    pubkeys = [state.validators[i].pubkey for i in indices]
    agg = AggregatePublicKey.aggregate(
        [PublicKey.from_bytes(pk) for pk in pubkeys]
    )
    from ..crypto.bls import curve_ref as cv

    return types.SyncCommittee(
        pubkeys=pubkeys,
        aggregate_pubkey=cv.g1_compress(agg.point),
    )


def process_sync_committee_updates(state, types, preset, spec) -> None:
    next_epoch = current_epoch(state, preset) + 1
    if next_epoch % preset.epochs_per_sync_committee_period == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(
            state, types, preset, spec
        )


# =============================================================================
# Top level
# =============================================================================


def process_epoch(state, types, preset: EthSpec, spec: ChainSpec) -> None:
    """Reference per_epoch_processing.rs:31 — dispatches base vs
    altair-family processing.  Altair-family states route through the
    epoch engine first (`epoch_engine.try_process_epoch`, the "cuda"
    backend unless configured otherwise); the scalar loops below are the
    spec path, where the engine routes what it does not take, and the
    differential oracle."""
    # Epoch processing mutates validator fields directly below; drop
    # any engine-installed root plane before touching them.
    inval = getattr(state.validators, "_invalidate", None)
    if inval is not None:
        inval()
    if state.fork_name == "base":
        from .helpers import CommitteeCache

        cur = CommitteeCache(
            state, current_epoch(state, preset), preset, spec
        )
        prev = CommitteeCache(
            state, previous_epoch(state, preset), preset, spec
        )

        class _Caches:
            def committee(self, slot, index):
                ep = slot // preset.slots_per_epoch
                return (cur if ep == cur.epoch else prev).committee(
                    slot, index
                )

        caches = _Caches()
        process_justification_and_finalization(state, preset, spec, caches)
        process_rewards_and_penalties_base(state, preset, spec, caches)
        process_registry_updates(state, preset, spec)
        process_slashings(state, preset, spec)
        process_eth1_data_reset(state, preset)
        process_effective_balance_updates(state, spec)
        process_slashings_reset(state, preset)
        process_randao_mixes_reset(state, preset)
        process_historical_roots_update(state, types, preset)
        process_participation_record_updates(state)
    else:
        from .epoch_engine import api as epoch_api

        if epoch_api.try_process_epoch(state, types, preset, spec):
            return
        t0 = time.perf_counter()
        sweeps = (
            EpochSweeps(state, preset, spec)
            if current_epoch(state, preset) != GENESIS_EPOCH else None
        )
        process_justification_and_finalization(
            state, preset, spec, sweeps=sweeps
        )
        process_inactivity_updates(state, preset, spec, sweeps=sweeps)
        process_rewards_and_penalties_altair(
            state, preset, spec, sweeps=sweeps
        )
        process_registry_updates(state, preset, spec)
        process_slashings(state, preset, spec)
        process_eth1_data_reset(state, preset)
        process_effective_balance_updates(state, spec)
        process_slashings_reset(state, preset)
        process_randao_mixes_reset(state, preset)
        process_historical_roots_update(state, types, preset)
        process_participation_flag_updates(state)
        process_sync_committee_updates(state, types, preset, spec)
        epoch_api.observe_scalar(time.perf_counter() - t0)


def compute_unrealized_checkpoints(state, preset, spec):
    """Unrealized justification/finalization: what the checkpoints WOULD
    become if epoch processing ran now on this (possibly mid-epoch)
    state (spec compute_pulled_up_tip; reference fork_choice.rs:653-800
    via state_processing's per_epoch_processing justification stage).

    Runs `process_justification_and_finalization` in place with a
    snapshot/restore of the only four fields it mutates — no full state
    copy on the block-import hot path.

    Returns ((justified_epoch, justified_root),
             (finalized_epoch, finalized_root))."""
    cur = current_epoch(state, preset)
    if state.slot == cur * preset.slots_per_epoch:
        # First slot of an epoch: epoch processing ran during the slot
        # advance, so there is nothing further to pull up (and the
        # current epoch's start block root is not in history yet).
        return (
            (int(state.current_justified_checkpoint.epoch),
             bytes(state.current_justified_checkpoint.root)),
            (int(state.finalized_checkpoint.epoch),
             bytes(state.finalized_checkpoint.root)),
        )
    snap = (
        state.previous_justified_checkpoint,
        state.current_justified_checkpoint,
        state.finalized_checkpoint,
        # weigh_justification mutates the bits list IN PLACE — the
        # snapshot must be a copy, not an alias.
        type(state.justification_bits)(state.justification_bits),
    )
    try:
        for_base = state.fork_name == "base"
        caches = None
        if for_base:
            from .helpers import CommitteeCache

            cur = CommitteeCache(
                state, current_epoch(state, preset), preset, spec
            )
            prev = CommitteeCache(
                state, previous_epoch(state, preset), preset, spec
            )

            class _Caches:
                def committee(self, slot, index):
                    ep = slot // preset.slots_per_epoch
                    return (cur if ep == cur.epoch else prev).committee(
                        slot, index
                    )

            caches = _Caches()
        process_justification_and_finalization(state, preset, spec, caches)
        ujc = (
            int(state.current_justified_checkpoint.epoch),
            bytes(state.current_justified_checkpoint.root),
        )
        ufc = (
            int(state.finalized_checkpoint.epoch),
            bytes(state.finalized_checkpoint.root),
        )
        return ujc, ufc
    finally:
        (state.previous_justified_checkpoint,
         state.current_justified_checkpoint,
         state.finalized_checkpoint,
         state.justification_bits) = snap
