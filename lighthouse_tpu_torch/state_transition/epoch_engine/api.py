"""Epoch-engine facade of the PyTorch/CUDA port: backend choice, the size
threshold, the device, and the device-processed epoch itself.

Counterpart of ``lighthouse_tpu/state_transition/epoch_engine/api.py``,
with the same calls:

  * ``configure(backend=..., threshold=..., device=...)``: backend
    ``"cuda"`` (the default: the kernels of ``cuda/kernel.py``) or
    ``"python"`` (the scalar loops of ``per_epoch``).  Registries under
    ``threshold`` validators (``DEFAULT_THRESHOLD`` = 4096, the
    reference's) stay on the scalar path by design.  ``device`` is where
    the kernels run: ``"cuda"`` (the default) or ``"cpu"`` (their plain
    versions; tests).
  * ``try_process_epoch(state, types, preset, spec)``: True when the
    engine processed the epoch (the post-state equals the scalar path's
    byte for byte), False when the caller must run the scalar path.  The
    scalar path is the reference's routing for the base fork, the
    genesis-edge epochs, registries under the threshold and states
    outside the uint64 envelope (``MAX_*`` and the product guards); it
    is not a fallback.
  * ``engine_status()`` counts the epochs each backend answered, the
    faults and the kernels' launches; ``last_stage_rows()`` holds the
    stage rows (snapshot, sums, justification, registry, kernel,
    writeback, sync_committee) of the last device-processed epoch.

Deliberate differences from the reference: the default backend is
``"cuda"`` (the reference's device path is opt-in); there is no breaker,
no exec cache, no lane buckets and no ``LIGHTHOUSE_TPU_EPOCH_*``
environment variables; a kernel fault restores the justification
snapshot (the only mutation before the writeback) and then raises, where
the reference re-runs the epoch on the host; a ``"cuda"`` call without a
card raises.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from ...runtime.stages import StageTimer
from ...runtime.tensors import resolve_device
from ...types.primitives import (
    FAR_FUTURE_EPOCH,
    compute_activation_exit_epoch,
)
from ...types.spec import GENESIS_EPOCH
from . import soa as soa_mod
from .cuda import kernel
from .shuffle import sample_sync_committee_indices

DEFAULT_THRESHOLD = 4096
BACKENDS = ("cuda", "python")

#: Host-side overflow guards: states beyond these bounds route to the
#: scalar path (arbitrary-precision ints) instead of risking uint64
#: wraparound on device.  Far beyond any state the STF can produce.
MAX_BALANCE = 1 << 61
MAX_INACTIVITY_SCORE = 1 << 26
MAX_EFFECTIVE = 1 << 40

_LOCK = threading.Lock()
_STATE = {"requested": "cuda", "threshold": DEFAULT_THRESHOLD,
          "device": "cuda"}
_ANSWERED = {name: 0 for name in BACKENDS}
_FAULTS = {"count": 0, "last": None}
_SCALAR = {"last_ms": None}

#: Stage rows of the last device-processed epoch.
_LAST_STAGES: List[dict] = []


def configure(backend: Optional[str] = None,
              threshold: Optional[int] = None, device=None) -> None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown epoch backend {backend!r}")
    with _LOCK:
        if backend is not None:
            _STATE["requested"] = backend
        if threshold is not None:
            _STATE["threshold"] = int(threshold)
        if device is not None:
            _STATE["device"] = str(device)


def reset_engine() -> None:
    """Back to the defaults, with the counts cleared (tests)."""
    configure("cuda", DEFAULT_THRESHOLD, "cuda")
    with _LOCK:
        for name in BACKENDS:
            _ANSWERED[name] = 0
        _FAULTS.update(count=0, last=None)
        _SCALAR["last_ms"] = None
        _LAST_STAGES.clear()
    kernel.reset_launches()


def engine_status() -> dict:
    with _LOCK:
        return {
            "backend": _STATE["requested"],
            "threshold": _STATE["threshold"],
            "device": _STATE["device"],
            "answered": dict(_ANSWERED),
            "faults": _FAULTS["count"],
            "last_fault": _FAULTS["last"],
            "last_scalar_ms": _SCALAR["last_ms"],
            "launches": kernel.launch_counts(),
        }


def last_stage_rows() -> List[dict]:
    with _LOCK:
        return list(_LAST_STAGES)


def observe_scalar(seconds: float) -> None:
    """Count an epoch the scalar path answered (per_epoch's loop flavor)
    and keep its wall time."""
    with _LOCK:
        _ANSWERED["python"] += 1
        _SCALAR["last_ms"] = seconds * 1e3


class _Unsupported(Exception):
    """State shape outside the engine's uint64 envelope: a routing
    decision (scalar handles it exactly), not a fault."""


def try_process_epoch(state, types, preset, spec) -> bool:
    """Process one epoch on the engine.  True -> `state` now holds the
    post-epoch state, byte-identical to the scalar path.  False -> the
    caller must run the scalar path (nothing was mutated).  A fault
    restores the justification checkpoints and bits and raises."""
    from ..helpers import current_epoch

    if state.fork_name == "base":
        return False
    with _LOCK:
        backend = _STATE["requested"]
        threshold = _STATE["threshold"]
        device = _STATE["device"]
    if backend != "cuda":
        return False
    n = len(state.validators)
    if n == 0 or n < threshold:
        return False
    if current_epoch(state, preset) <= GENESIS_EPOCH + 1:
        # Genesis-edge epochs skip justification; the scalar path owns
        # that branch structure.
        return False
    dev = resolve_device(device, "epoch engine")

    checkpoint_snap = (
        state.previous_justified_checkpoint,
        state.current_justified_checkpoint,
        state.finalized_checkpoint,
        type(state.justification_bits)(state.justification_bits),
    )
    timer = StageTimer()
    try:
        _run_device_epoch(state, types, preset, spec, timer, dev)
    except _Unsupported:
        return False
    except BaseException as e:
        # Justification is the only mutation before the writeback stage
        # (which is host Python over finished arrays).
        (state.previous_justified_checkpoint,
         state.current_justified_checkpoint,
         state.finalized_checkpoint,
         state.justification_bits) = checkpoint_snap
        with _LOCK:
            _FAULTS["count"] += 1
            _FAULTS["last"] = f"{type(e).__name__}: {e}"
        raise
    with _LOCK:
        _ANSWERED["cuda"] += 1
        _LAST_STAGES[:] = timer.rows()
    return True


def _epoch_scalars(state, spec, preset, prev, cur, leak, per_incr,
                   total_incr, flag_bal, adjusted, total_active) -> list:
    """The k_state scalar vector, in the ``kernel.S_*`` layout."""
    from ..per_epoch import (
        HYSTERESIS_DOWNWARD_MULTIPLIER,
        HYSTERESIS_QUOTIENT,
        HYSTERESIS_UPWARD_MULTIPLIER,
        _inactivity_quotient,
    )

    incr = spec.effective_balance_increment
    scalars = [0] * kernel.N_SCALARS
    scalars[kernel.S_PREV] = prev
    scalars[kernel.S_CUR] = cur
    scalars[kernel.S_LEAK] = int(leak)
    scalars[kernel.S_PER_INCR] = per_incr
    scalars[kernel.S_TOTAL_INCR] = total_incr
    for f in range(3):
        scalars[kernel.S_PART0 + f] = flag_bal[f] // incr
    scalars[kernel.S_BIAS] = spec.inactivity_score_bias
    scalars[kernel.S_RECOVERY] = spec.inactivity_score_recovery_rate
    scalars[kernel.S_INACT_DENOM] = (
        spec.inactivity_score_bias
        * _inactivity_quotient(state.fork_name, spec)
    )
    scalars[kernel.S_ADJUSTED] = adjusted
    scalars[kernel.S_TOTAL_ACTIVE] = total_active
    scalars[kernel.S_INCR] = incr
    scalars[kernel.S_MAX_EFF] = spec.max_effective_balance
    hysteresis = incr // HYSTERESIS_QUOTIENT
    scalars[kernel.S_DOWN] = hysteresis * HYSTERESIS_DOWNWARD_MULTIPLIER
    scalars[kernel.S_UP] = hysteresis * HYSTERESIS_UPWARD_MULTIPLIER
    scalars[kernel.S_SLASH_WD] = (
        cur + preset.epochs_per_slashings_vector // 2
    )
    return scalars


def _run_device_epoch(state, types, preset, spec, timer, device) -> None:
    from ..helpers import current_epoch, previous_epoch, get_seed
    from ..helpers import integer_squareroot, _slashing_quotients
    from ..per_epoch import (
        get_next_sync_committee,
        process_eth1_data_reset,
        process_historical_roots_update,
        process_randao_mixes_reset,
        process_slashings_reset,
        weigh_justification_and_finalization,
    )

    cur = current_epoch(state, preset)
    prev = previous_epoch(state, preset)
    n = len(state.validators)
    incr = spec.effective_balance_increment
    far = np.uint64(FAR_FUTURE_EPOCH)

    with timer.stage("snapshot"):
        soa = soa_mod.RegistrySoA.snapshot(state)
        if (int(soa.balance.max(initial=0)) > MAX_BALANCE
                or int(soa.inactivity_scores.max(initial=0))
                > MAX_INACTIVITY_SCORE
                or int(soa.effective_balance.max(initial=0))
                > MAX_EFFECTIVE):
            raise _Unsupported

    with timer.stage("sums"):
        sums = kernel.run_sums(soa, prev, cur, device)
        total_active = max(incr, int(sums[0]))
        flag_bal = [max(incr, int(sums[1 + f])) for f in range(3)]
        prev_target_bal = flag_bal[1]
        cur_target_bal = max(incr, int(sums[4]))
        active_count = int(sums[5])

    # Derived epoch scalars + the overflow envelope of every kernel
    # product (checked host-side in arbitrary precision BEFORE any
    # mutation).
    per_incr = (incr * spec.base_reward_factor
                // integer_squareroot(total_active))
    total_incr = total_active // incr
    _, slash_mult, _ = _slashing_quotients(state.fork_name, spec)
    adjusted = min(sum(state.slashings) * slash_mult, total_active)
    eff_max = int(soa.effective_balance.max(initial=0))
    if ((eff_max // incr) * per_incr * 26 * total_incr >= 1 << 63
            or (eff_max // incr) * adjusted >= 1 << 63):
        raise _Unsupported

    with timer.stage("justification"):
        weigh_justification_and_finalization(
            state, total_active, prev_target_bal, cur_target_bal, preset
        )

    finality_delay = prev - state.finalized_checkpoint.epoch
    leak = finality_delay > spec.min_epochs_to_inactivity_penalty

    with timer.stage("registry"):
        elig = soa.activation_eligibility_epoch.copy()
        act = soa.activation_epoch.copy()
        exitp = soa.exit_epoch.copy()
        wd = soa.withdrawable_epoch.copy()
        mark = (elig == far) & (
            soa.effective_balance == np.uint64(spec.max_effective_balance)
        )
        elig[mark] = np.uint64(cur + 1)
        churn_limit = max(
            spec.min_per_epoch_churn_limit,
            active_count // spec.churn_limit_quotient,
        )
        act_exit = compute_activation_exit_epoch(cur, spec)
        eject = (soa.active_mask(cur)
                 & (soa.effective_balance
                    <= np.uint64(spec.ejection_balance))
                 & (exitp == far))
        existing = exitp[exitp != far]
        exit_queue_epoch = max(
            int(existing.max()) if len(existing) else 0, act_exit
        )
        exit_queue_churn = int(
            np.count_nonzero(exitp == np.uint64(exit_queue_epoch))
        )
        delay = spec.min_validator_withdrawability_delay
        ejected: List[Tuple[int, int]] = []
        for i in np.nonzero(eject)[0]:
            if exit_queue_churn >= churn_limit:
                exit_queue_epoch += 1
                exit_queue_churn = 0
            exitp[i] = np.uint64(exit_queue_epoch)
            wd[i] = np.uint64(exit_queue_epoch + delay)
            ejected.append((int(i), exit_queue_epoch))
            exit_queue_churn += 1
        cand = np.nonzero(
            (elig <= np.uint64(state.finalized_checkpoint.epoch))
            & (act == far)
        )[0]
        queue = cand[np.lexsort((cand, elig[cand]))][:churn_limit]
        act[queue] = np.uint64(act_exit)

    with timer.stage("kernel"):
        scalars = _epoch_scalars(
            state, spec, preset, prev, cur, leak, per_incr, total_incr,
            flag_bal, adjusted, total_active)
        new_scores, new_bal, new_eff = kernel.run_state(
            soa, wd, scalars, device
        )

    with timer.stage("writeback"):
        state.inactivity_scores = new_scores.tolist()
        state.balances = new_bal.tolist()
        vals = state.validators
        for i in np.nonzero(mark)[0]:
            vals[int(i)].activation_eligibility_epoch = cur + 1
        for i, eq in ejected:
            vals[i].exit_epoch = eq
            vals[i].withdrawable_epoch = eq + delay
        for i in queue:
            vals[int(i)].activation_epoch = act_exit
        for i in np.nonzero(new_eff != soa.effective_balance)[0]:
            vals[int(i)].effective_balance = int(new_eff[i])
        process_eth1_data_reset(state, preset)
        process_slashings_reset(state, preset)
        process_randao_mixes_reset(state, preset)
        process_historical_roots_update(state, types, preset)
        state.previous_epoch_participation = (
            state.current_epoch_participation
        )
        state.current_epoch_participation = [0] * n

    if (cur + 1) % preset.epochs_per_sync_committee_period == 0:
        with timer.stage("sync_committee"):
            seed = get_seed(
                state, cur + 1, spec.domain_sync_committee, preset, spec
            )
            active_next = np.nonzero(
                (act <= np.uint64(cur + 1)) & (np.uint64(cur + 1) < exitp)
            )[0].astype(np.uint64)
            indices = sample_sync_committee_indices(
                active_next, new_eff, seed, preset.sync_committee_size,
                spec.max_effective_balance, spec.shuffle_round_count,
            )
            state.current_sync_committee = state.next_sync_committee
            state.next_sync_committee = get_next_sync_committee(
                state, types, preset, spec, indices=indices
            )

    # Hand the post-epoch SoA to the re-rooting fast path.
    soa.effective_balance = new_eff
    soa.balance = new_bal
    soa.inactivity_scores = new_scores
    soa.activation_eligibility_epoch = elig
    soa.activation_epoch = act
    soa.exit_epoch = exitp
    soa.withdrawable_epoch = wd
    soa_mod.install_root_plane(state, soa)
