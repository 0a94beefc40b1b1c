"""Consensus data types of the PyTorch/CUDA port: spec presets, the
runtime ChainSpec, the fork-versioned SSZ containers and the slot / epoch
helpers (copies of ``lighthouse_tpu/types/spec.py``, ``containers.py``
and ``primitives.py``).  The network config loader (``network_config.py``,
which needs ``yaml``) is not ported."""
from .spec import (
    ChainSpec,
    EthSpec,
    FAR_FUTURE_EPOCH,
    FORK_ORDER,
    GENESIS_EPOCH,
    GENESIS_SLOT,
    GNOSIS,
    MAINNET,
    MINIMAL,
    fork_index,
)
from .containers import (
    AttestationData,
    BeaconBlockHeader,
    Checkpoint,
    Eth1Data,
    Fork,
    HistoricalSummary,
    SpecTypes,
    Validator,
    mainnet_types,
    state_from_ssz_bytes,
)
from .primitives import (
    compute_activation_exit_epoch,
    compute_domain,
    compute_epoch_at_slot,
    compute_fork_data_root,
    compute_fork_digest,
    compute_signing_root,
    epoch_start_slot,
    is_active_validator,
    is_eligible_for_activation_queue,
    is_slashable_attestation_data,
    is_slashable_validator,
    slot_to_epoch,
)

__all__ = [n for n in dir() if not n.startswith("_")]
