"""Consensus data types of the PyTorch/CUDA port: spec presets, the
runtime ChainSpec and the fork-versioned SSZ containers (copies of
``lighthouse_tpu/types/spec.py`` and ``containers.py``).  The network
config loader (``network_config.py``, which needs ``yaml``) and the
slot/epoch helpers are not ported."""
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

__all__ = [n for n in dir() if not n.startswith("_")]
