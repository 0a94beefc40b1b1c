"""Compile-time presets (`EthSpec`) and runtime configuration (`ChainSpec`).

Equivalent of the reference's two configuration axes
(Lighthouse's consensus/types/src/eth_spec.rs:51 — typenum preset
trait, impls Mainnet:254 / Minimal:298 / Gnosis:345; chain_spec.rs:32 —
~200 runtime tunables).  Here a preset is a frozen dataclass of list
lengths / committee geometry consumed by the SSZ type factory
(..types.containers), and ChainSpec holds runtime constants (fork
epochs/versions, domains, timing).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_SLOT = 0
GENESIS_EPOCH = 0


@dataclass(frozen=True)
class EthSpec:
    """Preset: sizes fixed at type level in the reference."""

    name: str
    # misc
    max_committees_per_slot: int
    target_committee_size: int
    max_validators_per_committee: int
    # time
    slots_per_epoch: int
    slots_per_eth1_voting_period: int
    slots_per_historical_root: int
    epochs_per_eth1_voting_period: int
    # state list lengths
    epochs_per_historical_vector: int
    epochs_per_slashings_vector: int
    historical_roots_limit: int
    validator_registry_limit: int
    # blocks
    max_proposer_slashings: int
    max_attester_slashings: int
    max_attestations: int
    max_deposits: int
    max_voluntary_exits: int
    # sync committee (altair)
    sync_committee_size: int
    epochs_per_sync_committee_period: int
    sync_committee_subnet_count: int
    # execution (merge)
    max_bytes_per_transaction: int
    max_transactions_per_payload: int
    bytes_per_logs_bloom: int
    max_extra_data_bytes: int
    # capella
    max_bls_to_execution_changes: int
    max_withdrawals_per_payload: int
    max_validators_per_withdrawals_sweep: int
    # misc caps
    justification_bits_length: int = 4
    deposit_contract_tree_depth: int = 32
    # deneb blob geometry (defaulted tail fields: presets predating the
    # blob engine pick these up unchanged)
    field_elements_per_blob: int = 4096
    max_blobs_per_block: int = 6
    max_blob_commitments_per_block: int = 4096

    @property
    def genesis_epoch(self) -> int:
        return GENESIS_EPOCH


MAINNET = EthSpec(
    name="mainnet",
    max_committees_per_slot=64,
    target_committee_size=128,
    max_validators_per_committee=2048,
    slots_per_epoch=32,
    slots_per_eth1_voting_period=2048,
    slots_per_historical_root=8192,
    epochs_per_eth1_voting_period=64,
    epochs_per_historical_vector=65536,
    epochs_per_slashings_vector=8192,
    historical_roots_limit=2**24,
    validator_registry_limit=2**40,
    max_proposer_slashings=16,
    max_attester_slashings=2,
    max_attestations=128,
    max_deposits=16,
    max_voluntary_exits=16,
    sync_committee_size=512,
    epochs_per_sync_committee_period=256,
    sync_committee_subnet_count=4,
    max_bytes_per_transaction=2**30,
    max_transactions_per_payload=2**20,
    bytes_per_logs_bloom=256,
    max_extra_data_bytes=32,
    max_bls_to_execution_changes=16,
    max_withdrawals_per_payload=16,
    max_validators_per_withdrawals_sweep=16384,
)

# Reference: eth_spec.rs:298 MinimalEthSpec overrides a small set of
# mainnet parameters; 6s slots come from the minimal ChainSpec.
MINIMAL = replace(
    MAINNET,
    name="minimal",
    max_committees_per_slot=4,
    target_committee_size=4,
    slots_per_epoch=8,
    slots_per_eth1_voting_period=32,
    slots_per_historical_root=64,
    epochs_per_eth1_voting_period=4,
    epochs_per_historical_vector=64,
    epochs_per_slashings_vector=64,
    sync_committee_size=32,
    epochs_per_sync_committee_period=8,
    max_withdrawals_per_payload=4,
    max_validators_per_withdrawals_sweep=16,
    # Deviation from the upstream minimal preset (4096 elements): 64-element
    # blobs keep the KZG differential suite and the 500-peer blob scenarios
    # inside the tier-1 budget; the engine only requires a power of two.
    field_elements_per_blob=64,
    max_blob_commitments_per_block=16,
)

# Reference: eth_spec.rs:345 GnosisEthSpec — 16-slot epochs and a
# longer sync-committee period over otherwise mainnet geometry.
GNOSIS = replace(
    MAINNET,
    name="gnosis",
    slots_per_epoch=16,
    slots_per_eth1_voting_period=1024,
    epochs_per_sync_committee_period=512,
)


# --- Fork naming -------------------------------------------------------------

FORK_ORDER = ("base", "altair", "merge", "capella", "deneb")


def fork_index(name: str) -> int:
    return FORK_ORDER.index(name)


# --- ChainSpec ---------------------------------------------------------------


@dataclass
class ChainSpec:
    """Runtime constants (reference chain_spec.rs:32).  Only the subset
    consumed by implemented subsystems; extended as layers land."""

    config_name: str = "mainnet"
    preset_base: str = "mainnet"

    seconds_per_slot: int = 12
    intervals_per_slot: int = 3
    genesis_delay: int = 604800
    min_genesis_time: int = 1606824000
    min_genesis_active_validator_count: int = 16384

    # fork schedule: epoch = None means not scheduled
    genesis_fork_version: bytes = b"\x00\x00\x00\x00"
    altair_fork_version: bytes = b"\x01\x00\x00\x00"
    altair_fork_epoch: Optional[int] = 74240
    bellatrix_fork_version: bytes = b"\x02\x00\x00\x00"
    bellatrix_fork_epoch: Optional[int] = 144896
    capella_fork_version: bytes = b"\x03\x00\x00\x00"
    capella_fork_epoch: Optional[int] = 194048
    # Deneb ships unscheduled by default (epoch None on every preset):
    # the blob engine is opt-in per network/sim until a schedule lands.
    deneb_fork_version: bytes = b"\x04\x00\x00\x00"
    deneb_fork_epoch: Optional[int] = None

    # validator lifecycle
    min_deposit_amount: int = 10**9
    max_effective_balance: int = 32 * 10**9
    effective_balance_increment: int = 10**9
    ejection_balance: int = 16 * 10**9
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 2**16

    # gwei / rewards
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    proposer_reward_quotient: int = 8
    inactivity_penalty_quotient: int = 2**26
    min_slashing_penalty_quotient: int = 128
    proportional_slashing_multiplier: int = 1
    # altair overrides
    inactivity_penalty_quotient_altair: int = 3 * 2**24
    min_slashing_penalty_quotient_altair: int = 64
    proportional_slashing_multiplier_altair: int = 2
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    # bellatrix overrides
    inactivity_penalty_quotient_bellatrix: int = 2**24
    min_slashing_penalty_quotient_bellatrix: int = 32
    proportional_slashing_multiplier_bellatrix: int = 3

    # time windows
    min_attestation_inclusion_delay: int = 1
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4
    min_epochs_to_inactivity_penalty: int = 4
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    epochs_per_eth1_voting_period: int = 64

    # shuffle
    shuffle_round_count: int = 90

    # attestation subnets (reference chain_spec.rs:173-175,629 — drives
    # the deterministic long-lived subscriptions of
    # network/subnet_service.py)
    attestation_subnet_count: int = 64
    subnets_per_node: int = 2
    epochs_per_subnet_subscription: int = 256
    attestation_subnet_extra_bits: int = 0

    # domains (4-byte little-endian tags; chain_spec.rs domain consts)
    domain_beacon_proposer: int = 0
    domain_beacon_attester: int = 1
    domain_randao: int = 2
    domain_deposit: int = 3
    domain_voluntary_exit: int = 4
    domain_selection_proof: int = 5
    domain_aggregate_and_proof: int = 6
    domain_sync_committee: int = 7
    domain_sync_committee_selection_proof: int = 8
    domain_contribution_and_proof: int = 9
    domain_bls_to_execution_change: int = 10
    domain_application_mask: int = 0x00000001

    # fork choice
    proposer_score_boost: int = 40
    safe_slots_to_update_justified: int = 8

    # deposit contract / eth1 follower
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes.fromhex(
        "00000000219ab540356cbb839cbe05303d7705fa"
    )
    seconds_per_eth1_block: int = 14
    eth1_follow_distance: int = 2048

    # sync committee messaging
    target_aggregators_per_committee: int = 16
    target_aggregators_per_sync_subcommittee: int = 16

    # networking-ish constants used by consensus checks
    attestation_propagation_slot_range: int = 32
    maximum_gossip_clock_disparity_millis: int = 500

    def fork_name_at_epoch(self, epoch: int) -> str:
        if self.deneb_fork_epoch is not None and epoch >= self.deneb_fork_epoch:
            return "deneb"
        if self.capella_fork_epoch is not None and epoch >= self.capella_fork_epoch:
            return "capella"
        if self.bellatrix_fork_epoch is not None and epoch >= self.bellatrix_fork_epoch:
            return "merge"
        if self.altair_fork_epoch is not None and epoch >= self.altair_fork_epoch:
            return "altair"
        return "base"

    def fork_version_for_name(self, name: str) -> bytes:
        return {
            "base": self.genesis_fork_version,
            "altair": self.altair_fork_version,
            "merge": self.bellatrix_fork_version,
            "capella": self.capella_fork_version,
            "deneb": self.deneb_fork_version,
        }[name]

    def fork_epoch(self, name: str) -> Optional[int]:
        return {
            "base": 0,
            "altair": self.altair_fork_epoch,
            "merge": self.bellatrix_fork_epoch,
            "capella": self.capella_fork_epoch,
            "deneb": self.deneb_fork_epoch,
        }[name]

    @classmethod
    def mainnet(cls) -> "ChainSpec":
        return cls()

    @classmethod
    def gnosis(cls) -> "ChainSpec":
        # Reference chain_spec.rs:701 gnosis(): 5s slots, 0x64 fork
        # versions, chain id 100, slower churn.
        return cls(
            config_name="gnosis",
            preset_base="gnosis",
            seconds_per_slot=5,
            churn_limit_quotient=4096,
            min_genesis_active_validator_count=4096,
            genesis_fork_version=bytes.fromhex("00000064"),
            altair_fork_version=bytes.fromhex("01000064"),
            altair_fork_epoch=512,
            bellatrix_fork_version=bytes.fromhex("02000064"),
            bellatrix_fork_epoch=385536,
            capella_fork_version=bytes.fromhex("03000064"),
            capella_fork_epoch=648704,
            deneb_fork_version=bytes.fromhex("04000064"),
            deposit_chain_id=100,
            deposit_network_id=100,
            deposit_contract_address=bytes.fromhex(
                "0b98057ea310f4d31f2a452b414647007d1645d9"
            ),
            eth1_follow_distance=1024,
            proportional_slashing_multiplier=1,
            # Gnosis preset (consensus/types/presets/gnosis/phase0.yaml):
            # BASE_REWARD_FACTOR is 25, not mainnet's 64 — caught by the
            # ported preset conformance vectors (round 5).
            base_reward_factor=25,
        )

    @classmethod
    def minimal(cls) -> "ChainSpec":
        # Reference chain_spec.rs:665 minimal(): 6s slots, 10 shuffle
        # rounds, faster churn, minimal fork versions (*.00.00.01).
        return cls(
            config_name="minimal",
            preset_base="minimal",
            seconds_per_slot=6,
            genesis_delay=300,
            min_genesis_active_validator_count=64,
            churn_limit_quotient=32,
            shard_committee_period=64,
            epochs_per_eth1_voting_period=4,
            shuffle_round_count=10,
            genesis_fork_version=b"\x00\x00\x00\x01",
            altair_fork_version=b"\x01\x00\x00\x01",
            bellatrix_fork_version=b"\x02\x00\x00\x01",
            capella_fork_version=b"\x03\x00\x00\x01",
            deneb_fork_version=b"\x04\x00\x00\x01",
            altair_fork_epoch=None,
            bellatrix_fork_epoch=None,
            capella_fork_epoch=None,
            min_slashing_penalty_quotient=64,
            proportional_slashing_multiplier=2,
            inactivity_penalty_quotient=2**25,
            safe_slots_to_update_justified=2,
            eth1_follow_distance=16,
        )
