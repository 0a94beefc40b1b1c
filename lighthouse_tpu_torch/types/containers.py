"""Consensus containers, fork-versioned, generated per preset.

Equivalent of `consensus/types` (Lighthouse's consensus/types/src/ — 82
modules; superstruct fork-versioning in beacon_state.rs /
signed_beacon_block.rs; typenum lengths from eth_spec.rs).  The reference
fixes list lengths at the type level via `EthSpec` typenums; here a
`SpecTypes(preset)` factory instantiates the SSZ container classes for a
preset (cached), and fork variants are separate classes related by a
`fork_name` attribute plus `upgrade_*` converters in
..state_transition.upgrades.

Fork order (reference superstruct variants Base/Altair/Merge/Capella):
    base -> altair -> merge (bellatrix) -> capella

NOTE: this module must NOT use `from __future__ import annotations` —
Container field discovery reads evaluated class annotations.
"""
from functools import lru_cache
from types import SimpleNamespace

from ..ssz import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Vector,
    boolean,
    uint8,
    uint64,
    uint256,
)
from .spec import EthSpec, MAINNET

# --- Preset-independent containers ------------------------------------------


class Fork(Container):
    previous_version: Bytes4
    current_version: Bytes4
    epoch: uint64


class ForkData(Container):
    current_version: Bytes4
    genesis_validators_root: Bytes32


class Checkpoint(Container):
    epoch: uint64
    root: Bytes32


class Validator(Container):
    pubkey: Bytes48
    withdrawal_credentials: Bytes32
    effective_balance: uint64
    slashed: boolean
    activation_eligibility_epoch: uint64
    activation_epoch: uint64
    exit_epoch: uint64
    withdrawable_epoch: uint64


class AttestationData(Container):
    slot: uint64
    index: uint64
    beacon_block_root: Bytes32
    source: Checkpoint
    target: Checkpoint


class Eth1Data(Container):
    deposit_root: Bytes32
    deposit_count: uint64
    block_hash: Bytes32


class DepositMessage(Container):
    pubkey: Bytes48
    withdrawal_credentials: Bytes32
    amount: uint64


class DepositData(Container):
    pubkey: Bytes48
    withdrawal_credentials: Bytes32
    amount: uint64
    signature: Bytes96


class BeaconBlockHeader(Container):
    slot: uint64
    proposer_index: uint64
    parent_root: Bytes32
    state_root: Bytes32
    body_root: Bytes32


class SignedBeaconBlockHeader(Container):
    message: BeaconBlockHeader
    signature: Bytes96


class ProposerSlashing(Container):
    signed_header_1: SignedBeaconBlockHeader
    signed_header_2: SignedBeaconBlockHeader


class VoluntaryExit(Container):
    epoch: uint64
    validator_index: uint64


class SignedVoluntaryExit(Container):
    message: VoluntaryExit
    signature: Bytes96


class ValidatorRegistration(Container):
    """Validator registration for external block production (reference
    consensus/types/src/validator_registration_data.rs), signed under the
    application domain by the VC's preparation service."""
    fee_recipient: Bytes20
    gas_limit: uint64
    timestamp: uint64
    pubkey: Bytes48


class SigningData(Container):
    object_root: Bytes32
    domain: Bytes32


def state_from_ssz_bytes(raw: bytes, types, preset, spec):
    """Decode a BeaconState of unknown fork: sniff the slot (offset 40:
    after genesis_time u64 + genesis_validators_root 32B) and select the
    fork's state class.  The one canonical copy of this logic — used by
    checkpoint sync, lcli, and the CLI genesis loader."""
    slot = int.from_bytes(raw[40:48], "little")
    fork = spec.fork_name_at_epoch(slot // preset.slots_per_epoch)
    return types.states[fork].decode(raw)


class Withdrawal(Container):
    index: uint64
    validator_index: uint64
    address: Bytes20
    amount: uint64


class BLSToExecutionChange(Container):
    validator_index: uint64
    from_bls_pubkey: Bytes48
    to_execution_address: Bytes20


class SignedBLSToExecutionChange(Container):
    message: BLSToExecutionChange
    signature: Bytes96


class HistoricalSummary(Container):
    block_summary_root: Bytes32
    state_summary_root: Bytes32


class SyncCommitteeMessage(Container):
    slot: uint64
    beacon_block_root: Bytes32
    validator_index: uint64
    signature: Bytes96


class SyncAggregatorSelectionData(Container):
    """Signed by sync aggregators to prove subcommittee selection
    (reference consensus/types/src/sync_aggregator_selection_data.rs)."""
    slot: uint64
    subcommittee_index: uint64


class Eth1Block(Container):
    """Minimal eth1 block info cached by the deposit follower
    (reference beacon_node/eth1/src/block_cache.rs)."""
    hash: Bytes32
    timestamp: uint64
    number: uint64


# --- Preset-parameterized factory -------------------------------------------


@lru_cache(maxsize=None)
def SpecTypes(preset: EthSpec) -> SimpleNamespace:
    """All preset-dependent container classes for `preset`, as a
    namespace.  Mirrors the monomorphization the reference gets from
    `EthSpec` generics."""
    E = preset
    epochs_slots = E.epochs_per_eth1_voting_period * E.slots_per_epoch

    class IndexedAttestation(Container):
        attesting_indices: List[uint64, E.max_validators_per_committee]
        data: AttestationData
        signature: Bytes96

    class Attestation(Container):
        aggregation_bits: Bitlist[E.max_validators_per_committee]
        data: AttestationData
        signature: Bytes96

    class PendingAttestation(Container):
        aggregation_bits: Bitlist[E.max_validators_per_committee]
        data: AttestationData
        inclusion_delay: uint64
        proposer_index: uint64

    class AttesterSlashing(Container):
        attestation_1: IndexedAttestation
        attestation_2: IndexedAttestation

    class Deposit(Container):
        proof: Vector[Bytes32, E.deposit_contract_tree_depth + 1]
        data: DepositData

    class HistoricalBatch(Container):
        block_roots: Vector[Bytes32, E.slots_per_historical_root]
        state_roots: Vector[Bytes32, E.slots_per_historical_root]

    class SyncCommittee(Container):
        pubkeys: Vector[Bytes48, E.sync_committee_size]
        aggregate_pubkey: Bytes48

    class SyncAggregate(Container):
        sync_committee_bits: Bitvector[E.sync_committee_size]
        sync_committee_signature: Bytes96

    class SyncCommitteeContribution(Container):
        slot: uint64
        beacon_block_root: Bytes32
        subcommittee_index: uint64
        aggregation_bits: Bitvector[
            E.sync_committee_size // E.sync_committee_subnet_count
        ]
        signature: Bytes96

    class ContributionAndProof(Container):
        aggregator_index: uint64
        contribution: SyncCommitteeContribution
        selection_proof: Bytes96

    class SignedContributionAndProof(Container):
        message: ContributionAndProof
        signature: Bytes96

    class AggregateAndProof(Container):
        aggregator_index: uint64
        aggregate: Attestation
        selection_proof: Bytes96

    class SignedAggregateAndProof(Container):
        message: AggregateAndProof
        signature: Bytes96

    Transaction = ByteList[E.max_bytes_per_transaction]

    class ExecutionPayloadMerge(Container):
        parent_hash: Bytes32
        fee_recipient: Bytes20
        state_root: Bytes32
        receipts_root: Bytes32
        logs_bloom: ByteVector[E.bytes_per_logs_bloom]
        prev_randao: Bytes32
        block_number: uint64
        gas_limit: uint64
        gas_used: uint64
        timestamp: uint64
        extra_data: ByteList[E.max_extra_data_bytes]
        base_fee_per_gas: uint256
        block_hash: Bytes32
        transactions: List[Transaction, E.max_transactions_per_payload]

    class ExecutionPayloadCapella(ExecutionPayloadMerge):
        withdrawals: List[Withdrawal, E.max_withdrawals_per_payload]

    class ExecutionPayloadHeaderMerge(Container):
        parent_hash: Bytes32
        fee_recipient: Bytes20
        state_root: Bytes32
        receipts_root: Bytes32
        logs_bloom: ByteVector[E.bytes_per_logs_bloom]
        prev_randao: Bytes32
        block_number: uint64
        gas_limit: uint64
        gas_used: uint64
        timestamp: uint64
        extra_data: ByteList[E.max_extra_data_bytes]
        base_fee_per_gas: uint256
        block_hash: Bytes32
        transactions_root: Bytes32

    class ExecutionPayloadHeaderCapella(ExecutionPayloadHeaderMerge):
        withdrawals_root: Bytes32

    # -- block bodies per fork --

    class _BodyCommon(Container):
        randao_reveal: Bytes96
        eth1_data: Eth1Data
        graffiti: Bytes32
        proposer_slashings: List[ProposerSlashing, E.max_proposer_slashings]
        attester_slashings: List[AttesterSlashing, E.max_attester_slashings]
        attestations: List[Attestation, E.max_attestations]
        deposits: List[Deposit, E.max_deposits]
        voluntary_exits: List[SignedVoluntaryExit, E.max_voluntary_exits]

    class BeaconBlockBodyBase(_BodyCommon):
        pass

    class BeaconBlockBodyAltair(_BodyCommon):
        sync_aggregate: SyncAggregate

    class BeaconBlockBodyMerge(BeaconBlockBodyAltair):
        execution_payload: ExecutionPayloadMerge

    class BeaconBlockBodyCapella(BeaconBlockBodyAltair):
        execution_payload: ExecutionPayloadCapella
        bls_to_execution_changes: List[
            SignedBLSToExecutionChange, E.max_bls_to_execution_changes
        ]

    class BeaconBlockBodyDeneb(BeaconBlockBodyCapella):
        blob_kzg_commitments: List[Bytes48, E.max_blob_commitments_per_block]

    def _block_pair(body_cls, fork):
        class BeaconBlock(Container):
            slot: uint64
            proposer_index: uint64
            parent_root: Bytes32
            state_root: Bytes32
            body: body_cls

        class SignedBeaconBlock(Container):
            message: BeaconBlock
            signature: Bytes96

        BeaconBlock.__name__ = f"BeaconBlock{fork.title()}"
        BeaconBlock.fork_name = fork
        SignedBeaconBlock.__name__ = f"SignedBeaconBlock{fork.title()}"
        SignedBeaconBlock.fork_name = fork
        return BeaconBlock, SignedBeaconBlock

    BeaconBlockBase, SignedBeaconBlockBase = _block_pair(
        BeaconBlockBodyBase, "base"
    )
    BeaconBlockAltair, SignedBeaconBlockAltair = _block_pair(
        BeaconBlockBodyAltair, "altair"
    )
    BeaconBlockMerge, SignedBeaconBlockMerge = _block_pair(
        BeaconBlockBodyMerge, "merge"
    )
    BeaconBlockCapella, SignedBeaconBlockCapella = _block_pair(
        BeaconBlockBodyCapella, "capella"
    )
    BeaconBlockDeneb, SignedBeaconBlockDeneb = _block_pair(
        BeaconBlockBodyDeneb, "deneb"
    )

    class BlobSidecar(Container):
        """Deneb blob sidecar: the blob data plus its KZG commitment and
        opening proof, bound to a block by the signed header.  Deviation
        from the upstream container: no Merkle inclusion proof — binding
        is by header root plus commitment equality against the block
        body's ``blob_kzg_commitments`` (the availability checker
        enforces both), which keeps the sidecar self-contained without
        porting the generalized-index machinery."""
        index: uint64
        blob: ByteVector[E.field_elements_per_blob * 32]
        kzg_commitment: Bytes48
        kzg_proof: Bytes48
        signed_block_header: SignedBeaconBlockHeader

    # -- states per fork --

    class _StateCommon(Container):
        genesis_time: uint64
        genesis_validators_root: Bytes32
        slot: uint64
        fork: Fork
        latest_block_header: BeaconBlockHeader
        block_roots: Vector[Bytes32, E.slots_per_historical_root]
        state_roots: Vector[Bytes32, E.slots_per_historical_root]
        historical_roots: List[Bytes32, E.historical_roots_limit]
        eth1_data: Eth1Data
        eth1_data_votes: List[Eth1Data, epochs_slots]
        eth1_deposit_index: uint64
        validators: List[Validator, E.validator_registry_limit]
        balances: List[uint64, E.validator_registry_limit]
        randao_mixes: Vector[Bytes32, E.epochs_per_historical_vector]
        slashings: Vector[uint64, E.epochs_per_slashings_vector]

    class BeaconStateBase(_StateCommon):
        previous_epoch_attestations: List[
            PendingAttestation, E.max_attestations * E.slots_per_epoch
        ]
        current_epoch_attestations: List[
            PendingAttestation, E.max_attestations * E.slots_per_epoch
        ]
        justification_bits: Bitvector[E.justification_bits_length]
        previous_justified_checkpoint: Checkpoint
        current_justified_checkpoint: Checkpoint
        finalized_checkpoint: Checkpoint

    class _StateAltairCommon(_StateCommon):
        previous_epoch_participation: List[uint8, E.validator_registry_limit]
        current_epoch_participation: List[uint8, E.validator_registry_limit]
        justification_bits: Bitvector[E.justification_bits_length]
        previous_justified_checkpoint: Checkpoint
        current_justified_checkpoint: Checkpoint
        finalized_checkpoint: Checkpoint
        inactivity_scores: List[uint64, E.validator_registry_limit]
        current_sync_committee: SyncCommittee
        next_sync_committee: SyncCommittee

    class BeaconStateAltair(_StateAltairCommon):
        pass

    class BeaconStateMerge(_StateAltairCommon):
        latest_execution_payload_header: ExecutionPayloadHeaderMerge

    class BeaconStateCapella(_StateAltairCommon):
        latest_execution_payload_header: ExecutionPayloadHeaderCapella
        next_withdrawal_index: uint64
        next_withdrawal_validator_index: uint64
        historical_summaries: List[HistoricalSummary, E.historical_roots_limit]

    class BeaconStateDeneb(BeaconStateCapella):
        # Deneb adds no state fields here (the upstream payload-header
        # blob-gas fields ride the execution layer, which this repo
        # models structurally); the distinct class keeps fork dispatch
        # and upgrade hashing uniform.
        pass

    for cls, fork in (
        (BeaconStateBase, "base"),
        (BeaconStateAltair, "altair"),
        (BeaconStateMerge, "merge"),
        (BeaconStateCapella, "capella"),
        (BeaconStateDeneb, "deneb"),
    ):
        cls.fork_name = fork

    class LightClientBootstrap(Container):
        """Light-client boot record: requested header, the sync
        committee of its period, and the Merkle branch proving that
        committee against the header's state root (reference
        consensus/types/src/light_client_bootstrap.rs:24-31; served
        over req/resp per rpc/protocol.rs:177-179)."""
        header: BeaconBlockHeader
        current_sync_committee: SyncCommittee
        current_sync_committee_branch: Vector[
            Bytes32, 5  # CurrentSyncCommitteeProofLen (altair state: 2^5 fields)
        ]

    class LightClientFinalityUpdate(Container):
        """Finality proof for light clients: the sync-committee-signed
        attested header plus a Merkle branch from its state root down
        to the finalized checkpoint root (reference
        consensus/types/src/light_client_finality_update.rs; route
        GET /eth/v1/beacon/light_client/finality_update and the
        light_client_finality_update gossip topic)."""
        attested_header: BeaconBlockHeader
        finalized_header: BeaconBlockHeader
        finality_branch: Vector[
            Bytes32, 6  # FinalizedRootProofLen: 5 state fields + 1 in Checkpoint
        ]
        sync_aggregate: SyncAggregate
        signature_slot: uint64

    class LightClientOptimisticUpdate(Container):
        """Head-tracking record: attested header + the aggregate that
        signed it (reference
        consensus/types/src/light_client_optimistic_update.rs)."""
        attested_header: BeaconBlockHeader
        sync_aggregate: SyncAggregate
        signature_slot: uint64

    states = {
        "base": BeaconStateBase,
        "altair": BeaconStateAltair,
        "merge": BeaconStateMerge,
        "capella": BeaconStateCapella,
        "deneb": BeaconStateDeneb,
    }
    blocks = {
        "base": BeaconBlockBase,
        "altair": BeaconBlockAltair,
        "merge": BeaconBlockMerge,
        "capella": BeaconBlockCapella,
        "deneb": BeaconBlockDeneb,
    }
    signed_blocks = {
        "base": SignedBeaconBlockBase,
        "altair": SignedBeaconBlockAltair,
        "merge": SignedBeaconBlockMerge,
        "capella": SignedBeaconBlockCapella,
        "deneb": SignedBeaconBlockDeneb,
    }
    bodies = {
        "base": BeaconBlockBodyBase,
        "altair": BeaconBlockBodyAltair,
        "merge": BeaconBlockBodyMerge,
        "capella": BeaconBlockBodyCapella,
        "deneb": BeaconBlockBodyDeneb,
    }
    payloads = {
        "merge": ExecutionPayloadMerge,
        "capella": ExecutionPayloadCapella,
        "deneb": ExecutionPayloadCapella,  # deneb reuses the capella payload
    }
    payload_headers = {
        "merge": ExecutionPayloadHeaderMerge,
        "capella": ExecutionPayloadHeaderCapella,
        "deneb": ExecutionPayloadHeaderCapella,
    }

    return SimpleNamespace(
        preset=E,
        IndexedAttestation=IndexedAttestation,
        Attestation=Attestation,
        PendingAttestation=PendingAttestation,
        AttesterSlashing=AttesterSlashing,
        Deposit=Deposit,
        HistoricalBatch=HistoricalBatch,
        SyncCommittee=SyncCommittee,
        LightClientBootstrap=LightClientBootstrap,
        LightClientFinalityUpdate=LightClientFinalityUpdate,
        LightClientOptimisticUpdate=LightClientOptimisticUpdate,
        SyncAggregate=SyncAggregate,
        SyncCommitteeContribution=SyncCommitteeContribution,
        ContributionAndProof=ContributionAndProof,
        SignedContributionAndProof=SignedContributionAndProof,
        AggregateAndProof=AggregateAndProof,
        SignedAggregateAndProof=SignedAggregateAndProof,
        Transaction=Transaction,
        ExecutionPayloadMerge=ExecutionPayloadMerge,
        ExecutionPayloadCapella=ExecutionPayloadCapella,
        ExecutionPayloadHeaderMerge=ExecutionPayloadHeaderMerge,
        ExecutionPayloadHeaderCapella=ExecutionPayloadHeaderCapella,
        BeaconBlockBodyBase=BeaconBlockBodyBase,
        BeaconBlockBodyAltair=BeaconBlockBodyAltair,
        BeaconBlockBodyMerge=BeaconBlockBodyMerge,
        BeaconBlockBodyCapella=BeaconBlockBodyCapella,
        BeaconBlockBodyDeneb=BeaconBlockBodyDeneb,
        BeaconBlockBase=BeaconBlockBase,
        BeaconBlockAltair=BeaconBlockAltair,
        BeaconBlockMerge=BeaconBlockMerge,
        BeaconBlockCapella=BeaconBlockCapella,
        BeaconBlockDeneb=BeaconBlockDeneb,
        SignedBeaconBlockBase=SignedBeaconBlockBase,
        SignedBeaconBlockAltair=SignedBeaconBlockAltair,
        SignedBeaconBlockMerge=SignedBeaconBlockMerge,
        SignedBeaconBlockCapella=SignedBeaconBlockCapella,
        SignedBeaconBlockDeneb=SignedBeaconBlockDeneb,
        BeaconStateBase=BeaconStateBase,
        BeaconStateAltair=BeaconStateAltair,
        BeaconStateMerge=BeaconStateMerge,
        BeaconStateCapella=BeaconStateCapella,
        BeaconStateDeneb=BeaconStateDeneb,
        BlobSidecar=BlobSidecar,
        states=states,
        blocks=blocks,
        signed_blocks=signed_blocks,
        bodies=bodies,
        payloads=payloads,
        payload_headers=payload_headers,
    )


def mainnet_types() -> SimpleNamespace:
    return SpecTypes(MAINNET)
