"""Witness variable structs — parity with reference circuits/vars.rs (R3); the
port's copy of ``blobstreamx_tpu/circuits/vars.py``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..frontend.builder import Bytes32Variable, BytesVariable, CircuitBuilder, U64Variable
from . import consts


@dataclass
class MerkleInclusionProofVariable:
    """leaf bytes (34 or 72) + HEADER_PROOF_DEPTH aunt hashes."""

    leaf: BytesVariable
    aunts: List[Bytes32Variable]


@dataclass
class DataCommitmentProofVariable:
    """Reference circuits/vars.rs:15-26."""

    start_header: Bytes32Variable
    end_header: Bytes32Variable
    data_hash_proofs: List[MerkleInclusionProofVariable]  # MAX_LEAVES, 34-byte leaves
    last_block_id_proofs: List[MerkleInclusionProofVariable]  # MAX_LEAVES, 72-byte leaves


@dataclass
class MapReduceSubchainVariable:
    """Reference circuits/vars.rs:29-36."""

    is_enabled: object  # BoolVariable
    start_block: U64Variable
    start_header: Bytes32Variable
    end_block: U64Variable
    end_header: Bytes32Variable
    data_merkle_root: Bytes32Variable


def alloc_bytes(b: CircuitBuilder, n: int) -> BytesVariable:
    return BytesVariable([b.free_byte() for _ in range(n)])


def alloc_bytes32(b: CircuitBuilder) -> Bytes32Variable:
    return Bytes32Variable(tuple(b.free_byte() for _ in range(32)))


def alloc_inclusion_proof(b: CircuitBuilder, leaf_size: int) -> MerkleInclusionProofVariable:
    return MerkleInclusionProofVariable(
        leaf=alloc_bytes(b, leaf_size),
        aunts=[alloc_bytes32(b) for _ in range(consts.HEADER_PROOF_DEPTH)],
    )


def alloc_data_commitment_proof(b: CircuitBuilder, max_leaves: int) -> DataCommitmentProofVariable:
    return DataCommitmentProofVariable(
        start_header=alloc_bytes32(b),
        end_header=alloc_bytes32(b),
        data_hash_proofs=[
            alloc_inclusion_proof(b, consts.PROTOBUF_HASH_SIZE_BYTES)
            for _ in range(max_leaves)
        ],
        last_block_id_proofs=[
            alloc_inclusion_proof(b, consts.PROTOBUF_BLOCK_ID_SIZE_BYTES)
            for _ in range(max_leaves)
        ],
    )


def proof_wires(p: DataCommitmentProofVariable) -> List[int]:
    """Flattened wire list (fill order for the witness hint)."""
    wires = [x.wire for x in p.start_header.bytes]
    wires += [x.wire for x in p.end_header.bytes]
    for ip in p.data_hash_proofs:
        wires += [x.wire for x in ip.leaf.bytes]
        for a in ip.aunts:
            wires += [x.wire for x in a.bytes]
    for ip in p.last_block_id_proofs:
        wires += [x.wire for x in ip.leaf.bytes]
        for a in ip.aunts:
            wires += [x.wire for x in a.bytes]
    return wires
