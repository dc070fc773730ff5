"""Data-commitment circuit gadgets — parity with reference circuits/builder.rs (R4)
plus the tendermint merkle gadgets it pulls from plonky2x (SURVEY.md D12).
The port's copy of ``blobstreamx_tpu/circuits/builder.py``.

All functions extend the frontend CircuitBuilder (passed explicitly — the
python analogue of the reference's extension-trait pattern).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..frontend.builder import (
    BoolVariable,
    Bytes32Variable,
    BytesVariable,
    ByteVariable,
    CircuitBuilder,
    U32Variable,
    U64Variable,
    Variable,
)
from . import consts
from .vars import DataCommitmentProofVariable, MapReduceSubchainVariable


# ---------------------------------------------------------------------------
# tendermint merkle gadgets (D12)
# ---------------------------------------------------------------------------

def leaf_hash(b: CircuitBuilder, data: Sequence[ByteVariable]) -> Bytes32Variable:
    """sha256(0x00 || data)."""
    return b.sha256([b.byte_constant(0)] + list(data))


def inner_hash(b: CircuitBuilder, left: Bytes32Variable, right: Bytes32Variable) -> Bytes32Variable:
    """sha256(0x01 || left || right)."""
    return b.sha256([b.byte_constant(1)] + list(left.bytes) + list(right.bytes))


def get_root_from_merkle_proof(
    b: CircuitBuilder,
    leaf: BytesVariable,
    aunts: List[Bytes32Variable],
    path: Sequence[bool],
) -> Bytes32Variable:
    """Fixed-depth inclusion-proof root (static path bits).

    Reference circuits/builder.rs:189-199 usage; path bit i says whether the
    running node is the right child at level i.
    """
    node = leaf_hash(b, leaf.bytes)
    for bit, aunt in zip(path, aunts):
        if bit:
            node = inner_hash(b, aunt, node)
        else:
            node = inner_hash(b, node, aunt)
    return node


def compute_root_from_leaves(
    b: CircuitBuilder,
    leaves: List[BytesVariable],
    nb_enabled: U32Variable,
) -> Bytes32Variable:
    """Variable-leaf-count Tendermint root over fixed power-of-two slots.

    Pass-through reduction (a node whose right half is disabled forwards its
    left child) — equals RFC6962/celestia-core HashFromByteSlices for any
    enabled count (native model: tendermint/merkle.py root_from_enabled_leaves).
    """
    n_slots = len(leaves)
    assert n_slots & (n_slots - 1) == 0
    nodes = [leaf_hash(b, leaf.bytes) for leaf in leaves]
    enabled = [
        b.u32_lt(U32Variable(b.constant(i).wire), nb_enabled) for i in range(n_slots)
    ]
    while len(nodes) > 1:
        next_nodes, next_enabled = [], []
        for i in range(0, len(nodes), 2):
            combined = inner_hash(b, nodes[i], nodes[i + 1])
            next_nodes.append(b.select_bytes32(enabled[i + 1], combined, nodes[i]))
            next_enabled.append(enabled[i])
        nodes, enabled = next_nodes, next_enabled
    return nodes[0]


# ---------------------------------------------------------------------------
# data-commitment builder (R4)
# ---------------------------------------------------------------------------

def encode_data_root_tuple(
    b: CircuitBuilder, data_hash: Bytes32Variable, height: U64Variable
) -> BytesVariable:
    """abi.encode(height, data_hash): 24 zero bytes || 8 BE height bytes ||
    32 data-hash bytes. Reference circuits/builder.rs:82-103."""
    zero = b.byte_constant(0)
    height_bytes = b.u64_to_be_bytes(height)
    return BytesVariable([zero] * 24 + height_bytes + list(data_hash.bytes))


def get_data_commitment(
    b: CircuitBuilder,
    data_hashes: List[Bytes32Variable],
    start_block: U64Variable,
    end_block: U64Variable,
) -> Bytes32Variable:
    """Reference circuits/builder.rs:105-148."""
    max_leaves = len(data_hashes)
    gte = b.u64_gte(end_block, start_block)
    b.assert_is_equal(Variable(gte.wire), b.one())
    nb_blocks = b.u64_sub(end_block, start_block)
    # constrain the high limb to zero (< 2^32 blocks; builder.rs:127-128)
    b.assert_is_equal(Variable(nb_blocks.hi.wire), b.zero())
    nb_enabled = nb_blocks.lo

    leaves = []
    for i in range(max_leaves):
        height = b.u64_add_const(start_block, i)
        leaves.append(encode_data_root_tuple(b, data_hashes[i], height))
    return compute_root_from_leaves(b, leaves, nb_enabled)


def prove_subchain(
    b: CircuitBuilder,
    proof: DataCommitmentProofVariable,
    batch_start_block: U64Variable,
    batch_end_block: U64Variable,
    global_end_block: U64Variable,
    global_end_header_hash: Bytes32Variable,
) -> MapReduceSubchainVariable:
    """Header-chain linkage + batch data root. Reference circuits/builder.rs:150-271."""
    batch_size = len(proof.data_hash_proofs)
    true_bool = b._true()

    is_batch_enabled = b.u64_lt(batch_start_block, global_end_block)
    curr_block_enabled = is_batch_enabled
    curr_header = proof.start_header
    last_block_to_process = b.u64_sub(global_end_block, b.u64_constant(1))

    for i in range(batch_size):
        curr_idx = b.u64_add_const(batch_start_block, i)
        curr_block_disabled = b.not_(curr_block_enabled)
        is_last_block = b.u64_is_equal(last_block_to_process, curr_idx)
        is_not_last_block = b.not_(is_last_block)

        data_hash_proof_root = get_root_from_merkle_proof(
            b, proof.data_hash_proofs[i].leaf, proof.data_hash_proofs[i].aunts,
            consts.DATA_HASH_PATH,
        )
        last_block_id_proof_root = get_root_from_merkle_proof(
            b, proof.last_block_id_proofs[i].leaf, proof.last_block_id_proofs[i].aunts,
            consts.LAST_BLOCK_ID_PATH,
        )

        # header hash of block curr_idx from the last_block_id leaf [2..34]
        header_hash = Bytes32Variable(
            tuple(proof.last_block_id_proofs[i].leaf.bytes[2:2 + consts.HASH_SIZE])
        )
        is_valid_prev_header = b.is_equal_bytes32(curr_header, header_hash)
        prev_header_check = b.or_(curr_block_disabled, is_valid_prev_header)
        b.assert_is_equal(Variable(prev_header_check.wire), Variable(true_bool.wire))

        is_data_hash_proof_valid = b.is_equal_bytes32(data_hash_proof_root, header_hash)
        data_hash_check = b.or_(curr_block_disabled, is_data_hash_proof_valid)
        b.assert_is_equal(Variable(data_hash_check.wire), Variable(true_bool.wire))

        root_matches_end_header = b.is_equal_bytes32(
            last_block_id_proof_root, global_end_header_hash
        )
        end_header_check = b.or_(is_not_last_block, root_matches_end_header)
        b.assert_is_equal(Variable(end_header_check.wire), Variable(true_bool.wire))

        curr_header = b.select_bytes32(
            curr_block_enabled, last_block_id_proof_root, curr_header
        )
        curr_block_enabled = b.and_(curr_block_enabled, is_not_last_block)

    is_last_block_disabled = b.not_(curr_block_enabled)
    last_block_matches = b.is_equal_bytes32(curr_header, proof.end_header)
    end_check = b.or_(is_last_block_disabled, last_block_matches)
    b.assert_is_equal(Variable(end_check.wire), Variable(true_bool.wire))

    # end block of this batch's data root: max(start, min(batch_end, global_end))
    is_batch_end_lt_global = b.u64_lt(batch_end_block, global_end_block)
    temp_end = b.select_u64(is_batch_end_lt_global, batch_end_block, global_end_block)
    is_end_lt_start = b.u64_lt(temp_end, batch_start_block)
    end_block_num = b.select_u64(is_end_lt_start, batch_start_block, temp_end)

    data_hashes = [
        Bytes32Variable(tuple(p.leaf.bytes[2:2 + consts.HASH_SIZE]))
        for p in proof.data_hash_proofs
    ]
    data_merkle_root = get_data_commitment(b, data_hashes, batch_start_block, end_block_num)

    return MapReduceSubchainVariable(
        is_enabled=is_batch_enabled,
        start_block=batch_start_block,
        start_header=proof.start_header,
        end_block=end_block_num,
        end_header=curr_header,
        data_merkle_root=data_merkle_root,
    )


def reduce_subchains(
    b: CircuitBuilder,
    left: MapReduceSubchainVariable,
    right: MapReduceSubchainVariable,
) -> MapReduceSubchainVariable:
    """Reference reduce closure (circuits/builder.rs:337-395)."""
    true_var = b._true()
    is_right_disabled = b.not_(right.is_enabled)

    headers_linked = b.is_equal_bytes32(left.end_header, right.start_header)
    blocks_linked = b.u64_is_equal(left.end_block, right.start_block)
    linked = b.and_(headers_linked, blocks_linked)
    link_check = b.or_(is_right_disabled, linked)
    b.assert_is_equal(Variable(link_check.wire), Variable(true_var.wire))

    combined = inner_hash(b, left.data_merkle_root, right.data_merkle_root)
    data_merkle_root = b.select_bytes32(is_right_disabled, left.data_merkle_root, combined)
    end_block = b.select_u64(is_right_disabled, left.end_block, right.end_block)
    end_header = b.select_bytes32(is_right_disabled, left.end_header, right.end_header)

    return MapReduceSubchainVariable(
        is_enabled=left.is_enabled,
        start_block=left.start_block,
        start_header=left.start_header,
        end_block=end_block,
        end_header=end_header,
        data_merkle_root=data_merkle_root,
    )


def prove_data_commitment_inline(
    b: CircuitBuilder,
    proofs: List[DataCommitmentProofVariable],
    start_block: U64Variable,
    start_header_hash: Bytes32Variable,
    end_block: U64Variable,
    end_header_hash: Bytes32Variable,
    batch_size: int,
) -> Bytes32Variable:
    """prove_data_commitment with the map/reduce tree evaluated inline in a
    single circuit (the small-config equivalent of the reference's
    mapreduce recursion tree, circuits/builder.rs:273-409; distributed
    recursive aggregation is the parallel/ milestone)."""
    nb_jobs = len(proofs)
    max_blocks = nb_jobs * batch_size
    lte = b.u64_lte(end_block, b.u64_add_const(start_block, max_blocks))
    b.assert_is_equal(Variable(lte.wire), b.one())

    subchains = []
    for j, proof in enumerate(proofs):
        batch_start = b.u64_add_const(start_block, j * batch_size)
        batch_end = b.u64_add_const(start_block, (j + 1) * batch_size)
        subchains.append(
            prove_subchain(
                b, proof, batch_start, batch_end, end_block, end_header_hash
            )
        )
    while len(subchains) > 1:
        nxt = []
        for i in range(0, len(subchains), 2):
            nxt.append(reduce_subchains(b, subchains[i], subchains[i + 1]))
        subchains = nxt
    result = subchains[0]

    b.assert_is_equal(Variable(result.start_block.lo.wire), Variable(start_block.lo.wire))
    b.assert_is_equal(Variable(result.start_block.hi.wire), Variable(start_block.hi.wire))
    b.assert_bytes32_equal(result.start_header, start_header_hash)
    b.assert_is_equal(Variable(result.end_block.lo.wire), Variable(end_block.lo.wire))
    b.assert_is_equal(Variable(result.end_block.hi.wire), Variable(end_block.hi.wire))
    b.assert_bytes32_equal(result.end_header, end_header_hash)
    return result.data_merkle_root


def prove_next_header_data_commitment(
    b: CircuitBuilder,
    proof: DataCommitmentProofVariable,
    prev_block: U64Variable,
    prev_header_hash: Bytes32Variable,
) -> Bytes32Variable:
    """1-leaf special case. Reference circuits/builder.rs:411-443."""
    root = get_root_from_merkle_proof(
        b, proof.data_hash_proofs[0].leaf, proof.data_hash_proofs[0].aunts,
        consts.DATA_HASH_PATH,
    )
    b.assert_bytes32_equal(root, prev_header_hash)
    data_hash = Bytes32Variable(
        tuple(proof.data_hash_proofs[0].leaf.bytes[2:2 + consts.HASH_SIZE])
    )
    encoded = encode_data_root_tuple(b, data_hash, prev_block)
    return leaf_hash(b, encoded.bytes)
