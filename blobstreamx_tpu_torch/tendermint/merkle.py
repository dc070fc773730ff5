"""Tendermint (RFC 6962) binary Merkle tree — native host implementation.

A copy of ``blobstreamx_tpu/tendermint/merkle.py``. Capability parity with
the reference's tendermint merkle gadget inputs
(SURVEY.md D12; plonky2x ``frontend::merkle::tendermint`` used by reference
circuits/builder.rs:144-147,189-199,442) and with celestia-core's
``merkle.HashFromByteSlices`` / ``SimpleProof`` used to produce the golden
``data_commitment.json`` fixtures.

  leaf_hash(x)  = sha256(0x00 || x)
  inner_hash(l, r) = sha256(0x01 || l || r)
  root over n items: split at the largest power of two < n, recurse.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def leaf_hash(data: bytes) -> bytes:
    return hashlib.sha256(LEAF_PREFIX + data).digest()


def inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(INNER_PREFIX + left + right).digest()


def split_point(n: int) -> int:
    """Largest power of two strictly less than n (n >= 2)."""
    assert n >= 2
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return leaf_hash(items[0])
    k = split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]), hash_from_byte_slices(items[k:]))


def proofs_from_byte_slices(items: Sequence[bytes]) -> Tuple[bytes, List[List[bytes]]]:
    """Root + per-leaf inclusion proofs (aunts ordered leaf -> root)."""
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest(), []
    if n == 1:
        return leaf_hash(items[0]), [[]]
    k = split_point(n)
    lroot, lproofs = proofs_from_byte_slices(items[:k])
    rroot, rproofs = proofs_from_byte_slices(items[k:])
    root = inner_hash(lroot, rroot)
    proofs = [p + [rroot] for p in lproofs] + [p + [lroot] for p in rproofs]
    return root, proofs


def verify_inclusion(root: bytes, leaf: bytes, index: int, aunts: Sequence[bytes]) -> bool:
    """Verify with complete-tree path bits derived from the leaf index.

    Matches the in-circuit ``get_root_from_merkle_proof`` consumption model
    (reference circuits/builder.rs:189-199): bit i of ``index`` (LSB first)
    says whether the current node is a right child at level i.
    """
    h = leaf_hash(leaf)
    for i, aunt in enumerate(aunts):
        if (index >> i) & 1:
            h = inner_hash(aunt, h)
        else:
            h = inner_hash(h, aunt)
    return h == root


def root_from_enabled_leaves(leaves: Sequence[bytes], nb_enabled: int) -> bytes:
    """Variable-size root over a fixed power-of-two leaf slot count.

    Native model of plonky2x's ``compute_root_from_leaves`` (reference
    circuits/builder.rs:144-147): hash all slots, then reduce a complete
    binary tree where a node whose right child holds no enabled leaves
    passes its left child through unchanged. For nb_enabled = n this equals
    ``hash_from_byte_slices(leaves[:n])`` for any power-of-two slot count.
    """
    n_slots = len(leaves)
    assert n_slots & (n_slots - 1) == 0 and n_slots > 0
    assert 0 < nb_enabled <= n_slots
    nodes = [leaf_hash(l) for l in leaves]
    enabled = [i < nb_enabled for i in range(n_slots)]
    while len(nodes) > 1:
        next_nodes, next_enabled = [], []
        for i in range(0, len(nodes), 2):
            l_en, r_en = enabled[i], enabled[i + 1]
            if r_en:
                next_nodes.append(inner_hash(nodes[i], nodes[i + 1]))
            else:
                next_nodes.append(nodes[i])
            next_enabled.append(l_en)
        nodes, enabled = next_nodes, next_enabled
    return nodes[0]
