"""Merkle-cap vector commitments over Poseidon.

Counterpart of ``blobstreamx_tpu/proof/merkle_cap.py``. A commitment to a
``(n_leaves, leaf_width)`` matrix is the list of 2^cap_height digests at
depth log2(n) - cap_height. The tree is built level by level on the
leaves' device: one sponge call hashes every leaf row, then each level is
one call over the pairs of the level below (on the card, every call is the
Poseidon kernel). The layers are then copied to the host, where openings
read them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..field import goldilocks as gl
from ..ops import poseidon as pos


@dataclass
class MerkleTree:
    """layers[0] is the leaf-digest layer (n, 4) uint64; layers[-1] is the
    cap (2^cap_height, 4)."""

    layers: List[np.ndarray]
    cap_height: int

    @property
    def cap(self) -> np.ndarray:
        return self.layers[-1]

    def cap_ints(self) -> list:
        """Cap digests as python int lists (for the transcript)."""
        return [[int(v) for v in d] for d in self.cap]

    def open(self, index: int) -> List[list]:
        """Sibling digests (python ints) from leaf level up to the cap."""
        out = []
        idx = index
        for layer in self.layers[:-1]:
            out.append([int(v) for v in layer[idx ^ 1]])
            idx >>= 1
        return out


def build_tree(leaves: torch.Tensor, cap_height: int = 0) -> MerkleTree:
    """leaves: (n, w) int64 rows, row-major or the transpose of a row-major
    matrix; n a power of two >= 2^cap_height."""
    n = leaves.shape[0]
    log_n = n.bit_length() - 1
    if 1 << log_n != n or cap_height > log_n:
        raise ValueError(f"cannot build a cap of height {cap_height} over {n} leaves")
    dev = leaves.device
    cur = pos.hash_no_pad(leaves, dev)  # (n, 4)
    layers = [cur]
    for _ in range(log_n - cap_height):
        # sibling digests 2i, 2i+1 are adjacent rows: the (m/2, 8) view is
        # left || right, which hash_two_to_one absorbs as one sponge block
        cur = pos.hash_no_pad(cur.reshape(-1, 2 * pos.DIGEST), dev)
        layers.append(cur)
    return MerkleTree(layers=[gl.to_int(l) for l in layers], cap_height=cap_height)


def verify_opening(leaf_row, index: int, siblings, cap) -> bool:
    """Recompute the path from a leaf row (python ints) to the cap, on the
    host."""
    digest = pos.hash_no_pad_py([int(v) for v in leaf_row])
    idx = index
    for sib in siblings:
        sib = [int(v) for v in sib]
        if idx & 1:
            digest = pos.hash_two_to_one_py(sib, digest)
        else:
            digest = pos.hash_two_to_one_py(digest, sib)
        idx >>= 1
    return digest == [int(v) for v in cap[idx]]
