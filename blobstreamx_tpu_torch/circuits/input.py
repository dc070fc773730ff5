"""Witness input layer for the data-commitment circuits — the port's copy of
``DataCommitmentInputs``, ``InputDataFetcher`` and ``flatten_inputs`` from
``blobstreamx_tpu/circuits/input.py`` (parity with reference
circuits/input.rs, R6). Fixture mode reads the reference's JSON formats
(``{fixture_path}/{height}/header.json``,
``{fixture_path}/{start}-{end}/data_commitment.json``); the fixture
directory is an argument. The repository records one under
``blobstreamx_tpu/fixtures/mocha-4``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..tendermint.header import Header
from . import consts


@dataclass
class DataCommitmentInputs:
    start_header_hash: bytes
    end_header_hash: bytes
    data_hash_proofs: List[Tuple[bytes, List[bytes]]]  # (leaf, aunts)
    last_block_id_proofs: List[Tuple[bytes, List[bytes]]]
    expected_data_commitment: Optional[bytes]


class InputDataFetcher:
    """Fixture-backed witness acquisition: headers and data commitments
    read from ``fixture_path``."""

    def __init__(self, fixture_path: str):
        if not os.path.isdir(fixture_path):
            raise FileNotFoundError(f"no fixture directory at {fixture_path}")
        self.fixture_path = fixture_path
        self._header_cache: Dict[int, Header] = {}

    def get_header(self, height: int) -> Header:
        if height not in self._header_cache:
            with open(os.path.join(self.fixture_path, str(height), "header.json")) as f:
                data = json.load(f)["result"]["header"]
            self._header_cache[height] = Header.from_json(data)
        return self._header_cache[height]

    def get_data_commitment(self, start: int, end: int) -> Optional[bytes]:
        path = os.path.join(
            self.fixture_path, f"{start}-{end}", "data_commitment.json"
        )
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return bytes.fromhex(json.load(f)["result"]["data_commitment"])

    def get_data_commitment_inputs(
        self, start_block: int, end_block: int, max_leaves: int
    ) -> DataCommitmentInputs:
        """Reference circuits/input.rs:149-271 (fixture branch): data-hash
        proofs for [start, end-1], last-block-id proofs for [start+1, end],
        zero-padded to max_leaves."""
        assert end_block - start_block <= max_leaves
        zero32 = bytes(32)
        dummy_hash = (bytes(consts.PROTOBUF_HASH_SIZE_BYTES),
                      [zero32] * consts.HEADER_PROOF_DEPTH)
        dummy_block_id = (bytes(consts.PROTOBUF_BLOCK_ID_SIZE_BYTES),
                          [zero32] * consts.HEADER_PROOF_DEPTH)
        if end_block <= start_block:
            return DataCommitmentInputs(zero32, zero32, [dummy_hash] * max_leaves,
                                        [dummy_block_id] * max_leaves, None)
        data_hash_proofs = [self.get_header(h).data_hash_proof()
                            for h in range(start_block, end_block)]
        last_block_id_proofs = [self.get_header(h).last_block_id_proof()
                                for h in range(start_block + 1, end_block + 1)]
        pad = max_leaves - len(data_hash_proofs)
        return DataCommitmentInputs(
            start_header_hash=self.get_header(start_block).hash(),
            end_header_hash=self.get_header(end_block).hash(),
            data_hash_proofs=data_hash_proofs + [dummy_hash] * pad,
            last_block_id_proofs=last_block_id_proofs + [dummy_block_id] * pad,
            expected_data_commitment=self.get_data_commitment(start_block, end_block),
        )


def flatten_inputs(inp: DataCommitmentInputs) -> List[int]:
    """Byte list matching vars.proof_wires fill order."""
    out = list(inp.start_header_hash) + list(inp.end_header_hash)
    for leaf, aunts in inp.data_hash_proofs + inp.last_block_id_proofs:
        out += list(leaf)
        for a in aunts:
            out += list(a)
    return out
