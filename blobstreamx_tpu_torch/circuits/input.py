"""Witness input layer — the port's copy of
``blobstreamx_tpu/circuits/input.py`` (parity with reference
circuits/input.rs, R6, and the tendermintx step and skip fetchers, D16).
Fixture mode reads the reference's JSON formats
(``{fixture_path}/{height}/header.json``,
``{fixture_path}/{height}/signed_block.json``,
``{fixture_path}/{start}-{end}/data_commitment.json``); the fixture
directory is an argument. The repository records one under
``blobstreamx_tpu/fixtures/mocha-4``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..tendermint import vote as tvote
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


@dataclass
class StepValidatorInput:
    pubkey: bytes
    power: int
    signed: bool
    signature: bytes          # 64 bytes (zero when unsigned)
    msg: bytes                # canonical sign-bytes (empty when unsigned)


@dataclass
class StepInputs:
    """Witness data to advance prev_block -> prev_block + 1 (D13)."""

    leaves: List[bytes]                      # 14 encoded header fields
    validators: List[StepValidatorInput]     # padded to VSS
    nb_validators: int
    next_val_proof: Tuple[bytes, List[bytes]]   # prev header, field index 8
    next_header_hash: bytes


class StepInputFetcher(InputDataFetcher):
    """Fixture-backed witness acquisition for the step circuit (reads the
    reference signed_block.json format)."""

    def get_signed_block(self, height: int) -> dict:
        with open(os.path.join(self.fixture_path, str(height), "signed_block.json")) as f:
            return json.load(f)["result"]

    def get_step_inputs(self, prev_block: int, vss: int) -> StepInputs:
        blk = self.get_signed_block(prev_block + 1)
        header = Header.from_json(blk["header"])
        commit = tvote.Commit.from_json(blk["commit"])
        vals = [tvote.Validator.from_json(v) for v in blk["validator_set"]["validators"]]
        assert len(vals) <= vss
        chain_id = blk["header"]["chain_id"]
        valid = tvote.verify_commit(commit, vals, chain_id)
        by_addr = {s.validator_address: i for i, s in enumerate(commit.signatures)}
        validators: List[StepValidatorInput] = []
        for v in vals:
            si = by_addr.get(v.address)
            signed = si is not None and valid[si]
            validators.append(StepValidatorInput(
                pubkey=v.pub_key,
                power=v.voting_power,
                signed=signed,
                signature=commit.signatures[si].signature if signed else bytes(64),
                msg=commit.vote_sign_bytes(chain_id, si) if signed else b"",
            ))
        while len(validators) < vss:
            validators.append(StepValidatorInput(bytes(32), 0, False, bytes(64), b""))
        prev = self.get_header(prev_block)
        return StepInputs(
            leaves=header.field_bytes(),
            validators=validators,
            nb_validators=len(vals),
            next_val_proof=prev.inclusion_proof(8),
            next_header_hash=header.hash(),
        )


@dataclass
class SkipInputs:
    """Witness data to skip trusted_block -> target_block (D14)."""

    target_leaves: List[bytes]
    target_validators: List[StepValidatorInput]
    nb_target: int
    trusted_validators: List[StepValidatorInput]  # signed = counts to overlap
    nb_trusted: int
    overlap_indices: List[int]  # per trusted slot: index into target set
    trusted_val_proof: Tuple[bytes, List[bytes]]  # validators_hash, index 7
    target_header_hash: bytes


class SkipInputFetcher(StepInputFetcher):
    def get_skip_inputs(self, trusted_block: int, target_block: int,
                        vss: int) -> SkipInputs:
        blk = self.get_signed_block(target_block)
        header = Header.from_json(blk["header"])
        commit = tvote.Commit.from_json(blk["commit"])
        tvals = [tvote.Validator.from_json(v) for v in blk["validator_set"]["validators"]]
        chain_id = blk["header"]["chain_id"]
        valid = tvote.verify_commit(commit, tvals, chain_id)
        by_addr = {s.validator_address: i for i, s in enumerate(commit.signatures)}
        target_validators: List[StepValidatorInput] = []
        signed_by_pk: Dict[bytes, int] = {}
        for ti, v in enumerate(tvals):
            si = by_addr.get(v.address)
            signed = si is not None and valid[si]
            if signed:
                signed_by_pk[v.pub_key] = ti
            target_validators.append(StepValidatorInput(
                pubkey=v.pub_key, power=v.voting_power, signed=signed,
                signature=commit.signatures[si].signature if signed else bytes(64),
                msg=commit.vote_sign_bytes(chain_id, si) if signed else b"",
            ))
        while len(target_validators) < vss:
            target_validators.append(StepValidatorInput(bytes(32), 0, False, bytes(64), b""))

        tblk = self.get_signed_block(trusted_block)
        trvals = [tvote.Validator.from_json(v) for v in tblk["validator_set"]["validators"]]
        trusted_validators: List[StepValidatorInput] = []
        overlap_indices: List[int] = []
        for v in trvals:
            ti = signed_by_pk.get(v.pub_key)
            trusted_validators.append(StepValidatorInput(
                pubkey=v.pub_key, power=v.voting_power,
                signed=ti is not None, signature=bytes(64), msg=b"",
            ))
            overlap_indices.append(ti if ti is not None else 0)
        while len(trusted_validators) < vss:
            trusted_validators.append(StepValidatorInput(bytes(32), 0, False, bytes(64), b""))
            overlap_indices.append(0)

        trusted = self.get_header(trusted_block)
        return SkipInputs(
            target_leaves=header.field_bytes(),
            target_validators=target_validators,
            nb_target=len(tvals),
            trusted_validators=trusted_validators,
            nb_trusted=len(trvals),
            overlap_indices=overlap_indices,
            trusted_val_proof=trusted.inclusion_proof(7),
            target_header_hash=header.hash(),
        )


def flatten_inputs(inp: DataCommitmentInputs) -> List[int]:
    """Byte list matching vars.proof_wires fill order."""
    out = list(inp.start_header_hash) + list(inp.end_header_hash)
    for leaf, aunts in inp.data_hash_proofs + inp.last_block_id_proofs:
        out += list(leaf)
        for a in aunts:
            out += list(a)
    return out
