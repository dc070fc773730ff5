"""NextHeaderCircuit — parity with reference circuits/next_header.rs (R9)
plus the tendermintx step circuit it calls (SURVEY.md D13). The port's
copy of ``blobstreamx_tpu/circuits/next_header.py``.

evm_read(prev_block, prev_header_hash) ->
  step: recompute the next header hash from its 14 protobuf field leaves,
  check linkage (last_block_id -> prev header, validators_hash ->
  prev.next_validators_hash), verify >=2/3 of the new validator set's
  Ed25519 precommits over the canonical vote message, and
  prove_next_header_data_commitment ->
evm_write(next_header_hash, data_commitment).

Assumptions vs the reference (documented in circuits/tendermint.py):
round 0 precommits, part counts < 128, heights and voting powers < 2^32.
"""

from __future__ import annotations

from typing import Dict

from ..frontend.builder import CircuitBuilder, CompiledCircuit, Variable
from . import builder as dc
from . import consts
from . import tendermint as tm
from .input import StepInputFetcher, flatten_inputs
from .vars import alloc_bytes, alloc_bytes32, alloc_data_commitment_proof, proof_wires


class NextHeaderCircuit:
    """Small-config combined step circuit."""

    def __init__(self, chain_id: str = "mocha-4", vss: int = 2,
                 fetcher: StepInputFetcher = None, ed_nbits=None):
        if fetcher is None:
            raise ValueError("a StepInputFetcher over a fixture directory is required")
        assert vss & (vss - 1) == 0, "validator slots must be a power of two"
        self.chain_id = chain_id
        self.vss = vss
        self.fetcher = fetcher
        self.msg_min, self.msg_max = tm.vote_msg_bounds(chain_id)
        self._define(ed_nbits)

    def _define(self, ed_nbits):
        b = CircuitBuilder()
        if ed_nbits is not None:
            b.ed_nbits = ed_nbits
        chain_id, vss = self.chain_id, self.vss
        prev_block = b.evm_read_u64()
        prev_header = b.evm_read_bytes32()

        leaves, leaf_wires = tm.alloc_header_leaves(b, chain_id)
        validators, val_aux, nb_validators, val_wires = tm.alloc_validator_set(
            b, vss, self.msg_max
        )
        nv_leaf = alloc_bytes(b, consts.PROTOBUF_HASH_SIZE_BYTES)
        nv_aunts = [alloc_bytes32(b) for _ in range(consts.HEADER_PROOF_DEPTH)]
        wires = leaf_wires + val_wires + [x.wire for x in nv_leaf.bytes]
        for a in nv_aunts:
            wires += [x.wire for x in a.bytes]

        fetcher, msg_max, msg_min = self.fetcher, self.msg_max, self.msg_min

        def fetch(vals, _n=len(wires)):
            prev = vals[0] | (vals[1] << 32)
            inp = fetcher.get_step_inputs(prev, vss)
            out = tm.flatten_header_leaves(inp.leaves)
            out += tm.flatten_validator_set(
                inp.validators, inp.nb_validators, msg_max, msg_min
            )
            leaf, aunts = inp.next_val_proof
            out += list(leaf)
            for a in aunts:
                out += list(a)
            assert len(out) == _n, (len(out), _n)
            return out

        b.hint_into([prev_block.lo, prev_block.hi], wires, fetch)

        # --- header hash + linkage ---------------------------------------
        height = b.u64_add_const(prev_block, 1)
        new_header_hash = tm.hash_header(b, leaves)
        tm.bind_height_leaf(b, leaves, height)

        # last_block_id leaf [2..34] == prev header hash
        lbi = leaves[tm.LAST_BLOCK_ID_LEAF]
        for j in range(32):
            b.assert_is_equal(
                Variable(lbi.data[2 + j].wire), Variable(prev_header.bytes[j].wire)
            )

        tm.bind_validators_hash_leaf(b, leaves, validators, nb_validators)

        # prev.next_validators_hash == new validators_hash
        nv_root = dc.get_root_from_merkle_proof(
            b, nv_leaf, nv_aunts, consts.NEXT_VALIDATORS_PATH
        )
        b.assert_bytes32_equal(nv_root, prev_header)
        vh_leaf = leaves[tm.VALIDATORS_HASH_LEAF]
        for j in range(32):
            b.assert_is_equal(
                Variable(nv_leaf.bytes[2 + j].wire), Variable(vh_leaf.data[2 + j].wire)
            )

        # --- votes + quorum ----------------------------------------------
        tm.verify_commit_votes(
            b, validators, val_aux, height, new_header_hash, chain_id
        )
        tm.assert_power_quorum(b, validators, numerator=2, denominator=3)

        # --- data commitment (1-leaf special case) ------------------------
        proof = alloc_data_commitment_proof(b, 1)
        pwires = proof_wires(proof)

        def fetch_dc(vals, _n=len(pwires)):
            prev = vals[0] | (vals[1] << 32)
            inp = fetcher.get_data_commitment_inputs(prev, prev + 1, 1)
            return flatten_inputs(inp)

        b.hint_into([prev_block.lo, prev_block.hi], pwires, fetch_dc)
        root = dc.prove_next_header_data_commitment(b, proof, prev_block, prev_header)

        b.evm_write_bytes32(new_header_hash)
        b.evm_write_bytes32(root)
        self.builder = b
        self.circuit: CompiledCircuit = b.build()

    # -- convenience -------------------------------------------------------
    def make_public_inputs(self, prev_block: int, prev_header: bytes) -> Dict[int, int]:
        data = prev_block.to_bytes(8, "big") + prev_header
        return {i: v for i, v in enumerate(data)}

    def prove(self, prev_block: int, cfg=None, pks=None, device=None, timer=None):
        """Prove the step prev_block -> prev_block + 1 on ``device`` (None:
        the card). Returns (proof, public bytes, next header hash, data
        commitment)."""
        prev_header = self.fetcher.get_header(prev_block).hash()
        pub_in = self.make_public_inputs(prev_block, prev_header)
        proof, publics = self.circuit.prove(pub_in, cfg, pks, device, timer)
        next_hash = bytes(publics[40:72])
        data_commitment = bytes(publics[72:104])
        return proof, publics, next_hash, data_commitment

    def verify(self, proof, publics, cfg=None, vks=None, device=None) -> bool:
        return self.circuit.verify(proof, publics, cfg, vks, device)

    def build_keys(self, cfg=None, device=None):
        return self.circuit.build_keys(cfg, device)
