"""Subchain map-job circuit — the per-batch leaf of the MapReduce proof
tree (reference map closure, circuits/builder.rs:305-336). The port's copy
of ``blobstreamx_tpu/circuits/map_job.py``.

One proof per batch of `batch_size` blocks. Public interface (ABI bytes):

  evm_read : batch_start_block (8) ‖ global_end_block (8) ‖
             global_end_header (32)
  evm_write: subchain.start_header (32) ‖ subchain.end_header (32) ‖
             subchain.data_merkle_root (32)

`is_enabled` and the clamped `end_block` are pure functions of the public
inputs (batch_start < global_end; clamp(batch_start+batch_size,
global_end)), so the reduce layer derives them natively instead of carrying
them through the proof (``blobstreamx_tpu/parallel/mapreduce.py``). The
witness arrives via the same hint-fetcher mechanism as DataCommitmentCircuit
(reference DataCommitmentOffchainInputs async hint,
circuits/data_commitment.rs:18-45).
"""

from __future__ import annotations

from typing import Dict

from ..frontend.builder import CircuitBuilder, CompiledCircuit
from . import builder as dc
from .input import InputDataFetcher, flatten_inputs
from .vars import alloc_data_commitment_proof, proof_wires

# public-byte layout offsets
IN_BYTES = 48
OUT_START_HEADER = slice(48, 80)
OUT_END_HEADER = slice(80, 112)
OUT_DATA_ROOT = slice(112, 144)


class SubchainMapCircuit:
    """Circuit template shared by every map job of a given batch_size."""

    def __init__(self, batch_size: int, fetcher: InputDataFetcher):
        self.batch_size = batch_size
        self.fetcher = fetcher
        b = CircuitBuilder()
        batch_start = b.evm_read_u64()
        global_end = b.evm_read_u64()
        global_end_header = b.evm_read_bytes32()

        proof = alloc_data_commitment_proof(b, batch_size)
        wires = proof_wires(proof)
        fetcher = self.fetcher
        bs = batch_size

        def fetch(vals):
            start = vals[0] | (vals[1] << 32)
            g_end = vals[2] | (vals[3] << 32)
            end = max(start, min(start + bs, g_end))
            return flatten_inputs(
                fetcher.get_data_commitment_inputs(start, end, bs))

        b.hint_into(
            [batch_start.lo, batch_start.hi, global_end.lo, global_end.hi],
            wires, fetch,
        )

        batch_end = b.u64_add_const(batch_start, batch_size)
        sub = dc.prove_subchain(
            b, proof, batch_start, batch_end, global_end, global_end_header)
        b.evm_write_bytes32(sub.start_header)
        b.evm_write_bytes32(sub.end_header)
        b.evm_write_bytes32(sub.data_merkle_root)
        self.builder = b
        self.circuit: CompiledCircuit = b.build()

    def make_public_inputs(self, batch_start: int, global_end: int,
                           global_end_header: bytes) -> Dict[int, int]:
        data = (batch_start.to_bytes(8, "big")
                + global_end.to_bytes(8, "big") + global_end_header)
        return {i: v for i, v in enumerate(data)}

    def prove(self, batch_start: int, global_end: int,
              global_end_header: bytes, cfg=None, pks=None, device=None,
              timer=None):
        """Prove one map job on ``device`` (None: the card). Returns (proof,
        public bytes)."""
        pub_in = self.make_public_inputs(batch_start, global_end,
                                         global_end_header)
        return self.circuit.prove(pub_in, cfg, pks, device, timer)

    def verify(self, proof, publics, cfg=None, vks=None, device=None) -> bool:
        return self.circuit.verify(proof, publics, cfg, vks, device)
