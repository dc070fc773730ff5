"""DataCommitmentCircuit — parity with reference circuits/data_commitment.rs (R5);
the port's copy of ``blobstreamx_tpu/circuits/data_commitment.py``.

evm_read(start_block, start_header, end_block, end_header) ->
prove_data_commitment -> evm_write(data_commitment). Witness proofs arrive
through an async-hint-style fetcher callback (reference
DataCommitmentOffchainInputs, circuits/data_commitment.rs:18-45).
"""

from __future__ import annotations

from typing import Dict

from ..frontend.builder import CircuitBuilder, CompiledCircuit
from . import builder as dc
from .input import InputDataFetcher, flatten_inputs
from .vars import alloc_data_commitment_proof, proof_wires


class DataCommitmentCircuit:
    """Small-config data-commitment circuit (NB_MAP_JOBS batches inline)."""

    def __init__(self, max_leaves: int, fetcher: InputDataFetcher,
                 nb_map_jobs: int = 1):
        self.max_leaves = max_leaves
        self.nb_map_jobs = nb_map_jobs
        self.batch_size = max_leaves // nb_map_jobs
        assert self.batch_size * nb_map_jobs == max_leaves
        self.fetcher = fetcher
        self._define()

    def _define(self):
        b = CircuitBuilder()
        start_block = b.evm_read_u64()
        start_header = b.evm_read_bytes32()
        end_block = b.evm_read_u64()
        end_header = b.evm_read_bytes32()

        proofs = []
        for j in range(self.nb_map_jobs):
            proof = alloc_data_commitment_proof(b, self.batch_size)
            proofs.append(proof)
            # async-hint: fetch witness bytes for this batch from the
            # (start_block + j*batch) .. range at witness time
            wires = proof_wires(proof)
            fetcher = self.fetcher
            bs = self.batch_size
            off = j * self.batch_size

            def fetch(vals, _off=off, _bs=bs, _n=len(wires)):
                start = vals[0] | (vals[1] << 32)
                end = vals[2] | (vals[3] << 32)
                batch_start = start + _off
                batch_end = max(batch_start, min(batch_start + _bs, end))
                inp = fetcher.get_data_commitment_inputs(
                    batch_start, batch_end, _bs
                )
                return flatten_inputs(inp)

            b.hint_into(
                [start_block.lo, start_block.hi, end_block.lo, end_block.hi],
                wires,
                fetch,
            )

        self.roots = dc.prove_data_commitment_inline(
            b,
            proofs,
            start_block,
            start_header,
            end_block,
            end_header,
            self.batch_size,
        )
        b.evm_write_bytes32(self.roots)
        self.builder = b
        self.circuit: CompiledCircuit = b.build()

    # -- convenience -------------------------------------------------------
    def make_public_inputs(self, start_block: int, start_header: bytes,
                           end_block: int, end_header: bytes) -> Dict[int, int]:
        data = (
            start_block.to_bytes(8, "big")
            + start_header
            + end_block.to_bytes(8, "big")
            + end_header
        )
        return {i: v for i, v in enumerate(data)}

    def prove(self, start_block: int, end_block: int, cfg=None, pks=None,
              device=None, timer=None):
        """Prove the range on ``device`` (None: the card). Returns (proof,
        public bytes, data commitment)."""
        f = self.fetcher
        start_header = f.get_header(start_block).hash()
        end_header = f.get_header(end_block).hash()
        pub_in = self.make_public_inputs(
            start_block, start_header, end_block, end_header
        )
        proof, publics = self.circuit.prove(pub_in, cfg, pks, device, timer)
        root = bytes(publics[80:112])
        return proof, publics, root

    def verify(self, proof, publics, cfg=None, vks=None, device=None) -> bool:
        return self.circuit.verify(proof, publics, cfg, vks, device)
