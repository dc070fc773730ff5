"""Succinct MapReduce aggregation: reduce circuits that verify their child
proofs in-circuit (proof/recursion.py). The port's copy of
``blobstreamx_tpu/circuits/aggregate.py``.

Tree layout (uniform statement, per-level proof shape):

    level 0: SubchainMapCircuit(batch_size)            span = batch_size
    level L: ReduceCircuit over two level-(L-1) proofs  span = batch * 2^L

Every node shares the map circuit's public interface
(circuits/map_job.py):

  evm_read : node_start_block (8) ‖ global_end_block (8) ‖
             global_end_header (32)
  evm_write: subchain.start_header (32) ‖ subchain.end_header (32) ‖
             subchain.data_merkle_root (32)

so the final proof is one proof whose statement covers the whole range.
A reduce node:

  * derives its children's public inputs from its own (left start = start,
    right start = start + span/2, same global end and header),
  * receives the children's public outputs and proofs as hint witness,
  * verifies both child proofs in-circuit against those exact public byte
    streams (bus-balance binding),
  * enforces the linkage rule: if the right child is enabled
    (right_start < global_end), left.end_header == right.start_header and
    root = sha256(0x01 ‖ root_L ‖ root_R); else the node passes the left
    child through unchanged,
  * emits the combined subchain as its own public output.

Both child proofs are verified unconditionally; ``enabled`` gates only the
linkage and combination. A map leaf whose batch starts at or past the
global end proves the empty-range pass-through statement, so every node of
the tree has a proof.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..frontend.builder import (
    Bytes32Variable, ByteVariable, CircuitBuilder, CompiledCircuit, Variable,
)
from ..chips import channels as ch
from ..proof import check
from ..proof import recursion as rec
from ..proof import stark
from . import builder as dc

IN_BYTES = 48
PUB_BYTES = 144  # uniform node public surface (48 in + 96 out)


class ReduceCircuit:
    """One reduce level: verifies two child proofs of ``child_compiled``'s
    shape. The children's preprocessed caps, constants of this circuit,
    come from ``child_vks`` (the child circuit's verifier keys) or are
    committed on ``device`` (None: the card)."""

    def __init__(self, child_compiled: CompiledCircuit, span: int,
                 cfg: Optional[stark.StarkConfig] = None, device=None, child_vks=None):
        self.cfg = cfg or stark.StarkConfig()
        self.span = span
        self.child_shapes = rec.inner_shapes(child_compiled, self.cfg, device, child_vks)
        # witness slot: (left_proof, left_publics, right_proof,
        # right_publics), set right before the witness is generated
        self._pending: Optional[tuple] = None
        self._define()

    def _define(self):
        b = CircuitBuilder()
        cfg = self.cfg
        start_block = b.evm_read_u64()
        global_end = b.evm_read_u64()
        global_end_header = b.evm_read_bytes32()
        half = self.span // 2

        # children's public output bytes arrive as witness
        child_out_wires: List[List[int]] = []
        outs: List[List[ByteVariable]] = []
        for _ in range(2):
            byts = [b.free_byte() for _ in range(96)]
            outs.append(byts)
            child_out_wires.append([x.wire for x in byts])

        # two verifiers' proof witness blocks
        rv = rec.RecursiveVerifier(b, self.child_shapes, cfg)
        proofs, flats = [], []
        for _ in range(2):
            pw, flat = rv.alloc_proof()
            proofs.append(pw)
            flats.append(flat)

        def fetch(which):
            proof = self._pending[2 * which]
            return rec.flatten_system_proof(proof, self.child_shapes, cfg)

        def fetch_out(which):
            pub = self._pending[2 * which + 1]
            return [int(v) for v in pub[IN_BYTES:PUB_BYTES]]

        b.hint_into([], child_out_wires[0], lambda v: fetch_out(0))
        b.hint_into([], child_out_wires[1], lambda v: fetch_out(1))
        b.hint_into([], flats[0], lambda v: fetch(0))
        b.hint_into([], flats[1], lambda v: fetch(1))

        # children's public input bytes, derived in-circuit
        right_start = b.u64_add_const(start_block, half)
        start_bytes = b.u64_to_be_bytes(start_block)
        rstart_bytes = b.u64_to_be_bytes(right_start)
        gend_bytes = b.u64_to_be_bytes(global_end)

        for which, sb in enumerate((start_bytes, rstart_bytes)):
            in_bytes = (list(sb) + list(gend_bytes)
                        + list(global_end_header.bytes))
            msgs = [(ch.PUBLIC, [pos, Variable(x.wire)], -1)
                    for pos, x in enumerate(in_bytes)]
            msgs += [(ch.PUBLIC, [IN_BYTES + j, Variable(w)], -1)
                     for j, w in enumerate(child_out_wires[which])]
            rv.verify(proofs[which], msgs)

        left_start_header = Bytes32Variable(tuple(outs[0][0:32]))
        left_end_header = Bytes32Variable(tuple(outs[0][32:64]))
        left_root = Bytes32Variable(tuple(outs[0][64:96]))
        right_start_header = Bytes32Variable(tuple(outs[1][0:32]))
        right_end_header = Bytes32Variable(tuple(outs[1][32:64]))
        right_root = Bytes32Variable(tuple(outs[1][64:96]))

        # right enabled <=> right_start < global_end
        enabled = b.u64_lt(right_start, global_end)

        # linkage (gated): left.end_header == right.start_header
        for j in range(32):
            d = b.sub(Variable(left_end_header.bytes[j].wire),
                      Variable(right_start_header.bytes[j].wire))
            b._assert_expr_zero(qm_pair=(1, enabled.wire, d.wire))

        # combined root: sha256(0x01 || rootL || rootR) vs passthrough
        combined = dc.inner_hash(b, left_root, right_root)
        root = b.select_bytes32(enabled, combined, left_root)
        end_header = b.select_bytes32(enabled, right_end_header, left_end_header)

        b.evm_write_bytes32(left_start_header)
        b.evm_write_bytes32(end_header)
        b.evm_write_bytes32(root)
        self.builder = b
        self.circuit: CompiledCircuit = b.build()

    # -- proving ------------------------------------------------------------

    def make_public_inputs(self, start_block: int, global_end: int,
                           global_end_header: bytes) -> Dict[int, int]:
        data = (start_block.to_bytes(8, "big")
                + global_end.to_bytes(8, "big") + global_end_header)
        return {i: v for i, v in enumerate(data)}

    def _with_children(self, left, right, fn):
        self._pending = (left[0], left[1], right[0], right[1])
        try:
            return fn()
        finally:
            self._pending = None

    def prove(self, start_block: int, global_end: int,
              global_end_header: bytes,
              left: Tuple[object, List[int]], right: Tuple[object, List[int]],
              cfg=None, pks=None, device=None, timer=None):
        """left/right: (child SystemProof, child publics). Proves on
        ``device`` (None: the card); returns (proof, public bytes)."""
        pub_in = self.make_public_inputs(start_block, global_end, global_end_header)
        return self._with_children(left, right, lambda: self.circuit.prove(
            pub_in, cfg or self.cfg, pks, device, timer))

    def witness(self, start_block: int, global_end: int,
                global_end_header: bytes, left, right):
        """The node's witness over two children (no proof)."""
        pub_in = self.make_public_inputs(start_block, global_end, global_end_header)
        return self._with_children(left, right,
                                   lambda: self.circuit.generate_witness(pub_in))

    def witness_failures(self, start_block: int, global_end: int,
                         global_end_header: bytes, left, right,
                         device=None, tables=None) -> List[str]:
        """What a verifier of this node would reject, by table or bus
        (``proof/check.witness_failures``, limited to ``tables`` if given),
        without proving; the pos table's trace is built on ``device``
        (None: the card)."""
        pub_in = self.make_public_inputs(start_block, global_end, global_end_header)
        return self._with_children(left, right, lambda: check.witness_failures(
            self.circuit, pub_in, device, tables))

    def verify(self, proof, publics, cfg=None, vks=None, device=None) -> bool:
        return self.circuit.verify(proof, publics, cfg or self.cfg, vks, device)

    def build_keys(self, cfg=None, device=None):
        """Commit every table's preprocessed columns on ``device``: (pks, vks)."""
        return self.circuit.build_keys(cfg or self.cfg, device)
