"""HeaderRangeCircuit — parity with reference circuits/header_range.rs (R8)
plus the tendermintx skip circuit it calls (SURVEY.md D14). The port's
copy of ``blobstreamx_tpu/circuits/header_range.py``.

evm_read(trusted_block, trusted_header_hash, target_block) ->
  skip: recompute the target header hash from its field leaves, verify
  >=2/3 of the *target* validator set's precommits, and that >=1/3 of the
  *trusted* set's voting power signed the target commit (stake overlap,
  matched by pubkey against the trusted set whose hash is proven into the
  trusted header), then prove_data_commitment over the block range ->
evm_write(target_header_hash, data_commitment).
"""

from __future__ import annotations

from typing import Dict

from ..field.goldilocks import P as GL_P
from ..frontend.builder import (
    BoolVariable,
    CircuitBuilder,
    CompiledCircuit,
    Variable,
)
from . import builder as dc
from . import consts
from . import tendermint as tm
from .input import SkipInputFetcher, flatten_inputs
from .vars import alloc_bytes, alloc_bytes32, alloc_data_commitment_proof, proof_wires


def emit_skip(b: CircuitBuilder, chain_id: str, vss: int,
              fetcher: SkipInputFetcher, trusted_block, trusted_header,
              target_block):
    """Emit the tendermintx skip statement (D14) into `b`, returning the
    in-circuit target header hash.

    Verifies: target header recomputed from its field leaves; >=2/3 of the
    target validator set's precommits; the trusted set binds to the trusted
    header; and >=1/3 of the trusted set's voting power signed the target
    commit (overlap matched by pubkey). Used by HeaderRangeCircuit (inline
    data commitment); the reference's SkipCircuit, which composes it with
    MapReduce aggregation, is not ported yet."""
    msg_min, msg_max = tm.vote_msg_bounds(chain_id)

    # --- witness allocation ------------------------------------------
    leaves, leaf_wires = tm.alloc_header_leaves(b, chain_id)
    target_vals, target_aux, nb_target, tv_wires = tm.alloc_validator_set(
        b, vss, msg_max
    )
    trusted_vals, _, nb_trusted, tr_wires = tm.alloc_validator_set(
        b, vss, msg_max, with_votes=False
    )
    idx_wires = [b.free_wire() for _ in range(vss)]
    tvh_leaf = alloc_bytes(b, consts.PROTOBUF_HASH_SIZE_BYTES)
    tvh_aunts = [alloc_bytes32(b) for _ in range(consts.HEADER_PROOF_DEPTH)]
    wires = leaf_wires + tv_wires + tr_wires + list(idx_wires)
    wires += [x.wire for x in tvh_leaf.bytes]
    for a in tvh_aunts:
        wires += [x.wire for x in a.bytes]

    def fetch(vals, _n=len(wires)):
        trusted = vals[0] | (vals[1] << 32)
        target = vals[2] | (vals[3] << 32)
        inp = fetcher.get_skip_inputs(trusted, target, vss)
        out = tm.flatten_header_leaves(inp.target_leaves)
        out += tm.flatten_validator_set(
            inp.target_validators, inp.nb_target, msg_max, msg_min
        )
        out += tm.flatten_validator_set(
            inp.trusted_validators, inp.nb_trusted, msg_max, msg_min,
            with_votes=False,
        )
        out += list(inp.overlap_indices)
        leaf, aunts = inp.trusted_val_proof
        out += list(leaf)
        for a in aunts:
            out += list(a)
        assert len(out) == _n, (len(out), _n)
        return out

    b.hint_into(
        [trusted_block.lo, trusted_block.hi, target_block.lo, target_block.hi],
        wires, fetch,
    )

    # --- target header -----------------------------------------------
    lt = b.u64_lt(trusted_block, target_block)
    b.assert_is_equal(Variable(lt.wire), b.one())
    target_hash = tm.hash_header(b, leaves)
    tm.bind_height_leaf(b, leaves, target_block)
    tm.bind_validators_hash_leaf(b, leaves, target_vals, nb_target)

    # --- trusted set binds to the trusted header ----------------------
    troot = tm.validators_root(b, trusted_vals, nb_trusted)
    tvh_root = dc.get_root_from_merkle_proof(
        b, tvh_leaf, tvh_aunts, consts.VALIDATORS_PATH
    )
    b.assert_bytes32_equal(tvh_root, trusted_header)
    for j in range(32):
        b.assert_is_equal(
            Variable(tvh_leaf.bytes[2 + j].wire), Variable(troot.bytes[j].wire)
        )

    # --- votes + quorums ---------------------------------------------
    tm.verify_commit_votes(
        b, target_vals, target_aux, target_block, target_hash, chain_id
    )
    tm.assert_power_quorum(b, target_vals, numerator=2, denominator=3)

    # overlap: trusted validator i (flag = .signed) maps to target slot
    # idx_i with equal pubkey that signed; >=1/3 of trusted power
    for i, tv in enumerate(trusted_vals):
        t_flag = tv.signed
        eqs = [
            b.is_equal(Variable(idx_wires[i]), b.constant(j))
            for j in range(vss)
        ]
        one_of = None
        for e in eqs:
            one_of = e if one_of is None else BoolVariable(
                b._arith(terms=[(1, one_of.wire), (1, e.wire)]).wire
            )
        d = b._arith(terms=[(1, one_of.wire)], q0=GL_P - 1)
        b._assert_expr_zero(qm_pair=(1, t_flag.wire, d.wire))
        # selected target pubkey == trusted pubkey (gated)
        for byte in range(32):
            terms = []
            for j, e in enumerate(eqs):
                sel = b.mul(
                    Variable(e.wire), Variable(target_vals[j].pubkey[byte].wire)
                )
                terms.append((1, sel.wire))
            got = b._arith(terms=terms[:4])
            k = 4
            while k < len(terms):
                got = b._arith(terms=[(1, got.wire)] + terms[k:k + 3])
                k += 3
            dd = b.sub(got, Variable(tv.pubkey[byte].wire))
            b._assert_expr_zero(qm_pair=(1, t_flag.wire, dd.wire))
        # selected target slot signed
        sterms = []
        for j, e in enumerate(eqs):
            sel = b.mul(Variable(e.wire), Variable(target_vals[j].signed.wire))
            sterms.append((1, sel.wire))
        sgot = b._arith(terms=sterms[:4])
        k = 4
        while k < len(sterms):
            sgot = b._arith(terms=[(1, sgot.wire)] + sterms[k:k + 3])
            k += 3
        ds = b._arith(terms=[(1, sgot.wire)], q0=GL_P - 1)
        b._assert_expr_zero(qm_pair=(1, t_flag.wire, ds.wire))
    tm.assert_power_quorum(b, trusted_vals, numerator=1, denominator=3)
    return target_hash


class HeaderRangeCircuit:
    """Small-config combined skip circuit (map/reduce tree inline)."""

    def __init__(self, chain_id: str = "mocha-4", vss: int = 2,
                 nb_map_jobs: int = 1, batch_size: int = 4,
                 fetcher: SkipInputFetcher = None, ed_nbits=None):
        if fetcher is None:
            raise ValueError("a SkipInputFetcher over a fixture directory is required")
        assert vss & (vss - 1) == 0
        self.chain_id = chain_id
        self.vss = vss
        self.nb_map_jobs = nb_map_jobs
        self.batch_size = batch_size
        self.fetcher = fetcher
        self.msg_min, self.msg_max = tm.vote_msg_bounds(chain_id)
        self._define(ed_nbits)

    def _define(self, ed_nbits):
        b = CircuitBuilder()
        if ed_nbits is not None:
            b.ed_nbits = ed_nbits
        fetcher = self.fetcher
        trusted_block = b.evm_read_u64()
        trusted_header = b.evm_read_bytes32()
        target_block = b.evm_read_u64()

        target_hash = emit_skip(b, self.chain_id, self.vss, fetcher,
                                trusted_block, trusted_header, target_block)

        # --- data commitment over the range -------------------------------
        proofs = []
        for j in range(self.nb_map_jobs):
            proof = alloc_data_commitment_proof(b, self.batch_size)
            proofs.append(proof)
            pwires = proof_wires(proof)
            bs, off = self.batch_size, j * self.batch_size

            def fetch_dc(vals, _off=off, _bs=bs, _n=len(pwires)):
                start = vals[0] | (vals[1] << 32)
                end = vals[2] | (vals[3] << 32)
                batch_start = start + _off
                batch_end = max(batch_start, min(batch_start + _bs, end))
                inp = fetcher.get_data_commitment_inputs(batch_start, batch_end, _bs)
                return flatten_inputs(inp)

            b.hint_into(
                [trusted_block.lo, trusted_block.hi, target_block.lo, target_block.hi],
                pwires, fetch_dc,
            )
        root = dc.prove_data_commitment_inline(
            b, proofs, trusted_block, trusted_header, target_block, target_hash,
            self.batch_size,
        )

        b.evm_write_bytes32(target_hash)
        b.evm_write_bytes32(root)
        self.builder = b
        self.circuit: CompiledCircuit = b.build()

    # -- convenience -------------------------------------------------------
    def make_public_inputs(self, trusted_block: int, trusted_header: bytes,
                           target_block: int) -> Dict[int, int]:
        data = (
            trusted_block.to_bytes(8, "big") + trusted_header
            + target_block.to_bytes(8, "big")
        )
        return {i: v for i, v in enumerate(data)}

    def prove(self, trusted_block: int, target_block: int, cfg=None, pks=None,
              device=None, timer=None):
        """Prove the skip trusted_block -> target_block on ``device`` (None:
        the card). Returns (proof, public bytes, target header hash, data
        commitment)."""
        trusted_header = self.fetcher.get_header(trusted_block).hash()
        pub_in = self.make_public_inputs(trusted_block, trusted_header, target_block)
        proof, publics = self.circuit.prove(pub_in, cfg, pks, device, timer)
        target_hash = bytes(publics[48:80])
        data_commitment = bytes(publics[80:112])
        return proof, publics, target_hash, data_commitment

    def verify(self, proof, publics, cfg=None, vks=None, device=None) -> bool:
        return self.circuit.verify(proof, publics, cfg, vks, device)

    def build_keys(self, cfg=None, device=None):
        return self.circuit.build_keys(cfg, device)
