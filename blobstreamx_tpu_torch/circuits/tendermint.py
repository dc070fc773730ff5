"""Tendermint light-client circuit gadgets — step verification.

The port's copy of ``blobstreamx_tpu/circuits/tendermint.py``.

Capability parity with tendermintx's circuit layer (SURVEY.md D13/D15):
header hashing from protobuf field leaves, validator-set hashing, canonical
precommit vote binding, Ed25519 vote verification via the EC chip, and
voting-power quorum. The skip circuit composes the same gadgets (D14).

Design notes vs the reference:
  * Vote sign-bytes are witnessed whole and *pinned* at fixed offsets
    (length prefix, type=precommit, height, block_id hash) and at
    length-indexed suffix offsets (chain id); the timestamp region is free
    witness — exactly the security-relevant binding tendermintx enforces
    by reconstructing the message (round 0 and single-byte part counts
    assumed; documented).
  * Heights and voting powers are capped below 2^32 / 2^48 so varint
    reconstruction stays single-field-element (Celestia heights/powers are
    far below these).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..frontend.builder import (
    BoolVariable,
    Bytes32Variable,
    ByteVariable,
    CircuitBuilder,
    U32Variable,
    U64Variable,
    Variable,
)
from ..field.goldilocks import P as GL_P
from ..tendermint import ed25519 as ed
from ..tendermint import merkle as tmerkle
from . import builder as dc

HEADER_NUM_FIELDS = 14
# per-field (max_len, fixed_len or None); index = tendermint header field
LEAF_SHAPES = [
    (12, None),   # 0 version
    (None, None), # 1 chain_id (constant bytes, fixed per config)
    (7, None),    # 2 height (tag + varint<=6; heights < 2^32)
    (16, None),   # 3 time
    (72, 72),     # 4 last_block_id
    (34, 34),     # 5 last_commit_hash
    (34, 34),     # 6 data_hash
    (34, 34),     # 7 validators_hash
    (34, 34),     # 8 next_validators_hash
    (34, 34),     # 9 consensus_hash
    (34, 34),     # 10 app_hash
    (34, 34),     # 11 last_results_hash
    (34, 34),     # 12 evidence_hash
    (22, 22),     # 13 proposer_address
]
HEIGHT_LEAF, LAST_BLOCK_ID_LEAF, DATA_HASH_LEAF = 2, 4, 6
VALIDATORS_HASH_LEAF, NEXT_VALIDATORS_HASH_LEAF = 7, 8


def vote_msg_bounds(chain_id: str) -> Tuple[int, int]:
    """(min, max) canonical precommit sign-bytes length (round 0)."""
    clen = len(chain_id)
    return 92 + clen, 103 + clen


# ---------------------------------------------------------------------------
# leaves & trees
# ---------------------------------------------------------------------------

@dataclass
class HeaderLeaf:
    data: list          # ByteVariables, padded to max size
    length: Optional[U32Variable]  # None when fixed size


def leaf_hash_var(b: CircuitBuilder, leaf: HeaderLeaf) -> Bytes32Variable:
    """sha256(0x00 || data[:len]) with variable length."""
    if leaf.length is None:
        return dc.leaf_hash(b, leaf.data)
    total = b._arith(q0=1, terms=[(1, leaf.length.wire)])
    return b.sha256_var(
        [b.byte_constant(0)] + list(leaf.data), U32Variable(total.wire), 1
    )


def root_from_node_hashes(b: CircuitBuilder, nodes: List[Bytes32Variable],
                          nb_enabled: U32Variable) -> Bytes32Variable:
    """Enabled-slot tree reduction over precomputed leaf hashes (the
    variable-length-leaf variant of dc.compute_root_from_leaves)."""
    n_slots = len(nodes)
    assert n_slots & (n_slots - 1) == 0
    nodes = list(nodes)
    enabled = [
        b.u32_lt(U32Variable(b.constant(i).wire), nb_enabled)
        for i in range(n_slots)
    ]
    while len(nodes) > 1:
        nxt, nxt_en = [], []
        for i in range(0, len(nodes), 2):
            combined = dc.inner_hash(b, nodes[i], nodes[i + 1])
            nxt.append(b.select_bytes32(enabled[i + 1], combined, nodes[i]))
            nxt_en.append(enabled[i])
        nodes, enabled = nxt, nxt_en
    return nodes[0]


def hash_header(b: CircuitBuilder, leaves: List[HeaderLeaf]) -> Bytes32Variable:
    """Tendermint merkle root over the 14 header field leaves (static
    split-point tree; tendermint/merkle.py hash_from_byte_slices)."""
    assert len(leaves) == HEADER_NUM_FIELDS
    hashes = [leaf_hash_var(b, leaf) for leaf in leaves]

    def reduce(nodes: List[Bytes32Variable]) -> Bytes32Variable:
        if len(nodes) == 1:
            return nodes[0]
        k = tmerkle.split_point(len(nodes))
        return dc.inner_hash(b, reduce(nodes[:k]), reduce(nodes[k:]))

    return reduce(hashes)


# ---------------------------------------------------------------------------
# varint reconstruction (values < 2^32 -> <= 5 groups)
# ---------------------------------------------------------------------------

def assert_varint_u32(b: CircuitBuilder, data: Sequence[ByteVariable],
                      length: U32Variable, value: U32Variable,
                      cond: BoolVariable):
    """Constrain data[:length] to be the protobuf varint of value
    (length in [1, 5]); all asserts gated by cond."""
    n = min(len(data), 5)
    eq = [b.is_equal(Variable(length.wire), b.constant(j)) for j in range(n + 1)]
    # used_i = (length > i) = sum of eq_j for j > i
    used = []
    for i in range(n):
        acc = None
        for j in range(i + 1, n + 1):
            acc = eq[j] if acc is None else BoolVariable(
                b._arith(terms=[(1, acc.wire), (1, eq[j].wire)]).wire
            )
        used.append(acc)
    # length in [1, n]
    one_of = None
    for j in range(1, n + 1):
        one_of = eq[j] if one_of is None else BoolVariable(
            b._arith(terms=[(1, one_of.wire), (1, eq[j].wire)]).wire
        )
    b._assert_expr_zero(qm_pair=(1, cond.wire, one_of.wire), terms=[(GL_P - 1, cond.wire)])

    total_terms = []
    for i in range(n):
        nxt_used = used[i + 1] if i + 1 < n else b._false()
        low7 = b._arith(terms=[(1, data[i].wire), (GL_P - 128, nxt_used.wire)])
        b.add_byte_check(low7.wire)
        dbl = b._arith(terms=[(2, low7.wire)])
        b.add_byte_check(dbl.wire)
        masked = b.mul(Variable(used[i].wire), low7)
        total_terms.append((128 ** i, masked.wire))
    total = b._arith(terms=total_terms[:4])
    if len(total_terms) > 4:
        total = b._arith(terms=[(1, total.wire)] + total_terms[4:])
    diff = b.sub(total, Variable(value.wire))
    b._assert_expr_zero(qm_pair=(1, cond.wire, diff.wire))


# ---------------------------------------------------------------------------
# validator set hashing
# ---------------------------------------------------------------------------

@dataclass
class ValidatorVariable:
    pubkey: list        # 32 ByteVariables
    power: U64Variable  # voting power (< 2^48 enforced)
    power_varint: list  # 5 ByteVariables (witness varint of power)
    varint_len: U32Variable
    enabled: BoolVariable
    signed: BoolVariable


def validator_leaf_hash(b: CircuitBuilder, v: ValidatorVariable) -> Bytes32Variable:
    """sha256(0x00 || SimpleValidator marshal) with variable power varint."""
    # SimpleValidator marshal: 0A 22 (pub_key field, 34 B) 0A 20 (ed25519
    # key, 32 B) || pk || 10 || varint(power) — matches
    # tendermint/vote.py Validator.simple_encode (fixture bit-exact)
    prefix = [b.byte_constant(x) for x in (0x0A, 0x22, 0x0A, 0x20)]
    leaf = prefix + list(v.pubkey) + [b.byte_constant(0x10)] + list(v.power_varint)
    # power < 2^32 for the varint gadget (power.hi == 0 when enabled)
    b._assert_expr_zero(qm_pair=(1, v.enabled.wire, v.power.hi.wire))
    assert_varint_u32(b, v.power_varint, v.varint_len, v.power.lo, v.enabled)
    total = b._arith(q0=38, terms=[(1, v.varint_len.wire)])  # 1 + 37 + vlen
    return b.sha256_var(
        [b.byte_constant(0)] + leaf, U32Variable(total.wire), 39
    )


def validators_root(b: CircuitBuilder, validators: List[ValidatorVariable],
                    nb_validators: U32Variable) -> Bytes32Variable:
    hashes = [validator_leaf_hash(b, v) for v in validators]
    return root_from_node_hashes(b, hashes, nb_validators)


# ---------------------------------------------------------------------------
# vote messages
# ---------------------------------------------------------------------------

def constrain_vote_message(
    b: CircuitBuilder,
    msg: Sequence[ByteVariable],
    msg_len: U32Variable,
    height: U64Variable,
    header_hash: Bytes32Variable,
    chain_id: str,
    cond: BoolVariable,
):
    """Pin the security-relevant structure of a canonical precommit
    (round 0): length prefix, type, height, block_id hash, chain id."""
    min_len, max_len = vote_msg_bounds(chain_id)
    assert len(msg) >= max_len

    def pin(idx: int, expr_wire: int):
        d = b._arith(terms=[(1, msg[idx].wire), (GL_P - 1, expr_wire)])
        b._assert_expr_zero(qm_pair=(1, cond.wire, d.wire))

    def pin_const(idx: int, value: int):
        pin(idx, b.constant(value).wire)

    body_len = b._arith(terms=[(1, msg_len.wire)], q0=GL_P - 1)
    pin(0, body_len.wire)
    pin_const(1, 0x08)
    pin_const(2, 0x02)
    pin_const(3, 0x11)
    # height sfixed64 little-endian
    height_be = b.u64_to_be_bytes(height)
    for j in range(8):
        pin(4 + j, height_be[7 - j].wire)
    pin_const(12, 0x22)
    pin_const(13, 0x48)
    pin_const(14, 0x0A)
    pin_const(15, 0x20)
    for j in range(32):
        pin(16 + j, header_hash.bytes[j].wire)
    pin_const(48, 0x12)
    pin_const(49, 0x24)
    pin_const(50, 0x08)
    # msg[51] = part count (free single byte; <128 by byte range /2 check)
    dbl = b._arith(terms=[(2, msg[51].wire)])
    b.add_byte_check(dbl.wire)
    pin_const(52, 0x12)
    pin_const(53, 0x20)
    # msg[54..86] part-set hash: free witness
    pin_const(86, 0x2A)
    # ts field length byte: msg_len - clen - 90
    clen = len(chain_id)
    ts_len = b._arith(terms=[(1, msg_len.wire)], q0=GL_P - (clen + 90))
    pin(87, ts_len.wire)
    # suffix [0x32, clen, chain bytes] at msg_len - clen - 2, via per-length
    # one-hots (msg_len in [min_len, max_len])
    eqs = [
        (b.is_equal(Variable(msg_len.wire), b.constant(L)), L)
        for L in range(min_len, max_len + 1)
    ]
    one_of = None
    for e, _ in eqs:
        one_of = e if one_of is None else BoolVariable(
            b._arith(terms=[(1, one_of.wire), (1, e.wire)]).wire
        )
    b._assert_expr_zero(
        qm_pair=(1, cond.wire, one_of.wire), terms=[(GL_P - 1, cond.wire)]
    )
    suffix = [0x32, clen] + list(chain_id.encode())
    for j, expect in enumerate(suffix):
        # byte at (msg_len - clen - 2 + j) = sum_L eq_L * msg[L - clen - 2 + j]
        terms = []
        for e, L in eqs:
            idx = L - clen - 2 + j
            sel = b.mul(Variable(e.wire), Variable(msg[idx].wire))
            terms.append((1, sel.wire))
        got = b._arith(terms=terms[:4])
        k = 4
        while k < len(terms):
            got = b._arith(terms=[(1, got.wire)] + terms[k:k + 3])
            k += 3
        d = b._arith(terms=[(1, got.wire)], q0=GL_P - expect)
        b._assert_expr_zero(qm_pair=(1, cond.wire, d.wire))


# ---------------------------------------------------------------------------
# quorum
# ---------------------------------------------------------------------------

def assert_power_quorum(b: CircuitBuilder, validators: List[ValidatorVariable],
                        numerator: int = 2, denominator: int = 3):
    """sum(signed powers) * denominator > sum(enabled powers) * numerator.

    Step: 2/3 of the new set. Powers capped < 2^48 (hi limb < 2^16) so
    field sums stay below 2^56.
    """
    for v in validators:
        b.assert_bool(v.signed)
        b.assert_bool(v.enabled)
        # signed => enabled
        not_en = b.not_(v.enabled)
        b._assert_expr_zero(qm_pair=(1, v.signed.wire, not_en.wire))
    def side(flag_of):
        acc = b.zero()
        for v in validators:
            masked = b.mul(Variable(flag_of(v).wire), Variable(v.power.lo.wire))
            acc = b.add(acc, masked)
        return acc

    total = side(lambda v: v.enabled)
    signed = side(lambda v: v.signed)
    lhs = b._arith(terms=[(denominator, signed.wire)])
    rhs = b._arith(terms=[(numerator, total.wire)])

    # decompose both (< 2^56) into u32 limbs and compare rhs < lhs
    def to_u64(x):
        def split(vals):
            return [vals[0] & 0xFFFFFFFF, vals[0] >> 32]

        lo_w, hi_w = b.hint([x], 2, split, kind="split64")
        b.unpack_word_to_bytes(Variable(lo_w))
        b.unpack_word_to_bytes(Variable(hi_w))
        b._assert_expr_zero(
            terms=[(1, lo_w), (1 << 32, hi_w), (GL_P - 1, x.wire)]
        )
        return U64Variable(U32Variable(lo_w), U32Variable(hi_w))

    lt = b.u64_lt(to_u64(rhs), to_u64(lhs))
    b.assert_is_equal(Variable(lt.wire), b.one())


# ---------------------------------------------------------------------------
# reusable allocation + verification assemblies (shared by step and skip)
# ---------------------------------------------------------------------------

def assert_len_in(b: CircuitBuilder, length: U32Variable, lo: int, hi: int):
    """Pin a witness length to [lo, hi] via a one-hot sum."""
    acc = None
    for j in range(lo, hi + 1):
        e = b.is_equal(Variable(length.wire), b.constant(j))
        acc = e if acc is None else BoolVariable(
            b._arith(terms=[(1, acc.wire), (1, e.wire)]).wire
        )
    b.assert_is_equal(Variable(acc.wire), b.one())


def select_bytes(b: CircuitBuilder, cond: BoolVariable, a_bytes, const_bytes):
    """Per-byte select(cond, a, const)."""
    out = []
    for av, cv in zip(a_bytes, const_bytes):
        out.append(ByteVariable(
            b.select(cond, Variable(av.wire), b.constant(cv)).wire
        ))
    return out


def alloc_header_leaves(b: CircuitBuilder, chain_id: str):
    """(leaves, wires): witness the 14 header field leaves; chain_id is a
    constant leaf (pins the chain, tendermintx's chain-id domain check)."""
    from ..tendermint.header import cdc_encode_string
    from .vars import alloc_bytes

    wires: List[int] = []
    leaves: List[HeaderLeaf] = []
    for i, (max_len, fixed) in enumerate(LEAF_SHAPES):
        if i == 1:
            data = [b.byte_constant(x) for x in cdc_encode_string(chain_id)]
            leaves.append(HeaderLeaf(data, None))
            continue
        data = alloc_bytes(b, max_len).bytes
        wires += [x.wire for x in data]
        if fixed is None:
            lw = b.free_wire()
            wires.append(lw)
            assert_len_in(b, U32Variable(lw), 1, max_len)
            leaves.append(HeaderLeaf(list(data), U32Variable(lw)))
        else:
            leaves.append(HeaderLeaf(list(data), None))
    return leaves, wires


def flatten_header_leaves(raw_leaves: List[bytes]) -> List[int]:
    out: List[int] = []
    for i, (max_len, fixed) in enumerate(LEAF_SHAPES):
        if i == 1:
            continue
        raw = raw_leaves[i]
        assert len(raw) <= max_len
        out += list(raw) + [0] * (max_len - len(raw))
        if fixed is None:
            out.append(len(raw))
    return out


def alloc_validator_set(b: CircuitBuilder, vss: int, msg_max: int,
                        with_votes: bool = True):
    """(validators, val_aux, nb_validators, wires)."""
    from .vars import alloc_bytes

    wires: List[int] = []
    validators: List[ValidatorVariable] = []
    val_aux = []
    for _ in range(vss):
        pk = alloc_bytes(b, 32).bytes
        wires += [x.wire for x in pk]
        lo_w, hi_w = b.free_wire(), b.free_wire()
        wires += [lo_w, hi_w]
        b.unpack_word_to_bytes(Variable(lo_w))
        b.unpack_word_to_bytes(Variable(hi_w))
        pvar = alloc_bytes(b, 5).bytes
        wires += [x.wire for x in pvar]
        vlen_w = b.free_wire()
        wires.append(vlen_w)
        signed_w = b.free_wire()
        wires.append(signed_w)
        enabled_w = b.free_wire()
        wires.append(enabled_w)
        if with_votes:
            sig = alloc_bytes(b, 64).bytes
            wires += [x.wire for x in sig]
            msg = alloc_bytes(b, msg_max).bytes
            wires += [x.wire for x in msg]
            mlen_w = b.free_wire()
            wires.append(mlen_w)
            val_aux.append((list(sig), list(msg), U32Variable(mlen_w)))
        validators.append(ValidatorVariable(
            pubkey=list(pk),
            power=U64Variable(U32Variable(lo_w), U32Variable(hi_w)),
            power_varint=list(pvar), varint_len=U32Variable(vlen_w),
            enabled=BoolVariable(enabled_w), signed=BoolVariable(signed_w),
        ))
    nbv_w = b.free_wire()
    wires.append(nbv_w)
    nb_validators = U32Variable(nbv_w)
    assert_len_in(b, nb_validators, 1, vss)
    for i, v in enumerate(validators):
        want = b.u32_lt(U32Variable(b.constant(i).wire), nb_validators)
        b.assert_is_equal(Variable(v.enabled.wire), Variable(want.wire))
    return validators, val_aux, nb_validators, wires


def flatten_validator_set(validators_in, nb_validators: int, msg_max: int,
                          msg_min: int, with_votes: bool = True) -> List[int]:
    from ..tendermint.header import encode_varint

    out: List[int] = []
    for vi, v in enumerate(validators_in):
        out += list(v.pubkey)
        out += [v.power & 0xFFFFFFFF, v.power >> 32]
        pv = encode_varint(v.power) if v.power else b"\x00"
        out += list(pv) + [0] * (5 - len(pv))
        out.append(max(1, len(pv)))
        out.append(1 if v.signed else 0)
        out.append(1 if vi < nb_validators else 0)
        if with_votes:
            out += list(v.signature)
            m = v.msg
            out += list(m) + [0] * (msg_max - len(m))
            out.append(len(m) if m else msg_min)
    out.append(nb_validators)
    return out


def verify_commit_votes(b: CircuitBuilder, validators, val_aux,
                        height: U64Variable, header_hash: Bytes32Variable,
                        chain_id: str):
    """Pin every signed validator's vote message and verify its Ed25519
    signature via the EC chip (dummy-substituted for unsigned slots)."""
    msg_min, msg_max = vote_msg_bounds(chain_id)
    dpk, dmsg, dsig = dummy_signature(msg_min)
    for v, (sig, msg, mlen) in zip(validators, val_aux):
        assert_len_in(b, mlen, msg_min, msg_max)
        constrain_vote_message(b, msg, mlen, height, header_hash, chain_id, v.signed)
        sel_pk = select_bytes(b, v.signed, v.pubkey, dpk)
        sel_sig = select_bytes(b, v.signed, sig, dsig)
        sel_msg = select_bytes(b, v.signed, msg, dmsg + bytes(msg_max - len(dmsg)))
        sel_len = U32Variable(
            b.select(v.signed, Variable(mlen.wire), b.constant(msg_min)).wire
        )
        b.ed25519_verify(
            sel_pk, sel_sig, sel_msg,
            U64Variable(sel_len, U32Variable(b.zero().wire)),
            msg_min,
        )


def bind_validators_hash_leaf(b: CircuitBuilder, leaves, validators,
                              nb_validators):
    """validators_hash leaf [2..34] == root of the witnessed set."""
    vroot = validators_root(b, validators, nb_validators)
    vh_leaf = leaves[VALIDATORS_HASH_LEAF]
    for j in range(32):
        b.assert_is_equal(
            Variable(vh_leaf.data[2 + j].wire), Variable(vroot.bytes[j].wire)
        )
    return vroot


def bind_height_leaf(b: CircuitBuilder, leaves, height: U64Variable):
    """height leaf == 0x08 || varint(height) (heights < 2^32)."""
    b.assert_is_equal(Variable(height.hi.wire), b.zero())
    hleaf = leaves[HEIGHT_LEAF]
    b.assert_is_equal(Variable(hleaf.data[0].wire), b.constant(0x08))
    vlen = b._arith(terms=[(1, hleaf.length.wire)], q0=GL_P - 1)
    assert_varint_u32(b, hleaf.data[1:7], U32Variable(vlen.wire),
                      height.lo, b._true())


# ---------------------------------------------------------------------------
# dummy signature (slots whose validator did not sign)
# ---------------------------------------------------------------------------

def dummy_signature(msg_len: int) -> Tuple[bytes, bytes, bytes]:
    """(pubkey, msg, signature) valid under the chip's equation, for the
    secret scalar a=1 / nonce r=1 (pubkey = R = base point)."""
    msg = b"\x2a" * msg_len
    a_c = ed.compress(ed.BASE)
    r_c = ed.compress(ed.BASE)
    k = int.from_bytes(hashlib.sha512(r_c + a_c + msg).digest(), "little")
    s = (1 + k) % ed.L
    return a_c, msg, r_c + s.to_bytes(32, "little")
