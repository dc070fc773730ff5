"""Circuit frontend DSL — the plonky2x CircuitBuilder equivalent (SURVEY.md D7).

The port's copy of ``blobstreamx_tpu/frontend/builder.py`` (tables cpu,
sha, sha512, pos, ed, range16, bytes): it builds the same rows, wires and
events, so a circuit's witness, traces and proof equal the JAX package's.

API surface mirrors the reference frontend (typed variables named like
plonky2x's: ByteVariable, Bytes32Variable, U32Variable, U64Variable,
BoolVariable; ops add/sub/mul/select/is_equal/assert_is_equal/lt; sha256;
evm_read/evm_write; hints; watch). The lowering target is TPU-native: a
straight-line program over the CPU table (chips/cpu.py) with dataflow via
the wire bus, SHA-256 farmed to the SHA chip, and bytes range-checked by
the bytes chip — no routed-wire copy constraints anywhere.

Build once, prove many: `build()` freezes the program into a
CompiledCircuit whose preprocessed tables + verifier keys are the build
artifact (the reference's build/prove split, D17).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from .. import device as devmod
from ..field import goldilocks as gl
from ..chips import bytes as bytes_chip
from ..chips import channels as ch
from ..chips import cpu
from ..chips import ed25519 as ed_chip
from ..chips import poseidon as pos_chip
from ..chips import range16 as range16_chip
from ..chips import sha256 as sha_chip
from ..chips import sha512 as sha512_chip
from ..proof import stark, system

TWO32 = 1 << 32

ED_L = 2**252 + 27742317777372353535851937790883648493  # Ed25519 group order


@dataclass(frozen=True)
class Variable:
    wire: int


@dataclass(frozen=True)
class BoolVariable:
    wire: int


@dataclass(frozen=True)
class ByteVariable:
    wire: int


@dataclass(frozen=True)
class U32Variable:
    wire: int


@dataclass(frozen=True)
class U64Variable:
    """Two u32 limbs, little-endian (limbs[0] = low) — mirrors the
    reference's U64Variable limb layout (circuits/builder.rs:124-128)."""

    lo: U32Variable
    hi: U32Variable


@dataclass(frozen=True)
class Bytes32Variable:
    bytes: tuple  # 32 ByteVariables


class BytesVariable:
    def __init__(self, byte_vars):
        self.bytes = tuple(byte_vars)

    def __len__(self):
        return len(self.bytes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return BytesVariable(self.bytes[i])
        return self.bytes[i]

    def __add__(self, other):
        return BytesVariable(self.bytes + tuple(other.bytes))


@dataclass
class ShaCall:
    inst: int
    blocks_word_wires: List[List[int]]
    message_byte_wires: List[int]
    digest_word_wires: List[int]


@dataclass
class Sha512Call:
    inst: int
    blocks_half_wires: List[List[int]]  # per block: 32 half-word wires
    message_byte_wires: List[int]
    digest_half_wires: List[int]  # 16: a-side (lo,hi)x4 then e-side


@dataclass
class PosPerm:
    """One scheduled Poseidon permutation (chips/poseidon.py row)."""

    inst: int
    chain: int
    cpos: int
    absorb: Dict[int, int]  # lane -> wire
    carry: tuple = ()
    merkle: bool = False
    sib_wires: tuple = ()  # 4 wires (merkle mode)
    dir_wire: int = -1
    out_lanes: set = None

    def __post_init__(self):
        if self.out_lanes is None:
            self.out_lanes = set()


@dataclass
class EdCall:
    """One Ed25519 verification instance routed to the EC chip."""

    inst: int
    pubkey_wires: List[int]  # 32 compressed bytes
    sig_wires: List[int]     # 64 bytes (R || S)
    msg_wires: List[int]     # message bytes, padded to max
    len_wire: int            # actual message length


class CircuitBuilder:
    def __init__(self):
        self.rows: List[cpu.Row] = []
        self.n_wires = 0
        self.read_counts: Dict[int, int] = {}
        self.events: List[tuple] = []
        self.sha_calls: List[ShaCall] = []
        self.sha512_calls: List[Sha512Call] = []
        self.ed_calls: List[EdCall] = []
        self.pos_perms: List[PosPerm] = []
        self._pos_chains = 0
        self.range_checked: List[int] = []
        self.n_public = 0
        self.n_public_inputs = 0  # evm_read bytes (precede evm_write bytes)
        self.public_wires: List[int] = []
        self._const_cache: Dict[int, int] = {}
        self._watches: List[Tuple[str, object]] = []

    # -- wires & rows ------------------------------------------------------
    def _new_wire(self) -> int:
        w = self.n_wires
        self.n_wires += 1
        return w

    def _read(self, wire: int) -> int:
        self.read_counts[wire] = self.read_counts.get(wire, 0) + 1
        return wire

    def _row(self, row: cpu.Row):
        self.rows.append(row)
        self.events.append(("row", len(self.rows) - 1))

    def _ports(self, qm_pair, terms):
        ins = [0, 0, 0, 0]
        act = [0, 0, 0, 0]
        qs = [0, 0, 0, 0]
        if qm_pair is not None:
            qm, w1, w2 = qm_pair
            ins[0], ins[1] = self._read(w1), self._read(w2)
            act[0] = act[1] = 1
            port = 2
        else:
            qm = 0
            port = 0
        for coef, w in terms:
            assert port < 4, "too many terms for one row"
            ins[port] = self._read(w)
            act[port] = 1
            qs[port] = coef % gl.P
            port += 1
        return ins, act, qs, qm % gl.P

    def _arith(self, q0=0, terms=(), qm_pair=None) -> Variable:
        """out := q0 + sum qi*wire_i (+ qm*w1*w2)."""
        out = self._new_wire()
        ins, act, qs, qm = self._ports(qm_pair, terms)
        self._row(
            cpu.Row(
                q=(q0 % gl.P, qs[0], qs[1], qs[2], qs[3], qm),
                out_idx=out,
                in_idx=tuple(ins),
                in_act=tuple(act),
                constrain=1,
                defines=1,
            )
        )
        return Variable(out)

    def _assert_expr_zero(self, q0=0, terms=(), qm_pair=None):
        """Constrain q0 + sum qi*wi (+ qm*w1*w2) == 0 (out pinned to the
        zero-constant wire through an out-receive)."""
        z = self.zero().wire
        ins, act, qs, qm = self._ports(qm_pair, terms)
        self._row(
            cpu.Row(
                q=(q0 % gl.P, qs[0], qs[1], qs[2], qs[3], qm),
                out_idx=self._read(z),
                in_idx=tuple(ins),
                in_act=tuple(act),
                constrain=1,
                defines=0,
            )
        )

    # -- constants & field ops --------------------------------------------
    def constant(self, value: int) -> Variable:
        value = int(value) % gl.P
        if value in self._const_cache:
            return Variable(self._const_cache[value])
        out = self._new_wire()
        self._row(
            cpu.Row(q=(value, 0, 0, 0, 0, 0), out_idx=out, constrain=1, defines=1)
        )
        self._const_cache[value] = out
        return Variable(out)

    def zero(self) -> Variable:
        return self.constant(0)

    def one(self) -> Variable:
        return self.constant(1)

    def _true(self) -> BoolVariable:
        return BoolVariable(self.one().wire)

    def _false(self) -> BoolVariable:
        return BoolVariable(self.zero().wire)

    def add(self, a: Variable, b: Variable) -> Variable:
        return self._arith(terms=[(1, a.wire), (1, b.wire)])

    def sub(self, a: Variable, b: Variable) -> Variable:
        return self._arith(terms=[(1, a.wire), (gl.P - 1, b.wire)])

    def mul(self, a: Variable, b: Variable) -> Variable:
        return self._arith(qm_pair=(1, a.wire, b.wire))

    def free_wire(self) -> int:
        out = self._new_wire()
        self._row(cpu.Row(out_idx=out, constrain=0, defines=1))
        return out

    def hint(self, in_vars: Sequence, n_out: int, fn: Callable,
             kind: str = None) -> List[int]:
        """fn(values: list[int]) -> list[int]; outputs become free wires.

        Equivalent capability to plonky2x's hint generators (SURVEY.md D8).
        `kind` tags well-known hint semantics so the batched witness engine
        (frontend/witness.py) can vectorize them; untagged hints run as
        Python callbacks."""
        in_wires = [v.wire if hasattr(v, "wire") else int(v) for v in in_vars]
        outs = [self.free_wire() for _ in range(n_out)]
        self.events.append(("hint", fn, in_wires, outs, kind))
        return outs

    def hint_into(self, in_vars: Sequence, out_wires: Sequence[int], fn: Callable):
        """Like hint(), but fills pre-allocated free wires instead of
        creating new ones (used by witness fetchers filling big structs)."""
        in_wires = [v.wire if hasattr(v, "wire") else int(v) for v in in_vars]
        self.events.append(("hint", fn, in_wires, list(out_wires), None))

    def watch(self, var, label: str):
        self._watches.append((label, var))

    # -- booleans ----------------------------------------------------------
    def assert_bool(self, v: BoolVariable):
        self._assert_expr_zero(qm_pair=(1, v.wire, v.wire), terms=[(gl.P - 1, v.wire)])

    def not_(self, v: BoolVariable) -> BoolVariable:
        return BoolVariable(self._arith(q0=1, terms=[(gl.P - 1, v.wire)]).wire)

    def and_(self, a: BoolVariable, b: BoolVariable) -> BoolVariable:
        return BoolVariable(self.mul(Variable(a.wire), Variable(b.wire)).wire)

    def or_(self, a: BoolVariable, b: BoolVariable) -> BoolVariable:
        return BoolVariable(
            self._arith(
                terms=[(1, a.wire), (1, b.wire)],
                qm_pair=(gl.P - 1, a.wire, b.wire),
            ).wire
        )

    def select(self, c: BoolVariable, a: Variable, b: Variable) -> Variable:
        d = self.sub(a, b)
        return self._arith(qm_pair=(1, c.wire, d.wire), terms=[(1, b.wire)])

    def is_zero(self, a: Variable) -> BoolVariable:
        def inv_hint(vals):
            v = vals[0]
            return [0 if v == 0 else pow(v, gl.P - 2, gl.P)]

        (inv_w,) = self.hint([a], 1, inv_hint, kind="inv0")
        z = self._arith(q0=1, qm_pair=(gl.P - 1, a.wire, inv_w))
        self._assert_expr_zero(qm_pair=(1, z.wire, a.wire))
        return BoolVariable(z.wire)

    def is_equal(self, a: Variable, b: Variable) -> BoolVariable:
        return self.is_zero(self.sub(a, b))

    def assert_is_equal(self, a, b):
        aw = a.wire if hasattr(a, "wire") else a
        bw = b.wire if hasattr(b, "wire") else b
        self._assert_expr_zero(terms=[(1, aw), (gl.P - 1, bw)])

    # -- bytes -------------------------------------------------------------
    def add_byte_check(self, wire: int):
        self._row(
            cpu.Row(
                in_idx=(self._read(wire), 0, 0, 0),
                in_act=(1, 0, 0, 0),
                flags=(0, 0, 0, 0, 1),
            )
        )
        self.range_checked.append(wire)

    def byte_constant(self, value: int) -> ByteVariable:
        assert 0 <= value < 256
        return ByteVariable(self.constant(value).wire)

    def free_byte(self) -> ByteVariable:
        w = self.free_wire()
        self.add_byte_check(w)
        return ByteVariable(w)

    def bytes32_constant(self, data: bytes) -> Bytes32Variable:
        assert len(data) == 32
        return Bytes32Variable(tuple(self.byte_constant(x) for x in data))

    def pack4(self, b3, b2, b1, b0) -> Variable:
        """Big-endian u32 from 4 byte wires."""
        return self._arith(
            terms=[
                (1 << 24, b3.wire),
                (1 << 16, b2.wire),
                (1 << 8, b1.wire),
                (1, b0.wire),
            ]
        )

    def unpack_word_to_bytes(self, word: Variable) -> List[ByteVariable]:
        """u32 word -> 4 big-endian bytes (hint + ranges + pack constraint).
        Also serves as the canonical u32 range proof."""

        def split(vals):
            v = vals[0]
            return [(v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF]

        outs = self.hint([word], 4, split, kind="split4")
        for w in outs:
            self.add_byte_check(w)
        t = self.pack4(*[ByteVariable(w) for w in outs])
        self.assert_is_equal(t, word)
        return [ByteVariable(w) for w in outs]

    def select_bytes32(self, c, a, b) -> Bytes32Variable:
        return Bytes32Variable(
            tuple(
                ByteVariable(self.select(c, Variable(x.wire), Variable(y.wire)).wire)
                for x, y in zip(a.bytes, b.bytes)
            )
        )

    def is_equal_bytes32(self, a, b) -> BoolVariable:
        acc = self._true()
        for off in range(0, 32, 4):
            wa = self.pack4(*a.bytes[off:off + 4])
            wb = self.pack4(*b.bytes[off:off + 4])
            acc = self.and_(acc, self.is_equal(wa, wb))
        return acc

    def assert_bytes32_equal(self, a, b):
        for x, y in zip(a.bytes, b.bytes):
            self.assert_is_equal(Variable(x.wire), Variable(y.wire))

    # -- u32 / u64 ---------------------------------------------------------
    def u32_constant(self, v: int) -> U32Variable:
        assert 0 <= v < TWO32
        return U32Variable(self.constant(v).wire)

    def u64_constant(self, v: int) -> U64Variable:
        return U64Variable(
            self.u32_constant(v & 0xFFFFFFFF), self.u32_constant(v >> 32)
        )

    def u32_add_with_carry(self, a: U32Variable, b: U32Variable, c_in=None):
        def carry_hint(vals):
            return [(vals[0] + vals[1] + (vals[2] if len(vals) > 2 else 0)) >> 32]

        ins = [Variable(a.wire), Variable(b.wire)]
        if c_in is not None:
            ins.append(Variable(c_in.wire))
        (carry_w,) = self.hint(ins, 1, carry_hint,
                               kind="carry3" if c_in is not None else "carry2")
        carry = BoolVariable(carry_w)
        self.assert_bool(carry)
        if c_in is not None:
            s = self._arith(terms=[(1, a.wire), (1, b.wire), (1, c_in.wire)])
            out = self._arith(terms=[(1, s.wire), (gl.P - TWO32, carry_w)])
        else:
            out = self._arith(
                terms=[(1, a.wire), (1, b.wire), (gl.P - TWO32, carry_w)]
            )
        self.unpack_word_to_bytes(out)
        return U32Variable(out.wire), carry

    def u64_add(self, a: U64Variable, b: U64Variable) -> U64Variable:
        lo, c = self.u32_add_with_carry(a.lo, b.lo)
        hi, _ = self.u32_add_with_carry(a.hi, b.hi, c)
        return U64Variable(lo, hi)

    def u64_add_const(self, a: U64Variable, k: int) -> U64Variable:
        return self.u64_add(a, self.u64_constant(k))

    def u32_sub(self, a: U32Variable, b: U32Variable):
        """a - b -> (diff u32, borrow bool)."""

        def borrow_hint(vals):
            return [1 if vals[0] < vals[1] else 0]

        (h_w,) = self.hint([Variable(a.wire), Variable(b.wire)], 1, borrow_hint,
                           kind="borrow2")
        borrow = BoolVariable(h_w)
        self.assert_bool(borrow)
        d = self._arith(terms=[(1, a.wire), (gl.P - 1, b.wire), (TWO32, h_w)])
        self.unpack_word_to_bytes(d)
        return U32Variable(d.wire), borrow

    def u32_sub_with_borrow(self, a: U32Variable, b: U32Variable, b_in: BoolVariable):
        def hint_fn(vals):
            av, bv, bo = vals
            return [1 if av < bv + bo else 0]

        (h_w,) = self.hint(
            [Variable(a.wire), Variable(b.wire), Variable(b_in.wire)], 1,
            hint_fn, kind="borrow3",
        )
        borrow = BoolVariable(h_w)
        self.assert_bool(borrow)
        d = self._arith(
            terms=[
                (1, a.wire),
                (gl.P - 1, b.wire),
                (gl.P - 1, b_in.wire),
                (TWO32, h_w),
            ]
        )
        self.unpack_word_to_bytes(d)
        return U32Variable(d.wire), borrow

    def u64_sub(self, a: U64Variable, b: U64Variable) -> U64Variable:
        lo, borrow = self.u32_sub(a.lo, b.lo)
        hi, _ = self.u32_sub_with_borrow(a.hi, b.hi, borrow)
        return U64Variable(lo, hi)

    def u32_lt(self, a: U32Variable, b: U32Variable) -> BoolVariable:
        _, borrow = self.u32_sub(a, b)
        return borrow

    def u64_lt(self, a: U64Variable, b: U64Variable) -> BoolVariable:
        hi_lt = self.u32_lt(a.hi, b.hi)
        hi_eq = self.is_equal(Variable(a.hi.wire), Variable(b.hi.wire))
        lo_lt = self.u32_lt(a.lo, b.lo)
        return self.or_(hi_lt, self.and_(hi_eq, lo_lt))

    def u64_lte(self, a, b) -> BoolVariable:
        return self.not_(self.u64_lt(b, a))

    def u64_gte(self, a, b) -> BoolVariable:
        return self.u64_lte(b, a)

    def u64_is_equal(self, a, b) -> BoolVariable:
        return self.and_(
            self.is_equal(Variable(a.lo.wire), Variable(b.lo.wire)),
            self.is_equal(Variable(a.hi.wire), Variable(b.hi.wire)),
        )

    def select_u64(self, c, a, b) -> U64Variable:
        return U64Variable(
            U32Variable(self.select(c, Variable(a.lo.wire), Variable(b.lo.wire)).wire),
            U32Variable(self.select(c, Variable(a.hi.wire), Variable(b.hi.wire)).wire),
        )

    def u64_to_be_bytes(self, v: U64Variable) -> List[ByteVariable]:
        hi_bytes = self.unpack_word_to_bytes(Variable(v.hi.wire))
        lo_bytes = self.unpack_word_to_bytes(Variable(v.lo.wire))
        return hi_bytes + lo_bytes

    # -- SHA-256 -----------------------------------------------------------
    def sha256(self, message: Sequence[ByteVariable]) -> Bytes32Variable:
        """Hash fixed-length byte variables via the SHA chip (bus I/O).

        Mirrors reference plonky2x builder.sha256 (circuits/builder.rs:364).
        """
        msg_bytes = list(message)
        L = len(msg_bytes)
        pad = bytearray(b"\x80")
        while (L + len(pad)) % 64 != 56:
            pad.append(0)
        pad += (8 * L).to_bytes(8, "big")
        padded = msg_bytes + [self.byte_constant(x) for x in pad]
        return self.sha256_raw(padded, message_bytes=msg_bytes)

    def sha256_raw(self, padded: Sequence[ByteVariable],
                   message_bytes=None) -> Bytes32Variable:
        """Hash pre-padded 64-byte blocks (used by variable-length hashing:
        padding bytes are circuit-computed selects, not constants)."""
        assert len(padded) % 64 == 0
        inst = len(self.sha_calls)
        blocks = []
        for off in range(0, len(padded), 64):
            blk = padded[off:off + 64]
            word_wires = [
                self.pack4(blk[wo], blk[wo + 1], blk[wo + 2], blk[wo + 3]).wire
                for wo in range(0, 64, 4)
            ]
            blocks.append(word_wires)
        for blk_i, word_wires in enumerate(blocks):
            for slot, w in enumerate(word_wires):
                self._row(
                    cpu.Row(
                        in_idx=(self._read(w), 0, 0, 0),
                        in_act=(1, 0, 0, 0),
                        flags=(0, 1, 0, 0, 0),
                        io=(inst, slot, blk_i),
                    )
                )
        # register the witness-time hash computation BEFORE the digest
        # receive rows so their values are available when those rows run
        digest_wires = []
        call = ShaCall(
            inst, blocks,
            [bv.wire for bv in message_bytes] if message_bytes is not None else None,
            digest_wires,
        )
        self.sha_calls.append(call)
        self.events.append(("sha", call))
        for flag_pos in (2, 3):  # SHA_OUT_A then SHA_OUT_E
            for j in range(4):
                w = self._new_wire()
                flags = [0, 0, 0, 0, 0]
                flags[flag_pos] = 1
                self._row(
                    cpu.Row(
                        out_idx=w, defines=1, flags=tuple(flags), io=(inst, j, 0)
                    )
                )
                digest_wires.append(w)
        out_bytes = []
        for w in digest_wires:
            out_bytes.extend(self.unpack_word_to_bytes(Variable(w)))
        return Bytes32Variable(tuple(out_bytes))

    # -- SHA-512 -----------------------------------------------------------
    def sha512(self, message: Sequence[ByteVariable]) -> List[ByteVariable]:
        """Hash fixed-length byte variables via the SHA-512 chip (bus I/O).

        Returns the 64 digest bytes. Backs the Ed25519 challenge hash
        k = SHA512(R||A||M) (reference starkyx Ed25519, SURVEY.md D11).
        """
        msg_bytes = list(message)
        L = len(msg_bytes)
        pad = bytearray(b"\x80")
        while (L + len(pad)) % 128 != 112:
            pad.append(0)
        pad += (8 * L).to_bytes(16, "big")
        padded = msg_bytes + [self.byte_constant(x) for x in pad]
        return self.sha512_raw(padded, message_bytes=msg_bytes)

    def sha512_raw(self, padded: Sequence[ByteVariable],
                   message_bytes=None) -> List[ByteVariable]:
        """Hash pre-padded 128-byte blocks (variable-length support)."""
        assert len(padded) % 128 == 0
        inst = len(self.sha512_calls)
        blocks = []
        for off in range(0, len(padded), 128):
            blk = padded[off:off + 128]
            half_wires = []
            for wo in range(0, 128, 8):
                hi = self.pack4(blk[wo], blk[wo + 1], blk[wo + 2], blk[wo + 3])
                lo = self.pack4(blk[wo + 4], blk[wo + 5], blk[wo + 6], blk[wo + 7])
                half_wires.extend([lo.wire, hi.wire])
            blocks.append(half_wires)
        for blk_i, half_wires in enumerate(blocks):
            for halfslot, w in enumerate(half_wires):
                self._row(
                    cpu.Row(
                        in_idx=(self._read(w), 0, 0, 0),
                        in_act=(1, 0, 0, 0),
                        flags=(0, 0, 0, 0, 0, 1, 0, 0),
                        io=(inst, halfslot, blk_i),
                    )
                )
        digest_wires = []
        call = Sha512Call(
            inst, blocks,
            [bv.wire for bv in message_bytes] if message_bytes is not None else None,
            digest_wires,
        )
        self.sha512_calls.append(call)
        self.events.append(("sha512", call))
        for flag_pos in (5, 6):  # S512_OUT_A then S512_OUT_E (receive flags 6, 7)
            for halfj in range(8):
                w = self._new_wire()
                flags = [0] * 8
                flags[flag_pos + 1] = 1
                self._row(
                    cpu.Row(
                        out_idx=w, defines=1, flags=tuple(flags), io=(inst, halfj, 0)
                    )
                )
                digest_wires.append(w)
        out_bytes = []
        for j in range(8):
            # word j: big-endian bytes = hi32 then lo32
            base = 2 * (j % 4) + (0 if j < 4 else 8)
            lo_w, hi_w = digest_wires[base], digest_wires[base + 1]
            out_bytes.extend(self.unpack_word_to_bytes(Variable(hi_w)))
            out_bytes.extend(self.unpack_word_to_bytes(Variable(lo_w)))
        return out_bytes

    # -- Poseidon (chips/poseidon.py; backs in-circuit recursion) -----------
    def pos_new_chain(self) -> int:
        """Allocate a chain id; perms with the same chain id carry state
        in-chip (sponge / transcript duplex / Merkle climbs)."""
        c = self._pos_chains
        self._pos_chains += 1
        return c

    def pos_perm(self, chain: int, cpos: int, absorb: Dict[int, int],
                 carry=(), merkle=False, sib_wires=(), dir_wire=-1) -> PosPerm:
        """Schedule one permutation. absorb: {lane: wire}; carry: lanes
        carried from the previous perm of the chain; merkle mode instead
        consumes 4 sibling wires + a direction wire and dir-selects against
        the previous perm's digest in-chip."""
        inst = len(self.pos_perms)
        perm = PosPerm(inst, chain, cpos, dict(absorb), tuple(carry),
                       merkle, tuple(sib_wires), dir_wire)
        self.pos_perms.append(perm)
        flags_in = (0,) * 10 + (1, 0)
        if merkle:
            assert not absorb and not carry and cpos > 0
            ins = [(w, 12 + j) for j, w in enumerate(sib_wires)] + [(dir_wire, 16)]
        else:
            ins = [(w, lane) for lane, w in sorted(absorb.items())]
        for w, slot in ins:
            self._row(cpu.Row(
                in_idx=(self._read(w), 0, 0, 0), in_act=(1, 0, 0, 0),
                flags=flags_in, io=(inst, slot, 0),
            ))
        self.events.append(("pos", perm))
        return perm

    def pos_read(self, perm: PosPerm, lane: int) -> Variable:
        """Read one output lane of a scheduled permutation."""
        assert lane not in perm.out_lanes, "lane already read"
        perm.out_lanes.add(lane)
        w = self._new_wire()
        self._row(cpu.Row(
            out_idx=w, defines=1, flags=(0,) * 11 + (1,),
            io=(perm.inst, lane, 0),
        ))
        return Variable(w)

    # -- variable-length hashing ------------------------------------------
    def _pad_variable(self, message, length, min_len, block: int):
        """FIPS padding with circuit-computed position (len in [min_len, max]).

        Returns the padded byte list covering ceil((max_len+17)/block) blocks
        for SHA-256 (block=64, 8-byte length) or 2 blocks for SHA-512
        (block=128, 16-byte length).
        """
        max_len = len(message)
        len_field = 8 if block == 64 else 16
        n_blocks = (max_len + 1 + len_field + block - 1) // block
        total = n_blocks * block
        assert min_len + 1 + len_field <= total
        zero = self.byte_constant(0)
        # done_i = (length <= i); eq_i = (length == i)
        done = self._false()
        eq = {}
        for i in range(min_len, max_len + 1):
            eq[i] = self.is_equal(Variable(length.wire), self.constant(i))
            done = self.or_(done, eq[i])
            eq[i] = (eq[i], done)
        padded = []
        for i in range(total - len_field):
            if i < min_len:
                padded.append(message[i])
            elif i <= max_len:
                eq_i, done_i = eq[i]
                m_i = message[i] if i < max_len else zero
                # (1-done)*m + eq*0x80
                keep = self.mul(
                    self.sub(self.one(), Variable(done_i.wire)), Variable(m_i.wire)
                )
                v = self._arith(terms=[(1, keep.wire), (0x80, eq_i.wire)])
                padded.append(ByteVariable(v.wire))
            else:
                padded.append(zero)
        # length field: 8*length fits 16 bits for both block sizes here
        bitlen = self._arith(terms=[(8, length.wire)])

        def split2(vals):
            return [vals[0] >> 8, vals[0] & 0xFF]

        hi_w, lo_w = self.hint([bitlen], 2, split2, kind="split2")
        self.add_byte_check(hi_w)
        self.add_byte_check(lo_w)
        self._assert_expr_zero(
            terms=[(256, hi_w), (1, lo_w), (gl.P - 1, bitlen.wire)]
        )
        padded += [zero] * (len_field - 2)
        padded += [ByteVariable(hi_w), ByteVariable(lo_w)]
        return padded

    def sha256_var(self, message, length: U32Variable,
                   min_len: int = 0) -> Bytes32Variable:
        """SHA-256 of message[:length] (single-block: max_len <= 55)."""
        assert len(message) <= 55
        return self.sha256_raw(
            self._pad_variable(list(message), length, min_len, 64)
        )

    def sha512_var(self, message, length: U32Variable,
                   min_len: int) -> List[ByteVariable]:
        """SHA-512 of message[:length]; requires 112 <= min_len <= length
        so the block count (2) is static."""
        assert 112 <= min_len and len(message) <= 239
        return self.sha512_raw(
            self._pad_variable(list(message), length, min_len, 128)
        )

    # -- Ed25519 -----------------------------------------------------------
    def _pack2(self, lo: ByteVariable, hi: ByteVariable) -> Variable:
        return self._arith(terms=[(1, lo.wire), (256, hi.wire)])

    def _ed_send_point(self, inst: int, which: int, data):
        """Send a compressed point (32 ByteVariables) as 16 LE limbs + sign."""
        b31 = data[31]

        def sign_hint(vals):
            return [vals[0] >> 7]

        (sgn_w,) = self.hint([Variable(b31.wire)], 1, sign_hint, kind="shr7")
        self.assert_bool(BoolVariable(sgn_w))
        low7 = self._arith(terms=[(1, b31.wire), (gl.P - 128, sgn_w)])
        self.add_byte_check(low7.wire)
        dbl = self._arith(terms=[(2, low7.wire)])
        self.add_byte_check(dbl.wire)  # 2*low7 < 256 => low7 < 128
        for j in range(16):
            if j < 15:
                limb = self._pack2(data[2 * j], data[2 * j + 1])
            else:
                limb = self._arith(terms=[(1, data[30].wire), (256, low7.wire)])
            self._row(
                cpu.Row(
                    in_idx=(self._read(limb.wire), 0, 0, 0),
                    in_act=(1, 0, 0, 0),
                    flags=(0, 0, 0, 0, 0, 0, 0, 0, 1, 0),
                    io=(inst, j, which),
                )
            )
        self._row(
            cpu.Row(
                in_idx=(self._read(sgn_w), 0, 0, 0),
                in_act=(1, 0, 0, 0),
                flags=(0, 0, 0, 0, 0, 0, 0, 0, 1, 0),
                io=(inst, 16, which),
            )
        )

    def _ed_send_scalar_limbs(self, inst: int, which: int, byte_vars):
        for g in range(len(byte_vars) // 2):
            limb = self._pack2(byte_vars[2 * g], byte_vars[2 * g + 1])
            self._row(
                cpu.Row(
                    in_idx=(self._read(limb.wire), 0, 0, 0),
                    in_act=(1, 0, 0, 0),
                    flags=(0, 0, 0, 0, 0, 0, 0, 0, 0, 1),
                    io=(inst, g, which),
                )
            )

    def assert_bytes_lt_le(self, a_bytes, bound: int):
        """Assert the little-endian byte string a < bound (e.g. S < L)."""
        n = len(a_bytes)
        lt = self._false()
        for g in range(n // 4):
            w = self._arith(terms=[
                (1, a_bytes[4 * g].wire), (1 << 8, a_bytes[4 * g + 1].wire),
                (1 << 16, a_bytes[4 * g + 2].wire), (1 << 24, a_bytes[4 * g + 3].wire),
            ])
            bw = self.u32_constant((bound >> (32 * g)) & 0xFFFFFFFF)
            word = U32Variable(w.wire)
            eq = self.is_equal(Variable(w.wire), Variable(bw.wire))
            lt_g = self.u32_lt(word, bw)
            # scan from LSW to MSW: lt = eq ? lt : lt_g
            lt = BoolVariable(
                self.select(eq, Variable(lt.wire), Variable(lt_g.wire)).wire
            )
        self.assert_is_equal(Variable(lt.wire), self.one())

    def ed25519_verify(self, pubkey, signature, message, msg_len: U32Variable,
                       min_msg_len: int):
        """Verify an Ed25519 signature in-circuit.

        pubkey: 32 ByteVariables; signature: 64 (R || S); message: byte
        variables padded to the max length with msg_len the true length.
        Links the SHA-512 chip (challenge hash) and the Ed25519 EC chip
        (curve equation) over the bus. Reference: starkyx Ed25519 gadget
        used by tendermintx vote verification (SURVEY.md D11/D13).
        """
        inst = len(self.ed_calls)
        r_bytes = list(signature[:32])
        s_bytes = list(signature[32:])
        # k512 = SHA512(R || A || M)
        total_len = self._arith(q0=64, terms=[(1, msg_len.lo.wire)])
        digest = self.sha512_var(
            r_bytes + list(pubkey) + list(message),
            U32Variable(total_len.wire),
            64 + min_msg_len,
        )
        self._ed_send_point(inst, 0, list(pubkey))  # WHICH_A
        self._ed_send_point(inst, 1, r_bytes)       # WHICH_R
        self.assert_bytes_lt_le(s_bytes, ED_L)
        self._ed_send_scalar_limbs(inst, 2, s_bytes)  # WHICH_S
        self._ed_send_scalar_limbs(inst, 3, digest)   # WHICH_K (k512, LE)
        self.ed_calls.append(
            EdCall(
                inst,
                [b.wire for b in pubkey],
                [b.wire for b in signature],
                [b.wire for b in message],
                msg_len.lo.wire,
            )
        )

    # -- public I/O --------------------------------------------------------
    def _public_byte(self, wire: int):
        pos = self.n_public
        self.n_public += 1
        self.public_wires.append(wire)
        self._row(
            cpu.Row(
                in_idx=(self._read(wire), 0, 0, 0),
                in_act=(1, 0, 0, 0),
                flags=(1, 0, 0, 0, 0),
                io=(0, pos, 0),
            )
        )

    def evm_read_bytes32(self) -> Bytes32Variable:
        bs = []
        for _ in range(32):
            b = self.free_byte()
            self._public_byte(b.wire)
            bs.append(b)
        self.n_public_inputs += 32
        return Bytes32Variable(tuple(bs))

    def evm_read_u64(self) -> U64Variable:
        bs = [self.free_byte() for _ in range(8)]
        for b in bs:
            self._public_byte(b.wire)
        self.n_public_inputs += 8
        hi = self.pack4(bs[0], bs[1], bs[2], bs[3])
        lo = self.pack4(bs[4], bs[5], bs[6], bs[7])
        return U64Variable(U32Variable(lo.wire), U32Variable(hi.wire))

    def evm_write_bytes32(self, v: Bytes32Variable):
        for b in v.bytes:
            self._public_byte(b.wire)

    def build(self) -> "CompiledCircuit":
        for row in self.rows:
            if row.defines:
                row.mult_out = self.read_counts.get(row.out_idx, 0)
        return CompiledCircuit(self)


class CompiledCircuit:
    """Frozen circuit: preprocessed tables + witness generator."""

    def __init__(self, builder: CircuitBuilder):
        self.b = builder
        self.n_public_inputs = builder.n_public_inputs
        self.n_cpu_rows = 1 << max(4, (len(builder.rows) - 1).bit_length())
        self.cpu_air = cpu.CpuAir(builder.rows, self.n_cpu_rows)
        # an empty accelerator table is dropped entirely: its bus channels
        # simply carry no messages, so the balance argument is unaffected
        self.sha_air = None
        n_blocks = sum(len(c.blocks_word_wires) for c in builder.sha_calls)
        if n_blocks:
            seg_rows = n_blocks * sha_chip.SEGMENT
            self.n_sha_rows = 1 << max(8, (seg_rows - 1).bit_length())
            self.sha_schedule = sha_chip.schedule_for(
                [len(c.blocks_word_wires) for c in builder.sha_calls],
                self.n_sha_rows,
            )
            self.sha_air = sha_chip.Sha256Air(self.sha_schedule, self.n_sha_rows)
        self.sha512_air = None
        n_blocks512 = sum(len(c.blocks_half_wires) for c in builder.sha512_calls)
        if n_blocks512:
            seg512 = n_blocks512 * sha512_chip.SEGMENT
            self.n_sha512_rows = 1 << max(7, (seg512 - 1).bit_length())
            self.sha512_schedule = sha512_chip.schedule_for(
                [len(c.blocks_half_wires) for c in builder.sha512_calls],
                self.n_sha512_rows,
            )
            self.sha512_air = sha512_chip.Sha512Air(
                self.sha512_schedule, self.n_sha512_rows
            )
        self.pos_air = None
        if builder.pos_perms:
            self.n_pos_rows = 1 << max(4, (len(builder.pos_perms) - 1).bit_length())
            self.pos_schedule = pos_chip.pad_schedule(
                [
                    pos_chip.PermSpec(
                        p.inst, p.chain, p.cpos,
                        absorb=tuple(sorted(p.absorb)), carry=p.carry,
                        merkle=p.merkle, out_lanes=tuple(sorted(p.out_lanes)),
                    )
                    for p in builder.pos_perms
                ],
                self.n_pos_rows,
            )
            self.pos_air = pos_chip.PoseidonAir(self.pos_schedule, self.n_pos_rows)
        self.bytes_air = bytes_chip.BytesAir()
        self.ed_air = None
        if builder.ed_calls:
            na, nb = getattr(builder, "ed_nbits", (512, 256))
            seg = 4 + 2 * na + nb
            n_ed = 1 << max(6, (len(builder.ed_calls) * seg - 1).bit_length())
            self.ed_air = ed_chip.Ed25519Air(
                [ed_chip.SigInfo(c.inst) for c in builder.ed_calls],
                n_ed, nbits_a=na, nbits_b=nb,
            )
            self.range16_air = range16_chip.Range16Air()

    def generate_witness(self, public_inputs: Dict[int, int] = None) -> np.ndarray:
        """Run the program through the batched witness engine
        (frontend/witness.py): leveled schedule, vectorized sweeps.
        public_inputs: {position: byte}."""
        return self._witness(public_inputs, sequential=False)

    def generate_witness_interp(self, public_inputs: Dict[int, int] = None) -> np.ndarray:
        """Sequential oracle: same dataflow schedule as generate_witness but
        one op at a time via python ints and the hints' original callbacks
        (frontend/witness.py run_sequential). Dataflow (level) order, not
        event-emission order: gadgets may consume allocated wires that a
        later-registered hint_into fills."""
        return self._witness(public_inputs, sequential=True)

    def _witness(self, public_inputs, sequential: bool) -> np.ndarray:
        from . import witness as wmod

        if not hasattr(self, "_witness_program"):
            self._witness_program = wmod.WitnessProgram(self.b)
        b = self.b
        vals = np.zeros(b.n_wires, dtype=np.uint64)
        for pos, byte in (public_inputs or {}).items():
            vals[b.public_wires[pos]] = byte
        if sequential:
            self._witness_program.run_sequential(vals)
            return vals
        self._witness_program.run(vals)
        for label, var in b._watches:
            try:
                print(f"[watch] {label}: {self._render(var, vals)}")
            except Exception:
                pass
        return vals

    @staticmethod
    def _render(var, vals):
        if isinstance(var, Bytes32Variable):
            return bytes(int(vals[x.wire]) & 0xFF for x in var.bytes).hex()
        if isinstance(var, U64Variable):
            return int(vals[var.lo.wire]) | (int(vals[var.hi.wire]) << 32)
        if hasattr(var, "wire"):
            return int(vals[var.wire])
        return var

    def _trace_gathers(self):
        """Build-once gather indices for trace materialization."""
        b = self.b
        return {
            "cpu": cpu.trace_index_arrays(b.rows),
            "sha": [np.array(c.blocks_word_wires, dtype=np.int64) for c in b.sha_calls],
            "sha512": [np.array(c.blocks_half_wires, dtype=np.int64)
                       for c in b.sha512_calls],
            "range": np.array(b.range_checked, dtype=np.int64),
            "ed": [(np.array(c.pubkey_wires, dtype=np.int64),
                    np.array(c.sig_wires, dtype=np.int64),
                    np.array(c.msg_wires, dtype=np.int64), c.len_wire)
                   for c in b.ed_calls],
        }

    def traces(self, vals: np.ndarray, device=None) -> Dict[str, np.ndarray]:
        """Every table's trace from the solved wires (host numpy); the pos
        table's S-box columns are computed on ``device`` (None: the card)."""
        b = self.b
        if not hasattr(self, "_gathers"):
            self._gathers = self._trace_gathers()
        g = self._gathers
        out = {"cpu": cpu.build_trace(self.b.rows, vals, self.n_cpu_rows, g["cpu"])}
        if self.sha_air is not None:
            messages = [vals[idx].astype(np.uint32) for idx in g["sha"]]
            out["sha"] = sha_chip.build_trace(messages, self.n_sha_rows, self.sha_schedule)
        if self.sha512_air is not None:
            messages512 = []
            for idx in g["sha512"]:
                halves = vals[idx]  # (nblk, 32) (lo, hi) interleaved
                messages512.append(halves[:, 0::2] | (halves[:, 1::2] << np.uint64(32)))
            out["sha512"] = sha512_chip.build_trace(
                messages512, self.n_sha512_rows, self.sha512_schedule
            )
        if self.pos_air is not None:
            absorb_vals = {
                p.inst: {lane: int(vals[w]) for lane, w in p.absorb.items()}
                for p in b.pos_perms
            }
            sib_vals = {
                p.inst: [int(vals[w]) for w in p.sib_wires]
                for p in b.pos_perms if p.merkle
            }
            dir_vals = {
                p.inst: int(vals[p.dir_wire]) for p in b.pos_perms if p.merkle
            }
            out["pos"] = pos_chip.build_trace(
                self.pos_schedule, absorb_vals, sib_vals, dir_vals, device
            )
        counts = np.bincount(
            (vals[g["range"]] & np.uint64(0xFF)).astype(np.int64), minlength=256
        ).astype(np.uint64) if g["range"].size else np.zeros(256, dtype=np.uint64)
        if self.ed_air is not None:
            sigs = []
            for pk_idx, sig_idx, msg_idx, len_wire in g["ed"]:
                mlen = int(vals[len_wire])
                sigs.append(ed_chip.SigWitness(
                    pubkey=vals[pk_idx].astype(np.uint8).tobytes(),
                    msg=vals[msg_idx[:mlen]].astype(np.uint8).tobytes(),
                    signature=vals[sig_idx].astype(np.uint8).tobytes(),
                ))
            ed_trace = ed_chip.build_trace(self.ed_air, sigs)
            r16, r8 = ed_chip.range_counts(self.ed_air, ed_trace)
            counts += r8
            out["ed"] = ed_trace
            out["range16"] = range16_chip.build_trace(r16)
        out["bytes"] = bytes_chip.build_trace(counts)
        return out

    def public_values(self, vals: np.ndarray) -> List[int]:
        return [int(vals[w]) for w in self.b.public_wires]

    def public_messages(self, public_bytes: Sequence[int]):
        """PUBLIC-channel messages the verifier contributes (receiving what
        the circuit published)."""
        return [
            (ch.PUBLIC, [pos, int(v)], -1) for pos, v in enumerate(public_bytes)
        ]

    # -- proving -----------------------------------------------------------
    def airs(self) -> List:
        """The proof system's tables, in order (empty tables omitted)."""
        ed = (self.ed_air, self.range16_air) if self.ed_air is not None else ()
        return [air for air in (self.cpu_air, self.sha_air, self.sha512_air,
                                self.pos_air) + ed + (self.bytes_air,) if air is not None]

    def _table_names(self) -> List[str]:
        names = ["cpu"]
        if self.sha_air is not None:
            names.append("sha")
        if self.sha512_air is not None:
            names.append("sha512")
        if self.pos_air is not None:
            names.append("pos")
        if self.ed_air is not None:
            names += ["ed", "range16"]
        return names + ["bytes"]

    def specs(self, traces: Dict[str, np.ndarray], pks=None) -> List[system.TableSpec]:
        """The tables as the system prover takes them."""
        return [
            system.TableSpec(name, air, traces[name], [], pks[i] if pks else None)
            for i, (name, air) in enumerate(zip(self._table_names(), self.airs()))
        ]

    def prove(self, public_inputs: Dict[int, int], cfg=None, pks=None,
              device=None, timer=None):
        """Witness, traces and the system proof. ``device`` None is the
        card; ``timer`` (a system.PhaseTimer) collects the seconds of the
        host phases "witness" and "traces" and of every prover phase."""
        dev = devmod.resolve(device)
        cfg = cfg or stark.StarkConfig()
        timer = timer or system.PhaseTimer()
        timer.mark("witness", None)
        vals = self.generate_witness(public_inputs)
        timer.mark("traces", None)
        traces = self.traces(vals, dev)
        proof = system.prove_system(self.specs(traces, pks), cfg, device=dev,
                                    timer=timer)
        return proof, self.public_values(vals)

    def verify(self, proof, public_bytes: Sequence[int], cfg=None, vks=None,
               device=None) -> bool:
        cfg = cfg or stark.StarkConfig()
        airs = self.airs()
        return system.verify_system(
            airs,
            [[] for _ in airs],
            proof,
            cfg,
            vks=vks,
            public_messages=self.public_messages(public_bytes),
            device=device,
        )

    def build_keys(self, cfg=None, device=None):
        """Commit every table's preprocessed columns: (pks, vks)."""
        cfg = cfg or stark.StarkConfig()
        dev = devmod.resolve(device)
        sizes = self.table_sizes()
        pks, vks = [], []
        for name, air in zip(self._table_names(), self.airs()):
            pk, vk = stark.build(air, sizes[name], cfg, dev)
            pks.append(pk)
            vks.append(vk)
        return pks, vks

    def table_sizes(self) -> Dict[str, int]:
        """Rows of every table, by name."""
        sizes = {"cpu": self.n_cpu_rows, "bytes": bytes_chip.N_ROWS}
        if self.sha_air is not None:
            sizes["sha"] = self.n_sha_rows
        if self.sha512_air is not None:
            sizes["sha512"] = self.n_sha512_rows
        if self.pos_air is not None:
            sizes["pos"] = self.n_pos_rows
        if self.ed_air is not None:
            sizes["ed"] = self.ed_air.n_rows
            sizes["range16"] = range16_chip.N_ROWS
        return sizes
