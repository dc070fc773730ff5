"""Ed25519 signature-verification AIR ("chip") with bus I/O.

The port's copy of ``blobstreamx_tpu/chips/ed25519.py``.

TPU-native equivalent of the reference's starkyx curve25519 STARK
accelerator (SURVEY.md D11). One segment proves one signature:

    [S]B == R + [k512]A

where k512 = SHA512(R||A||M) (full 512-bit value, unreduced — equal to the
RFC-8032 check for prime-order keys; diverges only on adversarial keys
with small-order components, the same gray zone batch verifiers and ZIP215
occupy). The SHA-512 itself is proved by the SHA-512 chip; the challenge
bytes flow CPU -> here over the bus as 16-bit limbs.

Row = one unified twisted-Edwards addition (a = -1, extended coordinates),
9 modular muls over 2^255-19, each with a carry-polynomial identity on
16-bit limbs (all limbs/carries range-checked via the range16/bytes chips):

    u(x)*v(x) - c(x) - q(x)*p(x) = (x - 2^16) * k(x)

Segment layout (SEG = 4 + 2*nbits_a + nbits_b):
  row 0        LOAD_A: decompress pubkey A -> D, ACC <- neutral
  row 1        LOAD_R: decompress R -> REG
  rows 2..     phase A: nbits_a pairs (CADD_A, DBL): ACC += bit_i * D,
               D <- 2D   (computes [k512]A, bits LSB-first)
  row addr     ADDR: REG <- ACC + REG (= [k512]A + R), ACC <- neutral
  rows ..      phase B: nbits_b CADD_B rows with preprocessed [2^i]B
  row final    FINAL: projective equality ACC == REG

Scalar bits are packed 16 per limb and checked against bus-received limbs
at group-end rows. Point decompression enforces canonical encodings
(x < p, y < p, parity == sign bit).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..field.goldilocks import P as GL_P
from ..proof.air import Air, AirBuilder, Elem
from ..tendermint import ed25519 as ed
from . import channels as ch

P25519 = ed.P
BETA = 1 << 16
NLIMB = 16
OFFSET = 1 << 23  # carry-coefficient offset: k + OFFSET = klo + 2^16*khi


def to_limbs(v: int, n: int = NLIMB) -> List[int]:
    return [(v >> (16 * i)) & 0xFFFF for i in range(n)]


PL = to_limbs(P25519)
PM1L = to_limbs(P25519 - 1)
DL = to_limbs(ed.D)
D2L = to_limbs(2 * ed.D % P25519)
THREEP = to_limbs(3 * P25519, 17)
ONEL = to_limbs(1)
ZEROL = to_limbs(0)
TWOL = to_limbs(2)

# ---------------------------------------------------------------------------
# column map
# ---------------------------------------------------------------------------

REG_D = 0     # X, Y, Z, T x 16 limbs
REG_ACC = 64
REG_REG = 128
SLOT0 = 192
SLOT_SIZE = 99  # c16 + q17 + klo33 + khi33
C_OFF, Q_OFF, KLO_OFF, KHI_OFF = 0, 16, 33, 66
N_SLOTS = 9
COL_BIT = SLOT0 + N_SLOTS * SLOT_SIZE  # 1083
COL_PK = COL_BIT + 1
COL_SC = COL_BIT + 2
COL_SGN = COL_BIT + 3
COL_H15 = COL_BIT + 4
COL_M1 = COL_BIT + 5
COL_M2 = COL_BIT + 6
WIDTH = COL_BIT + 7

# preprocessed
T_LOAD_A, T_LOAD_R, T_DBL, T_CADD_A, T_CADD_B, T_ADDR, T_FINAL = range(7)
P_GEND = 7
P_PKZERO = 8
P_GIDX = 9
P_WEIGHT = 10
P_WHICH = 11
P_INST = 12
P_REAL = 13
P_BT = 14  # 48 cols: x, y, t limbs of the B power
PRE_WIDTH = P_BT + 48

# scalar channel "which" ids
WHICH_A, WHICH_R, WHICH_S, WHICH_K = 0, 1, 2, 3

X, Y, Z, T = 0, 1, 2, 3


def slot_col(s: int, off: int) -> int:
    return SLOT0 + s * SLOT_SIZE + off


# ---------------------------------------------------------------------------
# operand specs: (terms, const_limbs) with terms = [(coeff, source)],
# source = ('reg', base_col+coord*16) | ('c', slot) | ('bt', 0..2)
# ---------------------------------------------------------------------------

def _reg(base, coord):
    return ("reg", base + 16 * coord)


def _add_dataflow(p1_base, p2):
    """p2: register base, 'bt' (B table) or 'reg_r'. Returns slot specs."""
    if p2 == "bt":
        x2, y2, t2 = ("bt", 0), ("bt", 1), ("bt", 2)
        z2_terms, z2_const = [], TWOL  # 2*Z2 with Z2 = 1
    else:
        x2, y2, t2 = _reg(p2, X), _reg(p2, Y), _reg(p2, T)
        z2_terms, z2_const = [(2, _reg(p2, Z))], None
    x1, y1, z1, t1 = (_reg(p1_base, c) for c in (X, Y, Z, T))
    E = ([(1, ("c", 1)), (-1, ("c", 0))], THREEP)
    F = ([(1, ("c", 4)), (-1, ("c", 3))], THREEP)
    G = ([(1, ("c", 4)), (1, ("c", 3))], None)
    H = ([(1, ("c", 1)), (1, ("c", 0))], None)
    return {
        0: (([(1, y1), (-1, x1)], THREEP), ([(1, y2), (-1, x2)], THREEP)),
        1: (([(1, y1), (1, x1)], None), ([(1, y2), (1, x2)], None)),
        2: (([(1, t1)], None), ([(1, t2)], None)),
        3: (([(1, ("c", 2))], None), ([], D2L)),  # C * 2d
        4: (([(1, z1)], None), (z2_terms, z2_const)),
        5: (E, F),   # X3
        6: (G, H),   # Y3
        7: (E, H),   # T3
        8: (F, G),   # Z3
    }


SLOTS_BY_TYPE: Dict[int, Dict[int, tuple]] = {
    T_DBL: _add_dataflow(REG_D, REG_D),
    T_CADD_A: _add_dataflow(REG_ACC, REG_D),
    T_CADD_B: _add_dataflow(REG_ACC, "bt"),
    T_ADDR: _add_dataflow(REG_ACC, REG_REG),
    T_LOAD_A: {
        0: (([(1, ("c", 7))], None), ([(1, ("c", 7))], None)),  # y^2
        1: (([(1, ("c", 6))], None), ([(1, ("c", 6))], None)),  # x^2
        2: (([(1, ("c", 0))], None), ([(1, ("c", 1))], None)),  # x^2 y^2
        3: (([(1, ("c", 2))], None), ([], DL)),                 # d x^2 y^2
        5: (([(1, ("c", 6))], None), ([(1, ("c", 7))], None)),  # t = x*y
    },
    T_FINAL: {
        0: (([(1, _reg(REG_ACC, X))], None), ([(1, _reg(REG_REG, Z))], None)),
        1: (([(1, _reg(REG_REG, X))], None), ([(1, _reg(REG_ACC, Z))], None)),
        2: (([(1, _reg(REG_ACC, Y))], None), ([(1, _reg(REG_REG, Z))], None)),
        3: (([(1, _reg(REG_REG, Y))], None), ([(1, _reg(REG_ACC, Z))], None)),
    },
}
SLOTS_BY_TYPE[T_LOAD_R] = SLOTS_BY_TYPE[T_LOAD_A]

# P3 = (X3, Y3, Z3, T3) slots
P3_SLOTS = (5, 6, 8, 7)


@dataclass
class SigInfo:
    """Schedule entry: one signature instance (or a dummy filler)."""

    inst: int
    real: bool = True


class Ed25519Air(Air):
    pre_offsets = (0,)
    row_offsets = (0, 1)
    max_constraint_degree = 6
    width = WIDTH
    pre_width = PRE_WIDTH

    def __init__(self, schedule: List[SigInfo], n_rows: int,
                 nbits_a: int = 512, nbits_b: int = 256):
        assert nbits_a % 16 == 0 and nbits_b % 16 == 0
        self.schedule = schedule
        self.n_rows = n_rows
        self.nbits_a = nbits_a
        self.nbits_b = nbits_b
        self.seg = 4 + 2 * nbits_a + nbits_b
        assert len(schedule) * self.seg <= n_rows
        # affine B powers [2^i]B as (x, y, t) limb arrays
        self.b_powers = []
        pt = ed.BASE
        for _ in range(nbits_b):
            x, y, z, _t = pt
            zi = pow(z, P25519 - 2, P25519)
            xa, ya = x * zi % P25519, y * zi % P25519
            self.b_powers.append((xa, ya, xa * ya % P25519))
            pt = ed.point_add(pt, pt)

    # -- segment row helpers ----------------------------------------------
    def row_type(self, r: int) -> Optional[int]:
        """Row index within a segment -> row type."""
        na, nb = self.nbits_a, self.nbits_b
        if r == 0:
            return T_LOAD_A
        if r == 1:
            return T_LOAD_R
        if r < 2 + 2 * na:
            return T_CADD_A if (r - 2) % 2 == 0 else T_DBL
        if r == 2 + 2 * na:
            return T_ADDR
        if r < 3 + 2 * na + nb:
            return T_CADD_B
        if r == 3 + 2 * na + nb:
            return T_FINAL
        return None

    def row_types(self) -> np.ndarray:
        """Row type of every trace row, -1 outside real segments."""
        seg_types = np.asarray([self.row_type(r) for r in range(self.seg)], dtype=np.int64)
        out = np.full(self.n_rows, -1, dtype=np.int64)
        for si, sig in enumerate(self.schedule):
            if sig.real:
                out[si * self.seg:(si + 1) * self.seg] = seg_types
        return out

    def _segment_pre(self) -> np.ndarray:
        """The preprocessed rows of one real segment, instance 0."""
        pre = np.zeros((self.seg, PRE_WIDTH), dtype=np.uint64)
        na, nb = self.nbits_a, self.nbits_b
        addr_r = 2 + 2 * na
        for row in range(self.seg):
            t = self.row_type(row)
            if t is None:
                continue
            pre[row, t] = 1
            pre[row, P_REAL] = 1
            if t == T_LOAD_A:
                pre[row, P_WHICH] = WHICH_A
            elif t == T_LOAD_R:
                pre[row, P_WHICH] = WHICH_R
            if t == T_CADD_A:
                i = (row - 2) // 2
                pre[row, P_WEIGHT] = 1 << (i % 16)
                if i == 0:
                    pre[row, P_PKZERO] = 1
            elif t == T_DBL:
                i = (row - 3) // 2
                if i % 16 == 15:  # group-end: check + receive k512 limb
                    pre[row, P_GEND] = 1
                    pre[row, P_GIDX] = i // 16
                    pre[row, P_WHICH] = WHICH_K
            elif t == T_CADD_B:
                i = row - (addr_r + 1)
                pre[row, P_WEIGHT] = 1 << (i % 16)
                if i == 0:
                    pre[row, P_PKZERO] = 1
                if i % 16 == 0 and i > 0:  # check previous group
                    pre[row, P_GEND] = 1
                    pre[row, P_GIDX] = i // 16 - 1
                    pre[row, P_WHICH] = WHICH_S
                bx, by, bt = self.b_powers[i]
                pre[row, P_BT:P_BT + 16] = to_limbs(bx)
                pre[row, P_BT + 16:P_BT + 32] = to_limbs(by)
                pre[row, P_BT + 32:P_BT + 48] = to_limbs(bt)
            elif t == T_FINAL:
                pre[row, P_GEND] = 1
                pre[row, P_GIDX] = nb // 16 - 1
                pre[row, P_WHICH] = WHICH_S
        return pre

    def preprocessed_columns(self, n: int) -> np.ndarray:
        """The reference's row-by-row table, built as one segment's rows
        copied into every real segment with its instance id."""
        assert n == self.n_rows
        pre = np.zeros((n, PRE_WIDTH), dtype=np.uint64)
        seg_pre = self._segment_pre()
        typed = seg_pre[:, P_REAL] == 1
        for si, sig in enumerate(self.schedule):
            if not sig.real:
                continue
            block = pre[si * self.seg:(si + 1) * self.seg]
            block[:] = seg_pre
            block[typed, P_INST] = sig.inst
        return pre

    # -- constraint construction ------------------------------------------

    # The reference registers the conv identities, the register binds and
    # the conditional adds one limb at a time. Here each is one stacked
    # constraint whose lanes are those limbs in the same order: the same
    # constraints, in far fewer operations over the LDE.

    def _limbs_stack(self, b: AirBuilder, src, nxt=False) -> Elem:
        """The 16 limbs of a source as one stacked handle."""
        kind, arg = src
        if kind == "reg":
            return b.row_stack(1 if nxt else 0, arg, 16)
        if kind == "c":
            return b.row_stack(0, slot_col(arg, C_OFF), 16)
        if kind == "bt":
            return b.stack([b.pre_local(P_BT + 16 * arg + i) for i in range(16)])
        raise ValueError(kind)

    def _operand(self, b: AirBuilder, spec) -> Elem:
        """An operand's limbs (16, or 17 with a 17-limb constant), stacked."""
        terms, const = spec
        n = 17 if const is not None and len(const) > 16 else 16
        out = b.const_lanes([0] * n) if const is None else b.const_lanes(
            [int(cv) for cv in const] + [0] * (n - len(const)))
        for coeff, src in terms:
            out = out + b.lanes(coeff * self._limbs_stack(b, src), 0, n)
        return out

    def _carry(self, b: AirBuilder, s: int, j: int) -> Elem:
        klo = b.local(slot_col(s, KLO_OFF) + j)
        khi = b.local(slot_col(s, KHI_OFF) + j)
        return klo + BETA * khi - OFFSET

    def _carries(self, b: AirBuilder, s: int, count: int) -> Elem:
        """Carries k_0 .. k_{count-1} of slot s, stacked."""
        klo = b.row_stack(0, slot_col(s, KLO_OFF), count)
        khi = b.row_stack(0, slot_col(s, KHI_OFF), count)
        return klo + BETA * khi - OFFSET

    def _conv_identity(self, b: AirBuilder, gate: Elem, s: int, a: Elem, v: Elem,
                       la: int, lv: int):
        """gate * (a*v - c - q*p - (x - beta) k)_j = 0 for all coefficients j,
        as one constraint of n_coeff lanes (a, v: stacked limbs)."""
        n_coeff = max(la + lv - 1, 17 + 16)  # uv vs q*p conv length
        w = b.lanes(b.row_stack(0, slot_col(s, C_OFF), 16), 0, n_coeff)
        w = b.const_lanes([0] * n_coeff) - w
        for i in range(la):
            w = w + b.lanes(b.lane(a, i) * v, i, n_coeff)
        pl = b.const_lanes(PL)
        for i in range(17):
            w = w - b.lanes(b.local(slot_col(s, Q_OFF) + i) * pl, i, n_coeff)
        # (x - beta) * k: coefficient j = k_{j-1} - beta * k_j
        k = self._carries(b, s, n_coeff - 1)
        w = w - b.lanes(k, 1, n_coeff) + BETA * b.lanes(k, 0, n_coeff)
        b.assert_zero(gate * w)

    def _linzero(self, b: AirBuilder, gate: Elem, lhs: List[Elem],
                 m: Optional[Elem], carry_slot: int):
        """gate * (lhs - m*p - (x-beta)k)_j = 0 — value of lhs ≡ 0 mod p
        (m omitted: exact zero)."""
        n_coeff = len(lhs)
        for j in range(n_coeff):
            w = lhs[j]
            if m is not None and PL[j]:
                w = w - PL[j] * m
            if j > 0:
                w = w - self._carry(b, carry_slot, j - 1)
            if j < n_coeff - 1:
                w = w + BETA * self._carry(b, carry_slot, j)
            b.assert_zero(gate * w)

    def eval(self, b: AirBuilder):
        gates = {t: b.pre_local(t) for t in range(7)}
        real = b.pre_local(P_REAL)
        gend = b.pre_local(P_GEND)
        add_types = (T_DBL, T_CADD_A, T_CADD_B, T_ADDR)

        # conv identities per row type
        for t, slots in SLOTS_BY_TYPE.items():
            if t == T_LOAD_R:
                continue  # shares the LOAD_A dataflow via combined gate
            gate = gates[t]
            if t == T_LOAD_A:
                gate = gates[T_LOAD_A] + gates[T_LOAD_R]
            for s, (a_spec, v_spec) in slots.items():
                a = self._operand(b, a_spec)
                v = self._operand(b, v_spec)
                la = 17 if a_spec[1] is not None and len(a_spec[1]) > 16 else 16
                lv = 17 if v_spec[1] is not None and len(v_spec[1]) > 16 else 16
                self._conv_identity(b, gate, s, a, v, la, lv)

        load_gate = gates[T_LOAD_A] + gates[T_LOAD_R]
        xl = [b.local(slot_col(6, C_OFF) + i) for i in range(16)]
        yl = [b.local(slot_col(7, C_OFF) + i) for i in range(16)]

        # curve: y^2 - x^2 - 1 - d x^2 y^2 ≡ 0 (mod p); carries in slot 4
        c0 = [b.local(slot_col(0, C_OFF) + i) for i in range(16)]
        c1 = [b.local(slot_col(1, C_OFF) + i) for i in range(16)]
        c3 = [b.local(slot_col(3, C_OFF) + i) for i in range(16)]
        lhs = [c0[i] - c1[i] - c3[i] - (1 if i == 0 else 0) for i in range(16)]
        self._linzero(b, load_gate, lhs, b.local(COL_M1), 4)

        # canonicity x < p: x + z = p - 1 with z = slot8.c; carries slot 8
        z8 = [b.local(slot_col(8, C_OFF) + i) for i in range(16)]
        self._linzero(
            b, load_gate, [xl[i] + z8[i] - PM1L[i] for i in range(16)], None, 8
        )
        # canonicity y < p: z2 = slot6.q[0:16]; carries slot 6
        z6 = [b.local(slot_col(6, Q_OFF) + i) for i in range(16)]
        self._linzero(
            b, load_gate, [yl[i] + z6[i] - PM1L[i] for i in range(16)], None, 6
        )
        # parity: x_0 = 2*h + sign
        b.assert_zero(load_gate * (xl[0] - 2 * b.local(COL_H15) - b.local(COL_SGN)))
        sgn = b.local(COL_SGN)
        b.assert_zero(load_gate * sgn * (sgn - 1))

        # FINAL: projective equality, carries slots 4 (x) and 5 (y)
        fc = {s: [b.local(slot_col(s, C_OFF) + i) for i in range(16)] for s in range(4)}
        self._linzero(b, gates[T_FINAL],
                      [fc[0][i] - fc[1][i] for i in range(16)], b.local(COL_M1), 4)
        self._linzero(b, gates[T_FINAL],
                      [fc[2][i] - fc[3][i] for i in range(16)], b.local(COL_M2), 5)

        # -- register updates (next row), 16 limbs a constraint -------------
        def reg_limbs(base, coord, nxt=False):
            return self._limbs_stack(b, ("reg", base + 16 * coord), nxt=nxt)

        def bind(gate, base, coord, expr_limbs):
            b.assert_zero(gate * (reg_limbs(base, coord, nxt=True) - expr_limbs))

        def passthrough(gate, base):
            for coord in range(4):
                bind(gate, base, coord,
                     reg_limbs(base, coord))

        neutral = [b.const_lanes(ZEROL), b.const_lanes(ONEL), b.const_lanes(ONEL),
                   b.const_lanes(ZEROL)]
        p3 = [self._limbs_stack(b, ("c", s)) for s in P3_SLOTS]

        # LOAD_A: D <- (x, y, 1, t), ACC <- neutral
        loaded = [self._limbs_stack(b, ("c", 6)), self._limbs_stack(b, ("c", 7)),
                  b.const_lanes(ONEL), self._limbs_stack(b, ("c", 5))]
        for coord, limbs in zip(range(4), loaded):
            bind(gates[T_LOAD_A], REG_D, coord, limbs)
        for coord in range(4):
            bind(gates[T_LOAD_A], REG_ACC, coord, neutral[coord])
        # LOAD_R: REG <- (x, y, 1, t); D, ACC pass
        for coord, limbs in zip(range(4), loaded):
            bind(gates[T_LOAD_R], REG_REG, coord, limbs)
        passthrough(gates[T_LOAD_R], REG_D)
        passthrough(gates[T_LOAD_R], REG_ACC)
        # DBL: D <- P3; ACC, REG pass
        for coord in range(4):
            bind(gates[T_DBL], REG_D, coord, p3[coord])
        passthrough(gates[T_DBL], REG_ACC)
        passthrough(gates[T_DBL], REG_REG)
        # CADD: ACC <- bit ? P3 : ACC ; D, REG pass
        cadd = gates[T_CADD_A] + gates[T_CADD_B]
        bit = b.local(COL_BIT)
        b.assert_zero(cadd * bit * (bit - 1))
        for coord in range(4):
            acc = reg_limbs(REG_ACC, coord)
            nxt = reg_limbs(REG_ACC, coord, nxt=True)
            b.assert_zero(cadd * (nxt - (bit * (p3[coord] - acc) + acc)))
        passthrough(cadd, REG_D)
        passthrough(cadd, REG_REG)
        # ADDR: REG <- P3, ACC <- neutral
        for coord in range(4):
            bind(gates[T_ADDR], REG_REG, coord, p3[coord])
            bind(gates[T_ADDR], REG_ACC, coord, neutral[coord])

        # -- scalar packing ------------------------------------------------
        pk = b.local(COL_PK)
        pk_next = b.next(COL_PK)
        w = b.pre_local(P_WEIGHT)  # zero on DBL rows
        upd_gate = gates[T_DBL] + cadd
        b.assert_zero(upd_gate * (pk_next - (1 - gend) * pk - w * bit))
        b.assert_zero(gend * (pk - b.local(COL_SC)))
        b.assert_zero(b.pre_local(P_PKZERO) * pk)

        # -- bus -----------------------------------------------------------
        inst = b.pre_local(P_INST)
        which = b.pre_local(P_WHICH)
        for j in range(16):
            b.receive(ch.ED_POINT, [inst, which, b.const(j), yl[j]], load_gate)
        b.receive(ch.ED_POINT, [inst, which, b.const(16), sgn], load_gate)
        b.receive(ch.ED_SCALAR,
                  [inst, which, b.pre_local(P_GIDX), b.local(COL_SC)], gend)
        # range checks
        for s in range(N_SLOTS):
            for i in range(16):
                b.send(ch.RANGE16, [b.local(slot_col(s, C_OFF) + i)], real)
            for i in range(17):
                b.send(ch.RANGE16, [b.local(slot_col(s, Q_OFF) + i)], real)
            for i in range(33):
                b.send(ch.RANGE16, [b.local(slot_col(s, KLO_OFF) + i)], real)
                b.send(ch.RANGE8, [b.local(slot_col(s, KHI_OFF) + i)], real)
        h15 = b.local(COL_H15)
        b.send(ch.RANGE16, [h15], load_gate)
        b.send(ch.RANGE16, [2 * h15], load_gate)
        b.send(ch.RANGE8, [b.local(COL_M1) + 8], load_gate + gates[T_FINAL])
        b.send(ch.RANGE8, [b.local(COL_M2) + 8], gates[T_FINAL])


# ---------------------------------------------------------------------------
# witness generation
#
# The reference builds the trace row by row in python ints. This copy gives
# the same trace in two passes:
#   1. per row, in python ints: the register state entering the row, each
#      slot's product c = a*v mod p and quotient q, and the scalar and sign
#      bookkeeping (the row-to-row dependency lives here);
#   2. per (row type, slot), over every row of that type at once, in numpy
#      int64: the operand limbs, the coefficients of
#      a(x)v(x) - c(x) - q(x)p(x) (or of a linear identity), and the carries
#      k with (x - 2^16) k(x) equal to them.
# ---------------------------------------------------------------------------

# An operand limb is a small multiple of a 16-bit limb plus a constant limb
# (``_operand_limbs``); below 2^23, a coefficient of at most 17 products of
# two limbs stays far inside int64.
LIMB_BOUND = 1 << 23
ADD_TYPES = (T_DBL, T_CADD_A, T_CADD_B, T_ADDR)
NEUTRAL = tuple(ed.IDENTITY)


def _limb_val(limbs: Sequence[int]) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(limbs))


def _compile_spec(spec):
    """Operand spec -> (terms, constant value) over python ints: a term is
    (coeff, kind, index) with kind 0 a register value (index = column // 16),
    1 a slot's c, 2 a coordinate of the B power."""
    terms, const = spec
    out = []
    for coeff, (kind, arg) in terms:
        out.append((coeff, {"reg": 0, "c": 1, "bt": 2}[kind],
                    arg // 16 if kind == "reg" else arg))
    return tuple(out), (0 if const is None else _limb_val(const))


_VALUE_SPECS = {t: {s: (_compile_spec(a), _compile_spec(v)) for s, (a, v) in slots.items()}
                for t, slots in SLOTS_BY_TYPE.items()}


def _value(cspec, regs, cs, bt) -> int:
    terms, v = cspec
    for coeff, kind, idx in terms:
        v += coeff * (regs[idx] if kind == 0 else cs[idx] if kind == 1 else bt[idx])
    return v


def _to_limb_array(vals: List[int], n_limbs: int) -> np.ndarray:
    """Non-negative python ints -> (len, n_limbs) int64 16-bit limbs."""
    buf = b"".join(v.to_bytes(2 * n_limbs, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), n_limbs).astype(np.int64)


@dataclass
class SigWitness:
    """Native inputs for one proved signature."""

    pubkey: bytes
    msg: bytes
    signature: bytes

    def k512(self) -> int:
        import hashlib

        h = hashlib.sha512(self.signature[:32] + self.pubkey + self.msg).digest()
        return int.from_bytes(h, "little")

    def s_int(self) -> int:
        return int.from_bytes(self.signature[32:], "little")


def _load_point(comp: bytes):
    """Affine (x, y) of a compressed point. An encoding that does not
    decompress (the reference's builder raises on it) gets x = its sign bit
    and y reduced mod p, so the trace exists and the table's curve,
    canonicity or bus constraints reject it."""
    pt = ed.decompress(comp)
    if pt is not None:
        return pt[0], pt[1]
    y = int.from_bytes(comp, "little") & ((1 << 255) - 1)
    return comp[31] >> 7, y % P25519


def _segment_rows(air: Ed25519Air, sigs: List[SigWitness]):
    """Pass 1 over every real segment: yields (row, type, register values
    entering the row (12 ints: D, ACC, REG by coordinate), c (9), q (9), m1,
    m2) and writes the scalar columns into ``trace``."""
    na, nb = air.nbits_a, air.nbits_b
    addr_r = 2 + 2 * na
    types = [air.row_type(r) for r in range(air.seg)]
    b_vals = air.b_powers
    sig_i = 0
    for si, entry in enumerate(air.schedule):
        if not entry.real:
            continue
        sig = sigs[sig_i]
        sig_i += 1
        base = si * air.seg
        A = _load_point(sig.pubkey)
        R = _load_point(sig.signature[:32])
        k512 = sig.k512() % (1 << na)
        s_scalar = sig.s_int() % (1 << nb)
        regs = [0] * 12
        pk_acc = 0
        for r, t in enumerate(types):
            row = base + r
            entering = tuple(regs)
            cs = [0] * 9
            qs = [0] * 9
            m1 = m2 = 0
            sc = bitv = sgn = h15 = None
            pk = pk_acc
            if t in (T_LOAD_A, T_LOAD_R):
                pt = A if t == T_LOAD_A else R
                comp = sig.pubkey if t == T_LOAD_A else sig.signature[:32]
                x, y = pt[0], pt[1]
                cs[6], cs[7] = x, y
                for s in (0, 1, 2, 3, 5):
                    a_s, v_s = _VALUE_SPECS[T_LOAD_A][s]
                    qs[s], cs[s] = divmod(_value(a_s, regs, cs, None)
                                          * _value(v_s, regs, cs, None), P25519)
                m1 = (cs[0] - cs[1] - 1 - cs[3]) // P25519
                cs[8] = P25519 - 1 - x   # x < p witness (slot 8 c)
                qs[6] = P25519 - 1 - y   # y < p witness (slot 6 q)
                sgn = comp[31] >> 7
                h15 = ((x & 0xFFFF) - sgn) // 2 % GL_P
                if t == T_LOAD_A:
                    regs[0:4] = [x, y, 1, cs[5]]
                    regs[4:8] = NEUTRAL
                else:
                    regs[8:12] = [x, y, 1, cs[5]]
            elif t in ADD_TYPES:
                bt = b_vals[r - (addr_r + 1)] if t == T_CADD_B else None
                for s in range(9):
                    a_s, v_s = _VALUE_SPECS[t][s]
                    qs[s], cs[s] = divmod(_value(a_s, regs, cs, bt)
                                          * _value(v_s, regs, cs, bt), P25519)
                p3 = [cs[s] for s in P3_SLOTS]
                if t == T_DBL:
                    regs[0:4] = p3
                    i_bit = (r - 3) // 2
                    if i_bit % 16 == 15:
                        sc = (k512 >> (16 * (i_bit // 16))) & 0xFFFF
                        assert pk_acc == sc
                        pk_acc = 0
                elif t in (T_CADD_A, T_CADD_B):
                    if t == T_CADD_A:
                        i_bit = (r - 2) // 2
                        bitv = (k512 >> i_bit) & 1
                    else:
                        i_bit = r - (addr_r + 1)
                        bitv = (s_scalar >> i_bit) & 1
                        if i_bit % 16 == 0 and i_bit > 0:
                            sc = (s_scalar >> (16 * (i_bit // 16 - 1))) & 0xFFFF
                            assert pk_acc == sc
                            pk_acc = 0
                    if bitv:
                        regs[4:8] = p3
                    pk_acc += bitv << (i_bit % 16)
                else:  # ADDR
                    regs[8:12] = p3
                    regs[4:8] = NEUTRAL
            elif t == T_FINAL:
                sc = (s_scalar >> (16 * (nb // 16 - 1))) & 0xFFFF
                assert pk_acc == sc
                pk_acc = 0
                for s in range(4):
                    a_s, v_s = _VALUE_SPECS[T_FINAL][s]
                    qs[s], cs[s] = divmod(_value(a_s, regs, cs, None)
                                          * _value(v_s, regs, cs, None), P25519)
                dx, dy = cs[0] - cs[1], cs[2] - cs[3]
                m1, m2 = dx // P25519, dy // P25519  # exact for a valid signature
            yield row, t, entering, cs, qs, m1, m2, pk, sc, bitv, sgn, h15


def _operand_limbs(spec, regs: np.ndarray, c: np.ndarray, bt) -> np.ndarray:
    """(rows, 16 or 17) int64 limbs of an operand, from the rows' register
    limbs (rows, 192), slot c limbs (rows, 9, 16) and B-power limbs."""
    terms, const = spec
    n = 17 if const is not None and len(const) > 16 else 16
    out = np.zeros((regs.shape[0], n), dtype=np.int64)
    for coeff, (kind, arg) in terms:
        if kind == "reg":
            limbs = regs[:, arg:arg + 16]
        elif kind == "c":
            limbs = c[:, arg]
        else:
            limbs = bt[:, arg]
        out[:, :16] += coeff * limbs
    if const is not None:
        out += np.asarray(const, dtype=np.int64)
    if np.abs(out).max(initial=0) >= LIMB_BOUND:
        raise OverflowError("operand limb outside the int64-safe bound")
    return out


def _carries(w: np.ndarray) -> np.ndarray:
    """Carries k (rows, n-1) with w_j = k_{j-1} - 2^16 k_j (k_{-1} = 0) and
    k_{n-2} = w_{n-1}: the (x - 2^16) k(x) = w(x) division, row-wise. For
    a w that no k satisfies (an invalid signature) the quotients are
    floored and the table's constraints reject the row."""
    n = w.shape[1]
    k = np.zeros((w.shape[0], n - 1), dtype=np.int64)
    prev = np.zeros(w.shape[0], dtype=np.int64)
    for j in range(n - 1):
        k[:, j] = prev = (prev - w[:, j]) // BETA
    return k


def _write_carries(trace: np.ndarray, rows: np.ndarray, s: int, w: np.ndarray):
    """Carries of the coefficients w into slot s of ``rows``."""
    off = _carries(w) + OFFSET  # in [0, 2^24) for a valid signature
    cols = np.arange(off.shape[1])
    trace[rows[:, None], slot_col(s, KLO_OFF) + cols] = (off & 0xFFFF).astype(np.uint64)
    trace[rows[:, None], slot_col(s, KHI_OFF) + cols] = (off >> 16).astype(np.uint64)


def _conv_coeffs(a, v, c, q) -> np.ndarray:
    """Coefficients of a(x)v(x) - c(x) - q(x)p(x), row-wise."""
    la, lv = a.shape[1], v.shape[1]
    w = np.zeros((a.shape[0], max(la + lv - 1, 33)), dtype=np.int64)
    for i in range(la):
        w[:, i:i + lv] += a[:, i:i + 1] * v
    w[:, :16] -= c
    for i in range(17):
        w[:, i:i + 16] -= q[:, i:i + 1] * _PL
    return w


_PL = np.asarray(PL, dtype=np.int64)
_PM1L = np.asarray(PM1L, dtype=np.int64)
_ONEL = np.asarray(ONEL, dtype=np.int64)


def build_trace(air: Ed25519Air, sigs: List[SigWitness]) -> np.ndarray:
    n = air.n_rows
    trace = np.zeros((n, WIDTH), dtype=np.uint64)
    rows, types, regs, cvals, qvals, m1s, m2s = [], [], [], [], [], [], []
    for row, t, entering, cs, qs, m1, m2, pk, sc, bitv, sgn, h15 in _segment_rows(air, sigs):
        rows.append(row)
        types.append(t)
        regs.extend(entering)
        cvals.extend(cs)
        qvals.extend(qs)
        m1s.append(m1)
        m2s.append(m2)
        trace[row, COL_PK] = pk
        if sc is not None:
            trace[row, COL_SC] = sc
        if bitv is not None:
            trace[row, COL_BIT] = bitv
        if sgn is not None:
            trace[row, COL_SGN] = sgn
            trace[row, COL_H15] = h15
    if not rows:
        return trace
    rows = np.asarray(rows, dtype=np.int64)
    types = np.asarray(types, dtype=np.int64)
    m1s = np.asarray(m1s, dtype=np.int64)
    m2s = np.asarray(m2s, dtype=np.int64)
    regs = _to_limb_array(regs, 16).reshape(len(rows), 192)
    c = _to_limb_array(cvals, 16).reshape(len(rows), 9, 16)
    q = _to_limb_array(qvals, 17).reshape(len(rows), 9, 17)
    trace[rows, REG_D:REG_D + 192] = regs
    for s in range(N_SLOTS):
        trace[rows, slot_col(s, C_OFF):slot_col(s, C_OFF) + 16] = c[:, s]
        trace[rows, slot_col(s, Q_OFF):slot_col(s, Q_OFF) + 17] = q[:, s]

    # conv identities, one (row type, slot) group at a time
    bt_all = np.asarray([[to_limbs(x) for x in pw] for pw in air.b_powers], dtype=np.int64)
    for t in (T_LOAD_A, T_LOAD_R) + ADD_TYPES + (T_FINAL,):
        pos = np.nonzero(types == t)[0]
        if not len(pos):
            continue
        bt = bt_all[rows[pos] % air.seg - (3 + 2 * air.nbits_a)] if t == T_CADD_B else None
        for s, (a_spec, v_spec) in sorted(SLOTS_BY_TYPE[T_LOAD_A if t == T_LOAD_R else t].items()):
            a = _operand_limbs(a_spec, regs[pos], c[pos], bt)
            v = _operand_limbs(v_spec, regs[pos], c[pos], bt)
            _write_carries(trace, rows[pos], s, _conv_coeffs(a, v, c[pos, s], q[pos, s]))

    # linear identities: lhs - m*p == 0 with the carries in another slot
    def to_gl(m):
        return np.where(m < 0, m.astype(np.uint64) + np.uint64(GL_P), m.astype(np.uint64))

    pos = np.nonzero((types == T_LOAD_A) | (types == T_LOAD_R))[0]
    if len(pos):
        cl, m = c[pos], m1s[pos]
        trace[rows[pos], COL_M1] = to_gl(m)
        _write_carries(trace, rows[pos], 4,
                       cl[:, 0] - cl[:, 1] - cl[:, 3] - _ONEL - m[:, None] * _PL)
        _write_carries(trace, rows[pos], 8, cl[:, 6] + cl[:, 8] - _PM1L)   # x < p
        _write_carries(trace, rows[pos], 6, cl[:, 7] + q[pos, 6, :16] - _PM1L)  # y < p
    pos = np.nonzero(types == T_FINAL)[0]
    if len(pos):
        cl, m1, m2 = c[pos], m1s[pos], m2s[pos]
        trace[rows[pos], COL_M1] = to_gl(m1)
        trace[rows[pos], COL_M2] = to_gl(m2)
        _write_carries(trace, rows[pos], 4, cl[:, 0] - cl[:, 1] - m1[:, None] * _PL)
        _write_carries(trace, rows[pos], 5, cl[:, 2] - cl[:, 3] - m2[:, None] * _PL)
    return trace


def range_counts(air: Ed25519Air, trace: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(range16_counts, range8_counts) matching the chip's send mults: one
    bincount over the gathered limb columns of the real rows. A value out
    of range (only an invalid witness has one) is not counted, so the bus
    does not balance."""
    types = air.row_types()
    slots = trace[types >= 0, SLOT0:COL_BIT].reshape(-1, N_SLOTS, SLOT_SIZE)
    load = (types == T_LOAD_A) | (types == T_LOAD_R)
    final = types == T_FINAL
    h = trace[load, COL_H15]

    def plus8(m):  # (m + 8) mod p for canonical m
        v = m + np.uint64(8)
        return np.where(v >= np.uint64(GL_P), v - np.uint64(GL_P), v) % np.uint64(256)

    def count(values, n):
        values = np.concatenate([v.ravel() for v in values])
        return np.bincount(values[values < n].astype(np.int64), minlength=n).astype(np.uint64)

    r16 = count([slots[:, :, C_OFF:KHI_OFF], h, 2 * h], 1 << 16)  # c, q, klo
    r8 = count([slots[:, :, KHI_OFF:], plus8(trace[load | final, COL_M1]),
                plus8(trace[final, COL_M2])], 256)
    return r16, r8


def public_messages_for(air: Ed25519Air, sigs: List[SigWitness]):
    """Bus messages a stand-alone verifier contributes (the CPU's role)."""
    pubs = []
    real = [e for e in air.schedule if e.real]
    for entry, sig in zip(real, sigs):
        inst = entry.inst
        for which, comp in ((WHICH_A, sig.pubkey), (WHICH_R, sig.signature[:32])):
            y = int.from_bytes(comp, "little") & ((1 << 255) - 1)
            for j in range(16):
                pubs.append((ch.ED_POINT, [inst, which, j, (y >> (16 * j)) & 0xFFFF], +1))
            pubs.append((ch.ED_POINT, [inst, which, 16, comp[31] >> 7], +1))
        k512 = sig.k512() % (1 << air.nbits_a)
        for g in range(air.nbits_a // 16):
            pubs.append((ch.ED_SCALAR, [inst, WHICH_K, g, (k512 >> (16 * g)) & 0xFFFF], +1))
        s_val = sig.s_int() % (1 << air.nbits_b)
        for g in range(air.nbits_b // 16):
            pubs.append((ch.ED_SCALAR, [inst, WHICH_S, g, (s_val >> (16 * g)) & 0xFFFF], +1))
    return pubs
