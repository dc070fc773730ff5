"""Circuit "CPU" table: executes the frontend DSL's straight-line program.

Counterpart of ``blobstreamx_tpu/chips/cpu.py`` on the port's ``proof/air.py``:
the same columns, constraint and interactions in the same order (a proof's
bytes depend on them), including the SHA-512, Ed25519 and Poseidon ports
whose gadgets the port's frontend does not have yet (their flags stay 0).

The TPU-native replacement for plonky2x's routed-wire PLONK (SURVEY.md D7):
instead of copy constraints, dataflow is an *offline-memory LogUp argument*
— every row defines at most one wire (sends (index, value) with the wire's
static read count as multiplicity) and reads up to four wires (receives).
All indices, coefficients and port flags are preprocessed: the main trace
is just the five value columns, so witness generation is a vectorized
sweep and the constraint set is one generic arithmetic identity:

    out = q0 + q1*in1 + q2*in2 + q3*in3 + q4*in4 + qm*in1*in2

Bus roles beyond wires: publish public I/O, send SHA-256 message words,
receive digest words, and range-check bytes against the bytes chip.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..field import goldilocks as gl
from ..proof.air import Air, AirBuilder
from . import channels as ch

# main columns
V_IN1, V_IN2, V_IN3, V_IN4, V_OUT = range(5)
WIDTH = 5

# preprocessed columns
Q0, Q1, Q2, Q3, Q4, QM = range(6)
IDX_OUT = 6
IDX_IN1, IDX_IN2, IDX_IN3, IDX_IN4 = 7, 8, 9, 10
F_IN1, F_IN2, F_IN3, F_IN4 = 11, 12, 13, 14
MULT_OUT = 15
Q_CON = 16  # 1 if the arithmetic identity is enforced
F_PUB = 17
F_SHA_W = 18
F_SHA_OUT_A = 19
F_SHA_OUT_E = 20
F_RANGE8 = 21
F_OUT_RECV = 22  # assert rows: pin V_OUT to an existing wire's value
IO_A = 23  # instance id
IO_B = 24  # slot / word index / public position
IO_C = 25  # block index
F_S512_W = 26
F_S512_OUT_A = 27
F_S512_OUT_E = 28
F_ED_POINT = 29
F_ED_SCALAR = 30
F_POS_IN = 31
F_POS_OUT = 32
PRE_WIDTH = 33

N_FLAGS = 12


@dataclass
class Row:
    """One program row (all static fields preprocessed; values are witness)."""

    q: tuple = (0, 0, 0, 0, 0, 0)  # q0, q1..q4, qm
    out_idx: int = 0
    in_idx: tuple = (0, 0, 0, 0)
    in_act: tuple = (0, 0, 0, 0)
    mult_out: int = 0
    constrain: int = 0
    defines: int = 0  # 1 if this row is the defining site of out_idx
    # pub, sha_w, sha_out_a, sha_out_e, range8, s512_w, s512_out_a,
    # s512_out_e, ed_point, ed_scalar, pos_in, pos_out
    flags: tuple = (0,) * N_FLAGS
    io: tuple = (0, 0, 0)  # inst, slot/pos(j), blk(which)

    def __post_init__(self):
        if len(self.flags) < N_FLAGS:
            self.flags = tuple(self.flags) + (0,) * (N_FLAGS - len(self.flags))


class CpuAir(Air):
    width = WIDTH
    pre_width = PRE_WIDTH
    row_offsets = (0,)
    pre_offsets = (0,)
    max_constraint_degree = 4

    def __init__(self, rows: List[Row], n_rows: int):
        self.rows = rows
        self.n_rows = n_rows

    def preprocessed_columns(self, n: int) -> np.ndarray:
        assert n == self.n_rows and len(self.rows) <= n
        pre = np.zeros((n, PRE_WIDTH), dtype=np.uint64)
        for i, r in enumerate(self.rows):
            pre[i, Q0:QM + 1] = [int(v) % gl.P for v in r.q]
            pre[i, IDX_OUT] = r.out_idx
            pre[i, IDX_IN1:IDX_IN4 + 1] = r.in_idx
            pre[i, F_IN1:F_IN4 + 1] = r.in_act
            pre[i, MULT_OUT] = r.mult_out
            pre[i, Q_CON] = r.constrain
            flags = tuple(r.flags) + (0,) * (N_FLAGS - len(r.flags))
            pre[i, F_PUB:F_RANGE8 + 1] = flags[:5]
            pre[i, F_S512_W:F_ED_SCALAR + 1] = flags[5:10]
            pre[i, F_POS_IN:F_POS_OUT + 1] = flags[10:12]
            pre[i, F_OUT_RECV] = 1 if (r.constrain and not r.defines) else 0
            pre[i, IO_A:IO_C + 1] = r.io
        return pre

    def eval(self, b: AirBuilder):
        vin = [b.local(V_IN1 + i) for i in range(4)]
        out = b.local(V_OUT)
        expr = b.pre_local(Q0)
        for i in range(4):
            expr = expr + b.pre_local(Q1 + i) * vin[i]
        expr = expr + b.pre_local(QM) * vin[0] * vin[1]
        b.assert_zero(b.pre_local(Q_CON) * (out - expr))

        # wire memory
        b.send(ch.WIRE, [b.pre_local(IDX_OUT), out], b.pre_local(MULT_OUT))
        b.receive(ch.WIRE, [b.pre_local(IDX_OUT), out], b.pre_local(F_OUT_RECV))
        for i in range(4):
            b.receive(
                ch.WIRE,
                [b.pre_local(IDX_IN1 + i), vin[i]],
                b.pre_local(F_IN1 + i),
            )

        inst = b.pre_local(IO_A)
        pos = b.pre_local(IO_B)
        blk = b.pre_local(IO_C)
        b.send(ch.PUBLIC, [pos, vin[0]], b.pre_local(F_PUB))
        b.send(ch.SHA_W, [inst, blk, pos, vin[0]], b.pre_local(F_SHA_W))
        b.receive(ch.SHA_OUT_A, [inst, pos, out], b.pre_local(F_SHA_OUT_A))
        b.receive(ch.SHA_OUT_E, [inst, pos, out], b.pre_local(F_SHA_OUT_E))
        b.send(ch.RANGE8, [vin[0]], b.pre_local(F_RANGE8))
        b.send(ch.SHA512_W, [inst, blk, pos, vin[0]], b.pre_local(F_S512_W))
        b.receive(ch.SHA512_OUT_A, [inst, pos, out], b.pre_local(F_S512_OUT_A))
        b.receive(ch.SHA512_OUT_E, [inst, pos, out], b.pre_local(F_S512_OUT_E))
        # Ed25519 chip feeds: io = (inst, idx, which)
        b.send(ch.ED_POINT, [inst, blk, pos, vin[0]], b.pre_local(F_ED_POINT))
        b.send(ch.ED_SCALAR, [inst, blk, pos, vin[0]], b.pre_local(F_ED_SCALAR))
        # Poseidon chip: io = (inst, slot/lane, 0)
        b.send(ch.POS_IN, [inst, pos, vin[0]], b.pre_local(F_POS_IN))
        b.receive(ch.POS_OUT, [inst, pos, out], b.pre_local(F_POS_OUT))


def trace_index_arrays(rows: List[Row]):
    """Precomputed gather indices for build_trace (build-once, prove-many)."""
    n = len(rows)
    in_idx = np.zeros((n, 4), dtype=np.int64)
    in_act = np.zeros((n, 4), dtype=bool)
    out_idx = np.zeros(n, dtype=np.int64)
    for i, r in enumerate(rows):
        in_idx[i] = r.in_idx
        in_act[i] = [bool(a) for a in r.in_act]
        out_idx[i] = r.out_idx
    return in_idx, in_act, out_idx


def build_trace(rows: List[Row], wire_values: np.ndarray, n_rows: int,
                idx_arrays=None) -> np.ndarray:
    """Materialize the value columns from the solved wire table
    (vectorized gather; idx_arrays from trace_index_arrays)."""
    if idx_arrays is None:
        idx_arrays = trace_index_arrays(rows)
    in_idx, in_act, out_idx = idx_arrays
    n = len(rows)
    trace = np.zeros((n_rows, WIDTH), dtype=np.uint64)
    trace[:n, V_IN1:V_IN4 + 1] = np.where(in_act, wire_values[in_idx], 0)
    trace[:n, V_OUT] = wire_values[out_idx]
    return trace
