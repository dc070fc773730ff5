"""Poseidon permutation AIR ("chip") with bus I/O and in-chip chaining.

The port's copy of ``blobstreamx_tpu/chips/poseidon.py``: the same columns,
constraints and interactions in the same order (a proof's bytes depend on
them). One row proves one width-12 permutation (8 full + 22 partial rounds,
x^7 S-box, the permutation of ``ops/poseidon.py``). Committed columns are
the S-box outputs only; the round-constant adds and the MDS layer are
linear and live in constraint expressions with build-time coefficients.

Chaining is in-chip: a row can carry any subset of its input lanes from
the previous row's output (preprocessed flags), so sponges and the
transcript duplex cost no CPU-table traffic for intermediate states. In
Merkle mode a row absorbs a 4-element sibling digest and a direction bit
and selects (prev_digest, sib) or (sib, prev_digest) in-chip.

Bus protocol (channels POS_IN / POS_OUT, keyed by the permutation id):
  * receive POS_IN (inst, lane, value) for absorbed lanes  [from the CPU]
  * receive POS_IN (inst, 12+j, sib_j) and (inst, 16, dir) in Merkle mode
  * send POS_OUT (inst, lane, out_value) for read-out lanes [to the CPU]

Column layout (width 135):
  0..11    IN lanes (input state)
  12..129  S-box outputs: 4 full rounds x 12, 22 partial x 1, 4 full x 12
  130..133 SIB (sibling digest, Merkle mode)
  134      DIR (direction bit, Merkle mode)

The reference's ``permute_capture`` runs on ``jax.numpy``; here it runs the
rounds of ``ops/poseidon.permute_plain`` on int64 tensors on the device
the trace build is given.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as devmod
from ..field import goldilocks as gl
from ..ops import poseidon as pos
from ..proof.air import Air, AirBuilder, Elem, TRANSITION
from . import channels as ch

WIDTH_STATE = pos.WIDTH  # 12
HALF_FULL = pos.FULL_ROUNDS // 2  # 4
N_SBOX = 2 * HALF_FULL * WIDTH_STATE + pos.PARTIAL_ROUNDS  # 118

COL_IN = 0
COL_SB = 12
COL_SIB = COL_SB + N_SBOX  # 130
COL_DIR = COL_SIB + 4  # 134
WIDTH = COL_DIR + 1  # 135

# preprocessed columns
P_INST = 0
P_ABS = 1  # 12 absorb flags
P_CARRY = 13  # 12 carry flags
P_MERKLE = 25
P_OUT = 26  # 12 output-send flags
PRE_WIDTH = 38

# Merkle-mode bus slots
SLOT_SIB = 12  # sibling digest at slots 12..15
SLOT_DIR = 16


@dataclass
class PermSpec:
    """One scheduled permutation.

    absorb: lanes receiving a bus value (slot == lane).
    carry:  lanes carried from the previous row's output (requires cpos>0).
    merkle: Merkle mode: IN[0:8] = dir-select(prev digest, SIB), IN[8:12]=0;
            absorb/carry must be empty.
    out_lanes: lanes sent to the bus.
    """

    inst: int
    chain: int
    cpos: int
    absorb: Tuple[int, ...] = ()
    carry: Tuple[int, ...] = ()
    merkle: bool = False
    out_lanes: Tuple[int, ...] = ()
    real: bool = True


def pad_schedule(rows: List[PermSpec], n_rows: int) -> List[PermSpec]:
    """Sort chains contiguous and pad with dummy rows to n_rows."""
    sched = sorted(rows, key=lambda r: (r.chain, r.cpos))
    if len(sched) > n_rows:
        raise ValueError(f"{len(sched)} permutations need more than {n_rows} rows")
    sched += [PermSpec(inst=0, chain=-1, cpos=0, real=False)] * (n_rows - len(sched))
    return sched


# ---------------------------------------------------------------------------
# symbolic linear-expression tracking (build-time, host ints)
# ---------------------------------------------------------------------------

def _lin_add_const(lane, c):
    const, w = lane
    return ((const + c) % gl.P, w)


def _mds_apply_sym(lanes):
    mds = pos.mds_matrix()
    out = []
    for i in range(WIDTH_STATE):
        const = 0
        w: Dict[int, int] = {}
        for j in range(WIDTH_STATE):
            m = mds[i][j]
            cj, wj = lanes[j]
            const = (const + m * cj) % gl.P
            for col, coef in wj.items():
                w[col] = (w.get(col, 0) + m * coef) % gl.P
        out.append((const, {k: v for k, v in w.items() if v}))
    return out


@functools.lru_cache(maxsize=None)
def _symbolic_rounds():
    """Returns (sbox_inputs, out_exprs).

    sbox_inputs: list of (col_index, lane_expr): the committed column and
    the linear expression (const, {col: coeff}) whose 7th power it must
    equal. out_exprs: the 12 output lanes as linear expressions.
    """
    rc = pos.round_constants()
    lanes = [(0, {COL_IN + i: 1}) for i in range(WIDTH_STATE)]
    sbox_inputs = []
    col = COL_SB
    for r in range(pos.N_ROUNDS):
        partial = HALF_FULL <= r < HALF_FULL + pos.PARTIAL_ROUNDS
        new = []
        for i in range(WIDTH_STATE):
            pre = _lin_add_const(lanes[i], rc[r * WIDTH_STATE + i])
            if partial and i:
                new.append(pre)
                continue
            sbox_inputs.append((col, pre))
            new.append((0, {col: 1}))
            col += 1
        lanes = _mds_apply_sym(new)
    assert col == COL_SB + N_SBOX
    return tuple(sbox_inputs), tuple(lanes)


# ---------------------------------------------------------------------------
# the AIR
# ---------------------------------------------------------------------------

class PoseidonAir(Air):
    width = WIDTH
    pre_width = PRE_WIDTH
    row_offsets = (0, 1)
    pre_offsets = (0, 1)
    max_constraint_degree = 7

    def __init__(self, schedule: List[PermSpec], n_rows: int):
        if len(schedule) != n_rows:
            raise ValueError("schedule does not match the trace height")
        self.schedule = schedule
        self.n_rows = n_rows

    def preprocessed_columns(self, n: int) -> np.ndarray:
        if n != self.n_rows:
            raise ValueError(f"the schedule was built for {self.n_rows} rows, not {n}")
        pre = np.zeros((n, PRE_WIDTH), dtype=np.uint64)
        for r, spec in enumerate(self.schedule):
            if not spec.real:
                continue
            pre[r, P_INST] = spec.inst
            for i in spec.absorb:
                pre[r, P_ABS + i] = 1
            for i in spec.carry:
                assert spec.cpos > 0 and r > 0
                pre[r, P_CARRY + i] = 1
            if spec.merkle:
                assert spec.cpos > 0 and r > 0
                assert not spec.absorb and not spec.carry
                pre[r, P_MERKLE] = 1
            for i in spec.out_lanes:
                pre[r, P_OUT + i] = 1
        return pre

    def eval(self, b: AirBuilder):
        local = b.row_stack(0, 0, WIDTH)

        def lin(expr) -> Elem:
            const, w = expr
            if not w:
                return b.const(const)
            idx = sorted(w)
            e = b.fold(b.gather(local, idx), [w[i] for i in idx])
            if const:
                e = e + b.const(const)
            return e

        sbox_inputs, out_exprs = _symbolic_rounds()

        # S-box constraints: SB_col == (linear expr)^7
        for col, expr in sbox_inputs:
            x = lin(expr)
            x2 = x * x
            x3 = x2 * x
            x6 = x3 * x3
            b.assert_zero(b.local(col) - x6 * x)

        m_loc = b.pre_local(P_MERKLE)
        # default-zero lanes: (1 - absorb - carry - merkle) * IN = 0
        for i in range(WIDTH_STATE):
            z = (
                b.const(1)
                - b.pre_local(P_ABS + i)
                - b.pre_local(P_CARRY + i)
                - m_loc
            )
            b.assert_zero(z * b.local(COL_IN + i))
        # Merkle capacity lanes are zero
        for i in range(8, WIDTH_STATE):
            b.assert_zero(m_loc * b.local(COL_IN + i))
        # DIR is boolean on Merkle rows
        dir_l = b.local(COL_DIR)
        b.assert_zero(m_loc * dir_l * (dir_l - 1))

        # chaining: next.IN_i == out_i(local) where flagged
        out_local = [lin(out_exprs[i]) for i in range(WIDTH_STATE)]
        for i in range(WIDTH_STATE):
            c_next = b.pre(1, P_CARRY + i)
            b.assert_zero(c_next * (b.row(1, COL_IN + i) - out_local[i]), TRANSITION)
        # Merkle mode: next.IN[0:4] / IN[4:8] = dir-select(prev digest, sib)
        m_next = b.pre(1, P_MERKLE)
        dir_n = b.row(1, COL_DIR)
        for j in range(4):
            sib_j = b.row(1, COL_SIB + j)
            dig_j = out_local[j]
            left = b.row(1, COL_IN + j)
            right = b.row(1, COL_IN + 4 + j)
            b.assert_zero(m_next * (left - (dig_j + dir_n * (sib_j - dig_j))), TRANSITION)
            b.assert_zero(m_next * (right - (sib_j + dir_n * (dig_j - sib_j))), TRANSITION)

        # bus
        inst = b.pre_local(P_INST)
        for i in range(WIDTH_STATE):
            b.receive(ch.POS_IN, [inst, b.const(i), b.local(COL_IN + i)],
                      b.pre_local(P_ABS + i))
        for j in range(4):
            b.receive(ch.POS_IN, [inst, b.const(SLOT_SIB + j), b.local(COL_SIB + j)], m_loc)
        b.receive(ch.POS_IN, [inst, b.const(SLOT_DIR), dir_l], m_loc)
        for i in range(WIDTH_STATE):
            b.send(ch.POS_OUT, [inst, b.const(i), out_local[i]], b.pre_local(P_OUT + i))


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------

def simulate_chains(
    schedule: List[PermSpec],
    absorb_vals: Dict[int, Dict[int, int]],
    sib_vals: Dict[int, List[int]],
    dir_vals: Dict[int, int],
) -> Tuple[np.ndarray, Dict[int, List[int]]]:
    """Run the chains in schedule order (python ints, ``permute_py``).

    absorb_vals[inst][lane] / sib_vals[inst] / dir_vals[inst] give the
    bus-fed inputs. Returns (input_states (n,12) uint64, outputs[inst]).
    Padding rows permute the zero state."""
    n = len(schedule)
    states_in = np.zeros((n, WIDTH_STATE), dtype=np.uint64)
    outputs: Dict[int, List[int]] = {}
    prev_out: Optional[List[int]] = None
    zero_out = pos.permute_py([0] * WIDTH_STATE)
    for r, spec in enumerate(schedule):
        if not spec.real:
            prev_out = zero_out
            continue
        st = [0] * WIDTH_STATE
        if spec.merkle:
            dig = prev_out[:4]
            sib = sib_vals[spec.inst]
            if dir_vals[spec.inst]:
                st[0:4], st[4:8] = list(sib), list(dig)
            else:
                st[0:4], st[4:8] = list(dig), list(sib)
        else:
            for i in spec.carry:
                st[i] = prev_out[i]
            for i in spec.absorb:
                st[i] = absorb_vals[spec.inst][i]
        states_in[r] = st
        prev_out = pos.permute_py(st)
        outputs[spec.inst] = prev_out
    return states_in, outputs


def permute_capture(states_np: np.ndarray, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Batched permutation capturing S-box outputs: (n,12) -> (sb (n,118),
    out (n,12)), uint64 numpy. The rounds of ``permute_plain`` on int64
    tensors on ``device`` (None: the card)."""
    dev = devmod.resolve(device)
    s = gl.from_int(np.asarray(states_np, dtype=np.uint64), dev).reshape(-1, WIDTH_STATE)
    rc = pos._round_constants_tensor(dev)
    sb_cols = []
    for r in range(pos.N_ROUNDS):
        s = gl.add(s, rc[r])
        if HALF_FULL <= r < HALF_FULL + pos.PARTIAL_ROUNDS:
            s = torch.cat([pos._sbox(s[:, :1]), s[:, 1:]], dim=1)
            sb_cols.append(s[:, :1])
        else:
            s = pos._sbox(s)
            sb_cols.append(s)
        s = pos._mds_plain(s)
    return gl.to_int(torch.cat(sb_cols, dim=1)), gl.to_int(s)


def build_trace(
    schedule: List[PermSpec],
    absorb_vals: Dict[int, Dict[int, int]],
    sib_vals: Dict[int, List[int]],
    dir_vals: Dict[int, int],
    device=None,
) -> np.ndarray:
    """The pos table: input states from the chains, S-box outputs from
    ``permute_capture`` on ``device`` (None: the card)."""
    dev = devmod.resolve(device)
    n = len(schedule)
    states_in, _ = simulate_chains(schedule, absorb_vals, sib_vals, dir_vals)
    trace = np.zeros((n, WIDTH), dtype=np.uint64)
    trace[:, COL_IN:COL_IN + WIDTH_STATE] = states_in
    # padding rows all permute the zero state: capture it once
    n_real = sum(1 for spec in schedule if spec.real)
    real = np.array([spec.real for spec in schedule])
    if n_real:
        trace[real, COL_SB:COL_SB + N_SBOX] = permute_capture(states_in[real], dev)[0]
    if n_real < n:
        sb0, _ = permute_capture(np.zeros((1, WIDTH_STATE), dtype=np.uint64), dev)
        trace[~real, COL_SB:COL_SB + N_SBOX] = sb0
    for r, spec in enumerate(schedule):
        if spec.real and spec.merkle:
            trace[r, COL_SIB:COL_SIB + 4] = sib_vals[spec.inst]
            trace[r, COL_DIR] = dir_vals[spec.inst]
    return trace
