"""SHA-256 compression AIR ("chip") with bus I/O.

Counterpart of ``blobstreamx_tpu/chips/sha256.py``, the same table. One
68-row segment proves one compression:

  row r=0..3   loading: (A,E) hold (d_in,h_in),(c_in,g_in),(b_in,f_in),(a_in,e_in)
  row r=3+t    working state (a,e) entering round t, t = 0..64
  row r=64..67 digest rows: (out_a, out_e) = chaining-add of word j = 67-r

Working values b,c,d / f,g,h are *not* stored: they equal a/e at earlier
rows, read through the row-offset window. The message schedule lives in
the same rows (w for round t at row t+3) with its recurrence checked at
offsets +1/+9/+14/+16.

The *compression schedule* — which segment proves which (instance, block),
chaining and finality — is fixed at circuit build time and lives entirely
in preprocessed columns, so dummy segments cost nothing on the bus.
Bus protocol:
  * receive SHA_W (inst, blk, slot, word) at rows 3..18  [from the CPU]
  * first block:  si == H0 enforced directly
  * chained block: receive SHA_CHAIN_A/E (inst, blk, j, si word) rows 0..3
  * non-final block: send SHA_CHAIN_A/E (inst, blk+1, j, out word) rows 64..67
  * final block:  send SHA_OUT_A/E (inst, j, out word) rows 64..67 [to CPU]

Column layout (width 103):
  0..31 a bits   32..63 e bits   64..95 w bits
  96 carry_a  97 carry_e  98 carry_w
  99..106 si words (copied through the segment)
  107 out_a  108 out_e  109 co_a  110 co_e
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..ops import sha256 as sha
from ..proof.air import Air, AirBuilder, Elem
from . import channels as ch

SEGMENT = 68
ROUNDS = 64

COL_A = 0
COL_E = 32
COL_W = 64
COL_CA = 96
COL_CE = 97
COL_CW = 98
COL_SI = 99
COL_OUT_A = 107
COL_OUT_E = 108
COL_CO_A = 109
COL_CO_E = 110
WIDTH = 111

# preprocessed column indices
P_K = 0        # round constant K_t at anchor rows
P_SR = 1       # round anchor selector (r in 0..63)
P_SW = 2       # schedule anchor selector (r in 3..50)
P_SICOPY = 3   # si copy selector (r in 0..66)
P_L0 = 4       # one-hots r==0..3 (4 cols)
P_D0 = 8       # one-hots r==64..67 (4 cols)
P_J = 12       # digest word index: r at rows 0..3; 67-r at rows 64..67
P_WSLOT = 13   # message word slot (r-3) at rows 3..18
P_INST = 14    # instance id of this segment's message
P_BLK = 15     # block index within the message
P_FIRSTB = 16  # 1 at r==0 of a real first block (si == H0)
P_CHAINED = 17 # 1 at rows 0..3 of a real chained block (chain receive)
P_WRECV = 18   # 1 at rows 3..18 of a real block (w receive)
P_LASTB = 19   # 1 at rows 64..67 of a real final block (digest send)
P_CHSEND = 20  # 1 at rows 64..67 of a real non-final block (chain send)
PRE_WIDTH = 21


@dataclass
class SegmentInfo:
    """Schedule entry: segment s proves block `blk` of message `inst`."""

    inst: int
    blk: int
    is_first: bool
    is_last: bool
    real: bool = True


def schedule_for(messages: Sequence[Sequence], n_rows: int) -> List[SegmentInfo]:
    """messages: list of per-message block counts (ints) or block lists."""
    n_seg = n_rows // SEGMENT
    sched: List[SegmentInfo] = []
    for inst, m in enumerate(messages):
        n_blocks = m if isinstance(m, int) else len(m)
        for b in range(n_blocks):
            sched.append(SegmentInfo(inst, b, b == 0, b == n_blocks - 1))
    if len(sched) > n_seg:
        raise ValueError(f"{len(sched)} compressions need more than {n_rows} rows")
    while len(sched) < n_seg:
        sched.append(SegmentInfo(0, 0, True, True, real=False))
    return sched


def _xor2(x: Elem, y: Elem) -> Elem:
    return x + y - 2 * (x * y)


def _xor3(x: Elem, y: Elem, z: Elem) -> Elem:
    xy = x * y
    return x + y + z - 2 * (xy + y * z + x * z) + 4 * (xy * z)


class Sha256Air(Air):
    width = WIDTH
    pre_width = PRE_WIDTH
    row_offsets = (0, 1, 2, 3, 4, 9, 14, 16)
    pre_offsets = (0,)
    max_constraint_degree = 8

    def __init__(self, schedule: List[SegmentInfo], n_rows: int):
        self.schedule = schedule
        self.n_rows = n_rows

    def preprocessed_columns(self, n: int) -> np.ndarray:
        if n != self.n_rows:
            raise ValueError(f"the schedule was built for {self.n_rows} rows, not {n}")
        pre = np.zeros((n, PRE_WIDTH), dtype=np.uint64)
        for s, seg in enumerate(self.schedule):
            base = s * SEGMENT
            for r in range(SEGMENT):
                row = base + r
                if r < ROUNDS:
                    pre[row, P_K] = int(sha.K[r])
                    pre[row, P_SR] = 1
                if 3 <= r <= 50:
                    pre[row, P_SW] = 1
                if r <= 66:
                    pre[row, P_SICOPY] = 1
                if r < 4:
                    pre[row, P_L0 + r] = 1
                    pre[row, P_J] = r
                if 64 <= r <= 67:
                    pre[row, P_D0 + r - 64] = 1
                    pre[row, P_J] = 67 - r
                if 3 <= r <= 18:
                    pre[row, P_WSLOT] = r - 3
                pre[row, P_INST] = seg.inst
                pre[row, P_BLK] = seg.blk
                if seg.real:
                    if seg.is_first and r == 0:
                        pre[row, P_FIRSTB] = 1
                    if not seg.is_first and r < 4:
                        pre[row, P_CHAINED] = 1
                    if 3 <= r <= 18:
                        pre[row, P_WRECV] = 1
                    if 64 <= r <= 67:
                        if seg.is_last:
                            pre[row, P_LASTB] = 1
                        else:
                            pre[row, P_CHSEND] = 1
        return pre

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _range_check(b, e: Elem, hi: int):
        acc = e
        for j in range(1, hi + 1):
            acc = acc * (e - j)
        b.assert_zero(acc)

    POW2 = [1 << i for i in range(32)]

    def eval(self, b: AirBuilder):
        P2 = self.POW2
        a_bits = {k: b.row_stack(k, COL_A, 32) for k in (0, 1, 2, 3, 4)}
        e_bits = {k: b.row_stack(k, COL_E, 32) for k in (0, 1, 2, 3, 4)}
        w_bits = {k: b.row_stack(k, COL_W, 32) for k in (0, 1, 3, 9, 14, 16)}

        for e in (a_bits[0], e_bits[0], w_bits[0]):
            b.assert_bool(e)
        b.assert_bool(b.local(COL_CO_A))
        b.assert_bool(b.local(COL_CO_E))
        self._range_check(b, b.local(COL_CA), 7)
        self._range_check(b, b.local(COL_CE), 7)
        self._range_check(b, b.local(COL_CW), 3)

        sr = b.pre_local(P_SR)
        sw = b.pre_local(P_SW)
        si_copy = b.pre_local(P_SICOPY)
        k_const = b.pre_local(P_K)

        def word(bits_stacked):
            return b.fold(bits_stacked, P2)

        def rot(e, r):
            return b.gather(e, [(i + r) % 32 for i in range(32)])

        a0_val = word(a_bits[0])
        e0_val = word(e_bits[0])

        # loading rows bind (A, E) to the chaining input copies
        for j in range(4):
            lj = b.pre_local(P_L0 + j)
            b.assert_zero(lj * (a0_val - b.local(COL_SI + 3 - j)))
            b.assert_zero(lj * (e0_val - b.local(COL_SI + 7 - j)))

        # si copies within the segment
        for j in range(8):
            b.assert_zero(si_copy * (b.next(COL_SI + j) - b.local(COL_SI + j)))

        # first block: si == H0
        firstb = b.pre_local(P_FIRSTB)
        for j in range(8):
            b.assert_zero(firstb * (b.local(COL_SI + j) - int(sha.H0[j])))

        # round function (see module docstring)
        e3, f3, g3 = e_bits[3], e_bits[2], e_bits[1]
        s1 = word(_xor3(rot(e3, 6), rot(e3, 11), rot(e3, 25)))
        ch_val = word(e3 * f3 + g3 - e3 * g3)
        w_t = word(w_bits[3])
        t1 = e0_val + s1 + ch_val + k_const + w_t
        e_new = word(e_bits[4])
        b.assert_zero(sr * (e_new + (1 << 32) * b.local(COL_CE) - (a0_val + t1)))

        a3, b3, c3 = a_bits[3], a_bits[2], a_bits[1]
        s0 = word(_xor3(rot(a3, 2), rot(a3, 13), rot(a3, 22)))
        ab = a3 * b3
        maj = word(ab + a3 * c3 + b3 * c3 - 2 * (ab * c3))
        a_new = word(a_bits[4])
        b.assert_zero(sr * (a_new + (1 << 32) * b.local(COL_CA) - (t1 + s0 + maj)))

        # message schedule
        def sigma_small(bits, r1, r2, shift):
            x = rot(bits, r1)
            y = rot(bits, r2)
            xy = _xor2(x, y)
            full = _xor3(x, y, b.gather(bits, [(i + shift) % 32 for i in range(32)]))
            lanes_full = [i for i in range(32) if i + shift < 32]
            lanes_xy = [i for i in range(32) if i + shift >= 32]
            return b.fold(b.gather(full, lanes_full), [1 << i for i in lanes_full]) + \
                b.fold(b.gather(xy, lanes_xy), [1 << i for i in lanes_xy])

        w0 = word(w_bits[0])
        sig0 = sigma_small(w_bits[1], 7, 18, 3)
        w9 = word(w_bits[9])
        sig1 = sigma_small(w_bits[14], 17, 19, 10)
        w16 = word(w_bits[16])
        b.assert_zero(
            sw * (w16 + (1 << 32) * b.local(COL_CW) - (w0 + sig0 + w9 + sig1))
        )

        # digest rows r=64..67: word j = 67-r; out = si_j + final_word
        #   final a-word at row 64+i is A(local) with word index j=3-i,
        #   paired chaining word si_j (a side) / si_{4+j} (e side).
        for i in range(4):
            di = b.pre_local(P_D0 + i)
            j = 3 - i
            b.assert_zero(
                di
                * (
                    b.local(COL_OUT_A)
                    + (1 << 32) * b.local(COL_CO_A)
                    - (b.local(COL_SI + j) + a0_val)
                )
            )
            b.assert_zero(
                di
                * (
                    b.local(COL_OUT_E)
                    + (1 << 32) * b.local(COL_CO_E)
                    - (b.local(COL_SI + 4 + j) + e0_val)
                )
            )

        # -- bus ---------------------------------------------------------
        inst = b.pre_local(P_INST)
        blk = b.pre_local(P_BLK)
        jcol = b.pre_local(P_J)
        # message words from the CPU
        b.receive(
            ch.SHA_W,
            [inst, blk, b.pre_local(P_WSLOT), word(w_bits[0])],
            b.pre_local(P_WRECV),
        )
        # chained si words (value = si_{P_J} via the row one-hots)
        si_a = None
        si_e = None
        for j in range(4):
            lj = b.pre_local(P_L0 + j)
            ta = lj * b.local(COL_SI + j)
            te = lj * b.local(COL_SI + 4 + j)
            si_a = ta if si_a is None else si_a + ta
            si_e = te if si_e is None else si_e + te
        chained = b.pre_local(P_CHAINED)
        b.receive(ch.SHA_CHAIN_A, [inst, blk, jcol, si_a], chained)
        b.receive(ch.SHA_CHAIN_E, [inst, blk, jcol, si_e], chained)
        # chain sends to the next block
        chsend = b.pre_local(P_CHSEND)
        b.send(ch.SHA_CHAIN_A, [inst, blk + 1, jcol, b.local(COL_OUT_A)], chsend)
        b.send(ch.SHA_CHAIN_E, [inst, blk + 1, jcol, b.local(COL_OUT_E)], chsend)
        # digest sends to the CPU
        lastb = b.pre_local(P_LASTB)
        b.send(ch.SHA_OUT_A, [inst, jcol, b.local(COL_OUT_A)], lastb)
        b.send(ch.SHA_OUT_E, [inst, jcol, b.local(COL_OUT_E)], lastb)


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------

def build_trace(messages: Sequence[np.ndarray], n_rows: int,
                schedule: List[SegmentInfo]) -> np.ndarray:
    """messages[i]: (n_blocks_i, 16) uint32 block words for instance i.

    The schedule must enumerate each message's blocks in order (as produced
    by schedule_for). Returns the (n_rows, WIDTH) uint64 trace.
    """
    n_seg = n_rows // SEGMENT
    if len(schedule) != n_seg:
        raise ValueError("schedule does not match the trace height")

    # run compressions with chaining, per segment
    seg_blocks = np.zeros((n_seg, 16), dtype=np.uint32)
    seg_state_in = np.zeros((n_seg, 8), dtype=np.uint32)
    chain_state = {}
    for s, seg in enumerate(schedule):
        if seg.real:
            blk = np.asarray(messages[seg.inst][seg.blk], dtype=np.uint32)
        else:
            blk = np.zeros(16, dtype=np.uint32)
        seg_blocks[s] = blk
        if seg.real and not seg.is_first:
            seg_state_in[s] = chain_state[seg.inst]
        else:
            seg_state_in[s] = sha.H0
        out, _ = sha.compress_blocks(blk[None], seg_state_in[s][None], trace=True)
        chain_state[seg.inst] = out[0]

    state_out, tr = sha.compress_blocks(seg_blocks, seg_state_in, trace=True)
    states = tr["state"].astype(np.uint64)  # (n_seg, 65, 8)
    w = tr["w"].astype(np.uint64)  # (n_seg, 64)

    trace = np.zeros((n_rows, WIDTH), dtype=np.uint64)

    a_vals = np.zeros((n_seg, SEGMENT), dtype=np.uint64)
    e_vals = np.zeros((n_seg, SEGMENT), dtype=np.uint64)
    w_vals = np.zeros((n_seg, SEGMENT), dtype=np.uint64)
    a_vals[:, 0] = seg_state_in[:, 3]
    a_vals[:, 1] = seg_state_in[:, 2]
    a_vals[:, 2] = seg_state_in[:, 1]
    e_vals[:, 0] = seg_state_in[:, 7]
    e_vals[:, 1] = seg_state_in[:, 6]
    e_vals[:, 2] = seg_state_in[:, 5]
    a_vals[:, 3:] = states[:, :, 0]
    e_vals[:, 3:] = states[:, :, 4]
    w_vals[:, 3:67] = w

    # round carries
    a = states[:, :, 0].astype(np.uint32)
    e = states[:, :, 4].astype(np.uint32)
    S1 = np.zeros((n_seg, 64), dtype=np.uint64)
    CH = np.zeros((n_seg, 64), dtype=np.uint64)
    S0 = np.zeros((n_seg, 64), dtype=np.uint64)
    MAJ = np.zeros((n_seg, 64), dtype=np.uint64)
    for t in range(64):
        et, ft, gt = e[:, t], states[:, t, 5].astype(np.uint32), states[:, t, 6].astype(np.uint32)
        at, bt, ct = a[:, t], states[:, t, 1].astype(np.uint32), states[:, t, 2].astype(np.uint32)
        S1[:, t] = (((et >> 6) | (et << 26)) ^ ((et >> 11) | (et << 21)) ^ ((et >> 25) | (et << 7))).astype(np.uint64)
        CH[:, t] = ((et & ft) ^ (~et & gt)).astype(np.uint64)
        S0[:, t] = (((at >> 2) | (at << 30)) ^ ((at >> 13) | (at << 19)) ^ ((at >> 22) | (at << 10))).astype(np.uint64)
        MAJ[:, t] = ((at & bt) ^ (at & ct) ^ (bt & ct)).astype(np.uint64)
    t1_full = states[:, :64, 7] + S1 + CH + sha.K.astype(np.uint64)[None] + w
    e_new_full = states[:, :64, 3] + t1_full
    carry_e = e_new_full >> 32
    a_new_full = t1_full + S0 + MAJ
    carry_a = a_new_full >> 32
    assert np.array_equal(e_new_full & 0xFFFFFFFF, states[:, 1:, 4])
    assert np.array_equal(a_new_full & 0xFFFFFFFF, states[:, 1:, 0])

    carry_w = np.zeros((n_seg, SEGMENT), dtype=np.uint64)
    for r in range(3, 51):
        x15 = w[:, r - 2].astype(np.uint32)
        x2 = w[:, r + 11].astype(np.uint32)
        s0 = (((x15 >> 7) | (x15 << 25)) ^ ((x15 >> 18) | (x15 << 14)) ^ (x15 >> 3)).astype(np.uint64)
        s1 = (((x2 >> 17) | (x2 << 15)) ^ ((x2 >> 19) | (x2 << 13)) ^ (x2 >> 10)).astype(np.uint64)
        full = w[:, r - 3] + s0 + w[:, r + 6] + s1
        assert np.array_equal(full & 0xFFFFFFFF, w[:, r + 13])
        carry_w[:, r] = full >> 32

    out_full = seg_state_in.astype(np.uint64) + states[:, 64, :]
    co = out_full >> 32
    out = out_full & 0xFFFFFFFF
    assert np.array_equal(out.astype(np.uint32), state_out)

    for s in range(n_seg):
        base = s * SEGMENT
        rows = slice(base, base + SEGMENT)
        for i in range(32):
            trace[rows, COL_A + i] = (a_vals[s] >> i) & 1
            trace[rows, COL_E + i] = (e_vals[s] >> i) & 1
            trace[rows, COL_W + i] = (w_vals[s] >> i) & 1
        trace[base:base + 64, COL_CA] = carry_a[s]
        trace[base:base + 64, COL_CE] = carry_e[s]
        trace[rows, COL_CW] = carry_w[s]
        for j in range(8):
            trace[rows, COL_SI + j] = seg_state_in[s, j]
        for i in range(4):
            j = 3 - i
            trace[base + 64 + i, COL_OUT_A] = out[s, j]
            trace[base + 64 + i, COL_OUT_E] = out[s, 4 + j]
            trace[base + 64 + i, COL_CO_A] = co[s, j]
            trace[base + 64 + i, COL_CO_E] = co[s, 4 + j]
    return trace


def digests(messages: Sequence[np.ndarray]) -> List[List[int]]:
    """Expected digest words per instance (for building bus expectations)."""
    outs = []
    for blocks in messages:
        state = sha.H0[None].copy()
        for blk in np.asarray(blocks, dtype=np.uint32):
            state = sha.compress_blocks(blk[None], state)
        outs.append([int(v) for v in state[0]])
    return outs
