"""SHA-512 compression AIR ("chip") with bus I/O.

The port's copy of ``blobstreamx_tpu/chips/sha512.py``.

TPU-native equivalent of the SHA-512 inside the reference's Ed25519
accelerator (SURVEY.md D11: starkyx computes k = SHA512(R||A||M)). Mirrors
the SHA-256 chip layout (chips/sha256.py) with 1024-bit blocks, 80 rounds
and 64-bit words. One 84-row segment proves one compression:

  row r=0..3   loading: (A,E) hold (d,h),(c,g),(b,f),(a,e) of the input state
  row r=3+t    working state (a,e) entering round t, t = 0..80
  row r=80..83 digest rows: word j = 83-r chaining-add

64-bit words are stored as 64 bit-columns; all additive identities are
checked per 32-bit half with small carries (a full 64-bit word as a single
Goldilocks element would be ambiguous mod p = 2^64-2^32+1). Bus word args
are u32 halves with half-slot index 2*slot+half (half 0 = lo).

Column layout (width 222):
  0..63 a bits   64..127 e bits   128..191 w bits
  192..197 carries (ca_lo, ca_hi, ce_lo, ce_hi, cw_lo, cw_hi)
  198..213 si halves [w0_lo, w0_hi, ..., w7_hi]
  214..221 digest (out_a_lo, out_a_hi, out_e_lo, out_e_hi,
                   co_a_lo, co_a_hi, co_e_lo, co_e_hi)
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..ops import sha512 as sha
from ..proof.air import Air, AirBuilder, Elem
from . import channels as ch
from .sha256 import SegmentInfo

SEGMENT = 84
ROUNDS = 80

COL_A = 0
COL_E = 64
COL_W = 128
COL_CA_LO = 192
COL_CA_HI = 193
COL_CE_LO = 194
COL_CE_HI = 195
COL_CW_LO = 196
COL_CW_HI = 197
COL_SI = 198  # 16 half-word columns
COL_OUT_A_LO = 214
COL_OUT_A_HI = 215
COL_OUT_E_LO = 216
COL_OUT_E_HI = 217
COL_CO_A_LO = 218
COL_CO_A_HI = 219
COL_CO_E_LO = 220
COL_CO_E_HI = 221
WIDTH = 222

# preprocessed column indices
P_K_LO = 0
P_K_HI = 1
P_SR = 2
P_SW = 3
P_SICOPY = 4
P_L0 = 5       # one-hots r==0..3 (4 cols)
P_D0 = 9       # one-hots r==80..83 (4 cols)
P_J = 13
P_WSLOT = 14
P_INST = 15
P_BLK = 16
P_FIRSTB = 17
P_CHAINED = 18
P_WRECV = 19
P_LASTB = 20
P_CHSEND = 21
PRE_WIDTH = 22


def schedule_for(messages: Sequence, n_rows: int) -> List[SegmentInfo]:
    n_seg = n_rows // SEGMENT
    sched: List[SegmentInfo] = []
    for inst, m in enumerate(messages):
        n_blocks = m if isinstance(m, int) else len(m)
        for b in range(n_blocks):
            sched.append(SegmentInfo(inst, b, b == 0, b == n_blocks - 1))
    assert len(sched) <= n_seg, "sha512 trace too small for schedule"
    while len(sched) < n_seg:
        sched.append(SegmentInfo(0, 0, True, True, real=False))
    return sched


def _xor2(x: Elem, y: Elem) -> Elem:
    return x + y - 2 * (x * y)


def _xor3(x: Elem, y: Elem, z: Elem) -> Elem:
    xy = x * y
    return x + y + z - 2 * (xy + y * z + x * z) + 4 * (xy * z)


class Sha512Air(Air):
    width = WIDTH
    pre_width = PRE_WIDTH
    row_offsets = (0, 1, 2, 3, 4, 9, 14, 16)
    pre_offsets = (0,)
    max_constraint_degree = 8

    def __init__(self, schedule: List[SegmentInfo], n_rows: int):
        self.schedule = schedule
        self.n_rows = n_rows

    def preprocessed_columns(self, n: int) -> np.ndarray:
        assert n == self.n_rows
        pre = np.zeros((n, PRE_WIDTH), dtype=np.uint64)
        for s, seg in enumerate(self.schedule):
            base = s * SEGMENT
            for r in range(SEGMENT):
                row = base + r
                if r < ROUNDS:
                    pre[row, P_K_LO] = int(sha.K[r]) & 0xFFFFFFFF
                    pre[row, P_K_HI] = int(sha.K[r]) >> 32
                    pre[row, P_SR] = 1
                if 3 <= r <= 66:
                    pre[row, P_SW] = 1
                if r <= 82:
                    pre[row, P_SICOPY] = 1
                if r < 4:
                    pre[row, P_L0 + r] = 1
                    pre[row, P_J] = r
                if 80 <= r <= 83:
                    pre[row, P_D0 + r - 80] = 1
                    pre[row, P_J] = 83 - r
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
                    if 80 <= r <= 83:
                        if seg.is_last:
                            pre[row, P_LASTB] = 1
                        else:
                            pre[row, P_CHSEND] = 1
        return pre

    @staticmethod
    def _range_check(b, e: Elem, hi: int):
        acc = e
        for j in range(1, hi + 1):
            acc = acc * (e - j)
        b.assert_zero(acc)

    POW2 = [1 << i for i in range(32)]

    def eval(self, b: AirBuilder):
        P2 = self.POW2
        a_bits = {k: b.row_stack(k, COL_A, 64) for k in (0, 1, 2, 3, 4)}
        e_bits = {k: b.row_stack(k, COL_E, 64) for k in (0, 1, 2, 3, 4)}
        w_bits = {k: b.row_stack(k, COL_W, 64) for k in (0, 1, 3, 9, 14, 16)}

        for e in (a_bits[0], e_bits[0], w_bits[0]):
            b.assert_bool(e)
        for c in (COL_CO_A_LO, COL_CO_A_HI, COL_CO_E_LO, COL_CO_E_HI):
            b.assert_bool(b.local(c))
        for c in (COL_CA_LO, COL_CA_HI, COL_CE_LO, COL_CE_HI):
            self._range_check(b, b.local(c), 6)
        for c in (COL_CW_LO, COL_CW_HI):
            self._range_check(b, b.local(c), 3)

        sr = b.pre_local(P_SR)
        sw = b.pre_local(P_SW)
        si_copy = b.pre_local(P_SICOPY)
        k_lo = b.pre_local(P_K_LO)
        k_hi = b.pre_local(P_K_HI)

        def halves(bits_stacked):
            lo = b.fold(b.gather(bits_stacked, range(32)), P2)
            hi = b.fold(b.gather(bits_stacked, range(32, 64)), P2)
            return lo, hi

        def rot(e, r):
            return b.gather(e, [(i + r) % 64 for i in range(64)])

        a0_lo, a0_hi = halves(a_bits[0])
        e0_lo, e0_hi = halves(e_bits[0])

        # loading rows bind (A, E) to the chaining input halves
        for j in range(4):
            lj = b.pre_local(P_L0 + j)
            b.assert_zero(lj * (a0_lo - b.local(COL_SI + 2 * (3 - j))))
            b.assert_zero(lj * (a0_hi - b.local(COL_SI + 2 * (3 - j) + 1)))
            b.assert_zero(lj * (e0_lo - b.local(COL_SI + 2 * (7 - j))))
            b.assert_zero(lj * (e0_hi - b.local(COL_SI + 2 * (7 - j) + 1)))

        # si copies within the segment
        for j in range(16):
            b.assert_zero(si_copy * (b.next(COL_SI + j) - b.local(COL_SI + j)))

        # first block: si == H0
        firstb = b.pre_local(P_FIRSTB)
        for j in range(8):
            h = int(sha.H0[j])
            b.assert_zero(firstb * (b.local(COL_SI + 2 * j) - (h & 0xFFFFFFFF)))
            b.assert_zero(firstb * (b.local(COL_SI + 2 * j + 1) - (h >> 32)))

        # round function: offsets E: 0=h,1=g,2=f,3=e; A: 0=d,1=c,2=b,3=a
        e3, f3, g3 = e_bits[3], e_bits[2], e_bits[1]
        s1 = _xor3(rot(e3, 14), rot(e3, 18), rot(e3, 41))
        s1_lo, s1_hi = halves(s1)
        chx = e3 * f3 + g3 - e3 * g3
        ch_lo, ch_hi = halves(chx)
        w_lo, w_hi = halves(w_bits[3])
        e4_lo, e4_hi = halves(e_bits[4])
        # t1 = h + S1 + ch + K + w ; e_new = d + t1 (6 lo terms)
        sum_e_lo = a0_lo + e0_lo + s1_lo + ch_lo + k_lo + w_lo
        b.assert_zero(sr * (e4_lo + (1 << 32) * b.local(COL_CE_LO) - sum_e_lo))
        sum_e_hi = (
            a0_hi + e0_hi + s1_hi + ch_hi + k_hi + w_hi + b.local(COL_CE_LO)
        )
        b.assert_zero(sr * (e4_hi + (1 << 32) * b.local(COL_CE_HI) - sum_e_hi))

        a3, b3, c3 = a_bits[3], a_bits[2], a_bits[1]
        s0 = _xor3(rot(a3, 28), rot(a3, 34), rot(a3, 39))
        s0_lo, s0_hi = halves(s0)
        ab = a3 * b3
        maj = ab + a3 * c3 + b3 * c3 - 2 * (ab * c3)
        maj_lo, maj_hi = halves(maj)
        a4_lo, a4_hi = halves(a_bits[4])
        # a_new = t1 + S0 + maj (7 lo terms)
        sum_a_lo = e0_lo + s1_lo + ch_lo + k_lo + w_lo + s0_lo + maj_lo
        b.assert_zero(sr * (a4_lo + (1 << 32) * b.local(COL_CA_LO) - sum_a_lo))
        sum_a_hi = (
            e0_hi + s1_hi + ch_hi + k_hi + w_hi + s0_hi + maj_hi
            + b.local(COL_CA_LO)
        )
        b.assert_zero(sr * (a4_hi + (1 << 32) * b.local(COL_CA_HI) - sum_a_hi))

        # message schedule: w16 = w0 + s0(w1) + w9 + s1(w14)
        def sigma_small(bits, r1, r2, shift):
            x = rot(bits, r1)
            y = rot(bits, r2)
            xy = _xor2(x, y)
            full = _xor3(x, y, b.gather(bits, [(i + shift) % 64 for i in range(64)]))
            lanes_full = [i for i in range(64) if i + shift < 64]
            lanes_xy = [i for i in range(64) if i + shift >= 64]

            def fold_half(lo_range):
                lf = [i for i in lanes_full if i in lo_range]
                lx = [i for i in lanes_xy if i in lo_range]
                acc = None
                if lf:
                    t = b.fold(b.gather(full, lf), [1 << (i % 32) for i in lf])
                    acc = t
                if lx:
                    t = b.fold(b.gather(xy, lx), [1 << (i % 32) for i in lx])
                    acc = t if acc is None else acc + t
                return acc

            return (fold_half(range(32)), fold_half(range(32, 64)))

        w0_lo, w0_hi = halves(w_bits[0])
        sg0_lo, sg0_hi = sigma_small(w_bits[1], 1, 8, 7)
        w9_lo, w9_hi = halves(w_bits[9])
        sg1_lo, sg1_hi = sigma_small(w_bits[14], 19, 61, 6)
        w16_lo, w16_hi = halves(w_bits[16])
        sum_w_lo = w0_lo + sg0_lo + w9_lo + sg1_lo
        b.assert_zero(sw * (w16_lo + (1 << 32) * b.local(COL_CW_LO) - sum_w_lo))
        sum_w_hi = w0_hi + sg0_hi + w9_hi + sg1_hi + b.local(COL_CW_LO)
        b.assert_zero(sw * (w16_hi + (1 << 32) * b.local(COL_CW_HI) - sum_w_hi))

        # digest rows r=80..83: word j = 83-r; A local = final a-word j,
        # E local = final e-word j (state rotation, as in the SHA-256 chip)
        for i in range(4):
            di = b.pre_local(P_D0 + i)
            j = 3 - i
            b.assert_zero(di * (
                b.local(COL_OUT_A_LO) + (1 << 32) * b.local(COL_CO_A_LO)
                - (b.local(COL_SI + 2 * j) + a0_lo)
            ))
            b.assert_zero(di * (
                b.local(COL_OUT_A_HI) + (1 << 32) * b.local(COL_CO_A_HI)
                - (b.local(COL_SI + 2 * j + 1) + a0_hi + b.local(COL_CO_A_LO))
            ))
            b.assert_zero(di * (
                b.local(COL_OUT_E_LO) + (1 << 32) * b.local(COL_CO_E_LO)
                - (b.local(COL_SI + 2 * (4 + j)) + e0_lo)
            ))
            b.assert_zero(di * (
                b.local(COL_OUT_E_HI) + (1 << 32) * b.local(COL_CO_E_HI)
                - (b.local(COL_SI + 2 * (4 + j) + 1) + e0_hi + b.local(COL_CO_E_LO))
            ))

        # -- bus ---------------------------------------------------------
        inst = b.pre_local(P_INST)
        blk = b.pre_local(P_BLK)
        jcol = b.pre_local(P_J)
        wrecv = b.pre_local(P_WRECV)
        wslot = b.pre_local(P_WSLOT)
        b.receive(ch.SHA512_W, [inst, blk, 2 * wslot, w0_lo], wrecv)
        b.receive(ch.SHA512_W, [inst, blk, 2 * wslot + 1, w0_hi], wrecv)

        # chained si halves (value = si_{P_J} via the row one-hots)
        si_a_lo = si_a_hi = si_e_lo = si_e_hi = None
        for j in range(4):
            lj = b.pre_local(P_L0 + j)

            def acc(cur, col):
                t = lj * b.local(col)
                return t if cur is None else cur + t

            si_a_lo = acc(si_a_lo, COL_SI + 2 * j)
            si_a_hi = acc(si_a_hi, COL_SI + 2 * j + 1)
            si_e_lo = acc(si_e_lo, COL_SI + 2 * (4 + j))
            si_e_hi = acc(si_e_hi, COL_SI + 2 * (4 + j) + 1)
        chained = b.pre_local(P_CHAINED)
        b.receive(ch.SHA512_CHAIN_A, [inst, blk, 2 * jcol, si_a_lo], chained)
        b.receive(ch.SHA512_CHAIN_A, [inst, blk, 2 * jcol + 1, si_a_hi], chained)
        b.receive(ch.SHA512_CHAIN_E, [inst, blk, 2 * jcol, si_e_lo], chained)
        b.receive(ch.SHA512_CHAIN_E, [inst, blk, 2 * jcol + 1, si_e_hi], chained)

        chsend = b.pre_local(P_CHSEND)
        b.send(ch.SHA512_CHAIN_A, [inst, blk + 1, 2 * jcol, b.local(COL_OUT_A_LO)], chsend)
        b.send(ch.SHA512_CHAIN_A, [inst, blk + 1, 2 * jcol + 1, b.local(COL_OUT_A_HI)], chsend)
        b.send(ch.SHA512_CHAIN_E, [inst, blk + 1, 2 * jcol, b.local(COL_OUT_E_LO)], chsend)
        b.send(ch.SHA512_CHAIN_E, [inst, blk + 1, 2 * jcol + 1, b.local(COL_OUT_E_HI)], chsend)

        lastb = b.pre_local(P_LASTB)
        b.send(ch.SHA512_OUT_A, [inst, 2 * jcol, b.local(COL_OUT_A_LO)], lastb)
        b.send(ch.SHA512_OUT_A, [inst, 2 * jcol + 1, b.local(COL_OUT_A_HI)], lastb)
        b.send(ch.SHA512_OUT_E, [inst, 2 * jcol, b.local(COL_OUT_E_LO)], lastb)
        b.send(ch.SHA512_OUT_E, [inst, 2 * jcol + 1, b.local(COL_OUT_E_HI)], lastb)


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------

def build_trace(messages: Sequence[np.ndarray], n_rows: int,
                schedule: List[SegmentInfo]) -> np.ndarray:
    """messages[i]: (n_blocks_i, 16) uint64 block words for instance i."""
    n_seg = n_rows // SEGMENT
    assert len(schedule) == n_seg

    seg_blocks = np.zeros((n_seg, 16), dtype=np.uint64)
    seg_state_in = np.zeros((n_seg, 8), dtype=np.uint64)
    chain_state = {}
    for s, seg in enumerate(schedule):
        if seg.real:
            blk = np.asarray(messages[seg.inst][seg.blk], dtype=np.uint64)
        else:
            blk = np.zeros(16, dtype=np.uint64)
        seg_blocks[s] = blk
        if seg.real and not seg.is_first:
            seg_state_in[s] = chain_state[seg.inst]
        else:
            seg_state_in[s] = sha.H0
        out = sha.compress_blocks(blk[None], seg_state_in[s][None])
        chain_state[seg.inst] = out[0]

    state_out, tr = sha.compress_blocks(seg_blocks, seg_state_in, trace=True)
    states = tr["state"]  # (n_seg, 81, 8) uint64
    w = tr["w"]  # (n_seg, 80) uint64

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
    w_vals[:, 3:83] = w

    def lo(x):
        return x & np.uint64(0xFFFFFFFF)

    def hi(x):
        return x >> np.uint64(32)

    # round carries (per 32-bit half)
    for t in range(ROUNDS):
        et = states[:, t, 4]
        ft = states[:, t, 5]
        gt = states[:, t, 6]
        at = states[:, t, 0]
        bt = states[:, t, 1]
        ct = states[:, t, 2]

        def rotr(x, n):
            return (x >> np.uint64(n)) | (x << np.uint64(64 - n))

        S1 = rotr(et, 14) ^ rotr(et, 18) ^ rotr(et, 41)
        CH = (et & ft) ^ (~et & gt)
        S0 = rotr(at, 28) ^ rotr(at, 34) ^ rotr(at, 39)
        MAJ = (at & bt) ^ (at & ct) ^ (bt & ct)
        k_t = np.uint64(sha.K[t])
        rows = np.arange(n_seg) * SEGMENT + t
        # e side: d + h + S1 + ch + K + w
        terms_lo = (lo(states[:, t, 3]) + lo(states[:, t, 7]) + lo(S1)
                    + lo(CH) + lo(k_t) + lo(w[:, t]))
        e_new = states[:, t + 1, 4]
        ce_lo = (terms_lo - lo(e_new)) >> np.uint64(32)
        terms_hi = (hi(states[:, t, 3]) + hi(states[:, t, 7]) + hi(S1)
                    + hi(CH) + hi(k_t) + hi(w[:, t]) + ce_lo)
        ce_hi = (terms_hi - hi(e_new)) >> np.uint64(32)
        trace[rows, COL_CE_LO] = ce_lo
        trace[rows, COL_CE_HI] = ce_hi
        # a side: h + S1 + ch + K + w + S0 + maj
        terms_lo = (lo(states[:, t, 7]) + lo(S1) + lo(CH) + lo(k_t)
                    + lo(w[:, t]) + lo(S0) + lo(MAJ))
        a_new = states[:, t + 1, 0]
        ca_lo = (terms_lo - lo(a_new)) >> np.uint64(32)
        terms_hi = (hi(states[:, t, 7]) + hi(S1) + hi(CH) + hi(k_t)
                    + hi(w[:, t]) + hi(S0) + hi(MAJ) + ca_lo)
        ca_hi = (terms_hi - hi(a_new)) >> np.uint64(32)
        trace[rows, COL_CA_LO] = ca_lo
        trace[rows, COL_CA_HI] = ca_hi

    # schedule carries at anchor rows 3..66 (computing w[r+13])
    for r in range(3, 67):
        t = r + 13  # w index being produced
        x15 = w[:, t - 15]
        x2 = w[:, t - 2]

        def rotr(x, n):
            return (x >> np.uint64(n)) | (x << np.uint64(64 - n))

        s0 = rotr(x15, 1) ^ rotr(x15, 8) ^ (x15 >> np.uint64(7))
        s1 = rotr(x2, 19) ^ rotr(x2, 61) ^ (x2 >> np.uint64(6))
        rows = np.arange(n_seg) * SEGMENT + r
        terms_lo = lo(w[:, t - 16]) + lo(s0) + lo(w[:, t - 7]) + lo(s1)
        cw_lo = (terms_lo - lo(w[:, t])) >> np.uint64(32)
        terms_hi = hi(w[:, t - 16]) + hi(s0) + hi(w[:, t - 7]) + hi(s1) + cw_lo
        cw_hi = (terms_hi - hi(w[:, t])) >> np.uint64(32)
        trace[rows, COL_CW_LO] = cw_lo
        trace[rows, COL_CW_HI] = cw_hi

    out_full_lo = lo(seg_state_in) + lo(states[:, ROUNDS, :])
    co_lo = out_full_lo >> np.uint64(32)
    out_lo = out_full_lo & np.uint64(0xFFFFFFFF)
    out_full_hi = hi(seg_state_in) + hi(states[:, ROUNDS, :]) + co_lo
    co_hi = out_full_hi >> np.uint64(32)
    out_hi = out_full_hi & np.uint64(0xFFFFFFFF)
    assert np.array_equal(out_lo | (out_hi << np.uint64(32)), state_out)

    for s in range(n_seg):
        base = s * SEGMENT
        rows = slice(base, base + SEGMENT)
        for i in range(64):
            trace[rows, COL_A + i] = (a_vals[s] >> np.uint64(i)) & np.uint64(1)
            trace[rows, COL_E + i] = (e_vals[s] >> np.uint64(i)) & np.uint64(1)
            trace[rows, COL_W + i] = (w_vals[s] >> np.uint64(i)) & np.uint64(1)
        for j in range(8):
            trace[rows, COL_SI + 2 * j] = lo(seg_state_in[s, j])
            trace[rows, COL_SI + 2 * j + 1] = hi(seg_state_in[s, j])
        for i in range(4):
            j = 3 - i
            trace[base + 80 + i, COL_OUT_A_LO] = out_lo[s, j]
            trace[base + 80 + i, COL_OUT_A_HI] = out_hi[s, j]
            trace[base + 80 + i, COL_OUT_E_LO] = out_lo[s, 4 + j]
            trace[base + 80 + i, COL_OUT_E_HI] = out_hi[s, 4 + j]
            trace[base + 80 + i, COL_CO_A_LO] = co_lo[s, j]
            trace[base + 80 + i, COL_CO_A_HI] = co_hi[s, j]
            trace[base + 80 + i, COL_CO_E_LO] = co_lo[s, 4 + j]
            trace[base + 80 + i, COL_CO_E_HI] = co_hi[s, 4 + j]
    return trace
