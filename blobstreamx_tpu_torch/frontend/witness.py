"""Batched witness engine: compiles the frontend's straight-line event
program into a leveled schedule executed as vectorized numpy/field sweeps.

The port's copy of ``blobstreamx_tpu/frontend/witness.py``: arithmetic
rows, hints, SHA-256 and SHA-512 calls and Poseidon permutations. Host
numpy and python ints, as in the reference: a map job hashes a few hundred
messages, below the size where the SHA-256 kernel pays.

  * build-once: every event gets a dataflow level (1 + max level of its
    input wires); events at the same level are independent by construction.
  * prove-many: execution walks levels; within a level, same-kind events run
    as ONE vectorized operation — arithmetic rows as gathered Goldilocks
    numpy sweeps (field/goldilocks_host.py), typed hints (u32 splits,
    carries, borrows, inverses) as numpy expressions, SHA-256/512
    compressions batched across calls, Poseidon permutations through the
    python-int ``ops/poseidon.permute_py``. Only opaque callback hints (the
    witness fetchers, a handful per circuit) remain Python calls.

Equivalence with the interpreter is tested (tests/test_torch_frontend.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import hashlib

import numpy as np

from ..field import goldilocks_host as glh
from ..field.extension import W
from ..field.goldilocks import P
from ..ops import poseidon as _pos
from ..ops import sha256 as _sha
from ..ops import sha512 as _sha5

_U64 = np.uint64


@dataclass
class _Batch:
    kind: str
    payload: dict


class WitnessProgram:
    def __init__(self, builder):
        self.b = builder
        self._compile(builder)

    # -- compilation --------------------------------------------------------

    def _compile(self, b):
        rows = b.rows
        # Poseidon read-wire map: rows with flags[11] (F_POS_OUT)
        pos_reads: Dict[int, Dict[int, int]] = {}
        for r in rows:
            if r.defines and not r.constrain and len(r.flags) > 11 and r.flags[11]:
                pos_reads.setdefault(r.io[0], {})[r.io[1]] = r.out_idx
        # op records: (kind, in_wires, out_wires, payload)
        ops = []
        for ev in b.events:
            if ev[0] == "row":
                r = rows[ev[1]]
                if r.constrain and r.defines:
                    ins = [r.in_idx[p] for p in range(4) if r.in_act[p]]
                    ops.append(("arith", ins, [r.out_idx], r))
                # chip-output rows are produced by their chip event below;
                # assert/send/free rows define nothing to compute
            elif ev[0] == "hint":
                _, fn, in_wires, outs = ev[:4]
                kind = ev[4] if len(ev) > 4 and ev[4] else "call"
                ops.append((kind, list(in_wires), list(outs), fn))
            elif ev[0] == "sha":
                call = ev[1]
                if call.message_byte_wires is not None:
                    ins = list(call.message_byte_wires)
                else:
                    ins = [w for blk in call.blocks_word_wires for w in blk]
                ops.append(("sha", ins, list(call.digest_word_wires), call))
            elif ev[0] == "sha512":
                call = ev[1]
                if call.message_byte_wires is not None:
                    ins = list(call.message_byte_wires)
                else:
                    ins = [w for blk in call.blocks_half_wires for w in blk]
                ops.append(("sha512", ins, list(call.digest_half_wires), call))
            elif ev[0] == "pos":
                perm = ev[1]
                if perm.merkle:
                    ins = list(perm.sib_wires) + [perm.dir_wire]
                else:
                    ins = list(perm.absorb.values())
                reads = pos_reads.get(perm.inst, {})
                ops.append(("pos", ins, list(reads.values()), (perm, reads)))

        # Dataflow levels, independent of event-emission order: circuits may
        # legally consume wires whose producing hint_into is registered later
        # (e.g. tendermint alloc_* helpers). Well-defined because each wire
        # has exactly ONE producer (checked), so the dependency DAG is
        # explicit; Kahn topological pass assigns level = 1 + max(dep level).
        producer = np.full(b.n_wires, -1, dtype=np.int64)
        for i, (kind, ins, outs, _) in enumerate(ops):
            for w in outs:
                if producer[w] >= 0:
                    raise ValueError(f"wire {w} produced twice; dataflow "
                                     "scheduling would be ambiguous")
                producer[w] = i

        n_ops = len(ops)
        deps: List[set] = [set() for _ in range(n_ops)]
        last_perm_in_chain: Dict[int, int] = {}
        for i, (kind, ins, outs, payload) in enumerate(ops):
            for w in ins:
                pi = producer[w]
                if pi >= 0 and pi != i:
                    deps[i].add(int(pi))
            if kind == "pos":
                chain = payload[0].chain
                if chain in last_perm_in_chain:
                    deps[i].add(last_perm_in_chain[chain])
                last_perm_in_chain[chain] = i

        consumers: List[List[int]] = [[] for _ in range(n_ops)]
        indeg = np.zeros(n_ops, dtype=np.int64)
        for i, ds in enumerate(deps):
            indeg[i] = len(ds)
            for d in ds:
                consumers[d].append(i)
        op_level = np.zeros(n_ops, dtype=np.int64)
        queue = [i for i in range(n_ops) if indeg[i] == 0]
        done = 0
        while queue:
            nxt = []
            for i in queue:
                done += 1
                lvl = op_level[i]
                for c in consumers[i]:
                    if op_level[c] < lvl + 1:
                        op_level[c] = lvl + 1
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        nxt.append(c)
            queue = nxt
        if done != n_ops:
            raise ValueError("witness dataflow graph has a cycle")
        op_level += 1

        # group by (level, kind) preserving original order within groups
        groups: Dict[tuple, List[int]] = {}
        for i in range(len(ops)):
            groups.setdefault((int(op_level[i]), ops[i][0]), []).append(i)

        order = sorted(groups.items(), key=lambda kv: kv[0][0])
        self.batches: List[_Batch] = []
        for (lvl, kind), idxs in order:
            self.batches.append(self._build_batch(kind, [ops[i] for i in idxs]))
        # level-sorted flat op list for the sequential oracle
        self._ops_sorted = [ops[i] for _, idxs in order for i in idxs]

    def _build_batch(self, kind: str, ops) -> _Batch:
        if kind == "arith":
            n = len(ops)
            q = np.zeros((n, 6), dtype=_U64)
            in_idx = np.zeros((n, 4), dtype=np.int64)
            out_idx = np.zeros(n, dtype=np.int64)
            for i, (_, _, outs, r) in enumerate(ops):
                q[i] = [int(v) % P for v in r.q]
                in_idx[i] = r.in_idx
                out_idx[i] = r.out_idx
            return _Batch("arith", dict(q=q, in_idx=in_idx, out_idx=out_idx))
        if kind in ("inv0", "split4", "carry2", "carry3", "borrow2",
                    "borrow3", "split2", "split64", "shr7", "bits64",
                    "f2inv"):
            ins = np.array([op[1] for op in ops], dtype=np.int64)
            outs = np.array([op[2] for op in ops], dtype=np.int64)
            return _Batch(kind, dict(ins=ins, outs=outs))
        if kind in ("sha", "sha512"):
            msg, raw = [], []
            for op in ops:
                (msg if op[3].message_byte_wires is not None else raw).append(op)
            payload = dict(msg=[], raw={})
            for op in msg:
                call = op[3]
                payload["msg"].append((
                    np.array(call.message_byte_wires, dtype=np.int64),
                    np.array(op[2], dtype=np.int64),
                ))
            # raw path: group by block count for batched compression
            by_nblk: Dict[int, list] = {}
            for op in raw:
                call = op[3]
                blocks = (call.blocks_word_wires if kind == "sha"
                          else call.blocks_half_wires)
                by_nblk.setdefault(len(blocks), []).append(
                    (np.array(blocks, dtype=np.int64),
                     np.array(op[2], dtype=np.int64))
                )
            for nblk, items in by_nblk.items():
                payload["raw"][nblk] = (
                    np.stack([it[0] for it in items]),   # (B, nblk, n_words)
                    np.stack([it[1] for it in items]),   # (B, n_out)
                )
            return _Batch(kind, payload)
        if kind == "pos":
            return _Batch("pos", dict(perms=[op[3] for op in ops]))
        # generic callback hints
        return _Batch("call", dict(calls=[(op[3], op[1], op[2]) for op in ops]))

    # -- execution ----------------------------------------------------------

    def run(self, vals: np.ndarray):
        """Mutates vals in place."""
        chains: Dict[int, list] = {}
        for batch in self.batches:
            if batch.kind == "pos":
                for perm, reads in batch.payload["perms"]:
                    _pos_step(perm, reads, vals, chains)
            else:
                getattr(self, "_run_" + batch.kind)(batch.payload, vals)
        return vals

    def _run_arith(self, p, vals):
        v = vals[p["in_idx"]]                    # (n, 4)
        q = p["q"]
        acc = q[:, 0].copy()
        for port in range(4):
            acc = glh.add(acc, glh.mul(q[:, 1 + port], v[:, port]))
        acc = glh.add(acc, glh.mul(q[:, 5], glh.mul(v[:, 0], v[:, 1])))
        vals[p["out_idx"]] = acc

    def _run_inv0(self, p, vals):
        a = vals[p["ins"][:, 0]]
        if a.shape[0] < 128:
            out = np.array([0 if int(x) == 0 else pow(int(x), P - 2, P)
                            for x in a], dtype=_U64)
        else:
            out = glh.inv_or_zero(a)
        vals[p["outs"][:, 0]] = out

    def _run_split4(self, p, vals):
        v = vals[p["ins"][:, 0]]
        outs = p["outs"]
        vals[outs[:, 0]] = (v >> _U64(24)) & _U64(0xFF)
        vals[outs[:, 1]] = (v >> _U64(16)) & _U64(0xFF)
        vals[outs[:, 2]] = (v >> _U64(8)) & _U64(0xFF)
        vals[outs[:, 3]] = v & _U64(0xFF)

    def _run_carry2(self, p, vals):
        ins = p["ins"]
        vals[p["outs"][:, 0]] = (vals[ins[:, 0]] + vals[ins[:, 1]]) >> _U64(32)

    def _run_carry3(self, p, vals):
        ins = p["ins"]
        s = vals[ins[:, 0]] + vals[ins[:, 1]] + vals[ins[:, 2]]
        vals[p["outs"][:, 0]] = s >> _U64(32)

    def _run_borrow2(self, p, vals):
        ins = p["ins"]
        vals[p["outs"][:, 0]] = (vals[ins[:, 0]] < vals[ins[:, 1]]).astype(_U64)

    def _run_borrow3(self, p, vals):
        ins = p["ins"]
        lt = vals[ins[:, 0]] < vals[ins[:, 1]] + vals[ins[:, 2]]
        vals[p["outs"][:, 0]] = lt.astype(_U64)

    def _run_split2(self, p, vals):
        v = vals[p["ins"][:, 0]]
        vals[p["outs"][:, 0]] = v >> _U64(8)
        vals[p["outs"][:, 1]] = v & _U64(0xFF)

    def _run_split64(self, p, vals):
        v = vals[p["ins"][:, 0]]
        vals[p["outs"][:, 0]] = v & _U64(0xFFFFFFFF)
        vals[p["outs"][:, 1]] = v >> _U64(32)

    def _run_shr7(self, p, vals):
        vals[p["outs"][:, 0]] = vals[p["ins"][:, 0]] >> _U64(7)

    def _run_bits64(self, p, vals):
        v = vals[p["ins"][:, 0]]
        outs = p["outs"]  # (n, 64)
        for i in range(64):
            vals[outs[:, i]] = (v >> _U64(i)) & _U64(1)

    def _run_f2inv(self, p, vals):
        c0 = vals[p["ins"][:, 0]]
        c1 = vals[p["ins"][:, 1]]
        w = np.full_like(c0, _U64(W))
        norm = glh.sub(glh.mul(c0, c0), glh.mul(w, glh.mul(c1, c1)))
        ninv = glh.inv_or_zero(norm)
        vals[p["outs"][:, 0]] = glh.mul(c0, ninv)
        vals[p["outs"][:, 1]] = glh.mul(glh.neg(c1), ninv)

    def _run_sha(self, p, vals):
        for msg_idx, out_idx in p["msg"]:
            msg = vals[msg_idx].astype(np.uint8).tobytes()
            digest = hashlib.sha256(msg).digest()
            vals[out_idx] = np.frombuffer(digest, dtype=">u4").astype(_U64)
        for nblk, (blk_idx, out_idx) in p["raw"].items():
            B = blk_idx.shape[0]
            state = np.repeat(_sha.H0[None], B, axis=0)
            words = vals[blk_idx].astype(np.uint32)  # (B, nblk, 16)
            for k in range(nblk):
                state = _sha.compress_blocks(words[:, k], state)
            vals[out_idx] = state.astype(_U64)

    def _run_sha512(self, p, vals):
        def to_halves(state):
            # digest layout: a-side words 0..3 as (lo,hi) pairs, then e-side
            out = np.empty((state.shape[0], 16), dtype=_U64)
            out[:, 0::2] = state & _U64(0xFFFFFFFF)
            out[:, 1::2] = state >> _U64(32)
            return out

        for msg_idx, out_idx in p["msg"]:
            msg = vals[msg_idx].astype(np.uint8).tobytes()
            digest = hashlib.sha512(msg).digest()
            words = np.frombuffer(digest, dtype=">u8").astype(_U64)[None]
            vals[out_idx] = to_halves(words)[0]
        for nblk, (blk_idx, out_idx) in p["raw"].items():
            B = blk_idx.shape[0]
            state = np.repeat(_sha5.H0[None], B, axis=0)
            halves = vals[blk_idx]  # (B, nblk, 32): (lo, hi) interleaved
            words = (halves[:, :, 0::2] | (halves[:, :, 1::2] << _U64(32)))
            for k in range(nblk):
                state = _sha5.compress_blocks(words[:, k].astype(np.uint64), state)
            vals[out_idx] = to_halves(state)

    def _run_call(self, p, vals):
        for fn, ins, outs in p["calls"]:
            results = fn([int(vals[w]) for w in ins])
            for w, r in zip(outs, results):
                vals[w] = int(r) % P

    # -- sequential oracle ---------------------------------------------------

    def run_sequential(self, vals: np.ndarray):
        """Execute the same dataflow schedule one op at a time with Python
        integers and the hints' ORIGINAL callbacks — independent of the
        vectorized kernels above, so it serves as the equivalence oracle
        for them (tests/test_torch_frontend.py)."""
        chains: Dict[int, list] = {}
        for kind, ins, outs, payload in self._ops_sorted:
            if kind == "arith":
                r = payload
                acc = r.q[0]
                for port in range(4):
                    if r.in_act[port]:
                        acc = (acc + r.q[1 + port] * int(vals[r.in_idx[port]])) % P
                if r.q[5]:
                    acc = (acc + r.q[5] * int(vals[r.in_idx[0]])
                           * int(vals[r.in_idx[1]])) % P
                vals[r.out_idx] = acc
            elif kind == "sha":
                call = payload
                if call.message_byte_wires is not None:
                    msg = bytes(int(vals[w]) & 0xFF for w in call.message_byte_wires)
                    digest = hashlib.sha256(msg).digest()
                    words = [int.from_bytes(digest[4 * i:4 * i + 4], "big")
                             for i in range(8)]
                else:
                    state = _sha.H0[None].copy()
                    for word_wires in call.blocks_word_wires:
                        blk = np.array([[int(vals[w]) for w in word_wires]],
                                       dtype=np.uint32)
                        state = _sha.compress_blocks(blk, state)
                    words = [int(v) for v in state[0]]
                vals[np.array(outs, dtype=np.int64)] = np.array(words, dtype=_U64)
            elif kind == "sha512":
                call = payload
                if call.message_byte_wires is not None:
                    msg = bytes(int(vals[w]) & 0xFF for w in call.message_byte_wires)
                    digest = hashlib.sha512(msg).digest()
                else:
                    state = _sha5.H0[None].copy()
                    for half_wires in call.blocks_half_wires:
                        blk = np.array(
                            [[int(vals[half_wires[2 * wi]])
                              | (int(vals[half_wires[2 * wi + 1]]) << 32)
                              for wi in range(16)]], dtype=np.uint64)
                        state = _sha5.compress_blocks(blk, state)
                    digest = b"".join(int(v).to_bytes(8, "big") for v in state[0])
                halves = []
                for j in range(8):
                    word = int.from_bytes(digest[8 * j:8 * j + 8], "big")
                    halves.append((word & 0xFFFFFFFF, word >> 32))
                flat = ([h for pair in halves[:4] for h in pair]
                        + [h for pair in halves[4:] for h in pair])
                vals[np.array(outs, dtype=np.int64)] = np.array(flat, dtype=_U64)
            elif kind == "pos":
                _pos_step(*payload, vals, chains)
            else:  # every hint kind, typed or not: original callback
                results = payload([int(vals[w]) for w in ins])
                for w, r in zip(outs, results):
                    vals[w] = int(r) % P
        return vals


def _pos_step(perm, reads: Dict[int, int], vals: np.ndarray, chains: Dict[int, list]):
    """One scheduled permutation: its input state (absorbed wires, lanes
    carried from its chain's last output, or a Merkle step), the python-int
    permutation, and the lanes the circuit reads."""
    st = [0] * _pos.WIDTH
    if perm.merkle:
        dig = chains[perm.chain][:4]
        sib = [int(vals[w]) for w in perm.sib_wires]
        if int(vals[perm.dir_wire]):
            st[0:4], st[4:8] = sib, dig
        else:
            st[0:4], st[4:8] = dig, sib
    else:
        prev = chains.get(perm.chain)
        for i in perm.carry:
            st[i] = prev[i]
        for lane, w in perm.absorb.items():
            st[lane] = int(vals[w])
    out = _pos.permute_py(st)
    chains[perm.chain] = out
    for lane, w in reads.items():
        vals[w] = out[lane]
