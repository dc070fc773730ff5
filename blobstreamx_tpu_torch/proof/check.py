"""Witness-level soundness checker: evaluate every table's constraints on
the raw trace domain plus the LogUp bus balance, without proving. The
port's copy of ``blobstreamx_tpu/proof/check.py``.

This is exactly the statement the STARK enforces (the quotient must vanish
on the trace domain and the bus must balance), evaluated directly — a
malicious witness that fails here cannot yield a verifying proof, and an
honest witness that passes will. Used by adversarial tests (forged vote,
broken quorum, bad linkage must fail) and as a fast preflight in debugging.

Runs on a numpy host backend (field/goldilocks_host.py): AIR evaluation
here is thousands of small ops, which a numpy sweep over the trace does
far faster than per-op tensor dispatch. ``witness_failures`` names what
fails (a table and its constraints, or the bus), so a test can assert the
specific rejection; ``witness_check`` is its boolean.

Reference counterpart: the prove-then-verify oracle of every reference test
(SURVEY.md section 4) — this is its seconds-fast approximation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..field import goldilocks_host as glh
from ..field.goldilocks import P
from ..field.extension import W
from .air import (
    AirBuilder, FIRST_ROW, LAST_ROW, TRANSITION,
)

_U64 = np.uint64
_P = _U64(P)
_M32 = _U64(0xFFFFFFFF)
_32 = _U64(32)
_TWO32 = 1 << 32


class HostBackend:
    """AirBuilder backend over numpy uint64 arrays (trace-domain eval)."""

    def __init__(self, n: int):
        self.n = n
        self._consts = {}

    def const(self, c: int):
        c = int(c) % P
        if c not in self._consts:  # shared: no operation writes in place
            self._consts[c] = np.full(self.n, _U64(c), dtype=_U64)
        return self._consts[c]

    add = staticmethod(glh.add)
    sub = staticmethod(glh.sub)

    @staticmethod
    def mul(a, b):
        """glh.mul, with a shortcut when an operand is below 2^32 (most
        limb products of the byte and limb AIRs): the product then needs
        fewer partial products. Same canonical result."""
        a_small = int(a.max(initial=0)) < _TWO32
        b_small = int(b.max(initial=0)) < _TWO32
        if a_small and b_small:
            p = a * b
            return np.where(p >= _P, p - _P, p)
        if b_small:
            a, b = b, a
            a_small = True
        if a_small:  # a < 2^32: a*b = a*b0 + (a*b1) 2^32
            ll = a * (b & _M32)
            lh = a * (b >> _32)
            lo = ll + (lh << _32)
            hi = (lh >> _32) + np.where(lo < ll, _U64(1), _U64(0))
            return glh._reduce128(lo, hi)
        return glh.mul(a, b)

    def stack(self, handles):
        return np.stack(list(handles), axis=0)

    def gather(self, h, indices):
        return h[np.asarray(list(indices), dtype=np.int64)]

    def lanes(self, h, offset: int, total: int):
        return np.pad(h, ((offset, total - offset - h.shape[0]), (0, 0)))

    def const_lanes(self, values):
        return np.asarray([int(v) % P for v in values], dtype=_U64)[:, None]

    def fold(self, h, weights):
        acc = None
        for k, w in enumerate(weights):
            t = glh.mul(h[k], np.full(h.shape[1], _U64(int(w) % P), dtype=_U64))
            acc = t if acc is None else glh.add(acc, t)
        return acc


def _rolled_host(offsets, mat: np.ndarray):
    out = {}
    for k in offsets:
        m = np.roll(mat, -k, axis=0) if k else mat
        out[k] = [m[:, i] for i in range(m.shape[1])]
    return out


def _host_builder(air, trace: np.ndarray) -> AirBuilder:
    """The AIR evaluated on its trace (no aux columns: the bus is checked
    from the recorded interactions)."""
    n = trace.shape[0]
    pre_rows = None
    if air.pre_width:
        pre_rows = _rolled_host(air.pre_offsets,
                                air.preprocessed_columns(n).astype(_U64))
    b = AirBuilder(HostBackend(n), rows=_rolled_host(air.row_offsets,
                                                     trace.astype(_U64) % _U64(P)),
                   publics=[], pre_rows=pre_rows)
    air.eval(b)
    return b


def _constraint_failures(b: AirBuilder, n: int) -> list:
    """[(constraint_idx, scope, first bad rows)] of an evaluated builder."""
    failures = []
    for ci, con in enumerate(b.constraints):
        ints = np.asarray(con.expr)
        if ints.ndim == 1:
            ints = ints[None]
        bad = set()
        for lane in ints:
            nz = np.nonzero(lane)[0]
            if con.scope == FIRST_ROW:
                nz = nz[nz == 0]
            elif con.scope == LAST_ROW:
                nz = nz[nz == n - 1]
            elif con.scope == TRANSITION:
                nz = nz[nz != n - 1]
            bad.update(int(x) for x in nz)
        if bad:
            failures.append((ci, con.scope, sorted(bad)[:10]))
    return failures


# -- host GF(p^2) vector helpers ---------------------------------------------

def _f2v_add(a, b):
    return (glh.add(a[0], b[0]), glh.add(a[1], b[1]))


def _f2v_inv_batch(elems):
    """Inverses (0 for 0) of a list of host GF(p^2) vectors, by one base
    inversion: a^-1 = conj(a) / norm(a), and the norms inverted together
    (Montgomery's trick along the list)."""
    w = np.full_like(elems[0][0], _U64(W))
    norms = [glh.sub(glh.mul(a[0], a[0]), glh.mul(w, glh.mul(a[1], a[1])))
             for a in elems]
    one = np.ones_like(norms[0])
    safe = [np.where(nm == 0, one, nm) for nm in norms]
    prefix = [safe[0]]
    for nm in safe[1:]:
        prefix.append(glh.mul(prefix[-1], nm))
    acc = glh.inv(prefix[-1])
    out = [None] * len(elems)
    for k in range(len(elems) - 1, -1, -1):
        ninv = glh.mul(acc, prefix[k - 1]) if k else acc
        acc = glh.mul(acc, safe[k])
        ninv = np.where(norms[k] == 0, _U64(0), ninv)
        a = elems[k]
        out[k] = (glh.mul(a[0], ninv), glh.mul(glh.neg(a[1]), ninv))
    return out


def _bus_total(b: AirBuilder, n: int, challenges) -> Tuple[int, int]:
    """LogUp total of the interactions an evaluated builder recorded (they
    do not depend on the challenges)."""
    if not b.interactions:
        return (0, 0)
    from ..field.extension import GFp2 as F2

    gamma, delta = challenges
    mul = HostBackend.mul
    dens = []
    for inter in b.interactions:
        # delta + channel + sum_k gamma^k a_k, with base-field args a_k
        f0 = np.full(n, _U64((delta[0] + inter.channel) % P))
        f1 = np.full(n, _U64(delta[1]))
        gp = (1, 0)
        for a in inter.args:
            gp = F2.mul(gp, gamma)
            av = a.v if hasattr(a, "v") else a
            f0 = glh.add(f0, mul(av, np.full(n, _U64(gp[0]))))
            f1 = glh.add(f1, mul(av, np.full(n, _U64(gp[1]))))
        dens.append((f0, f1))
    total = (np.zeros(n, dtype=_U64), np.zeros(n, dtype=_U64))
    for inter, inv in zip(b.interactions, _f2v_inv_batch(dens)):
        mult = inter.mult.v if hasattr(inter.mult, "v") else inter.mult
        term = (mul(inv[0], mult), mul(inv[1], mult))
        if inter.sign < 0:
            term = (glh.neg(term[0]), glh.neg(term[1]))
        total = _f2v_add(total, term)
    return (
        int(sum(int(v) for v in total[0]) % P),
        int(sum(int(v) for v in total[1]) % P),
    )


def _message_term(channel, args, gamma, delta):
    from ..field.extension import GFp2 as F2

    f = (channel % P, 0)
    gp = (1, 0)
    for a in args:
        gp = F2.mul(gp, gamma)
        f = F2.add(f, F2.mul(gp, (int(a) % P, 0)))
    return F2.inv(F2.add(delta, f))


def _derive_challenges(traces: dict, publics) -> List[list]:
    """Fiat-Shamir-style bus challenges bound to the witness itself: a
    crafted witness cannot target them (they move whenever any trace cell
    or public byte moves). Two independent (gamma, delta) pairs are sampled
    so a single accidental collision cannot mask an unbalanced bus. Real
    soundness still comes from prove+verify, where the challenges are drawn
    from the transcript after commitment."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(traces):
        h.update(name.encode())
        arr = np.ascontiguousarray(np.asarray(traces[name], dtype=_U64))
        h.update(arr.tobytes())
    h.update(bytes(int(v) % 256 for v in publics))
    seed = h.digest()
    out = []
    for i in range(2):
        hi = hashlib.sha256(seed + bytes([i])).digest()
        vals = [int.from_bytes(hi[8 * j:8 * j + 8], "big") % P
                for j in range(4)]
        out.append([(vals[0], vals[1]), (vals[2], vals[3])])
    return out


def witness_failures(compiled, public_inputs: Dict[int, int],
                     device=None, tables=None) -> List[str]:
    """Full-system witness check for a CompiledCircuit: generate the
    witness, build every table trace, evaluate all constraints on the trace
    domain, and check the bus balances against the public byte stream.

    Returns what a verifier would reject, one line each: ``"table <name>:
    ..."`` with the failing constraints and rows, or ``"bus: ..."``; an
    empty list for a witness that satisfies everything. Witness-generation
    exceptions propagate. A circuit with a pos table builds its S-box
    columns on ``device`` (None: the card). ``tables`` (names) limits the
    check to those tables' constraints, without the bus."""
    vals = compiled.generate_witness(public_inputs)
    return trace_failures(compiled, vals, compiled.traces(vals, device), tables)


def trace_failures(compiled, vals, traces: dict, tables=None) -> List[str]:
    """``witness_failures`` of a witness ``vals`` whose table traces are
    already built."""
    from ..field.extension import GFp2 as F2

    names = compiled._table_names()
    airs = compiled.airs()
    out = []
    builders = {}
    for name, air in zip(names, airs):
        if tables is not None and name not in tables:
            continue
        builders[name] = _host_builder(air, traces[name])
        fails = _constraint_failures(builders[name], traces[name].shape[0])
        if fails:
            out.append(f"table {name}: {len(fails)} failing constraints, "
                       f"first {fails[:3]}")
    if tables is not None:
        return out
    publics = compiled.public_values(vals)
    for k, challenges in enumerate(_derive_challenges(traces, publics)):
        total = (0, 0)
        for name in names:
            total = F2.add(total, _bus_total(builders[name], traces[name].shape[0],
                                             challenges))
        gamma, delta = challenges
        for channel, args, sign in compiled.public_messages(publics):
            term = _message_term(channel, args, gamma, delta)
            if sign < 0:
                term = F2.sub((0, 0), term)
            total = F2.add(total, term)
        if total != (0, 0):
            out.append(f"bus: unbalanced under challenge pair {k}")
            break
    return out


def witness_check(compiled, public_inputs: Dict[int, int], device=None) -> bool:
    """True iff the witness satisfies everything a verifier would enforce
    (``witness_failures`` is empty)."""
    return not witness_failures(compiled, public_inputs, device)
