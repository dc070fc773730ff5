"""In-circuit recursive verification of SystemProofs.

The port's copy of ``blobstreamx_tpu/proof/recursion.py``. A
``RecursiveVerifier`` emits, into a frontend ``CircuitBuilder``, the
complete verification of one ``proof/system.py`` SystemProof of a fixed
inner-circuit shape: Fiat-Shamir transcript replay as Poseidon-chip duplex
chains, Merkle cap openings as chip sponges and Merkle-mode climbs
(data-dependent paths via in-chip direction selects), the constraint
identity at zeta re-evaluated through a circuit backend for the same
``Air.eval`` code the prover and verifier run, DEEP recomputation, FRI fold
walks, the grind check, and the LogUp bus balance against the inner
circuit's public byte stream.

The verifier circuit is shape-specific (table sizes, widths, query counts
are baked at build time). Proof data enters as hint witness via
``flatten_system_proof``, whose element order mirrors ``alloc_proof``
exactly; it reads the port's proof dataclasses (python-int digests,
openings and FRI pairs) and yields the reference's element stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..field import goldilocks as gl
from ..field.extension import GFp2 as F2
from ..field.extension import W
from ..frontend.builder import BoolVariable, CircuitBuilder, Variable
from . import fri as fri_mod
from . import system as system_mod
from .air import AirBuilder, FIRST_ROW, LAST_ROW, TRANSITION
from .stark import StarkConfig, build as stark_build

P = gl.P
INV2 = pow(2, P - 2, P)


# ---------------------------------------------------------------------------
# GF(p^2) arithmetic on wires
# ---------------------------------------------------------------------------

class F2C:
    """F2 ops over (c0_wire, c1_wire) handles, lowered to CPU-table rows."""

    def __init__(self, cb: CircuitBuilder):
        self.cb = cb
        self.zero_w = cb.zero().wire
        self.one_w = cb.one().wire

    def const(self, pair) -> tuple:
        return (self.cb.constant(pair[0]).wire, self.cb.constant(pair[1]).wire)

    def from_base(self, w: int) -> tuple:
        return (w, self.zero_w)

    def add(self, a, b) -> tuple:
        cb = self.cb
        return (
            cb._arith(terms=[(1, a[0]), (1, b[0])]).wire,
            cb._arith(terms=[(1, a[1]), (1, b[1])]).wire,
        )

    def sub(self, a, b) -> tuple:
        cb = self.cb
        return (
            cb._arith(terms=[(1, a[0]), (P - 1, b[0])]).wire,
            cb._arith(terms=[(1, a[1]), (P - 1, b[1])]).wire,
        )

    def mul(self, a, b) -> tuple:
        """(a0b0 + W a1b1, a0b1 + a1b0) in 4 rows."""
        cb = self.cb
        t0 = cb._arith(qm_pair=(1, a[0], b[0]))
        c0 = cb._arith(qm_pair=(W, a[1], b[1]), terms=[(1, t0.wire)])
        t2 = cb._arith(qm_pair=(1, a[0], b[1]))
        c1 = cb._arith(qm_pair=(1, a[1], b[0]), terms=[(1, t2.wire)])
        return (c0.wire, c1.wire)

    def mul_add(self, a, b, t) -> tuple:
        """a*b + t in 4 rows (the Horner primitive)."""
        cb = self.cb
        u = cb._arith(qm_pair=(1, a[0], b[0]))
        c0 = cb._arith(qm_pair=(W, a[1], b[1]),
                       terms=[(1, u.wire), (1, t[0])])
        v = cb._arith(qm_pair=(1, a[0], b[1]))
        c1 = cb._arith(qm_pair=(1, a[1], b[0]),
                       terms=[(1, v.wire), (1, t[1])])
        return (c0.wire, c1.wire)

    def mul_base(self, a, w: int) -> tuple:
        """Multiply by a base-field wire."""
        cb = self.cb
        return (
            cb._arith(qm_pair=(1, a[0], w)).wire,
            cb._arith(qm_pair=(1, a[1], w)).wire,
        )

    def mul_int(self, a, k: int) -> tuple:
        cb = self.cb
        k = k % P
        return (
            cb._arith(terms=[(k, a[0])]).wire,
            cb._arith(terms=[(k, a[1])]).wire,
        )

    def add_int(self, a, pair) -> tuple:
        cb = self.cb
        return (
            cb._arith(q0=pair[0] % P, terms=[(1, a[0])]).wire,
            cb._arith(q0=pair[1] % P, terms=[(1, a[1])]).wire,
        )

    def inv(self, a) -> tuple:
        """Hinted inverse with in-circuit product check (a must be nonzero;
        the check a*inv == 1 enforces both existence and correctness)."""
        cb = self.cb

        def f2inv(vals):
            return list(F2.inv((vals[0], vals[1])))

        i0, i1 = cb.hint([Variable(a[0]), Variable(a[1])], 2, f2inv,
                         kind="f2inv")
        prod = self.mul(a, (i0, i1))
        cb._assert_expr_zero(q0=P - 1, terms=[(1, prod[0])])
        cb._assert_expr_zero(terms=[(1, prod[1])])
        return (i0, i1)

    def assert_eq(self, a, b):
        cb = self.cb
        cb._assert_expr_zero(terms=[(1, a[0]), (P - 1, b[0])])
        cb._assert_expr_zero(terms=[(1, a[1]), (P - 1, b[1])])

    def pow_int(self, a, e: int) -> tuple:
        acc = None
        base = a
        while e:
            if e & 1:
                acc = base if acc is None else self.mul(acc, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return acc if acc is not None else self.const((1, 0))

    def select(self, bit_w: int, a, b) -> tuple:
        """bit ? a : b (bit already constrained boolean)."""
        cb = self.cb
        out = []
        for j in range(2):
            d = cb._arith(terms=[(1, a[j]), (P - 1, b[j])])
            out.append(cb._arith(qm_pair=(1, bit_w, d.wire),
                                 terms=[(1, b[j])]).wire)
        return tuple(out)


def bits64(cb: CircuitBuilder, w: int) -> List[int]:
    """Decompose a field wire into 64 boolean wires (LSB first) with a
    canonical-representation constraint (value < p, so the decomposition
    is unique — Goldilocks canonicity: hi32 == 2^32-1 implies lo32 == 0)."""

    def split_bits(vals):
        v = vals[0]
        return [(v >> i) & 1 for i in range(64)]

    bit_ws = cb.hint([Variable(w)], 64, split_bits, kind="bits64")
    for bw in bit_ws:
        cb.assert_bool(BoolVariable(bw))

    def wordsum(bits, shift0):
        acc = None
        for i in range(0, 32, 4):
            terms = [(1 << (shift0 + i + j), bits[i + j]) for j in range(4)]
            if acc is None:
                acc = cb._arith(terms=terms[:3])
                acc = cb._arith(terms=[(1, acc.wire)] + terms[3:])
            else:
                acc = cb._arith(terms=[(1, acc.wire)] + terms[:3])
                acc = cb._arith(terms=[(1, acc.wire)] + terms[3:])
        return acc

    lo = wordsum(bit_ws[:32], 0)
    hi = wordsum(bit_ws[32:], 0)
    cb._assert_expr_zero(
        terms=[(1, lo.wire), (1 << 32, hi.wire), (P - 1, w)]
    )
    eq = cb.is_equal(hi, cb.constant(0xFFFFFFFF))
    cb._assert_expr_zero(qm_pair=(1, eq.wire, lo.wire))
    return bit_ws


# ---------------------------------------------------------------------------
# in-circuit transcript (Poseidon duplex via the pos chip)
# ---------------------------------------------------------------------------

class CircuitTranscript:
    """Mirrors proof/transcript.py Transcript exactly, lane for lane."""

    RATE = 8
    WIDTH = 12

    def __init__(self, cb: CircuitBuilder, init_state: Optional[List[int]] = None):
        self.cb = cb
        self.chain = cb.pos_new_chain()
        self.cpos = 0
        self.last_perm = None
        self.input_buffer: List[int] = []
        self.out_remaining = 0
        self._read_cache: Dict[int, int] = {}
        self._init_state = init_state  # 12 wires (fork), else zero state

    def _duplex(self):
        cb = self.cb
        absorb = {i: w for i, w in enumerate(self.input_buffer)}
        nbuf = len(self.input_buffer)
        if self.last_perm is not None:
            carry = tuple(range(nbuf, self.WIDTH))
        elif self._init_state is not None:
            for i in range(nbuf, self.WIDTH):
                absorb[i] = self._init_state[i]
            carry = ()
        else:
            carry = ()  # zero state: unabsorbed lanes default to 0 in-chip
        self.last_perm = cb.pos_perm(self.chain, self.cpos, absorb, carry=carry)
        self.cpos += 1
        self.input_buffer = []
        self.out_remaining = self.RATE
        self._read_cache = {}

    def _read_lane(self, lane: int) -> int:
        if lane not in self._read_cache:
            self._read_cache[lane] = self.cb.pos_read(self.last_perm, lane).wire
        return self._read_cache[lane]

    def observe(self, w: int):
        self.out_remaining = 0
        self.input_buffer.append(w)
        if len(self.input_buffer) == self.RATE:
            self._duplex()

    def observe_ext(self, h):
        self.observe(h[0])
        self.observe(h[1])

    def observe_digest(self, ws: Sequence[int]):
        for w in ws:
            self.observe(w)

    def get_challenge(self) -> int:
        if self.input_buffer or not self.out_remaining:
            self._duplex()
        self.out_remaining -= 1
        return self._read_lane(self.out_remaining)

    def ext_challenge(self):
        return (self.get_challenge(), self.get_challenge())

    def fork(self) -> "CircuitTranscript":
        """Snapshot (reference check_grind forks the challenger)."""
        if self.last_perm is not None:
            state = [self._read_lane(i) for i in range(self.WIDTH)]
        elif self._init_state is not None:
            state = list(self._init_state)
        else:
            state = [self.cb.zero().wire] * self.WIDTH
        t = CircuitTranscript(self.cb, init_state=state)
        t.input_buffer = list(self.input_buffer)
        # a forked host transcript also inherits the output buffer, but
        # check_grind immediately observes (clearing it) — not modeled
        return t


# ---------------------------------------------------------------------------
# in-circuit Merkle verification (pos chip sponge + merkle climbs)
# ---------------------------------------------------------------------------

def merkle_verify_circuit(cb: CircuitBuilder, row_wires: List[int],
                          path_bits: List[int], sib_wires: List[List[int]],
                          cap_digests: List[List[int]]) -> None:
    """Constrain hash_no_pad(row) climbed along path_bits (with the proof's
    sibling digests) to equal the cap digest selected by the remaining
    bits. len(path_bits) == len(sib_wires) + log2(len(cap_digests))."""
    n_cap = len(cap_digests)
    cap_bits_n = n_cap.bit_length() - 1
    assert 1 << cap_bits_n == n_cap
    levels = len(path_bits) - cap_bits_n
    assert len(sib_wires) == levels

    chain = cb.pos_new_chain()
    cpos = 0
    for off in range(0, len(row_wires), 8):
        chunk = row_wires[off:off + 8]
        carry = tuple(range(len(chunk), 12)) if cpos else ()
        cb.pos_perm(chain, cpos, {i: w for i, w in enumerate(chunk)},
                    carry=carry)
        cpos += 1
    for lvl in range(levels):
        cb.pos_perm(chain, cpos, {}, merkle=True,
                    sib_wires=tuple(sib_wires[lvl]),
                    dir_wire=path_bits[lvl])
        cpos += 1
    # final digest == selected cap digest
    last = cb.pos_perms[-1]
    digest = [cb.pos_read(last, j).wire for j in range(4)]
    sel = cap_digests
    for bi in range(cap_bits_n):
        bit = path_bits[levels + bi]
        nxt = []
        for k in range(0, len(sel), 2):
            nxt.append([
                cb.select(BoolVariable(bit), Variable(sel[k + 1][j]),
                          Variable(sel[k][j])).wire
                for j in range(4)
            ])
        sel = nxt
    for j in range(4):
        cb.assert_is_equal(Variable(digest[j]), Variable(sel[0][j]))


# ---------------------------------------------------------------------------
# AirBuilder backend over F2C handles
# ---------------------------------------------------------------------------

class CircuitExtBackend:
    """AirBuilder backend: values are GF(p^2) wire-pair handles — the
    circuit analogue of ExtPointBackend (evaluation at zeta)."""

    def __init__(self, f2: F2C):
        self.f2 = f2

    def const(self, c):
        if isinstance(c, tuple):  # already a handle (challenge component)
            return c
        return self.f2.const((int(c) % P, 0))

    def add(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            a = a if isinstance(a, list) else [a] * len(b)
            b = b if isinstance(b, list) else [b] * len(a)
            return [self.add(x, y) for x, y in zip(a, b)]
        return self.f2.add(a, b)

    def sub(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            a = a if isinstance(a, list) else [a] * len(b)
            b = b if isinstance(b, list) else [b] * len(a)
            return [self.sub(x, y) for x, y in zip(a, b)]
        return self.f2.sub(a, b)

    def mul(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            a = a if isinstance(a, list) else [a] * len(b)
            b = b if isinstance(b, list) else [b] * len(a)
            return [self.mul(x, y) for x, y in zip(a, b)]
        return self.f2.mul(a, b)

    def stack(self, handles):
        return list(handles)

    def gather(self, h, indices):
        return [h[i] for i in indices]

    def fold(self, h, weights):
        acc = None
        for v, w in zip(h, weights):
            t = self.f2.mul_int(v, int(w))
            acc = t if acc is None else self.f2.add(acc, t)
        return acc

    @staticmethod
    def is_stacked(h):
        return isinstance(h, list)


# ---------------------------------------------------------------------------
# proof shapes
# ---------------------------------------------------------------------------

@dataclass
class TableShape:
    name: str
    air: object
    n: int
    n_inter: int
    vk_pre_cap: Optional[list]  # cap ints (constants of the outer circuit)

    def derived(self, cfg: StarkConfig):
        log_n = self.n.bit_length() - 1
        N = self.n << cfg.rate_bits
        log_N = log_n + cfg.rate_bits
        return log_n, N, log_N


def fri_layer_shapes(log_N: int, cfg: StarkConfig):
    """[(half, cap_height_k, levels_k)] for each fold layer."""
    out = []
    size = 1 << log_N
    while size > (1 << cfg.final_poly_bits):
        half = size // 2
        cap_k = min(cfg.cap_height, half.bit_length() - 1)
        out.append((half, cap_k, (half.bit_length() - 1) - cap_k))
        size = half
    return out


def inner_shapes(compiled, cfg: StarkConfig, device=None, vks=None) -> List[TableShape]:
    """Table shapes of a CompiledCircuit (the inner statement). The
    preprocessed caps come from ``vks`` (the circuit's verifier keys, as
    ``build_keys`` returns them) or are committed on ``device`` (None: the
    card)."""
    sizes = compiled.table_sizes()
    shapes = []
    for i, (name, air) in enumerate(zip(compiled._table_names(), compiled.airs())):
        n_inter = system_mod.introspect_interactions(air)
        vk_cap = None
        if air.pre_width:
            vk = vks[i] if vks else stark_build(air, sizes[name], cfg, device)[1]
            vk_cap = vk.pre_cap
        shapes.append(TableShape(name, air, sizes[name], n_inter, vk_cap))
    return shapes


# ---------------------------------------------------------------------------
# the recursive verifier
# ---------------------------------------------------------------------------

class RecursiveVerifier:
    def __init__(self, cb: CircuitBuilder, shapes: List[TableShape],
                 cfg: StarkConfig):
        self.cb = cb
        self.f2 = F2C(cb)
        self.shapes = shapes
        self.cfg = cfg
        self.any_bus = any(s.n_inter for s in shapes)

    # -- proof wire allocation (order mirrored by flatten_system_proof) ----

    def alloc_proof(self) -> Tuple[dict, List[int]]:
        cb, cfg = self.cb, self.cfg
        flat: List[int] = []

        def w():
            x = cb.free_wire()
            flat.append(x)
            return x

        def ws(k):
            return [w() for _ in range(k)]

        def cap(n_cap):
            return [ws(4) for _ in range(n_cap)]

        def exts(k):
            return [(w(), w()) for _ in range(k)]

        proof = {"tables": []}
        n_cap = 1 << cfg.cap_height
        for s in self.shapes:
            air = s.air
            log_n, N, log_N = s.derived(cfg)
            blowup = 1 << cfg.rate_bits
            aux_w = 2 * (s.n_inter + 1) if s.n_inter else 0
            t = {
                "main_cap": cap(n_cap),
                "aux_cap": cap(n_cap) if s.n_inter else None,
                "totals": (w(), w()) if s.n_inter else None,
                "quotient_cap": cap(n_cap),
                "main_openings": {k: exts(air.width)
                                  for k in air.row_offsets},
                "aux_openings": ({k: exts(aux_w) for k in (0, 1)}
                                 if s.n_inter else {}),
                "pre_openings": ({k: exts(air.pre_width)
                                  for k in air.pre_offsets}
                                 if air.pre_width else {}),
                "quotient_zeta": exts(2 * blowup),
                "aux_w": aux_w,
            }
            layers = fri_layer_shapes(log_N, cfg)
            final_len = max(1, (1 << cfg.final_poly_bits) >> cfg.rate_bits)
            t["fri"] = {
                "caps": [cap(1 << cap_k) for (_, cap_k, _) in layers],
                "final_coeffs": exts(final_len),
                "pow_nonce": w(),
                "queries": [
                    [
                        {"pair": exts(2), "sibs": [ws(4) for _ in range(lv)]}
                        for (_, _, lv) in layers
                    ]
                    for _ in range(cfg.num_query_rounds)
                ],
            }
            levels = log_N - cfg.cap_height
            t["query_openings"] = []
            for _ in range(cfg.num_query_rounds):
                entry = {
                    "main": {"row": ws(air.width),
                             "sibs": [ws(4) for _ in range(levels)]},
                    "quotient": {"row": ws(2 * blowup),
                                 "sibs": [ws(4) for _ in range(levels)]},
                }
                if s.n_inter:
                    entry["aux"] = {"row": ws(aux_w),
                                    "sibs": [ws(4) for _ in range(levels)]}
                if air.pre_width:
                    entry["pre"] = {"row": ws(air.pre_width),
                                    "sibs": [ws(4) for _ in range(levels)]}
                t["query_openings"].append(entry)
            proof["tables"].append(t)
        return proof, flat

    # -- the verification statement ----------------------------------------

    def verify(self, proof: dict,
               public_messages: List[Tuple[int, List[int], int]]):
        """Emit all constraints. public_messages: (channel, [wire args],
        sign) — the inner circuit's public byte stream as outer wires."""
        cb, f2, cfg = self.cb, self.f2, self.cfg
        tr = CircuitTranscript(cb)

        # 1. preamble + pre caps (constants), main caps
        pre_cap_wires = []
        for s in self.shapes:
            tr.observe(cb.constant(s.air.width % P).wire)
            tr.observe(cb.constant(s.n % P).wire)
            if s.air.pre_width:
                wires = [[cb.constant(int(v)).wire for v in d]
                         for d in s.vk_pre_cap]
                pre_cap_wires.append(wires)
                for d in wires:
                    tr.observe_digest(d)
            else:
                pre_cap_wires.append(None)
        for s, t in zip(self.shapes, proof["tables"]):
            for d in t["main_cap"]:
                tr.observe_digest(d)

        gamma = delta = None
        if self.any_bus:
            gamma = tr.ext_challenge()
            delta = tr.ext_challenge()

        for s, t in zip(self.shapes, proof["tables"]):
            if s.n_inter:
                for d in t["aux_cap"]:
                    tr.observe_digest(d)
                tr.observe(t["totals"][0])
                tr.observe(t["totals"][1])

        alpha = tr.ext_challenge()
        for s, t in zip(self.shapes, proof["tables"]):
            for d in t["quotient_cap"]:
                tr.observe_digest(d)
        zeta = tr.ext_challenge()

        for s, t in zip(self.shapes, proof["tables"]):
            for k in s.air.row_offsets:
                for v in t["main_openings"][k]:
                    tr.observe_ext(v)
            for k in ((0, 1) if s.n_inter else ()):
                for v in t["aux_openings"][k]:
                    tr.observe_ext(v)
            for k in (s.air.pre_offsets if s.air.pre_width else ()):
                for v in t["pre_openings"][k]:
                    tr.observe_ext(v)
            for v in t["quotient_zeta"]:
                tr.observe_ext(v)
        alpha2 = tr.ext_challenge()

        # 2. per table: constraint identity + FRI
        for s, t, pre_cap in zip(self.shapes, proof["tables"], pre_cap_wires):
            self._check_table(s, t, pre_cap, tr, gamma, delta, alpha, zeta,
                              alpha2)

        # 3. bus balance
        if self.any_bus:
            acc = None
            for s, t in zip(self.shapes, proof["tables"]):
                if s.n_inter:
                    tot = t["totals"]
                    h = (tot[0], tot[1])
                    acc = h if acc is None else f2.add(acc, h)
            for channel, args, sign in public_messages:
                fp = f2.const((channel % P, 0))
                gp = f2.const((1, 0))
                for a in args:
                    gp = f2.mul(gp, gamma)
                    if isinstance(a, int):  # static arg (e.g. byte position)
                        fp = f2.add(fp, f2.mul_int(gp, a))
                    else:
                        fp = f2.add(fp, f2.mul_base(gp, a.wire))
                term = f2.inv(f2.add(delta, fp))
                if sign < 0:
                    term = f2.sub(f2.const((0, 0)), term)
                acc = term if acc is None else f2.add(acc, term)
            cb._assert_expr_zero(terms=[(1, acc[0])])
            cb._assert_expr_zero(terms=[(1, acc[1])])

    # -- one table ----------------------------------------------------------

    def _check_table(self, s: TableShape, t: dict, pre_cap, tr, gamma, delta,
                     alpha, zeta, alpha2):
        cb, f2, cfg = self.cb, self.f2, self.cfg
        air = s.air
        log_n, N, log_N = s.derived(cfg)
        n = s.n
        blowup = 1 << cfg.rate_bits
        g_n = gl.primitive_root_of_unity(log_n)
        offsets = tuple(air.row_offsets)
        aux_offsets = (0, 1) if s.n_inter else ()
        pre_off = tuple(air.pre_offsets) if air.pre_width else ()

        # --- constraint identity at zeta --------------------------------
        handle = lambda v: (v[0], v[1])
        rows_at = {k: [handle(v) for v in t["main_openings"][k]]
                   for k in offsets}
        aux_at = ({k: [handle(v) for v in t["aux_openings"][k]]
                   for k in aux_offsets} if s.n_inter else None)
        pre_at = ({k: [handle(v) for v in t["pre_openings"][k]]
                   for k in pre_off} if air.pre_width else None)
        chal_handles = []
        if s.n_inter:
            chal_handles = [
                (f2.from_base(gamma[0]), f2.from_base(gamma[1])),
                (f2.from_base(delta[0]), f2.from_base(delta[1])),
            ]
        builder = AirBuilder(
            CircuitExtBackend(f2),
            rows=rows_at,
            publics=[],
            aux_rows=aux_at,
            challenges=chal_handles,
            pre_rows=pre_at,
        )
        air.eval(builder)
        if s.n_inter:
            tot_h = (f2.from_base(t["totals"][0]), f2.from_base(t["totals"][1]))
            system_mod._emit_logup_constraints(builder, tot_h)

        zh, sel_first, sel_last, sel_trans = self._selectors_at(zeta, log_n)
        combined = None
        for con in builder.constraints:
            entries = con.expr if isinstance(con.expr, list) else [con.expr]
            sel = {FIRST_ROW: sel_first, LAST_ROW: sel_last,
                   TRANSITION: sel_trans}.get(con.scope)
            for cc in entries:
                if sel is not None:
                    cc = f2.mul(cc, sel)
                combined = cc if combined is None else f2.mul_add(
                    combined, alpha, cc)
        zn = f2.pow_int(zeta, n)
        q_at = f2.const((0, 0))
        zkn = f2.const((1, 0))
        for k in range(blowup):
            c0 = t["quotient_zeta"][2 * k]
            c1 = t["quotient_zeta"][2 * k + 1]
            # chunk = c0 + c1 * t  (t = (0,1), t^2 = W)
            chunk_h = f2.add((c0[0], c0[1]),
                             f2.mul((c1[0], c1[1]), f2.const((0, 1))))
            q_at = f2.add(q_at, f2.mul(zkn, chunk_h))
            if k + 1 < blowup:
                zkn = f2.mul(zkn, zn)
        f2.assert_eq(combined, f2.mul(zh, q_at))

        # --- FRI ---------------------------------------------------------
        layers = fri_layer_shapes(log_N, cfg)
        betas = []
        for cap_ws, _layer in zip(t["fri"]["caps"], layers):
            for d in cap_ws:
                tr.observe_digest(d)
            betas.append(tr.ext_challenge())
        for c in t["fri"]["final_coeffs"]:
            tr.observe_ext(c)
        # grind
        fork = tr.fork()
        fork.observe(t["fri"]["pow_nonce"])
        pow_ch = fork.get_challenge()
        pow_bits_w = bits64(cb, pow_ch)
        for j in range(64 - cfg.pow_bits, 64):
            cb.assert_is_equal(Variable(pow_bits_w[j]), cb.zero())
        tr.observe(t["fri"]["pow_nonce"])

        # query indices
        zeta_by_offset = {
            k: f2.mul_int(zeta, pow(g_n, k, P))
            for k in sorted(set(offsets) | set(aux_offsets) | set(pre_off))
        }
        inv2_h = None
        for qi in range(cfg.num_query_rounds):
            ch = tr.get_challenge()
            qbits = bits64(cb, ch)[:log_N]
            v = self._deep_at_index(s, t, pre_cap, qi, qbits, zeta_by_offset,
                                    alpha2, log_n)
            # fold walk
            idx_bits = qbits
            for k, ((half, cap_k, lv), beta) in enumerate(zip(layers, betas)):
                step = t["fri"]["queries"][qi][k]
                log_half = half.bit_length() - 1
                p_bits = idx_bits[:log_half]
                top = idx_bits[log_half]
                v0, v1 = step["pair"]
                # row[pos_in_pair] == v
                sel0 = f2.select(top, v1, v0)
                f2.assert_eq(sel0, v)
                row_flat = [v0[0], v0[1], v1[0], v1[1]]
                merkle_verify_circuit(cb, row_flat, p_bits, step["sibs"],
                                      t["fri"]["caps"][k])
                # fold: v' = ((v0+v1) + beta*(v0-v1)/x) / 2
                shift, w_root = fri_mod._layer_domain(log_N, k)
                x = self._pow_bits(p_bits, w_root, shift)
                x_inv = self._inv_base(x)
                s_plus = f2.add(v0, v1)
                s_minus = f2.sub(v0, v1)
                term = f2.mul(beta, f2.mul_base(s_minus, x_inv))
                v = f2.mul_int(f2.add(s_plus, term), INV2)
                idx_bits = p_bits
            # final poly eval at xf
            n_layers = len(layers)
            shift_f = pow(gl.GENERATOR, 1 << n_layers, P)
            w_f = gl.primitive_root_of_unity(log_N - n_layers)
            xf = self._pow_bits(idx_bits, w_f, shift_f)
            acc = f2.const((0, 0))
            for c in reversed(t["fri"]["final_coeffs"]):
                acc = f2.add(f2.mul_base(acc, xf), (c[0], c[1]))
            f2.assert_eq(acc, v)

    # -- helpers ------------------------------------------------------------

    def _pow_bits(self, bits: List[int], w_root: int, shift: int) -> int:
        """shift * w^(sum bits_i 2^i) as a base wire."""
        cb = self.cb
        acc = cb.constant(shift)
        wp = w_root % P
        for b in bits:
            # acc *= (1 + bit*(wp - 1)):  out = acc + bit*acc*(wp-1)
            acc = cb._arith(qm_pair=((wp - 1) % P, b, acc.wire),
                            terms=[(1, acc.wire)])
            wp = (wp * wp) % P
        return acc.wire

    def _inv_base(self, w: int) -> int:
        cb = self.cb

        def binv(vals):
            return [pow(vals[0], P - 2, P)]

        (iw,) = cb.hint([Variable(w)], 1, binv, kind="inv0")
        cb._assert_expr_zero(q0=P - 1, qm_pair=(1, w, iw))
        return iw

    def _selectors_at(self, zeta, log_n):
        f2 = self.f2
        n = 1 << log_n
        g_n = gl.primitive_root_of_unity(log_n)
        g_last = pow(g_n, n - 1, P)
        n_inv = pow(n, P - 2, P)
        zh = f2.add_int(f2.pow_int(zeta, n), (P - 1, 0))
        zm1 = f2.add_int(zeta, (P - 1, 0))
        zmg = f2.add_int(zeta, (P - g_last, 0))
        sel_first = f2.mul(f2.mul_int(zh, n_inv), f2.inv(zm1))
        sel_last = f2.mul(f2.mul_int(zh, (n_inv * g_last) % P), f2.inv(zmg))
        return zh, sel_first, sel_last, zmg

    def _deep_at_index(self, s: TableShape, t: dict, pre_cap, qi: int,
                       qbits: List[int], zeta_by_offset, alpha2, log_n):
        """Merkle-verify the query openings and recompute the DEEP value."""
        cb, f2, cfg = self.cb, self.f2, self.cfg
        air = s.air
        blowup = 1 << cfg.rate_bits
        log_N = log_n + cfg.rate_bits
        entry = t["query_openings"][qi]

        def mverify(rec, cap_ws):
            merkle_verify_circuit(cb, rec["row"], qbits, rec["sibs"], cap_ws)

        mverify(entry["main"], t["main_cap"])
        mverify(entry["quotient"], t["quotient_cap"])
        if s.n_inter:
            mverify(entry["aux"], t["aux_cap"])
        if air.pre_width:
            mverify(entry["pre"], pre_cap)

        # x = GENERATOR * w^q
        w_N = gl.primitive_root_of_unity(log_N)
        x = self._pow_bits(qbits, w_N, gl.GENERATOR)
        inv_at = {k: f2.inv(self._sub_base_ext(x, zk))
                  for k, zk in zeta_by_offset.items()}

        # Horner over terms grouped identically to the native verifier
        terms = []
        for k in air.row_offsets:
            for i in range(air.width):
                terms.append((entry["main"]["row"][i],
                              t["main_openings"][k][i], inv_at[k]))
        for k in ((0, 1) if s.n_inter else ()):
            for i in range(t["aux_w"]):
                terms.append((entry["aux"]["row"][i],
                              t["aux_openings"][k][i], inv_at[k]))
        for k in (air.pre_offsets if air.pre_width else ()):
            for i in range(air.pre_width):
                terms.append((entry["pre"]["row"][i],
                              t["pre_openings"][k][i], inv_at[k]))
        for i in range(2 * blowup):
            terms.append((entry["quotient"]["row"][i],
                          t["quotient_zeta"][i], inv_at[0]))
        acc = None
        for v_w, y, inv in terms:
            d = (cb._arith(terms=[(1, v_w), (P - 1, y[0])]).wire,
                 cb._arith(terms=[(P - 1, y[1])]).wire)
            tt = f2.mul(d, inv)
            acc = tt if acc is None else f2.mul_add(acc, alpha2, tt)
        return acc

    def _sub_base_ext(self, base_w: int, ext_h) -> tuple:
        cb = self.cb
        return (
            cb._arith(terms=[(1, base_w), (P - 1, ext_h[0])]).wire,
            cb._arith(terms=[(P - 1, ext_h[1])]).wire,
        )


# ---------------------------------------------------------------------------
# proof flattening (hint-fill order == alloc_proof order)
# ---------------------------------------------------------------------------

def _digest_ints(d) -> List[int]:
    return [int(v) for v in d]


def flatten_system_proof(proof, shapes: List[TableShape],
                         cfg: StarkConfig) -> List[int]:
    out: List[int] = []

    def ext(v):
        out.append(int(v[0]) % P)
        out.append(int(v[1]) % P)

    if len(proof.table_proofs) != len(shapes):
        raise ValueError(f"{len(proof.table_proofs)} table proofs for "
                         f"{len(shapes)} tables")
    for i, (s, tp) in enumerate(zip(shapes, proof.table_proofs)):
        air = s.air
        if tp.n_rows != s.n:
            raise ValueError(f"table {s.name} has {tp.n_rows} rows, not {s.n}")
        log_n, N, log_N = s.derived(cfg)
        blowup = 1 << cfg.rate_bits
        for d in tp.main_cap:
            out.extend(_digest_ints(d))
        if s.n_inter:
            for d in tp.aux_cap:
                out.extend(_digest_ints(d))
            tot = proof.bus_totals[i]
            out.append(int(tot[0]) % P)
            out.append(int(tot[1]) % P)
        for d in tp.quotient_cap:
            out.extend(_digest_ints(d))
        for k in air.row_offsets:
            for v in tp.main_openings[k]:
                ext(v)
        for k in ((0, 1) if s.n_inter else ()):
            for v in tp.aux_openings[k]:
                ext(v)
        for k in (air.pre_offsets if air.pre_width else ()):
            for v in tp.pre_openings[k]:
                ext(v)
        for v in tp.quotient_zeta:
            ext(v)
        fp = tp.fri_proof
        for capl in fp.caps:
            for d in capl:
                out.extend(_digest_ints(d))
        for c in fp.final_coeffs:
            ext(c)
        out.append(int(fp.pow_nonce) % P)
        for steps in fp.query_rounds:
            for step in steps:
                for v in step.pair_values:  # [v(x), v(-x)], extension pairs
                    out.extend(int(c) for c in v)
                for sib in step.siblings:
                    out.extend(_digest_ints(sib))
        for entry in tp.query_openings:
            def rec(r):
                out.extend(int(v) % P for v in r.values)
                for sib in r.siblings:
                    out.extend(_digest_ints(sib))
            rec(entry["main"])
            rec(entry["quotient"])
            if s.n_inter:
                rec(entry["aux"])
            if air.pre_width:
                rec(entry["pre"])
    return out
