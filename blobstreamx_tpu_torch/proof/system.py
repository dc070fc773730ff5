"""Multi-table proof system: shared transcript + LogUp bus across AIRs.

Counterpart of ``blobstreamx_tpu/proof/system.py``, with the same protocol
and transcript order, so a proof here is byte-identical (``serde.dumps``)
to the JAX package's on the same inputs:

  1. observe per-table preamble + preprocessed caps
  2. commit every table's main trace            -> caps observed
  3. draw bus challenges gamma (fingerprint), delta (denominator)
  4. per table: build LogUp aux columns, commit  -> caps + totals observed
  5. draw alpha; per table: quotient commit      -> caps observed
  6. draw zeta; per table: openings              -> observed
  7. draw alpha2; per table: DEEP + FRI (sequential)
  8. verifier: sum of table totals == sum of public-message terms

``prove_system`` runs on the card by default (``device=None``); the heavy
steps go through the NTT and Poseidon kernels there. ``device="cpu"`` runs
the plain versions. The verifier is host code.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as devmod
from ..field import goldilocks as gl
from ..field import ntt as nttmod
from ..field import extension as ext
from . import fri
from . import merkle_cap
from .air import Air, AirBuilder, BaseLdeBackend, ExtPointBackend, Elem, ExtElem
from .stark import (
    OpenedRow,
    ProverKey,
    StarkConfig,
    StarkProof,
    Discard,
    HornerLde,
    VerifierKey,
    _combine_constraints_point,
    _commit_matrix,
    _eval_cols_at_points,
    _ext_pow,
    _ext_weights,
    _lde_point,
    _lde_points,
    _observe_preamble,
    _offset_rows,
    _open_rows,
    _selector_tables,
    _selectors_at_point,
    build,
    column_chunks,
    offset_rows,
)
from .transcript import Transcript

F2 = ext.GFp2


@dataclass
class TableSpec:
    name: str
    air: Air
    trace: np.ndarray  # (n, width) uint64
    publics: Sequence[int]
    pk: Optional[ProverKey] = None


@dataclass
class SystemProof:
    table_proofs: List[StarkProof]
    bus_totals: List[Optional[Tuple[int, int]]]


class PhaseTimer:
    """Wall seconds per prover phase. A phase ends where the next begins;
    on the card each boundary synchronises first, so a phase's seconds hold
    its own device work."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._name = None
        self._t0 = 0.0
        self._device = None

    def mark(self, name: str, device) -> None:
        self._close()
        self._name, self._device = name, device
        self._t0 = time.perf_counter()

    def end(self) -> None:
        self._close()
        self._name = None

    def _close(self) -> None:
        if self._name is None:
            return
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        dt = time.perf_counter() - self._t0
        self.seconds[self._name] = self.seconds.get(self._name, 0.0) + dt


# ---------------------------------------------------------------------------
# LogUp helpers
# ---------------------------------------------------------------------------

def introspect_interactions(air: Air) -> int:
    """Count the AIR's bus interactions (runs eval with dummy values)."""
    zero = (0, 0)
    dummy_rows = {k: [zero] * air.width for k in air.row_offsets}
    pre = None
    if air.pre_width:
        pre = {k: [zero] * air.pre_width for k in air.pre_offsets}
    b = AirBuilder(
        ExtPointBackend(),
        rows=dummy_rows,
        publics=[0] * 64,
        aux_rows={0: [zero] * 1024, 1: [zero] * 1024},
        challenges=[(1, 1), (1, 1)],
        pre_rows=pre,
    )
    air.eval(b)
    return len(b.interactions)


def _fingerprint(builder: AirBuilder, inter, gamma_pair) -> ExtElem:
    """channel + gamma*arg0 + gamma^2*arg1 + ... as an ExtElem.

    gamma_pair is an int pair on the prover and verifier (the powers of
    gamma fold into host constants) or a pair of backend handles inside the
    recursive verifier (proof/recursion.py), where the powers are computed
    in-circuit."""
    acc = ExtElem.from_base(builder.const(inter.channel))
    if isinstance(gamma_pair[0], int):
        gp = (1, 0)
        for a in inter.args:
            gp = F2.mul(gp, gamma_pair)
            acc = acc + builder.ext_const(gp) * a
    else:
        gamma = ExtElem(builder.const(gamma_pair[0]), builder.const(gamma_pair[1]))
        gp = builder.ext_const((1, 0))
        for a in inter.args:
            gp = gp * gamma
            acc = acc + gp * a
    return acc


def _stacked_dens(inters, gamma, delta, n: int, dev) -> torch.Tensor:
    """delta + fingerprint of each interaction over the domain, as one
    (K, n, 2) tensor: channel + sum_k gamma^(k+1) arg_k, the arguments of
    all K interactions stacked a position at a time (a missing argument is
    0). The same values as ``_fingerprint``, in a few launches."""
    k_max = max(len(inter.args) for inter in inters)
    chan = gl.from_int([(inter.channel + delta[0]) % gl.P for inter in inters], dev)
    f0 = chan[:, None].expand(len(inters), n)
    f1 = gl.scalar(delta[1], dev).expand(len(inters), n)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    gp = (1, 0)
    for k in range(k_max):
        gp = F2.mul(gp, gamma)
        a = torch.stack([inter.args[k].v.expand(n) if k < len(inter.args) else zero
                         for inter in inters])
        f0 = gl.add(f0, gl.mul(a, gl.scalar(gp[0], dev)))
        f1 = gl.add(f1, gl.mul(a, gl.scalar(gp[1], dev)))
    return ext.join(f0, f1)


def _stacked_mults(inters, n: int) -> torch.Tensor:
    return torch.stack([(inter.mult.v if isinstance(inter.mult, Elem) else inter.mult)
                        .expand(n) for inter in inters])


def message_term(channel: int, args: Sequence[int], gamma, delta) -> Tuple[int, int]:
    """Host-side 1/(delta + fingerprint) for a public message."""
    f = (channel % gl.P, 0)
    gp = (1, 0)
    for a in args:
        gp = F2.mul(gp, gamma)
        f = F2.add(f, F2.mul(gp, (int(a) % gl.P, 0)))
    return F2.inv(F2.add(delta, f))


def _emit_logup_constraints(builder: AirBuilder, total_pair) -> None:
    """Append the LogUp constraints after air.eval registered interactions.

    Aux layout: cols (2i, 2i+1) = inv_i (extension), last pair = running sum.
    """
    inters = builder.interactions
    n_i = len(inters)
    gamma = builder._challenges[0]
    delta = builder._challenges[1]
    if isinstance(builder.b, BaseLdeBackend):
        # the same constraints in the same order, computed a chunk of
        # interactions at a time
        b, n = builder.b, builder.b.n
        for sl in column_chunks(n_i, 2 * n):
            chunk = inters[sl]
            inv = ext.join(
                torch.stack([builder.aux_local(2 * i).v for i in range(sl.start, sl.stop)]),
                torch.stack([builder.aux_local(2 * i + 1).v
                             for i in range(sl.start, sl.stop)]))
            e = ext.mul(inv, _stacked_dens(chunk, gamma, delta, n, b.device))
            e0 = gl.sub(ext.c0(e), _stacked_mults(chunk, n))
            e1 = ext.c1(e)
            del inv, e
            for k in range(len(chunk)):
                builder.assert_zero(Elem(e0[k], b))
                builder.assert_zero(Elem(e1[k], b))
    else:
        for i, inter in enumerate(inters):
            inv = builder.aux_local_ext(i)
            f = _fingerprint(builder, inter, gamma)
            den = builder.ext_const(delta) + f
            builder.assert_zero_ext(inv * den - inter.mult)

    def signed_sum(get):
        acc = None
        for i, inter in enumerate(inters):
            term = get(i)
            if inter.sign < 0:
                term = ExtElem(builder.const(0) - term.c0, builder.const(0) - term.c1)
            acc = term if acc is None else acc + term
        return acc

    s_local = builder.aux_local_ext(n_i)
    s_next = builder.aux_next_ext(n_i)
    first_sum = signed_sum(builder.aux_local_ext)
    builder.assert_zero_ext(
        ExtElem(s_local.c0 - first_sum.c0, s_local.c1 - first_sum.c1), "first_row"
    )
    next_sum = signed_sum(builder.aux_next_ext)
    builder.assert_zero_ext(
        ExtElem(
            s_next.c0 - s_local.c0 - next_sum.c0,
            s_next.c1 - s_local.c1 - next_sum.c1,
        ),
        "transition",
    )
    total = builder.ext_const(total_pair)
    builder.assert_zero_ext(
        ExtElem(s_local.c0 - total.c0, s_local.c1 - total.c1), "last_row"
    )


def _build_logup_aux(air: Air, trace: torch.Tensor, pre_trace: Optional[torch.Tensor],
                     challenges, publics: Sequence[int] = ()):
    """Evaluate the interactions over the raw trace (columns (c, n) on the
    device) and build the aux columns [inv_0 .. inv_I-1, running_sum] as
    (2(I+1), n) base columns. Returns (aux, total pair)."""
    dev = trace.device
    n = trace.shape[1]
    builder = AirBuilder(
        BaseLdeBackend(n, dev),
        rows=offset_rows(trace, air.row_offsets),
        publics=list(publics) + [0] * 64,
        aux_rows=None,
        challenges=challenges,
        pre_rows=offset_rows(pre_trace, air.pre_offsets) if air.pre_width else None,
    )
    builder.constraints = Discard()  # only the interactions are needed
    air.eval(builder)
    inters = builder.interactions
    gamma, delta = challenges[0], challenges[1]
    cols = []
    signed = None
    # a chunk of interactions at a time: stacked fingerprints, one batched
    # inversion, the signed terms summed over the chunk
    for sl in column_chunks(len(inters), 2 * n):
        chunk = inters[sl]
        inv = ext.scalar_mul(ext.inv(_stacked_dens(chunk, gamma, delta, n, dev)),
                             _stacked_mults(chunk, n))  # (chunk, n, 2)
        cols.append(inv)
        neg = torch.tensor([inter.sign < 0 for inter in chunk], device=dev)[:, None, None]
        part = ext.sum(torch.where(neg, ext.neg(inv), inv), 0)
        signed = part if signed is None else ext.add(signed, part)
    run = ext.prefix_sum(signed)
    cols.append(run[None])
    aux = torch.cat(cols).permute(0, 2, 1).reshape(2 * (len(inters) + 1), n)
    total = ext.to_int_pairs(run[-1])[0]
    return aux.contiguous(), total


def _trace_tensor(trace: np.ndarray, device) -> torch.Tensor:
    """(n, width) uint64 numpy -> (width, n) int64 columns on the device."""
    return gl.from_int(np.ascontiguousarray(np.asarray(trace, dtype=np.uint64).T), device)


def check_bus_balance(specs: List[TableSpec], public_messages=None,
                      challenges=None, device=None) -> bool:
    """Witness-level check: with fixed bus challenges, the LogUp totals of
    all tables plus the public-message terms must sum to zero."""
    dev = devmod.resolve(device)
    challenges = challenges or [(12345, 67890), (54321, 9876)]
    total = (0, 0)
    for spec in specs:
        air = spec.air
        if not introspect_interactions(air):
            continue
        n = spec.trace.shape[0]
        pre = _trace_tensor(air.preprocessed_columns(n), dev) if air.pre_width else None
        _, t = _build_logup_aux(air, _trace_tensor(spec.trace, dev), pre,
                                challenges, spec.publics)
        total = F2.add(total, t)
    gamma, delta = challenges
    for channel, args, sign in public_messages or []:
        term = message_term(channel, args, gamma, delta)
        if sign < 0:
            term = F2.sub((0, 0), term)
        total = F2.add(total, term)
    return total == (0, 0)


# ---------------------------------------------------------------------------
# system prover
# ---------------------------------------------------------------------------

def _deep_combination(st, zeta, alpha2, log_n, rate_bits, dev) -> torch.Tensor:
    """sum_j alpha2^(T-1-j) * (v_j(x) - y_j) / (x - zeta*g^k(j)) over the
    LDE domain, terms in the verifier's order (main per offset, aux per
    offset, pre per offset, quotient). Exact field arithmetic, so the terms
    are summed grouped by their offset: one weighted column sum per group
    and one inverse vector per offset, instead of a (T, N) stack."""
    blowup = 1 << rate_bits
    g_n = gl.primitive_root_of_unity(log_n)
    groups = []  # (offset, columns (c, N), claimed values)
    for k in st["offsets"]:
        groups.append((k, st["main_lde"], st["main_openings"][k]))
    for k in st["aux_offsets"]:
        groups.append((k, st["aux_lde"], st["aux_openings"][k]))
    for k in st["pre_off"]:
        groups.append((k, st["pk"].pre_lde, st["pre_openings"][k]))
    groups.append((0, st["q_lde"], st["q_zeta_pairs"]))
    T = sum(len(y) for _, _, y in groups)
    weights, _ = _ext_weights(alpha2, T, dev)  # alpha2^(T-1-j)
    w_host = ext.to_int_pairs(weights)

    per_offset: Dict[int, torch.Tensor] = {}
    j = 0
    for k, cols, ys in groups:
        c = len(ys)
        w = weights[j:j + c]
        # sum_i w_i v_i - sum_i w_i y_i, a chunk of columns at a time
        wv = None
        for sl in column_chunks(c, cols.shape[1]):
            part = ext.sum(ext.scalar_mul(w[sl, None, :], cols[sl]), 0)
            wv = part if wv is None else ext.add(wv, part)
        wy = (0, 0)
        for wi, y in zip(w_host[j:j + c], ys):
            wy = F2.add(wy, F2.mul(wi, (int(y[0]), int(y[1]))))
        part = ext.sub(wv, ext.from_int_pair(wy, dev))
        per_offset[k] = part if k not in per_offset else ext.add(per_offset[k], part)
        j += c

    ks = sorted(per_offset)
    x = _lde_points(log_n, rate_bits, dev)
    zk = ext.from_int_pairs([F2.mul(zeta, (pow(g_n, k, gl.P), 0)) for k in ks], dev)
    invs = ext.inv(ext.sub(ext.from_base(x)[None], zk[:, None, :]))  # (K, N, 2)
    acc = None
    for i, k in enumerate(ks):
        term = ext.mul(per_offset[k], invs[i])
        acc = term if acc is None else ext.add(acc, term)
    return acc


def prove_system(specs: List[TableSpec], cfg: StarkConfig = StarkConfig(),
                 device=None, timer: Optional[PhaseTimer] = None) -> SystemProof:
    """Prove every table under one transcript. ``timer`` (optional) collects
    the seconds of each phase."""
    dev = devmod.resolve(device)
    timer = timer or PhaseTimer()
    timer.mark("preamble", dev)
    transcript = Transcript()
    states = []
    any_bus = False
    blowup = 1 << cfg.rate_bits

    for spec in specs:
        air, trace = spec.air, spec.trace
        n, width = trace.shape
        if width != air.width:
            raise ValueError(f"{spec.name}: trace width {width} != air width {air.width}")
        log_n = n.bit_length() - 1
        if 1 << log_n != n:
            raise ValueError(f"{spec.name}: {n} rows is not a power of two")
        N = n << cfg.rate_bits
        if air.max_constraint_degree * (n - 1) + 1 > N - 1:
            raise ValueError(f"{spec.name}: constraint degree too high for rate_bits")
        pk = spec.pk
        if air.pre_width and pk is None:
            pk, _ = build(air, n, cfg, dev)
        _observe_preamble(transcript, air, n, spec.publics)
        if air.pre_width:
            transcript.observe_cap(pk.pre_tree.cap_ints())
        n_inter = introspect_interactions(air)
        any_bus = any_bus or n_inter > 0
        states.append(dict(spec=spec, air=air, n=n, log_n=log_n, N=N, pk=pk,
                           n_inter=n_inter))

    # 2. main commits
    timer.mark("main_commits", dev)
    for st in states:
        st["main_trace"] = _trace_tensor(st["spec"].trace, dev)
        st["main_coeffs"], st["main_lde"], st["main_tree"] = _commit_matrix(
            st["main_trace"], cfg.rate_bits, cfg.cap_height)
        transcript.observe_cap(st["main_tree"].cap_ints())

    # 3. bus challenges
    challenges = []
    if any_bus:
        challenges = [transcript.get_extension_challenge() for _ in range(2)]

    # 4. LogUp aux commits
    timer.mark("aux_commits", dev)
    for st in states:
        air = st["air"]
        st["challenges"] = challenges
        st["bus_total"] = None
        st["aux_width"] = 0
        if st["n_inter"]:
            pre = st["pk"].pre_trace if air.pre_width else None
            # named ranges let a profile attribute device kernels to a table
            with torch.profiler.record_function(f"logup_aux:{st['spec'].name}"):
                aux, st["bus_total"] = _build_logup_aux(air, st["main_trace"], pre,
                                                        challenges, st["spec"].publics)
            del st["main_trace"]
            st["aux_width"] = aux.shape[0]
            st["aux_coeffs"], st["aux_lde"], st["aux_tree"] = _commit_matrix(
                aux, cfg.rate_bits, cfg.cap_height)
            transcript.observe_cap(st["aux_tree"].cap_ints())
            transcript.observe_element(st["bus_total"][0])
            transcript.observe_element(st["bus_total"][1])

    # 5. quotients
    timer.mark("quotients", dev)
    alpha = transcript.get_extension_challenge()
    g_inv = pow(gl.GENERATOR, gl.P - 2, gl.P)
    for st in states:
        air, n, N, log_n = st["air"], st["n"], st["N"], st["log_n"]
        builder = AirBuilder(
            BaseLdeBackend(N, dev),
            rows=_offset_rows(st["main_lde"], tuple(air.row_offsets), cfg.rate_bits),
            publics=list(st["spec"].publics),
            aux_rows=(_offset_rows(st["aux_lde"], (0, 1), cfg.rate_bits)
                      if st["aux_width"] else None),
            challenges=st["challenges"],
            pre_rows=(_offset_rows(st["pk"].pre_lde, tuple(air.pre_offsets),
                                   cfg.rate_bits) if air.pre_width else None),
        )
        sels = _selector_tables(log_n, cfg.rate_bits, dev)
        builder.constraints = sink = HornerLde(alpha, sels, N, dev)
        with torch.profiler.record_function(f"constraint_sweep:{st['spec'].name}"):
            air.eval(builder)
            if st["n_inter"]:
                _emit_logup_constraints(builder, st["bus_total"])
        combined = sink.acc
        del builder, sink
        quotient = ext.scalar_mul(combined, sels[0])  # (N, 2)
        q_coeffs = nttmod.coset_shift(
            nttmod.ntt(quotient.t(), inverse=True, device=dev), g_inv)  # (2, N)
        # blowup chunks of degree < n, as 2*blowup base columns
        chunks = q_coeffs.reshape(2, blowup, n).permute(1, 0, 2).reshape(2 * blowup, n)
        q_cols = nttmod.ntt(chunks, device=dev)
        st["q_coeffs"], st["q_lde"], st["q_tree"] = _commit_matrix(
            q_cols, cfg.rate_bits, cfg.cap_height)
        transcript.observe_cap(st["q_tree"].cap_ints())

    # 6. openings
    timer.mark("openings", dev)
    zeta = transcript.get_extension_challenge()
    for st in states:
        air, log_n = st["air"], st["log_n"]
        g_n = gl.primitive_root_of_unity(log_n)

        def zs_for(ks):
            return [F2.mul(zeta, (pow(g_n, k, gl.P), 0)) for k in ks]

        offsets = tuple(air.row_offsets)
        st["offsets"] = offsets
        st["main_openings"] = dict(
            zip(offsets, _eval_cols_at_points(st["main_coeffs"], zs_for(offsets))))
        aux_offsets = (0, 1) if st["aux_width"] else ()
        st["aux_offsets"] = aux_offsets
        st["aux_openings"] = {}
        if st["aux_width"]:
            st["aux_openings"] = dict(
                zip(aux_offsets, _eval_cols_at_points(st["aux_coeffs"], zs_for(aux_offsets))))
        pre_off = tuple(air.pre_offsets) if air.pre_width else ()
        st["pre_off"] = pre_off
        st["pre_openings"] = {}
        if air.pre_width:
            st["pre_openings"] = dict(
                zip(pre_off, _eval_cols_at_points(st["pk"].pre_coeffs, zs_for(pre_off))))
        st["q_zeta_pairs"] = _eval_cols_at_points(st["q_coeffs"], [zeta])[0]
        for k in offsets:
            for v in st["main_openings"][k]:
                transcript.observe_extension(v)
        for k in aux_offsets:
            for v in st["aux_openings"][k]:
                transcript.observe_extension(v)
        for k in pre_off:
            for v in st["pre_openings"][k]:
                transcript.observe_extension(v)
        for v in st["q_zeta_pairs"]:
            transcript.observe_extension(v)

    # 7. DEEP + FRI per table
    timer.mark("deep_fri", dev)
    alpha2 = transcript.get_extension_challenge()
    table_proofs = []
    for st in states:
        air = st["air"]
        acc = _deep_combination(st, zeta, alpha2, st["log_n"], cfg.rate_bits, dev)
        fri_proof, indices = fri.fri_prove(acc, transcript, cfg.fri())

        oracles = [("main", st["main_lde"], st["main_tree"]),
                   ("quotient", st["q_lde"], st["q_tree"])]
        if st["aux_width"]:
            oracles.append(("aux", st["aux_lde"], st["aux_tree"]))
        if air.pre_width:
            oracles.append(("pre", st["pk"].pre_lde, st["pk"].pre_tree))
        opened = {name: _open_rows(lde, indices) for name, lde, _ in oracles}
        query_openings = []
        for qi, q in enumerate(indices):
            query_openings.append({
                name: OpenedRow(values=opened[name][qi], siblings=tree.open(q))
                for name, _, tree in oracles
            })

        table_proofs.append(StarkProof(
            n_rows=st["n"],
            main_cap=st["main_tree"].cap_ints(),
            aux_cap=st["aux_tree"].cap_ints() if st["aux_width"] else None,
            quotient_cap=st["q_tree"].cap_ints(),
            main_openings=st["main_openings"],
            aux_openings=st["aux_openings"],
            pre_openings=st["pre_openings"],
            quotient_zeta=st["q_zeta_pairs"],
            fri_proof=fri_proof,
            query_openings=query_openings,
        ))

    timer.end()
    return SystemProof(table_proofs=table_proofs,
                       bus_totals=[st["bus_total"] for st in states])


# ---------------------------------------------------------------------------
# system verifier
# ---------------------------------------------------------------------------

def verify_system(
    airs: List[Air],
    publics_list: List[Sequence[int]],
    proof: SystemProof,
    cfg: StarkConfig = StarkConfig(),
    vks: Optional[List[Optional[VerifierKey]]] = None,
    public_messages: Optional[List[Tuple[int, Sequence[int], int]]] = None,
    device=None,
) -> bool:
    """public_messages: (channel, args, sign) tuples the verifier contributes
    as a virtual bus participant. Balance: sum(table totals) + sum(public
    terms) == 0. ``device`` is where a missing verifier key's preprocessed
    commitment is built; everything else runs on the host."""
    dev = devmod.resolve(device)
    n_tables = len(airs)
    if len(proof.table_proofs) != n_tables or len(proof.bus_totals) != n_tables:
        return False
    transcript = Transcript()
    metas = []
    any_bus = False
    for i, air in enumerate(airs):
        p = proof.table_proofs[i]
        n = p.n_rows
        log_n = n.bit_length() - 1
        if n < 1 or 1 << log_n != n:
            return False
        vk = vks[i] if vks else None
        if air.pre_width and vk is None:
            _, vk = build(air, n, cfg, dev)
        _observe_preamble(transcript, air, n, publics_list[i])
        if air.pre_width:
            transcript.observe_cap(vk.pre_cap)
        n_inter = introspect_interactions(air)
        any_bus = any_bus or n_inter > 0
        metas.append(dict(air=air, n=n, log_n=log_n, vk=vk, n_inter=n_inter))

    for i in range(n_tables):
        transcript.observe_cap(proof.table_proofs[i].main_cap)

    challenges = []
    if any_bus:
        challenges = [transcript.get_extension_challenge() for _ in range(2)]
        # the bus balance needs only the challenges: checked first, so a
        # wrong public message is rejected before the openings are read
        gamma, delta = challenges
        total = (0, 0)
        for t in proof.bus_totals:
            if t is not None:
                total = F2.add(total, (t[0] % gl.P, t[1] % gl.P))
        for channel, args, sign in public_messages or []:
            term = message_term(channel, args, gamma, delta)
            if sign < 0:
                term = F2.sub((0, 0), term)
            total = F2.add(total, term)
        if total != (0, 0):
            return False

    for i, m in enumerate(metas):
        p = proof.table_proofs[i]
        m["challenges"] = challenges
        m["aux_width"] = 0
        if m["n_inter"]:
            m["aux_width"] = 2 * (m["n_inter"] + 1)
            if p.aux_cap is None or proof.bus_totals[i] is None:
                return False
            transcript.observe_cap(p.aux_cap)
            transcript.observe_element(proof.bus_totals[i][0] % gl.P)
            transcript.observe_element(proof.bus_totals[i][1] % gl.P)

    alpha = transcript.get_extension_challenge()
    for i in range(n_tables):
        transcript.observe_cap(proof.table_proofs[i].quotient_cap)
    zeta = transcript.get_extension_challenge()

    blowup = 1 << cfg.rate_bits
    for i, m in enumerate(metas):
        air = m["air"]
        p = proof.table_proofs[i]
        offsets = tuple(air.row_offsets)
        aux_offsets = (0, 1) if m["aux_width"] else ()
        pre_off = tuple(air.pre_offsets) if air.pre_width else ()
        m["offsets"], m["aux_offsets"], m["pre_off"] = offsets, aux_offsets, pre_off
        for k in offsets:
            if k not in p.main_openings or len(p.main_openings[k]) != air.width:
                return False
        for k in aux_offsets:
            if k not in p.aux_openings or len(p.aux_openings[k]) != m["aux_width"]:
                return False
        for k in pre_off:
            if k not in p.pre_openings or len(p.pre_openings[k]) != air.pre_width:
                return False
        if len(p.quotient_zeta) != 2 * blowup:
            return False
        for k in offsets:
            for v in p.main_openings[k]:
                transcript.observe_extension(v)
        for k in aux_offsets:
            for v in p.aux_openings[k]:
                transcript.observe_extension(v)
        for k in pre_off:
            for v in p.pre_openings[k]:
                transcript.observe_extension(v)
        for v in p.quotient_zeta:
            transcript.observe_extension(v)

    alpha2 = transcript.get_extension_challenge()

    # constraint identity + FRI per table
    for i, m in enumerate(metas):
        air = m["air"]
        p = proof.table_proofs[i]
        n, log_n = m["n"], m["log_n"]
        g_n = gl.primitive_root_of_unity(log_n)
        offsets, aux_offsets, pre_off = m["offsets"], m["aux_offsets"], m["pre_off"]

        builder = AirBuilder(
            ExtPointBackend(),
            rows={k: [tuple(v) for v in p.main_openings[k]] for k in offsets},
            publics=list(publics_list[i]),
            aux_rows=({k: [tuple(v) for v in p.aux_openings[k]] for k in aux_offsets}
                      if m["aux_width"] else None),
            challenges=m["challenges"],
            pre_rows=({k: [tuple(v) for v in p.pre_openings[k]] for k in pre_off}
                      if air.pre_width else None),
        )
        air.eval(builder)
        if m["n_inter"]:
            _emit_logup_constraints(builder, proof.bus_totals[i])
        sels_pt = _selectors_at_point(zeta, log_n)
        combined = _combine_constraints_point(builder, alpha, sels_pt)
        zh = sels_pt[0]
        zn = _ext_pow(zeta, n)
        q_at_zeta = (0, 0)
        zkn = (1, 0)
        for k in range(blowup):
            c0 = tuple(p.quotient_zeta[2 * k])
            c1 = tuple(p.quotient_zeta[2 * k + 1])
            chunk = F2.add(c0, F2.mul(c1, (0, 1)))
            q_at_zeta = F2.add(q_at_zeta, F2.mul(zkn, chunk))
            zkn = F2.mul(zkn, zn)
        if combined != F2.mul(zh, q_at_zeta):
            return False

        zeta_by_offset = {
            k: F2.mul(zeta, (pow(g_n, k, gl.P), 0))
            for k in sorted(set(offsets) | set(aux_offsets) | set(pre_off))
        }

        def eval_at_index(round_i: int, q: int, p=p, air=air, m=m, log_n=log_n,
                          offsets=offsets, aux_offsets=aux_offsets,
                          pre_off=pre_off, zeta_by_offset=zeta_by_offset):
            entry = p.query_openings[round_i]
            main = entry["main"]
            quot = entry["quotient"]
            if len(main.values) != air.width or len(quot.values) != 2 * blowup:
                return None
            if not merkle_cap.verify_opening(main.values, q, main.siblings, p.main_cap):
                return None
            if not merkle_cap.verify_opening(quot.values, q, quot.siblings, p.quotient_cap):
                return None
            aux_vals = []
            if m["aux_width"]:
                aux = entry["aux"]
                if len(aux.values) != m["aux_width"]:
                    return None
                if not merkle_cap.verify_opening(aux.values, q, aux.siblings, p.aux_cap):
                    return None
                aux_vals = aux.values
            pre_vals = []
            if air.pre_width:
                pre = entry["pre"]
                if len(pre.values) != air.pre_width:
                    return None
                if not merkle_cap.verify_opening(pre.values, q, pre.siblings, m["vk"].pre_cap):
                    return None
                pre_vals = pre.values
            x = (_lde_point(log_n, cfg.rate_bits, q), 0)
            inv_at = {k: F2.inv(F2.sub(x, zk)) for k, zk in zeta_by_offset.items()}
            terms = []
            for k in offsets:
                for j in range(air.width):
                    terms.append((main.values[j], p.main_openings[k][j], inv_at[k]))
            for k in aux_offsets:
                for j in range(m["aux_width"]):
                    terms.append((aux_vals[j], p.aux_openings[k][j], inv_at[k]))
            for k in pre_off:
                for j in range(air.pre_width):
                    terms.append((pre_vals[j], p.pre_openings[k][j], inv_at[k]))
            for j in range(2 * blowup):
                terms.append((quot.values[j], p.quotient_zeta[j], inv_at[0]))
            acc = None
            for v, y, inv in terms:
                t = F2.mul(F2.sub((int(v), 0), tuple(y)), inv)
                acc = t if acc is None else F2.add(F2.mul(acc, alpha2), t)
            return acc

        log_N = log_n + cfg.rate_bits
        if not fri.fri_verify(p.fri_proof, log_N, transcript, cfg.fri(), eval_at_index):
            return False

    return True
