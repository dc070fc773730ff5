"""Uniform-AIR STARK building blocks over Goldilocks with FRI openings.

Counterpart of ``blobstreamx_tpu/proof/stark.py``: the config and proof
dataclasses, ``build`` with its per-AIR memo, the trace commitment, the
selector and opening helpers on the prover's device, and the host-side
selector helpers of the verifier. ``proof/system.py`` drives them.

Trace matrices are (columns, rows) int64 tensors. An LDE stays on the
device; the leaf hash reads its rows in place (the transpose view) and
query openings gather only the queried rows.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as devmod
from ..field import goldilocks as gl
from ..field import ntt as nttmod
from ..field import extension as ext
from . import merkle_cap
from . import fri
from .air import Air, FIRST_ROW, LAST_ROW, TRANSITION
from .transcript import Transcript

F2 = ext.GFp2


@dataclass
class StarkConfig:
    rate_bits: int = 3
    cap_height: int = 2
    num_query_rounds: int = 28
    pow_bits: int = 8
    final_poly_bits: int = 3

    def fri(self) -> fri.FriConfig:
        return fri.FriConfig(
            rate_bits=self.rate_bits,
            cap_height=self.cap_height,
            num_query_rounds=self.num_query_rounds,
            pow_bits=self.pow_bits,
            final_poly_bits=self.final_poly_bits,
        )


@dataclass
class OpenedRow:
    values: list  # python ints (base field), row of the oracle leaf
    siblings: list  # digests of 4 python ints, leaf level upwards


@dataclass
class StarkProof:
    n_rows: int
    main_cap: list
    aux_cap: Optional[list]
    quotient_cap: list
    # openings[k] = values of all main cols at zeta * g^k, for k in offsets
    main_openings: Dict[int, list]
    aux_openings: Dict[int, list]
    pre_openings: Dict[int, list]
    quotient_zeta: list  # 2*n_chunks base-col evals at zeta
    fri_proof: fri.FriProof
    query_openings: list  # per FRI query round: {"main","quotient","aux","pre"}


@dataclass
class ProverKey:
    """Built once per (air, n): the preprocessed oracle in prover form."""

    pre_trace: Optional[torch.Tensor]  # (pre_width, n) subgroup values
    pre_lde: Optional[torch.Tensor]  # (pre_width, N)
    pre_coeffs: Optional[torch.Tensor]
    pre_tree: Optional[merkle_cap.MerkleTree]


@dataclass
class VerifierKey:
    pre_cap: Optional[list]


def build(air: Air, n: int, cfg: "StarkConfig", device=None):
    """Commit the preprocessed columns on ``device`` (None: the card).
    Returns (ProverKey, VerifierKey); both empty for AIRs without
    preprocessed columns.

    Memoized per air instance: the columns are a pure function of
    (air, n), so repeated calls for one table (prove, then verify) reuse
    the commitment."""
    device = devmod.resolve(device)
    if not air.pre_width:
        return ProverKey(None, None, None, None), VerifierKey(None)
    key = (n, cfg.rate_bits, cfg.cap_height, str(device))
    cache = air.__dict__.setdefault("_torch_build_cache", {})
    if key in cache:
        return cache[key]
    pre = air.preprocessed_columns(n)
    if pre.shape != (n, air.pre_width):
        raise ValueError(f"preprocessed columns have shape {pre.shape}")
    cols = gl.from_int(np.ascontiguousarray(pre.T), device)
    coeffs, lde, tree = _commit_matrix(cols, cfg.rate_bits, cfg.cap_height)
    out = ProverKey(cols, lde, coeffs, tree), VerifierKey(tree.cap_ints())
    cache[key] = out
    return out


# ---------------------------------------------------------------------------
# domain tables on the device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lde_points(log_n: int, rate_bits: int, device) -> torch.Tensor:
    """(N,) tensor of x_i = g * w_N^i."""
    N = 1 << (log_n + rate_bits)
    w = gl.primitive_root_of_unity(log_n + rate_bits)
    return gl.mul(gl.powers(w, N, device), gl.scalar(gl.GENERATOR, device))


def _lde_point(log_n: int, rate_bits: int, i: int) -> int:
    """x_i = g * w_N^i as a python int (verifier side)."""
    w = gl.primitive_root_of_unity(log_n + rate_bits)
    return gl.GENERATOR * pow(w, i, gl.P) % gl.P


@functools.lru_cache(maxsize=None)
def _selector_tables(log_n: int, rate_bits: int, device):
    """(zh_inv, sel_first, sel_last, sel_trans), each (N,) on the device."""
    n = 1 << log_n
    blowup = 1 << rate_bits
    N = n << rate_bits
    x = _lde_points(log_n, rate_bits, device)
    g_last = pow(gl.primitive_root_of_unity(log_n), n - 1, gl.P)
    n_inv = pow(n, gl.P - 2, gl.P)
    # x_i^n - 1 takes only 2^rate_bits values (x_i^n = g^n w_blowup^i)
    w_b = gl.primitive_root_of_unity(rate_bits)
    g_n = pow(gl.GENERATOR, n, gl.P)
    zh_small = [(g_n * pow(w_b, i, gl.P) - 1) % gl.P for i in range(blowup)]
    reps = N // blowup
    zh = gl.from_int(zh_small, device).repeat(reps)
    zh_inv = gl.from_int([pow(z, gl.P - 2, gl.P) for z in zh_small], device).repeat(reps)
    sel_trans = gl.sub(x, gl.scalar(g_last, device))
    invs = gl.inv(torch.stack([gl.sub(x, gl.scalar(1, device)), sel_trans]))
    zh_n = gl.mul(zh, gl.scalar(n_inv, device))
    sel_first = gl.mul(zh_n, invs[0])
    sel_last = gl.mul(gl.mul(zh_n, gl.scalar(g_last, device)), invs[1])
    return zh_inv, sel_first, sel_last, sel_trans


def _ext_pow(z, e: int):
    acc = (1, 0)
    base = z
    while e:
        if e & 1:
            acc = F2.mul(acc, base)
        base = F2.mul(base, base)
        e >>= 1
    return acc


def _selectors_at_point(z, log_n: int):
    """(zh, sel_first, sel_last, sel_trans) at an extension point."""
    n = 1 << log_n
    g_n = gl.primitive_root_of_unity(log_n)
    g_last = pow(g_n, n - 1, gl.P)
    n_inv = pow(n, gl.P - 2, gl.P)
    zh = F2.sub(_ext_pow(z, n), (1, 0))
    sel_first = F2.mul(F2.mul(zh, (n_inv, 0)), F2.inv(F2.sub(z, (1, 0))))
    sel_last = F2.mul(
        F2.mul(F2.mul(zh, (n_inv, 0)), (g_last, 0)), F2.inv(F2.sub(z, (g_last, 0)))
    )
    sel_trans = F2.sub(z, (g_last, 0))
    return zh, sel_first, sel_last, sel_trans


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

# Elements a column chunk may hold: a field multiply keeps about 14
# temporaries of its operands' size, so a chunk of 2^26 elements bounds a
# step's transient memory to a few GB however wide or tall the table is.
CHUNK_ELEMS = 1 << 26


def column_chunks(c: int, n: int):
    """Slices of at most CHUNK_ELEMS // n (at least one) of c columns."""
    step = max(1, CHUNK_ELEMS // n)
    return [slice(s, min(c, s + step)) for s in range(0, c, step)]


def _commit_matrix(cols: torch.Tensor, rate_bits: int, cap_height: int):
    """cols: (c, n) subgroup evals -> (coeffs (c, n), lde (c, N), tree),
    a chunk of columns at a time. The tree's leaves are the LDE rows, read
    in place as lde.t()."""
    dev = cols.device
    c, n = cols.shape
    coeffs = torch.empty_like(cols)
    lde = torch.empty((c, n << rate_bits), dtype=torch.int64, device=dev)
    for sl in column_chunks(c, n << rate_bits):
        coeffs[sl] = nttmod.ntt(cols[sl], inverse=True, device=dev)
        # the coset shift scales coefficient i by g^i; the padding is zero
        shifted = nttmod.coset_shift(coeffs[sl], gl.GENERATOR)
        lde[sl] = nttmod.ntt(torch.nn.functional.pad(shifted, (0, lde.shape[1] - n)),
                             device=dev)
        del shifted
    tree = merkle_cap.build_tree(lde.t(), cap_height)
    return coeffs, lde, tree


def _eval_cols_at_points(coeffs: torch.Tensor, z_pairs) -> List[List[Tuple[int, int]]]:
    """Evaluate base-coeff columns (c, n) at extension points, a chunk of
    columns at a time. Returns [per-point [per-column (c0, c1)]]."""
    out = []
    chunks = column_chunks(*coeffs.shape)
    for z in z_pairs:
        vals = torch.cat([nttmod.eval_poly_ext(coeffs[sl], z) for sl in chunks])  # (c, 2)
        out.append(ext.to_int_pairs(vals))
    return out


def _ext_weights(alpha, k: int, device):
    """(k, 2) tensor of alpha^(k-1-j) for j < k, and alpha^k."""
    w = []
    cur = (1, 0)
    for _ in range(k):
        w.append(cur)
        cur = F2.mul(cur, alpha)
    return ext.from_int_pairs(w[::-1], device), cur


class HornerLde:
    """Constraint sink for the sweep over the LDE: takes the place of
    ``AirBuilder.constraints`` and folds the constraints, in the order the
    AIR registers them, into the Horner combination acc = acc * alpha + c.
    Single constraints are held back and folded a group at a time, as
    acc * alpha^K + sum_k alpha^(K-1-k) c_k, the same value in fewer
    launches (a stacked constraint of K lanes is such a group itself). A
    group holds at most CHUNK_ELEMS / 4 elements, so no more constraint
    columns are alive than that."""

    def __init__(self, alpha, sels, n_points, device):
        self.alpha, self.sels, self.n_points, self.device = alpha, sels, n_points, device
        self.group = max(1, (CHUNK_ELEMS // 4) // n_points)
        self._pending = []
        self._acc = None

    def append(self, con):
        _, sel_first, sel_last, sel_trans = self.sels
        c = con.expr
        if con.scope == FIRST_ROW:
            c = gl.mul(c, sel_first)
        elif con.scope == LAST_ROW:
            c = gl.mul(c, sel_last)
        elif con.scope == TRANSITION:
            c = gl.mul(c, sel_trans)
        if c.dim() == 2:
            self._flush()
            for start in range(0, c.shape[0], self.group):
                self._fold(c[start:start + self.group])
        else:
            self._pending.append(c.expand(self.n_points))
            if len(self._pending) == self.group:
                self._flush()

    def _flush(self):
        if self._pending:
            group, self._pending = torch.stack(self._pending), []
            self._fold(group)

    def _fold(self, c):
        """acc <- acc * alpha^K + sum_k alpha^(K-1-k) c_k for (K, N) c."""
        w, alpha_k = _ext_weights(self.alpha, c.shape[0], self.device)
        group = ext.sum(ext.scalar_mul(w[:, None, :], c), 0)
        self._acc = group if self._acc is None else ext.add(
            ext.mul(self._acc, ext.from_int_pair(alpha_k, self.device)), group)

    @property
    def acc(self):
        """The combination of every constraint appended so far, (N, 2)."""
        self._flush()
        return self._acc


class Discard:
    """Constraint sink that keeps nothing (a sweep that only needs the
    AIR's bus interactions)."""

    def append(self, con):
        pass


def _combine_constraints_point(builder, alpha, sels_pt):
    _, sel_first, sel_last, sel_trans = sels_pt
    acc = None
    for con in builder.constraints:
        c = con.expr  # GFp2 pair, or list of pairs (stacked group)
        entries = c if isinstance(c, list) else [c]
        sel = None
        if con.scope == FIRST_ROW:
            sel = sel_first
        elif con.scope == LAST_ROW:
            sel = sel_last
        elif con.scope == TRANSITION:
            sel = sel_trans
        for cc in entries:
            if sel is not None:
                cc = F2.mul(cc, sel)
            acc = cc if acc is None else F2.add(F2.mul(acc, alpha), cc)
    return acc


def _observe_preamble(transcript: Transcript, air: Air, n: int, publics):
    transcript.observe_element(air.width % gl.P)
    transcript.observe_element(n % gl.P)
    transcript.observe_elements([int(p) % gl.P for p in publics])


class RolledColumns:
    """Columns of a (c, n) matrix read at row i + shift: column j is rolled
    when it is read, so no shifted copy of the whole matrix is made."""

    def __init__(self, mat: torch.Tensor, shift: int):
        self.mat, self.shift = mat, shift

    def __getitem__(self, j: int) -> torch.Tensor:
        return torch.roll(self.mat[j], -self.shift)

    def __len__(self):
        return self.mat.shape[0]


def offset_rows(mat: torch.Tensor, offsets, stride: int = 1):
    """(c, n) columns -> {offset k: per-column (n,) values at rows i + k*stride}."""
    return {k: RolledColumns(mat, k * stride) if k else list(mat.unbind(0))
            for k in offsets}


def _offset_rows(lde: torch.Tensor, offsets, rate_bits: int):
    """LDE (c, N) -> {offset: per-column (N,) values of rows i + k*blowup}."""
    return offset_rows(lde, offsets, 1 << rate_bits)


def _open_rows(lde: torch.Tensor, indices) -> List[List[int]]:
    """Gather the queried LDE rows to the host: [per index [per column]]."""
    idx = torch.tensor(list(indices), dtype=torch.int64, device=lde.device)
    rows = gl.to_int(lde[:, idx].t())
    return [[int(v) for v in r] for r in rows]
