"""AIR (algebraic intermediate representation) interface.

Counterpart of ``blobstreamx_tpu/proof/air.py``. An ``Air`` registers its
constraints through an ``AirBuilder``, and the same ``eval`` runs on two
backends: ``BaseLdeBackend`` (int64 tensors over every LDE row, on the
prover's device) and ``ExtPointBackend`` (GF(p^2) python-int pairs at the
out-of-domain point, on prover and verifier).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import extension as ext

# constraint scopes
EVERYWHERE = "everywhere"
FIRST_ROW = "first_row"
LAST_ROW = "last_row"
TRANSITION = "transition"


class Elem:
    """Field-element handle with operator overloading, backend-dispatched."""

    __slots__ = ("v", "b")

    def __init__(self, v, b):
        self.v = v
        self.b = b

    def _lift(self, other):
        if isinstance(other, Elem):
            return other
        return Elem(self.b.const(int(other)), self.b)

    def __add__(self, o):
        o = self._lift(o)
        return Elem(self.b.add(self.v, o.v), self.b)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._lift(o)
        return Elem(self.b.sub(self.v, o.v), self.b)

    def __rsub__(self, o):
        return self._lift(o).__sub__(self)

    def __mul__(self, o):
        if not isinstance(o, Elem) and hasattr(self.b, "mul_const"):
            return Elem(self.b.mul_const(self.v, int(o)), self.b)
        o = self._lift(o)
        return Elem(self.b.mul(self.v, o.v), self.b)

    __rmul__ = __mul__

    def __neg__(self):
        return Elem(self.b.sub(self.b.const(0), self.v), self.b)


class ExtElem:
    """GF(p^2) element as two base-field Elems (c0 + c1*t, t^2 = W)."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Elem, c1: Elem):
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def from_base(e: Elem) -> "ExtElem":
        zero = Elem(e.b.const(0), e.b)
        return ExtElem(e, zero)

    def __add__(self, o: "ExtElem") -> "ExtElem":
        if isinstance(o, Elem):
            o = ExtElem.from_base(o)
        return ExtElem(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "ExtElem") -> "ExtElem":
        if isinstance(o, Elem):
            o = ExtElem.from_base(o)
        return ExtElem(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o) -> "ExtElem":
        if isinstance(o, Elem):
            return ExtElem(self.c0 * o, self.c1 * o)
        return ExtElem(
            self.c0 * o.c0 + ext.W * (self.c1 * o.c1),
            self.c0 * o.c1 + self.c1 * o.c0,
        )


class BaseLdeBackend:
    """Values are (N,) int64 tensors over the LDE domain; "stacked" handles
    carry a leading lane axis (K, N) so whole words of bit columns run
    through one op. Constants are 0-dim tensors expanded to (N,)."""

    def __init__(self, n_points: int, device):
        self.n = n_points
        self.device = device

    def const(self, c: int):
        return gl.scalar(c, self.device).expand(self.n)

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def mul_const(self, a, c: int):
        """a * c for a python-int c: the value of mul(a, const(c)), with
        fewer launches for c in {0, 1, p - 1} and c < 2^30."""
        c %= gl.P
        if c == 0:
            return torch.zeros_like(a)
        if c == 1:
            return a
        if c == gl.P - 1:
            return gl.neg(a)
        if c < gl.SMALL_MUL_BOUND:
            return gl.mul_small(a, c)
        return gl.mul(a, self.const(c))

    def stack(self, handles):
        return torch.stack(list(torch.broadcast_tensors(*handles)), dim=0)

    def gather(self, h, indices):
        return h[torch.tensor(list(indices), dtype=torch.int64, device=h.device)]

    def lanes(self, h, offset: int, total: int):
        """Stacked h placed at lanes offset.. of ``total`` lanes, zero elsewhere."""
        return torch.nn.functional.pad(h, (0, 0, offset, total - offset - h.shape[0]))

    def const_lanes(self, values):
        """A stacked handle of constants, one a lane: (K, 1), broadcasting
        against (N,) and (K, N) values."""
        return gl.from_int([int(v) % gl.P for v in values], self.device)[:, None]

    def fold(self, h, weights):
        """Stacked (K, N) -> (N,): sum_k weights[k] * h[k]."""
        w = gl.from_int([int(x) % gl.P for x in weights], h.device)
        return gl.sum(gl.mul(h, w[:, None]), 0)


def _point_bc(op):
    def f(a, b):
        if isinstance(a, list) or isinstance(b, list):
            if not isinstance(a, list):
                a = [a] * len(b)
            if not isinstance(b, list):
                b = [b] * len(a)
            return [op(x, y) for x, y in zip(a, b)]
        return op(a, b)

    return f


class ExtPointBackend:
    """Values are GF(p^2) python-int pairs (evaluation at zeta); stacked
    handles are python lists of pairs."""

    def const(self, c: int):
        return (c % gl.P, 0)

    add = staticmethod(_point_bc(ext.GFp2.add))
    sub = staticmethod(_point_bc(ext.GFp2.sub))
    mul = staticmethod(_point_bc(ext.GFp2.mul))

    def stack(self, handles):
        return list(handles)

    def gather(self, h, indices):
        return [h[i] for i in indices]

    def lanes(self, h, offset: int, total: int):
        return [(0, 0)] * offset + list(h) + [(0, 0)] * (total - offset - len(h))

    def const_lanes(self, values):
        return [(int(v) % gl.P, 0) for v in values]

    def fold(self, h, weights):
        acc = (0, 0)
        for v, w in zip(h, weights):
            acc = ext.GFp2.add(acc, ext.GFp2.mul(v, (int(w) % gl.P, 0)))
        return acc


@dataclass
class Constraint:
    expr: Any  # backend value handle
    scope: str


@dataclass
class Interaction:
    """A LogUp bus message: sign * mult / (delta + fingerprint(channel, args))."""

    channel: int
    args: list  # list of Elem
    mult: Any  # Elem
    sign: int  # +1 send, -1 receive


class AirBuilder:
    """Passed to Air.eval; exposes row values and records constraints.

    rows: {offset: [per-column backend values]} for the AIR's row window.
    challenges: list of (c0, c1) extension pairs (python ints).
    """

    def __init__(
        self,
        backend,
        rows: Dict[int, list],
        publics: Sequence[int],
        aux_rows: Optional[Dict[int, list]] = None,
        challenges: Optional[Sequence] = None,
        pre_rows: Optional[Dict[int, list]] = None,
    ):
        self.b = backend
        self._rows = rows
        self._aux_rows = aux_rows
        self._challenges = list(challenges or [])
        self._public = list(publics)
        self._pre_rows = pre_rows
        self.constraints: List[Constraint] = []
        self.interactions: List[Interaction] = []

    # row access ----------------------------------------------------------
    def row(self, offset: int, col: int) -> Elem:
        return Elem(self._rows[offset][col], self.b)

    def local(self, col: int) -> Elem:
        return self.row(0, col)

    def next(self, col: int) -> Elem:
        return self.row(1, col)

    def aux_row(self, offset: int, col: int) -> Elem:
        return Elem(self._aux_rows[offset][col], self.b)

    def aux_local(self, col: int) -> Elem:
        return self.aux_row(0, col)

    def aux_next(self, col: int) -> Elem:
        return self.aux_row(1, col)

    def aux_local_ext(self, i: int) -> ExtElem:
        """Aux columns (2i, 2i+1) as one extension element."""
        return ExtElem(self.aux_local(2 * i), self.aux_local(2 * i + 1))

    def aux_next_ext(self, i: int) -> ExtElem:
        return ExtElem(self.aux_next(2 * i), self.aux_next(2 * i + 1))

    def pre(self, offset: int, col: int) -> Elem:
        """Preprocessed (build-time constant) column at a row offset."""
        return Elem(self._pre_rows[offset][col], self.b)

    def pre_local(self, col: int) -> Elem:
        return self.pre(0, col)

    # stacked (vectorized-lane) access ------------------------------------
    def row_stack(self, offset: int, col_base: int, count: int) -> Elem:
        """Columns [col_base, col_base+count) at one offset as one handle."""
        return Elem(
            self.b.stack([self._rows[offset][col_base + i] for i in range(count)]),
            self.b,
        )

    def stack(self, elems) -> Elem:
        """Single values as one stacked handle, a lane each."""
        return Elem(self.b.stack([e.v for e in elems]), self.b)

    def lane(self, e: Elem, i: int) -> Elem:
        """Lane i of a stacked handle, as a single value."""
        return Elem(e.v[i], self.b)

    def lanes(self, e: Elem, offset: int, total: int) -> Elem:
        """A stacked handle moved to lanes offset.. of ``total``, zeros elsewhere."""
        return Elem(self.b.lanes(e.v, offset, total), self.b)

    def const_lanes(self, values) -> Elem:
        """Constants as one stacked handle, a lane each."""
        return Elem(self.b.const_lanes(values), self.b)

    def gather(self, e: Elem, indices) -> Elem:
        return Elem(self.b.gather(e.v, list(indices)), self.b)

    def fold(self, e: Elem, weights) -> Elem:
        return Elem(self.b.fold(e.v, list(weights)), self.b)

    def challenge(self, i: int) -> ExtElem:
        c0, c1 = self._challenges[i]
        return ExtElem(self.const(c0), self.const(c1))

    def public(self, i: int) -> Elem:
        return self.const(self._public[i])

    def const(self, c) -> Elem:
        if isinstance(c, (int, np.integer)):
            c = int(c)
        return Elem(self.b.const(c), self.b)

    def ext_const(self, pair) -> ExtElem:
        return ExtElem(self.const(pair[0]), self.const(pair[1]))

    # constraints ---------------------------------------------------------
    def assert_zero(self, e: Elem, scope: str = EVERYWHERE):
        self.constraints.append(Constraint(e.v, scope))

    def assert_zero_ext(self, e: ExtElem, scope: str = EVERYWHERE):
        self.assert_zero(e.c0, scope)
        self.assert_zero(e.c1, scope)

    def assert_eq(self, a: Elem, b, scope: str = EVERYWHERE):
        if not isinstance(b, Elem):
            b = self.const(int(b))
        self.assert_zero(a - b, scope)

    def assert_bool(self, e: Elem, scope: str = EVERYWHERE):
        self.assert_zero(e * (e - 1), scope)

    # bus -------------------------------------------------------------------
    def send(self, channel: int, args: List[Elem], mult: Elem):
        self.interactions.append(Interaction(channel, list(args), mult, +1))

    def receive(self, channel: int, args: List[Elem], mult: Elem):
        self.interactions.append(Interaction(channel, list(args), mult, -1))

    def when_transition(self):
        return _Scoped(self, TRANSITION)

    def when_first_row(self):
        return _Scoped(self, FIRST_ROW)

    def when_last_row(self):
        return _Scoped(self, LAST_ROW)


class _Scoped:
    def __init__(self, builder: AirBuilder, scope: str):
        self.builder = builder
        self.scope = scope

    def assert_zero(self, e: Elem):
        self.builder.assert_zero(e, self.scope)

    def assert_zero_ext(self, e: ExtElem):
        self.builder.assert_zero_ext(e, self.scope)

    def assert_eq(self, a: Elem, b):
        if not isinstance(b, Elem):
            b = self.builder.const(int(b))
        self.builder.assert_zero(a - b, self.scope)


class Air:
    """Base class for proved tables.

    Subclasses set:
      width                  number of main columns
      row_offsets            row window used by constraints (must start 0)
      pre_width, pre_offsets preprocessed columns and their row window
      max_constraint_degree  max total degree incl. scope selector
    and implement ``eval(builder)``. Aux columns come only from the LogUp
    bus (``send`` / ``receive``); the reference's AIR-built aux columns
    and periodic columns have no user in either package and are not
    ported.
    """

    width: int = 0
    row_offsets = (0, 1)
    pre_width: int = 0
    pre_offsets = (0,)
    max_constraint_degree: int = 3

    def eval(self, builder: AirBuilder):
        raise NotImplementedError

    def preprocessed_columns(self, n: int):
        """(n, pre_width) uint64 numpy of build-time constants."""
        raise NotImplementedError("Air has pre columns but no preprocessed_columns")
