"""Quadratic extension GF(p^2) = GF(p)[t] / (t^2 - W) over Goldilocks.

Counterpart of ``blobstreamx_tpu/field/extension.py``. An element is a
trailing axis of size 2 of int64 field elements: ``x[..., 0] + x[..., 1] t``.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl

# W must be a quadratic non-residue mod p; 7 (the multiplicative generator)
# is one.
W = 7


def c0(x):
    return x[..., 0]


def c1(x):
    return x[..., 1]


def join(r0, r1):
    r0, r1 = torch.broadcast_tensors(r0, r1)
    return torch.stack([r0, r1], dim=-1)


def from_base(x):
    return join(x, torch.zeros_like(x))


def from_int_pair(pair, device) -> torch.Tensor:
    """A python-int pair -> (2,) tensor."""
    return gl.from_int([int(pair[0]) % gl.P, int(pair[1]) % gl.P], device)


def from_int_pairs(pairs, device) -> torch.Tensor:
    """A list of python-int pairs -> (k, 2) tensor."""
    return gl.from_int([[int(a) % gl.P, int(b) % gl.P] for a, b in pairs],
                       device).reshape(-1, 2)


def to_int_pairs(x) -> list:
    """(..., 2) tensor -> nested lists of python-int pairs (flattened)."""
    arr = gl.to_int(x).reshape(-1, 2)
    return [(int(a), int(b)) for a, b in arr]


def add(x, y):
    return join(gl.add(c0(x), c0(y)), gl.add(c1(x), c1(y)))


def sub(x, y):
    return join(gl.sub(c0(x), c0(y)), gl.sub(c1(x), c1(y)))


def neg(x):
    return join(gl.neg(c0(x)), gl.neg(c1(x)))


def mul(x, y):
    """(a0 + a1 t)(b0 + b1 t) = (a0 b0 + W a1 b1) + (a0 b1 + a1 b0) t."""
    a0, a1 = c0(x), c1(x)
    b0, b1 = c0(y), c1(y)
    w = gl.scalar(W, x.device)
    r0 = gl.add(gl.mul(a0, b0), gl.mul(gl.mul(a1, b1), w))
    r1 = gl.add(gl.mul(a0, b1), gl.mul(a1, b0))
    return join(r0, r1)


def scalar_mul(x, s):
    """Extension element times base-field element s."""
    return join(gl.mul(c0(x), s), gl.mul(c1(x), s))


def inv(x):
    """1 / (a0 + a1 t) = (a0 - a1 t) / (a0^2 - W a1^2)."""
    a0, a1 = c0(x), c1(x)
    w = gl.scalar(W, x.device)
    norm = gl.sub(gl.square(a0), gl.mul(gl.square(a1), w))
    ninv = gl.inv(norm)
    return join(gl.mul(a0, ninv), gl.mul(gl.neg(a1), ninv))


def sum(x, dim: int):
    """Sum of extension elements along ``dim`` (not the trailing axis)."""
    d = dim if dim >= 0 else dim - 1
    return join(gl.sum(c0(x), d), gl.sum(c1(x), d))


def powers(z, n: int, device) -> torch.Tensor:
    """(n, 2) tensor of z^0 .. z^(n-1) for a python-int pair z, by doubling."""
    out = from_int_pair((1, 0), device).reshape(1, 2)
    zk = z
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, from_int_pair(zk, device))])
        zk = GFp2.mul(zk, zk)
    return out[:n]


def prefix_sum(x):
    """Inclusive running sum of (n, 2) extension values along axis 0, by
    log-step doubling of field adds (int64 cumsum would overflow)."""
    n = x.shape[0]
    d = 1
    while d < n:
        x = torch.cat([x[:d], add(x[d:], x[:-d])])
        d *= 2
    return x


class GFp2:
    """Python-int reference: elements are (c0, c1) tuples of ints."""

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % gl.P, (a[1] + b[1]) % gl.P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % gl.P, (a[1] - b[1]) % gl.P)

    @staticmethod
    def mul(a, b):
        return (
            (a[0] * b[0] + W * a[1] * b[1]) % gl.P,
            (a[0] * b[1] + a[1] * b[0]) % gl.P,
        )

    @staticmethod
    def inv(a):
        norm = (a[0] * a[0] - W * a[1] * a[1]) % gl.P
        ninv = pow(norm, gl.P - 2, gl.P)
        return ((a[0] * ninv) % gl.P, (-a[1] * ninv) % gl.P)
