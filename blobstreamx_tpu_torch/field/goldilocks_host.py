"""Vectorized host-side (numpy uint64) Goldilocks arithmetic.

A copy of ``blobstreamx_tpu/field/goldilocks_host.py``. The witness engine
(frontend/witness.py) evaluates its arithmetic rows and typed hints with
it; per-element Python integers would be ~1000x slower. Same reduction
identities as the tensor versions (field/goldilocks.py): 2^64 = 2^32 - 1
(mod p), 2^96 = -1 (mod p).

All functions take/return canonical (< p) numpy uint64 arrays; numpy's
wrapping uint64 arithmetic does the u64 work.
"""

from __future__ import annotations

import numpy as np

from .goldilocks import P, EPSILON

_U64 = np.uint64
_MASK32 = _U64(0xFFFFFFFF)
_EPS = _U64(EPSILON)
_P = _U64(P)
_32 = _U64(32)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    s = a + b
    # wrap => result - 2^64: add EPSILON back (cannot re-wrap: a,b < p)
    s = s + np.where(s < a, _EPS, _U64(0))
    return np.where(s >= _P, s - _P, s)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return d - np.where(a < b, _EPS, _U64(0))


def neg(a: np.ndarray) -> np.ndarray:
    return np.where(a == 0, _U64(0), _P - a)


def _reduce128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(hi:lo) 128-bit -> canonical field element."""
    hi_lo = hi & _MASK32
    hi_hi = hi >> _32
    t = lo - hi_hi
    t = t - np.where(lo < hi_hi, _EPS, _U64(0))
    v = (hi_lo << _32) - hi_lo  # hi_lo * EPSILON, fits in u64
    r = t + v
    r = r + np.where(r < t, _EPS, _U64(0))
    return np.where(r >= _P, r - _P, r)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a0 = a & _MASK32
    a1 = a >> _32
    b0 = b & _MASK32
    b1 = b >> _32
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl
    midc = np.where(mid < lh, _U64(1), _U64(0))
    lo = ll + (mid << _32)
    loc = np.where(lo < ll, _U64(1), _U64(0))
    hi = hh + (mid >> _32) + (midc << _32) + loc
    return _reduce128(lo, hi)


def mul_scalar(a: np.ndarray, k: int) -> np.ndarray:
    return mul(a, np.full_like(a, _U64(k % P)))


def pow_const(a: np.ndarray, e: int) -> np.ndarray:
    """a ** e for a static python-int exponent (binary ladder)."""
    result = np.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def inv(a: np.ndarray) -> np.ndarray:
    """Batched Fermat inverse (a nonzero)."""
    return pow_const(a, P - 2)


def inv_or_zero(a: np.ndarray) -> np.ndarray:
    return np.where(a == 0, _U64(0), inv(np.where(a == 0, _U64(1), a)))
