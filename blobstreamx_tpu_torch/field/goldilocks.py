"""Goldilocks field arithmetic on int64 tensors.

Same field as ``blobstreamx_tpu/field/goldilocks.py`` (p = 2^64 - 2^32 + 1),
but one element per ``torch.int64`` holding the u64 bit pattern instead of
two u32 limbs. PyTorch has no unsigned 64-bit arithmetic on every device,
so the functions here treat int64 as u64 by hand:

  * additions and subtractions wrap mod 2^64, and an unsigned comparison
    flips the sign bit of both sides first (``_ult``);
  * ``>>`` is arithmetic on int64, so every right shift is masked;
  * a product is built from 32 x 16-bit partial products (each < 2^48, so
    no multiplication overflows int64), collected into four 32-bit columns
    of the 128-bit product and reduced with 2^64 = 2^32 - 1 and
    2^96 = -1 (mod p).

Every output is canonical (< p). These are the plain versions that the
kernels in ``csrc/goldilocks.cuh`` compute with native u64 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

P = 0xFFFFFFFF_00000001  # 2**64 - 2**32 + 1
EPSILON = 0xFFFFFFFF  # 2**32 - 1 == 2**64 mod p
GENERATOR = 7
TWO_ADICITY = 32

_SIGN = -(1 << 63)
_P_FLIPPED = (P - (1 << 64)) ^ _SIGN  # p with its sign bit flipped
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


# ---------------------------------------------------------------------------
# int <-> tensor
# ---------------------------------------------------------------------------

def to_signed(v: int) -> int:
    """u64 python int -> the int64 with the same bit pattern."""
    return v - (1 << 64) if v >= (1 << 63) else v


def from_int(values, device) -> torch.Tensor:
    """Python ints / numpy integers (values < 2^64) -> int64 tensor."""
    arr = np.asarray(values, dtype=np.uint64)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64)).to(device)


def to_int(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array (host copy)."""
    return x.detach().to("cpu").contiguous().numpy().view(np.uint64)


def scalar(v: int, device) -> torch.Tensor:
    """A 0-dim int64 tensor holding v mod p."""
    return torch.tensor(to_signed(int(v) % P), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def add(a, b):
    s = a + b
    # carry out of 2^64: 2^64 = EPSILON (mod p) and the wrapped sum is then
    # below p - 2^32, so one fold finishes. Without a carry, s >= p folds
    # the same way: s - p = s + EPSILON (mod 2^64).
    fix = _ult(s, a) | ((s ^ _SIGN) >= _P_FLIPPED)
    return torch.where(fix, s + EPSILON, s)


def sub(a, b):
    d = a - b
    # borrow: d = a - b + 2^64, and a - b + p = d - EPSILON
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a):
    return torch.where(a == 0, a, (P - (1 << 64)) - a)


def _reduce128(n0, n1, n2, n3):
    """Four 32-bit limbs (n0 lowest) of a 128-bit value -> canonical mod p."""
    x = n0 | (n1 << 32)
    t = x - n3  # x - n3 mod p, minus EPSILON again on a borrow
    t = torch.where(_ult(x, n3), t - EPSILON, t)
    v = (n2 << 32) - n2  # n2 * EPSILON < 2^64
    r = t + v
    fix = _ult(r, t) | ((r ^ _SIGN) >= _P_FLIPPED)
    return torch.where(fix, r + EPSILON, r)


def _mul_wide(a, b):
    """128-bit product a*b as four 32-bit limbs."""
    a0 = a & _M32
    a1 = (a >> 32) & _M32
    b0 = b & _M16
    b1 = (b >> 16) & _M16
    b2 = (b >> 32) & _M16
    b3 = (b >> 48) & _M16
    # products at bit offsets 0, 32, 32, 64
    e00 = a0 * b0
    e02 = a0 * b2
    e10 = a1 * b0
    e12 = a1 * b2
    # products at bit offsets 16, 48, 48, 80
    o01 = a0 * b1
    o03 = a0 * b3
    o11 = a1 * b1
    o13 = a1 * b3
    c0 = (e00 & _M32) + ((o01 & _M16) << 16)
    c1 = ((e00 >> 32) + (e02 & _M32) + (e10 & _M32) + (o01 >> 16)
          + ((o03 & _M16) << 16) + ((o11 & _M16) << 16))
    c2 = ((e02 >> 32) + (e10 >> 32) + (e12 & _M32) + (o03 >> 16)
          + (o11 >> 16) + ((o13 & _M16) << 16))
    c3 = (e12 >> 32) + (o13 >> 16)
    c1 = c1 + (c0 >> 32)
    c2 = c2 + (c1 >> 32)
    c3 = c3 + (c2 >> 32)
    return c0 & _M32, c1 & _M32, c2 & _M32, c3


def mul(a, b):
    return _reduce128(*_mul_wide(a, b))


# mul_small's bound on its constant: a 32-bit half of a times c < 2^30 stays
# below 2^62, so the partial products and their sum fit int64
SMALL_MUL_BOUND = 1 << 30


def mul_small(a, c: int):
    """a * c for a python-int constant 0 <= c < 2^30: the product is below
    2^94, three 32-bit limbs, reduced as in _reduce128 with no top limb."""
    if not 0 <= c < SMALL_MUL_BOUND:
        raise ValueError("mul_small takes a constant below 2^30")
    lo = (a & _M32) * c
    t = ((a >> 32) & _M32) * c + (lo >> 32)
    x = (lo & _M32) | ((t & _M32) << 32)
    n2 = t >> 32
    r = x + ((n2 << 32) - n2)  # + n2 * EPSILON, which is < 2^63
    fix = _ult(r, x) | ((r ^ _SIGN) >= _P_FLIPPED)
    return torch.where(fix, r + EPSILON, r)


def square(x):
    return mul(x, x)


def pow_const(x, e: int):
    """x ** e for a python-int exponent (square and multiply)."""
    result = None
    base = x
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    if result is None:
        return torch.ones_like(x)
    return result


def inv(x):
    """Field inverse via Fermat: x^(p-2). x must be nonzero."""
    return pow_const(x, P - 2)


def sum(x, dim: int):
    """Field sum along ``dim``: the 32-bit halves are summed exactly in
    int64 (up to 2^30 terms) and the total is reduced once."""
    if x.shape[dim] > (1 << 30):
        raise ValueError("field sum over more than 2^30 terms")
    lo = (x & _M32).sum(dim)
    hi = ((x >> 32) & _M32).sum(dim)
    t = (lo >> 32) + hi
    return _reduce128(lo & _M32, t & _M32, t >> 32, torch.zeros_like(t))


def powers(base: int, n: int, device) -> torch.Tensor:
    """(n,) tensor of base^0 .. base^(n-1), by doubling."""
    out = scalar(1, device).reshape(1)
    step = base % P
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, scalar(step, device))])
        step = step * step % P
    return out[:n]


# ---------------------------------------------------------------------------
# derived constants (computed, not copied)
# ---------------------------------------------------------------------------

def primitive_root_of_unity(n_bits: int) -> int:
    """Generator of the order-2^n_bits subgroup, as a python int."""
    if not 0 <= n_bits <= TWO_ADICITY:
        raise ValueError(f"no subgroup of order 2^{n_bits}")
    base = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
    for _ in range(TWO_ADICITY - n_bits):
        base = (base * base) % P
    return base
