"""Poseidon permutation over Goldilocks, width 12, and the sponge on it.

Counterpart of ``blobstreamx_tpu/ops/poseidon.py``: the same instance (round
constants from a SHA-256 counter stream, Cauchy MDS M[i][j] = 1/(i+j+12)),
derived here the same way. State layout ``(..., 12)`` int64.

``permute`` / ``hash_no_pad`` / ``hash_two_to_one`` launch the CUDA kernel
(``csrc/poseidon.cu``) for tensors on the card and run the plain
round-by-round versions for tensors on the CPU. ``permute_py`` (the
sparse form) and the ``*_py`` sponge helpers are python-int versions for
host use (the transcript, grinding and the verifier).
"""

from __future__ import annotations

import collections
import functools
import hashlib
import math
import operator
from typing import NamedTuple

import numpy as np
import torch

from .. import device as devmod
from .. import kernels
from ..field import goldilocks as gl

WIDTH = 12
RATE = 8
CAPACITY = 4
DIGEST = 4
FULL_ROUNDS = 8  # 4 before + 4 after the partial rounds
PARTIAL_ROUNDS = 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
SBOX_EXP = 7

_DOMAIN = b"blobstreamx-tpu/poseidon-goldilocks-w12/v1"


@functools.lru_cache(maxsize=None)
def round_constants() -> tuple:
    """360 field elements from a SHA-256 counter stream (rejection sampled)."""
    out = []
    counter = 0
    while len(out) < N_ROUNDS * WIDTH:
        h = hashlib.sha256(_DOMAIN + b"/rc/" + counter.to_bytes(8, "big")).digest()
        for off in range(0, 32, 8):
            v = int.from_bytes(h[off:off + 8], "big")
            if v < gl.P and len(out) < N_ROUNDS * WIDTH:
                out.append(v)
        counter += 1
    return tuple(out)


@functools.lru_cache(maxsize=None)
def mds_matrix() -> tuple:
    """12x12 Cauchy matrix M[i][j] = 1/(i + j + WIDTH) over GF(p)."""
    return tuple(
        tuple(pow(i + j + WIDTH, gl.P - 2, gl.P) for j in range(WIDTH))
        for i in range(WIDTH)
    )


# ---------------------------------------------------------------------------
# the partial rounds in sparse form (the kernel's constants)
# ---------------------------------------------------------------------------

class SparseConstants(NamedTuple):
    """The same permutation with the partial rounds rewritten (Grassi et
    al., "Poseidon", appendix B; plonky2's "fast partial rounds"):

        full rounds 0-3 with ``full[0:4]``
        s += first;  s[1:] = init @ s[1:]
        for k in range(22):
            s[0] = sbox(s[0]) + scalars[k]
            s = [rows[k] . s] + [s[i] + cols[k][i-1] * s[0] for i in 1..11]
        full rounds 4-7 with ``full[4:8]``

    A partial round then costs 4 + 23 multiplies in place of 4 + 144."""
    full: tuple     # (8, 12): round constants of the full rounds
    first: tuple    # (12,): every partial round's constants, pushed to the front
    init: tuple     # (11, 11): applied to lanes 1..11 once, before round 0
    scalars: tuple  # (22,): added to lane 0 after each S-box; the last is 0
    rows: tuple     # (22, 12): new lane 0
    cols: tuple     # (22, 11): lane i gains cols[i-1] * lane 0


def _mat_inv(a: list) -> list:
    """Inverse of a square matrix over GF(p) (Gauss-Jordan)."""
    P = gl.P
    n = len(a)
    m = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(a)]
    for c in range(n):
        piv = next(r for r in range(c, n) if m[r][c])
        m[c], m[piv] = m[piv], m[c]
        inv = pow(m[c][c], P - 2, P)
        m[c] = [v * inv % P for v in m[c]]
        for r in range(n):
            if r != c and m[r][c]:
                f = m[r][c]
                m[r] = [(v - f * w) % P for v, w in zip(m[r], m[c])]
    return [row[n:] for row in m]


def _mat_vec(a, v) -> list:
    return [sum(x * y for x, y in zip(row, v)) % gl.P for row in a]


@functools.lru_cache(maxsize=None)
def sparse_constants() -> SparseConstants:
    """Derive the sparse form from ``round_constants`` and ``mds_matrix``.

    Constants, from the last partial round back: a round's constants c
    added before its S-box equal M^-1 c added after the previous round's
    S-box. Lane 0 of that stays there as the previous round's scalar; the
    other lanes commute with its S-box and join its constants. What
    reaches round 0 is added once, as ``first``.

    Matrices, likewise from the back: A = M for the last round; factor
    A = S D with D = diag(1, A[1:,1:]) and S = [[a00, r], [a[1:,0], I]],
    r = A[0,1:] A[1:,1:]^-1 (every square submatrix of a Cauchy matrix is
    invertible). D commutes with the S-box of lane 0, so it moves into the
    round before: A <- D M there. The last D is ``init``."""
    P = gl.P
    rc = round_constants()
    mds = [list(row) for row in mds_matrix()]
    mds_inv = _mat_inv(mds)
    half = FULL_ROUNDS // 2
    full = tuple(tuple(rc[r * WIDTH:(r + 1) * WIDTH])
                 for r in list(range(half)) + list(range(half + PARTIAL_ROUNDS, N_ROUNDS)))

    def partial(k):
        return rc[(half + k) * WIDTH:(half + k + 1) * WIDTH]

    scalars = [0] * PARTIAL_ROUNDS
    carry = list(partial(PARTIAL_ROUNDS - 1))
    for k in range(PARTIAL_ROUNDS - 1, 0, -1):
        u = _mat_vec(mds_inv, carry)
        scalars[k - 1] = u[0]
        carry = [partial(k - 1)[0]] + [(c + x) % P for c, x in zip(partial(k - 1)[1:], u[1:])]

    rows, cols = [None] * PARTIAL_ROUNDS, [None] * PARTIAL_ROUNDS
    a = mds
    for k in range(PARTIAL_ROUNDS - 1, -1, -1):
        a_hat = [row[1:] for row in a[1:]]
        a_hat_inv = _mat_inv(a_hat)
        r = [sum(a[0][1 + i] * a_hat_inv[i][j] for i in range(WIDTH - 1)) % P
             for j in range(WIDTH - 1)]
        rows[k] = (a[0][0],) + tuple(r)
        cols[k] = tuple(a[i][0] for i in range(1, WIDTH))
        d = [[1] + [0] * (WIDTH - 1)] + [[0] + row for row in a_hat]
        a = [[sum(d[i][t] * mds[t][j] for t in range(WIDTH)) % P for j in range(WIDTH)]
             for i in range(WIDTH)]
    return SparseConstants(full=full, first=tuple(carry),
                           init=tuple(tuple(row) for row in a_hat),
                           scalars=tuple(scalars), rows=tuple(rows), cols=tuple(cols))


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _round_constants_tensor(device) -> torch.Tensor:
    return gl.from_int(np.array(round_constants(), dtype=np.uint64)
                       .reshape(N_ROUNDS, WIDTH), device)


@functools.lru_cache(maxsize=None)
def _mds_limb_matrix(device) -> torch.Tensor:
    """(48, 84) float64: row j*4 + l, column i*7 + (l + k) holds 16-bit limb
    k of M[i][j], so (state limbs) @ this gives, per output lane i, the
    seven 16-bit-offset buckets of sum_j M[i][j] * s[j]."""
    a = np.zeros((WIDTH * 4, WIDTH * 7), dtype=np.float64)
    for i, row in enumerate(mds_matrix()):
        for j, v in enumerate(row):
            for k in range(4):
                for l in range(4):
                    a[j * 4 + l, i * 7 + l + k] += (v >> (16 * k)) & 0xFFFF
    return torch.from_numpy(a).to(device)


def _mds_plain(s: torch.Tensor) -> torch.Tensor:
    """(B, 12) -> (B, 12). 16-bit limbs of the state times 16-bit limbs of
    M: every product is < 2^32 and every bucket a sum of at most 48 of
    them (< 2^38), so the float64 matmul is exact. The buckets sit at bit
    offsets 16k, k = 0..6; they are gathered into 32-bit columns of a
    < 2^134 value and reduced once (2^128 = -2^32 mod p)."""
    limbs = torch.stack([(s >> (16 * k)) & 0xFFFF for k in range(4)], dim=-1)
    buckets = (limbs.reshape(-1, WIDTH * 4).to(torch.float64)
               @ _mds_limb_matrix(s.device)).to(torch.int64)
    b = buckets.reshape(-1, WIDTH, 7)
    m32 = 0xFFFFFFFF
    cols = [torch.zeros_like(b[..., 0]) for _ in range(5)]
    for k in range(7):
        v = b[..., k]
        c = k // 2
        if k % 2 == 0:  # offset 32c
            cols[c] = cols[c] + (v & m32)
            cols[c + 1] = cols[c + 1] + (v >> 32)
        else:  # offset 32c + 16
            cols[c] = cols[c] + ((v & 0xFFFF) << 16)
            cols[c + 1] = cols[c + 1] + (v >> 16)
    for c in range(4):
        cols[c + 1] = cols[c + 1] + (cols[c] >> 32)
        cols[c] = cols[c] & m32
    r = gl._reduce128(cols[0], cols[1], cols[2], cols[3])
    return gl.sub(r, cols[4] << 32)


def _sbox(x):
    x2 = gl.square(x)
    x3 = gl.mul(x2, x)
    return gl.mul(gl.square(x3), x)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Round-by-round Poseidon permutation in plain PyTorch, on any device.
    state: (..., 12) int64."""
    shape = state.shape
    rc = _round_constants_tensor(state.device)
    s = state.reshape(-1, WIDTH)
    half = FULL_ROUNDS // 2
    for r in range(N_ROUNDS):
        s = gl.add(s, rc[r])
        if half <= r < half + PARTIAL_ROUNDS:
            s = torch.cat([_sbox(s[:, :1]), s[:, 1:]], dim=1)
        else:
            s = _sbox(s)
        s = _mds_plain(s)
    return s.reshape(shape)


def hash_no_pad_plain(inputs: torch.Tensor) -> torch.Tensor:
    """Sponge (rate 8, overwrite mode, no padding) in plain PyTorch:
    (..., n) -> (..., 4)."""
    batch = inputs.shape[:-1]
    x = inputs.reshape(math.prod(batch), inputs.shape[-1])
    state = torch.zeros((x.shape[0], WIDTH), dtype=torch.int64, device=x.device)
    for off in range(0, x.shape[1], RATE):
        chunk = x[:, off:off + RATE]
        state = permute_plain(torch.cat([chunk, state[:, chunk.shape[1]:]], dim=1))
    return state[:, :DIGEST].reshape(batch + (DIGEST,))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_lib(device_index: int):
    """The Poseidon library with its constants copied to this device."""
    lib = kernels.lib("poseidon")
    arrays = kernel_constants()
    with torch.cuda.device(device_index):
        kernels.check(lib.bsx_poseidon_set_constants(*(a.ctypes.data for a in arrays)),
                      "bsx_poseidon_set_constants")
    return lib


@functools.lru_cache(maxsize=None)
def kernel_constants() -> tuple:
    """What ``bsx_poseidon_set_constants`` takes, in its order: contiguous
    uint64 arrays of canonical field elements full (8, 12), first (12,),
    scalars (22,), cols (22, 11), mds (12, 12), init (11, 11), rows (22, 12)."""
    sc = sparse_constants()
    return tuple(np.ascontiguousarray(np.array(v, dtype=np.uint64))
                 for v in (sc.full, sc.first, sc.scalars, sc.cols, mds_matrix(),
                           sc.init, sc.rows))


def _rows(x: torch.Tensor, what: str):
    """x as a (B, n) int64 matrix on the card, row- or column-major, with
    its element strides."""
    if not x.is_cuda:
        raise ValueError(f"{what} takes a CUDA tensor")
    if x.dtype != torch.int64:
        raise TypeError(f"{what} takes int64, got {x.dtype}")
    if x.dim() != 2:
        x = x.reshape(math.prod(x.shape[:-1]), x.shape[-1])
    if not (x.is_contiguous() or x.t().is_contiguous()):
        x = x.contiguous()
    return x, x.stride(0), x.stride(1)


def _launch(wrapper, key, fn: str, x: torch.Tensor, out: torch.Tensor, *args) -> None:
    """Runs ``fn`` and counts the launch on ``wrapper``, in all and under
    ``key``: the input's shape and whether it is a column-major matrix."""
    dev = x.device
    lib = _kernel_lib(dev.index if dev.index is not None else torch.cuda.current_device())
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(x.data_ptr(), out.data_ptr(), *args,
                              torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, fn)
    wrapper.launches += 1
    wrapper.calls[key] += 1


def permute_kernel(state: torch.Tensor) -> torch.Tensor:
    """The CUDA permutation on a (..., 12) int64 tensor on the card."""
    if state.shape[-1] != WIDTH:
        raise ValueError(f"Poseidon state must have {WIDTH} lanes")
    x, rs, cs = _rows(state, "permute_kernel")
    out = torch.empty((x.shape[0], WIDTH), dtype=torch.int64, device=x.device)
    key = (tuple(state.shape), state.dim() == 2 and not x.is_contiguous())
    _launch(permute_kernel, key, "bsx_poseidon_permute", x, out, x.shape[0], rs, cs)
    return out.reshape(state.shape)


# launches, and launches by (shape, column-major)
permute_kernel.launches = 0
permute_kernel.calls = collections.Counter()


def hash_no_pad_kernel(inputs: torch.Tensor) -> torch.Tensor:
    """The CUDA sponge on (..., n) int64 rows on the card -> (..., 4). A 2-D
    input may be row-major or the transpose of a row-major matrix."""
    batch = inputs.shape[:-1]
    n = inputs.shape[-1]
    x, rs, cs = _rows(inputs, "hash_no_pad_kernel")
    out = torch.empty((x.shape[0], DIGEST), dtype=torch.int64, device=x.device)
    key = (tuple(inputs.shape), inputs.dim() == 2 and not x.is_contiguous())
    _launch(hash_no_pad_kernel, key, "bsx_poseidon_hash_no_pad", x, out, x.shape[0], n, rs, cs)
    return out.reshape(batch + (DIGEST,))


hash_no_pad_kernel.launches = 0
hash_no_pad_kernel.calls = collections.Counter()


def launches() -> int:
    """Launches of the one Poseidon kernel, through either wrapper."""
    return permute_kernel.launches + hash_no_pad_kernel.launches


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def permute(state, device=None) -> torch.Tensor:
    """Poseidon permutation, batched: (..., 12) int64."""
    x = devmod.on(state, device)
    return permute_kernel(x) if x.is_cuda else permute_plain(x)


def hash_no_pad(inputs, device=None) -> torch.Tensor:
    """Sponge-hash (..., n) field elements -> (..., 4) digest; absorbs RATE
    elements per permutation, no padding (fixed-length use only)."""
    x = devmod.on(inputs, device)
    return hash_no_pad_kernel(x) if x.is_cuda else hash_no_pad_plain(x)


def hash_two_to_one(left, right, device=None) -> torch.Tensor:
    """Compress two (..., 4) digests -> (..., 4). The state [left, right, 0]
    is exactly what the sponge absorbs from the 8 elements left || right."""
    dev = devmod.resolve(device)
    return hash_no_pad(torch.cat([devmod.on(left, dev), devmod.on(right, dev)],
                                 dim=-1), dev)


# ---------------------------------------------------------------------------
# python-int versions (host)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _py_tables():
    rc = round_constants()
    return (tuple(tuple(rc[r * WIDTH:(r + 1) * WIDTH]) for r in range(N_ROUNDS)),
            tuple(tuple(row) for row in mds_matrix()))


def permute_py_rounds(state: list) -> list:
    """Python-int permutation on a list of 12 ints, round by round as the
    instance defines it."""
    rcs, mds = _py_tables()
    P = gl.P
    s = list(state)
    half = FULL_ROUNDS // 2
    for r, rc in enumerate(rcs):
        s = [(x + c) % P for x, c in zip(s, rc)]
        if half <= r < half + PARTIAL_ROUNDS:
            s[0] = pow(s[0], SBOX_EXP, P)
        else:
            s = [pow(x, SBOX_EXP, P) for x in s]
        s = [sum(map(operator.mul, row, s)) % P for row in mds]
    return s


def permute_py(state: list) -> list:
    """Python-int permutation on a list of 12 ints, in the sparse form of
    ``sparse_constants`` (the kernel's): the same function as
    ``permute_py_rounds`` with about a third of the multiplies. The host
    transcript and the verifier's Merkle paths run on it."""
    sc = sparse_constants()
    mds = _py_tables()[1]
    P, e, mul = gl.P, SBOX_EXP, operator.mul
    s = list(state)
    half = FULL_ROUNDS // 2

    def full_round(s, rc):
        t = [pow((x + c) % P, e, P) for x, c in zip(s, rc)]
        return [sum(map(mul, row, t)) % P for row in mds]

    for r in range(half):
        s = full_round(s, sc.full[r])
    s = [(x + c) % P for x, c in zip(s, sc.first)]
    rest = s[1:]
    s = [s[0]] + [sum(map(mul, row, rest)) % P for row in sc.init]
    for k in range(PARTIAL_ROUNDS):
        s0 = (pow(s[0], e, P) + sc.scalars[k]) % P
        s[0] = s0
        new0 = sum(map(mul, sc.rows[k], s)) % P
        s = [new0] + [(x + v * s0) % P for x, v in zip(s[1:], sc.cols[k])]
    for r in range(half, FULL_ROUNDS):
        s = full_round(s, sc.full[r])
    return s


def hash_no_pad_py(inputs: list) -> list:
    state = [0] * WIDTH
    for off in range(0, len(inputs), RATE):
        chunk = list(inputs[off:off + RATE])
        state = permute_py(chunk + state[len(chunk):])
    return state[:DIGEST]


def hash_two_to_one_py(left: list, right: list) -> list:
    return permute_py(list(left) + list(right) + [0] * CAPACITY)[:DIGEST]
