"""Batched NTT / coset LDE over Goldilocks on int64 tensors.

Counterpart of ``blobstreamx_tpu/field/ntt.py``. Layout: ``(..., n)``, the
transform along the last axis (the JAX package's ``(..., n, 2)`` without
the limb axis). Same convention as the reference's ``_twiddles``: the input
is bit-reversed, the output is in natural order, the inverse is scaled by
n^-1.

``ntt`` launches the CUDA kernel (``csrc/ntt.cu``) for a tensor on the card
and runs the plain staged version ``ntt_plain`` for a tensor on the CPU.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from .. import device as devmod
from .. import kernels
from . import goldilocks as gl


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT length {n} is not a power of two")
    return log_n


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """(n,) table tw[m + j] = w_{2m}^j for m = 1, 2, .., n/2 and j < m,
    w the forward (or inverse) root of order n; tw[0] = 1. Stage s of the
    transform (half-block m = 2^s) reads tw[m:2m]."""
    n = 1 << log_n
    w = gl.primitive_root_of_unity(log_n)
    if inverse:
        w = pow(w, gl.P - 2, gl.P)
    pows = gl.powers(w, max(n // 2, 1), "cpu")  # w^0 .. w^(n/2 - 1)
    k = np.arange(n)
    m = np.ones(n, dtype=np.int64)
    m[1:] = 1 << (np.frexp(k[1:])[1] - 1).astype(np.int64)  # top bit of k
    idx = (k - m) * (n // (2 * m))
    idx[0] = 0
    return pows[torch.from_numpy(idx)].to(device)


def ntt_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Staged radix-2 NTT in plain PyTorch field ops, on any device.
    x: (..., n) int64."""
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x.clone()
    shape = x.shape
    dev = x.device
    x = x.reshape(-1, n)[:, torch.from_numpy(_bit_reverse_perm(log_n)).to(dev)]
    tw = twiddles(log_n, inverse, dev)
    B = x.shape[0]
    for s in range(log_n):
        m = 1 << s
        x = x.reshape(B, n // (2 * m), 2, m)
        even = x[:, :, 0]
        odd = gl.mul(x[:, :, 1], tw[m:2 * m])
        x = torch.stack([gl.add(even, odd), gl.sub(even, odd)], dim=2)
    x = x.reshape(shape)
    if inverse:
        x = gl.mul(x, gl.scalar(pow(n, gl.P - 2, gl.P), dev))
    return x


# the kernel's passes (csrc/ntt.cu): a first pass of FIRST_STAGES stages on
# 2^FIRST_GROUP chunks a block, then upper passes of at most UPPER_STAGES
# stages on tiles of 2^TILE_BITS words
FIRST_STAGES = 11
FIRST_GROUP = 2
UPPER_STAGES = 9
TILE_BITS = 12


@functools.lru_cache(maxsize=None)
def plan(log_n: int) -> tuple:
    """The passes of the kernel for n = 2^log_n, as (s0, k, width) triples:
    pass p runs stages s0 .. s0 + k - 1. The first pass (s0 = 0) takes 2^width
    chunks of 2^k positions a block; an upper pass takes tiles of 2^k
    positions 2^s0 apart (bits s0 .. s0 + k - 1 of the position) by 2^width
    consecutive ones. Up to 2^12 the first pass is the whole transform; up
    to 2^20 one upper pass follows."""
    if log_n <= TILE_BITS:
        return ((0, log_n, 0),)
    passes = [(0, FIRST_STAGES, FIRST_GROUP)]
    upper = log_n - FIRST_STAGES
    n_upper = -(-upper // UPPER_STAGES)
    s0 = FIRST_STAGES
    for i in range(n_upper):
        k = upper // n_upper + (i < upper % n_upper)
        passes.append((s0, k, TILE_BITS - k))
        s0 += k
    return tuple(passes)


@functools.lru_cache(maxsize=None)
def _plan_array(log_n: int) -> np.ndarray:
    return np.ascontiguousarray(np.array(plan(log_n), dtype=np.int32).reshape(-1))


def ntt_kernel(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The CUDA NTT (csrc/ntt.cu) on a (..., n) int64 tensor on the card."""
    if not x.is_cuda:
        raise ValueError("ntt_kernel takes a CUDA tensor")
    if x.dtype != torch.int64:
        raise TypeError(f"ntt_kernel takes int64, got {x.dtype}")
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x.clone()
    if log_n > gl.TWO_ADICITY:
        raise ValueError(f"no root of unity of order 2^{log_n}")
    x = x.contiguous()
    out = torch.empty_like(x)
    batch = x.numel() // n
    tw = twiddles(log_n, inverse, x.device)
    n_inv = pow(n, gl.P - 2, gl.P)
    passes = _plan_array(log_n)
    with torch.cuda.device(x.device):
        rc = kernels.lib("ntt").bsx_ntt(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), batch, log_n,
            passes.ctypes.data, len(passes) // 3, int(inverse), n_inv,
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "bsx_ntt")
    ntt_kernel.launches += 1
    ntt_kernel.calls[(tuple(x.shape), bool(inverse))] += 1
    return out


# launches, and launches by (shape, inverse)
ntt_kernel.launches = 0
ntt_kernel.calls = collections.Counter()


def ntt(coeffs, inverse: bool = False, device=None) -> torch.Tensor:
    """Forward NTT (coefficients -> evaluations on the order-n subgroup,
    natural order) or inverse, along the last axis. The kernel runs for a
    tensor on the card, the plain version for one on the CPU."""
    x = devmod.on(coeffs, device)
    if x.is_cuda:
        return ntt_kernel(x, inverse)
    return ntt_plain(x, inverse)


@functools.lru_cache(maxsize=None)
def _shift_powers(shift: int, n: int, device) -> torch.Tensor:
    return gl.powers(shift, n, device)


def coset_shift(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """Scale coefficient i by shift^i (evals on H -> evals on shift*H)."""
    return gl.mul(coeffs, _shift_powers(shift % gl.P, coeffs.shape[-1],
                                        coeffs.device))


def lde(evals: torch.Tensor, rate_bits: int, shift: int = gl.GENERATOR,
        device=None) -> torch.Tensor:
    """Evaluations on H (order n, natural order) -> evaluations on the
    coset shift*K, K of order n << rate_bits. (..., n) -> (..., n << rate_bits)."""
    x = devmod.on(evals, device)
    n = x.shape[-1]
    coeffs = ntt(x, inverse=True, device=x.device)
    coeffs = torch.nn.functional.pad(coeffs, (0, (n << rate_bits) - n))
    return ntt(coset_shift(coeffs, shift), device=x.device)


def interpolate_coeffs(evals, device=None) -> torch.Tensor:
    """Evaluations on the subgroup (natural order) -> coefficients."""
    return ntt(evals, inverse=True, device=device)


def eval_poly_ext(coeffs_base: torch.Tensor, point) -> torch.Tensor:
    """Evaluate base-field polynomials (coeffs (..., n)) at an extension
    point (python-int pair). Returns (..., 2)."""
    from . import extension as ext

    pows = ext.powers(point, coeffs_base.shape[-1], coeffs_base.device)
    return ext.join(gl.sum(gl.mul(coeffs_base, pows[:, 0]), -1),
                    gl.sum(gl.mul(coeffs_base, pows[:, 1]), -1))
