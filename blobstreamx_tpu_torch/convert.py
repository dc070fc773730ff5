"""Carry field values between the JAX package's layout and the port's.

The JAX package stores a Goldilocks element as two uint32 limbs on a
trailing axis (``x[..., 0] = lo``, ``x[..., 1] = hi``); the port stores one
int64 holding the u64 bit pattern. These converters work on numpy arrays,
so a caller hands over the reference's values without this module
importing the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def limbs_to_tensor(limbs, device="cpu") -> torch.Tensor:
    """numpy (..., 2) uint32 limbs -> (...) int64 tensor."""
    arr = np.asarray(limbs)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"expected a trailing limb axis of 2, got {arr.shape}")
    u = arr[..., 0].astype(np.uint64) | (arr[..., 1].astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(np.ascontiguousarray(u).view(np.int64)).to(device)


def tensor_to_limbs(x: torch.Tensor) -> np.ndarray:
    """(...) int64 tensor -> numpy (..., 2) uint32 limbs."""
    u = x.detach().to("cpu").contiguous().numpy().view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-1)


def ints_to_tensor(values, device="cpu") -> torch.Tensor:
    """Python ints / numpy integers (each < 2^64) -> int64 tensor."""
    u = np.asarray(values, dtype=np.uint64)
    return torch.from_numpy(np.ascontiguousarray(u).view(np.int64)).to(device)
