"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card. Asking for the card on a host without
    one raises: the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on(x, device) -> torch.Tensor:
    """``x`` (tensor, numpy array or nested ints) as an int64 tensor on the
    resolved device."""
    dev = resolve(device)
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int64:
            raise TypeError(f"expected int64 field elements, got {x.dtype}")
        return x.to(dev)
    return torch.as_tensor(x, dtype=torch.int64, device=dev)
