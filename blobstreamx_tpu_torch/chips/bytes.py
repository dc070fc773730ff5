"""Byte range-check chip: a 256-row table receiving RANGE8 bus messages.

Counterpart of ``blobstreamx_tpu/chips/bytes.py``. Every byte sent on the
bus lands here; balance forces all of them into [0, 256). Multiplicities
are witness (counted at trace build).
"""

from __future__ import annotations

import numpy as np

from ..proof.air import Air, AirBuilder
from . import channels as ch

N_ROWS = 256


class BytesAir(Air):
    width = 1  # multiplicity column
    pre_width = 1  # the value column 0..255
    row_offsets = (0,)
    pre_offsets = (0,)
    max_constraint_degree = 3

    def preprocessed_columns(self, n: int) -> np.ndarray:
        if n != N_ROWS:
            raise ValueError(f"the bytes chip has {N_ROWS} rows, not {n}")
        return np.arange(n, dtype=np.uint64)[:, None]

    def eval(self, b: AirBuilder):
        b.receive(ch.RANGE8, [b.pre_local(0)], b.local(0))


def build_trace(byte_counts: np.ndarray) -> np.ndarray:
    """byte_counts: (256,) uint64 — how many times each value was sent."""
    if byte_counts.shape != (N_ROWS,):
        raise ValueError(f"expected {N_ROWS} counts, got {byte_counts.shape}")
    return byte_counts[:, None].astype(np.uint64)
