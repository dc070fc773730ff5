"""16-bit range-check chip: a 65536-row table receiving RANGE16 bus messages.

The port's copy of ``blobstreamx_tpu/chips/range16.py``.

The Ed25519 EC chip's field-element limbs (16-bit) and carry decompositions
send their values here; bus balance forces them into [0, 2^16). Mirrors the
bytes chip (chips/bytes.py) one size up.
"""

from __future__ import annotations

import numpy as np

from ..proof.air import Air, AirBuilder
from . import channels as ch

N_ROWS = 1 << 16


class Range16Air(Air):
    width = 1  # multiplicity column
    pre_width = 1  # the value column 0..65535
    row_offsets = (0,)
    pre_offsets = (0,)
    max_constraint_degree = 3

    def preprocessed_columns(self, n: int) -> np.ndarray:
        assert n == N_ROWS
        return np.arange(n, dtype=np.uint64)[:, None]

    def eval(self, b: AirBuilder):
        b.receive(ch.RANGE16, [b.pre_local(0)], b.local(0))


def build_trace(counts: np.ndarray) -> np.ndarray:
    """counts: (65536,) uint64 — how many times each value was sent."""
    assert counts.shape == (N_ROWS,)
    return counts[:, None].astype(np.uint64)
