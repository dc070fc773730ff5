"""Fiat-Shamir transcript (Poseidon duplex challenger), host-side.

Counterpart of ``blobstreamx_tpu/proof/transcript.py``: python ints and the
python-int permutation, replayed identically by prover and verifier.
"""

from __future__ import annotations

from typing import List, Sequence

from ..field import goldilocks as gl
from ..ops import poseidon as pos


class Transcript:
    def __init__(self):
        self.state = [0] * pos.WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    # -- observing ---------------------------------------------------------

    def observe_element(self, x: int):
        if not 0 <= x < gl.P:
            raise ValueError("transcript element out of range")
        self.output_buffer.clear()
        self.input_buffer.append(x)
        if len(self.input_buffer) == pos.RATE:
            self._duplex()

    def observe_elements(self, xs: Sequence[int]):
        for x in xs:
            self.observe_element(int(x))

    def observe_extension(self, x):
        self.observe_element(int(x[0]))
        self.observe_element(int(x[1]))

    def observe_digest(self, digest: Sequence[int]):
        self.observe_elements(digest)

    def observe_cap(self, cap: Sequence[Sequence[int]]):
        for digest in cap:
            self.observe_digest(digest)

    # -- challenges --------------------------------------------------------

    def _duplex(self):
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = pos.permute_py(self.state)
        self.output_buffer[:] = self.state[: pos.RATE]

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_extension_challenge(self):
        return (self.get_challenge(), self.get_challenge())

    def get_indices(self, n: int, domain_bits: int) -> List[int]:
        """n query indices in [0, 2^domain_bits) (64-bit challenge mod 2^k)."""
        return [self.get_challenge() & ((1 << domain_bits) - 1) for _ in range(n)]

    def fork(self) -> "Transcript":
        t = Transcript()
        t.state = list(self.state)
        t.input_buffer = list(self.input_buffer)
        t.output_buffer = list(self.output_buffer)
        return t
