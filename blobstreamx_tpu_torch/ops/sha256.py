"""SHA-256 host part (numpy): constants, padding, message schedule and the
vectorized compression with round-trace export that the SHA-256 chip's
witness uses.

A copy of the numpy part of ``blobstreamx_tpu/ops/sha256.py``. The TPU's
batched SHA-256 kernel (``ops/pallas/sha256.py``) is off the prover's path
and is not ported here.
"""

from __future__ import annotations

import numpy as np

H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)

K = np.array(
    [0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
     0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
     0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
     0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
     0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
     0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
     0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
     0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
     0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
     0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
     0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2],
    dtype=np.uint32,
)


def pad_message(msg: bytes) -> np.ndarray:
    """FIPS-180-4 pad -> (n_blocks, 16) uint32 big-endian words."""
    length = len(msg)
    padded = bytearray(msg)
    padded.append(0x80)
    while len(padded) % 64 != 56:
        padded.append(0)
    padded += (8 * length).to_bytes(8, "big")
    arr = np.frombuffer(bytes(padded), dtype=">u4").astype(np.uint32)
    return arr.reshape(-1, 16)


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _shr(x: np.ndarray, n: int) -> np.ndarray:
    return x >> np.uint32(n)


def message_schedule(blocks: np.ndarray) -> np.ndarray:
    """(B, 16) -> (B, 64) expanded schedule w."""
    B = blocks.shape[0]
    w = np.zeros((B, 64), dtype=np.uint32)
    w[:, :16] = blocks
    for t in range(16, 64):
        s0 = _rotr(w[:, t - 15], 7) ^ _rotr(w[:, t - 15], 18) ^ _shr(w[:, t - 15], 3)
        s1 = _rotr(w[:, t - 2], 17) ^ _rotr(w[:, t - 2], 19) ^ _shr(w[:, t - 2], 10)
        w[:, t] = w[:, t - 16] + s0 + w[:, t - 7] + s1
    return w


def compress_blocks(blocks: np.ndarray, state_in: np.ndarray, trace: bool = False):
    """Vectorized compression.

    blocks: (B, 16) uint32; state_in: (B, 8) uint32.
    Returns state_out (B, 8); if trace, also a dict with per-round arrays:
      w (B, 64), state (B, 65, 8) where state[:, t] is (a..h) *before* round t.
    """
    blocks = np.ascontiguousarray(blocks, dtype=np.uint32)
    state_in = np.ascontiguousarray(state_in, dtype=np.uint32)
    B = blocks.shape[0]
    w = message_schedule(blocks)
    vars_ = [state_in[:, i].copy() for i in range(8)]
    states = np.zeros((B, 65, 8), dtype=np.uint32) if trace else None
    for t in range(64):
        a, b, c, d, e, f, g, h = vars_
        if trace:
            states[:, t] = np.stack(vars_, axis=1)
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + K[t] + w[:, t]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        vars_ = [t1 + t2, a, b, c, d + t1, e, f, g]
    if trace:
        states[:, 64] = np.stack(vars_, axis=1)
    state_out = np.stack(vars_, axis=1) + state_in
    if trace:
        return state_out, {"w": w, "state": states}
    return state_out
