"""SHA-256: the numpy host part and the batched fixed-length hash.

The numpy part (constants, padding, message schedule and the vectorized
compression with round-trace export) is a copy of that of
``blobstreamx_tpu/ops/sha256.py``; the SHA-256 chip's trace and the
witness engine use it.

``sha256_fixed_len`` hashes B messages of one length L, (B, L) uint8 ->
(B, 32) uint8, as ``blobstreamx_tpu/ops/sha256.py:sha256_fixed_len`` does.
For a tensor on the card it launches the CUDA kernel (``csrc/sha256.cu``,
which replaces the TPU kernel ``ops/pallas/sha256.py``); for one on the
CPU it runs ``sha256_fixed_len_plain``. The plain version works on int64
masked to 32 bits, since PyTorch on the CPU has no shifts, adds or
comparisons for uint32.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .. import device as devmod
from .. import kernels

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


def padding(length: int) -> bytes:
    """The FIPS 180-4 padding of a message of ``length`` bytes: 0x80, zeros
    to 56 mod 64, then the bit length as 8 big-endian bytes."""
    return b"\x80" + bytes((55 - length) % 64) + (8 * length).to_bytes(8, "big")


def pad_message(msg: bytes) -> np.ndarray:
    """FIPS-180-4 pad -> (n_blocks, 16) uint32 big-endian words."""
    padded = bytes(msg) + padding(len(msg))
    arr = np.frombuffer(padded, dtype=">u4").astype(np.uint32)
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


# ---------------------------------------------------------------------------
# batched fixed-length hashing
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotr32(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def sha256_fixed_len_plain(msgs: torch.Tensor) -> torch.Tensor:
    """(B, L) uint8 -> (B, 32) uint8 in plain PyTorch, on any device.
    Words are int64 in [0, 2^32): every add and left shift is masked."""
    if msgs.dtype != torch.uint8 or msgs.dim() != 2:
        raise ValueError(f"expected (B, L) uint8 messages, got {tuple(msgs.shape)} {msgs.dtype}")
    B, L = msgs.shape
    dev = msgs.device
    pad = torch.tensor(list(padding(L)), dtype=torch.int64, device=dev)
    padded = torch.cat([msgs.to(torch.int64), pad.expand(B, -1)], dim=1)
    b4 = padded.reshape(B, -1, 4)
    words = (b4[..., 0] << 24) | (b4[..., 1] << 16) | (b4[..., 2] << 8) | b4[..., 3]
    k = [int(v) for v in K]
    state = [torch.full((B,), int(h), dtype=torch.int64, device=dev) for h in H0]
    for blk in range(words.shape[1] // 16):
        w = list(words[:, 16 * blk:16 * blk + 16].unbind(1))
        for t in range(16, 64):
            s0 = _rotr32(w[t - 15], 7) ^ _rotr32(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr32(w[t - 2], 17) ^ _rotr32(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
        a, b, c, d, e, f, g, h = state
        for t in range(64):
            S1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
            ch = (e & f) ^ ((e ^ _M32) & g)
            t1 = (h + S1 + ch + k[t] + w[t]) & _M32
            S0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            a, b, c, d, e, f, g, h = (t1 + S0 + maj) & _M32, a, b, c, (d + t1) & _M32, e, f, g
        state = [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]
    st = torch.stack(state, dim=1)  # (B, 8)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=dev)
    return ((st[..., None] >> shifts) & 0xFF).reshape(B, 32).to(torch.uint8)


def sha256_fixed_len_kernel(msgs: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (csrc/sha256.cu) on (B, L) uint8 messages on the card."""
    if not msgs.is_cuda:
        raise ValueError("sha256_fixed_len_kernel takes a CUDA tensor")
    if msgs.dtype != torch.uint8 or msgs.dim() != 2:
        raise ValueError(f"expected (B, L) uint8 messages, got {tuple(msgs.shape)} {msgs.dtype}")
    msgs = msgs.contiguous()
    B, L = msgs.shape
    out = torch.empty((B, 32), dtype=torch.uint8, device=msgs.device)
    with torch.cuda.device(msgs.device):
        rc = kernels.lib("sha256").bsx_sha256_fixed_len(
            msgs.data_ptr(), out.data_ptr(), B, L,
            torch.cuda.current_stream(msgs.device).cuda_stream)
    kernels.check(rc, "bsx_sha256_fixed_len")
    sha256_fixed_len_kernel.launches += 1
    sha256_fixed_len_kernel.calls[tuple(msgs.shape)] += 1
    return out


# launches, and launches by shape
sha256_fixed_len_kernel.launches = 0
sha256_fixed_len_kernel.calls = collections.Counter()


def sha256_fixed_len(msgs, device=None) -> torch.Tensor:
    """Batch-hash equal-length messages: (B, L) uint8 -> (B, 32) uint8.

    The messages (a tensor, a numpy array or nested ints) go to ``device``
    first, where None is the card: there the kernel runs, and with
    ``device="cpu"`` the plain version."""
    dev = devmod.resolve(device)
    if isinstance(msgs, torch.Tensor):
        x = msgs.to(dev)
    else:
        x = torch.as_tensor(np.ascontiguousarray(msgs, dtype=np.uint8), device=dev)
    return sha256_fixed_len_kernel(x) if x.is_cuda else sha256_fixed_len_plain(x)
