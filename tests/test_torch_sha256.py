"""The port's batched SHA-256 (``ops/sha256.sha256_fixed_len``) against the
JAX package's function of the same name, which the TPU kernel is a drop-in
for (run here on its numpy path), and against hashlib. The CUDA kernel
itself is compared with the plain version only where a card is present."""

import hashlib

import numpy as np
import pytest
import torch

from blobstreamx_tpu.ops import sha256 as jsha
from blobstreamx_tpu_torch.ops import sha256 as sha

torch.set_num_threads(1)


def messages(B: int, L: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(B, L), dtype=np.uint8)


def hashlib_digests(msgs: np.ndarray) -> np.ndarray:
    return np.array([list(hashlib.sha256(m.tobytes()).digest()) for m in msgs],
                    dtype=np.uint8).reshape(len(msgs), 32)


@pytest.mark.parametrize("L", [55, 64, 150])
def test_plain_matches_reference_and_hashlib(L):
    msgs = messages(97, L, seed=L)
    got = sha.sha256_fixed_len(torch.from_numpy(msgs), device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (97, 32) and not got.is_cuda
    assert np.array_equal(got.numpy(), jsha.sha256_fixed_len(msgs))
    assert np.array_equal(got.numpy(), hashlib_digests(msgs))


@pytest.mark.parametrize("B,L", [(1, 0), (3, 56), (5, 119), (4, 120), (2, 1000)])
def test_plain_padding_edges(B, L):
    """Lengths where the padding adds a block, fills one exactly, or spans
    many blocks."""
    msgs = messages(B, L, seed=B + L)
    got = sha.sha256_fixed_len(msgs, device="cpu")
    assert not got.is_cuda
    assert np.array_equal(got.numpy(), hashlib_digests(msgs))


def test_cpu_tensor_with_device_cpu_matches_hashlib():
    """A uint8 tensor given ``device="cpu"`` is hashed by the plain version
    on the CPU; without it (None: the card) it would go to the card."""
    msgs = messages(33, 65, seed=65)
    x = torch.from_numpy(msgs)
    got = sha.sha256_fixed_len(x, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), hashlib_digests(msgs))
    assert torch.equal(x, torch.from_numpy(msgs))  # the input is left as it was


def test_kernel_refuses_cpu_tensors_and_bad_input():
    with pytest.raises(ValueError):
        sha.sha256_fixed_len_kernel(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        sha.sha256_fixed_len_plain(torch.zeros((2, 4), dtype=torch.int64))
