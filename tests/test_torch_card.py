"""Each hand-written CUDA kernel of the port against its plain PyTorch
version on the card, exactly (integer arithmetic). Every test skips on a
host without a CUDA card: the kernels have no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX; ``tests/conftest.py`` imports JAX, so run
it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_card.py``."""

import hashlib

import numpy as np
import pytest
import torch

from blobstreamx_tpu_torch import convert
from blobstreamx_tpu_torch.field import goldilocks as gl
from blobstreamx_tpu_torch.field import ntt
from blobstreamx_tpu_torch.ops import poseidon as pos
from blobstreamx_tpu_torch.ops import sha256 as sha


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def field(seed: int, shape, dev) -> torch.Tensor:
    values = np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)
    return convert.ints_to_tensor(values, dev)


@pytest.mark.parametrize("log_n", [1, 4, 12, 13, 17, 20, 21, 22])
def test_ntt_kernel_matches_plain(card, log_n):
    x = field(log_n, (3, 1 << log_n), card)
    for inverse in (False, True):
        got = ntt.ntt_kernel(x, inverse)
        torch.cuda.synchronize()
        assert torch.equal(got, ntt.ntt_plain(x, inverse))


@pytest.mark.parametrize("batch", [1, 2048, 65537])
def test_poseidon_permute_kernel_matches_plain(card, batch):
    s = field(batch, (batch, pos.WIDTH), card)
    got = pos.permute_kernel(s)
    torch.cuda.synchronize()
    assert torch.equal(got, pos.permute_plain(s))


@pytest.mark.parametrize("rows,width,col_major", [(4096, 111, True), (2048, 8, False),
                                                  (300, 21, True), (1 << 20, 5, True),
                                                  (1 << 20, 38, True)])
def test_poseidon_hash_no_pad_kernel_matches_plain(card, rows, width, col_major):
    m = field(rows + width, (width, rows) if col_major else (rows, width), card)
    leaves = m.t() if col_major else m
    got = pos.hash_no_pad_kernel(leaves)
    torch.cuda.synchronize()
    assert torch.equal(got, pos.hash_no_pad_plain(leaves))


@pytest.mark.parametrize("B,L", [(1 << 15, 64), (130, 55), (64, 150), (1100, 64)])
def test_sha256_kernel_matches_plain_and_hashlib(card, B, L):
    msgs = np.random.default_rng(B + L).integers(0, 256, size=(B, L), dtype=np.uint8)
    x = torch.from_numpy(msgs).to(card)
    got = sha.sha256_fixed_len_kernel(x)
    torch.cuda.synchronize()
    assert torch.equal(got, sha.sha256_fixed_len_plain(x))
    host = got.cpu().numpy()
    for i in (0, B // 2, B - 1):
        assert bytes(host[i]) == hashlib.sha256(msgs[i].tobytes()).digest()
