"""The port's NTT, coset shift and LDE (the CUDA kernel's plain version on
the CPU) against the JAX package's, element for element."""

import numpy as np
import pytest
import torch

from blobstreamx_tpu.field import goldilocks as jgl
from blobstreamx_tpu.field import ntt as jntt
from blobstreamx_tpu_torch import convert
from blobstreamx_tpu_torch.field import goldilocks as gl
from blobstreamx_tpu_torch.field import ntt

torch.set_num_threads(1)

SIZES = [16, 256, 4096]


def columns(seed: int, n: int, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, gl.P, size=(batch, n), dtype=np.uint64)


def same(port_out, ref_out) -> bool:
    return np.array_equal(gl.to_int(port_out), jgl.to_int(np.asarray(ref_out)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_ntt_matches_reference(n, inverse):
    x = columns(n, n)
    got = ntt.ntt(convert.ints_to_tensor(x), inverse, device="cpu")
    assert same(got, jntt.ntt(jgl.from_int(x), inverse=inverse))


@pytest.mark.parametrize("n", SIZES)
def test_coset_shift_matches_reference(n):
    x = columns(n + 1, n)
    got = ntt.coset_shift(convert.ints_to_tensor(x), gl.GENERATOR)
    assert same(got, jntt.coset_shift(jgl.from_int(x), gl.GENERATOR))


@pytest.mark.parametrize("n,rate_bits", [(16, 3), (256, 3), (4096, 1)])
def test_lde_matches_reference(n, rate_bits):
    x = columns(n + 2, n)
    got = ntt.lde(convert.ints_to_tensor(x), rate_bits, device="cpu")
    assert same(got, jntt.lde(jgl.from_int(x), rate_bits))


def test_interpolate_and_eval_match_reference():
    from blobstreamx_tpu.field import extension as jext

    x = columns(3, 64)
    coeffs = ntt.interpolate_coeffs(convert.ints_to_tensor(x), device="cpu")
    ref_coeffs = jntt.interpolate_coeffs(jgl.from_int(x))
    assert same(coeffs, ref_coeffs)
    z = (123456789, 987654321)
    got = gl.to_int(ntt.eval_poly_ext(coeffs, z))
    c0, c1 = jext.to_int_pair(jntt.eval_poly_ext(ref_coeffs, jext.from_int_pair(*z)))
    assert np.array_equal(got, np.stack([c0, c1], axis=-1))


def test_ntt_matches_pallas_kernel_in_interpret_mode():
    """The TPU kernel this port's CUDA NTT replaces, run as its own tests
    run it on the CPU."""
    from blobstreamx_tpu.ops.pallas import ntt as pntt

    x = columns(7, 256, batch=3)
    for inverse in (False, True):
        want = pntt.ntt(jgl.from_int(x), inverse, interpret=True)
        assert same(ntt.ntt(convert.ints_to_tensor(x), inverse, device="cpu"), want)


def test_twiddle_table_layout():
    """tw[m + j] = w_{2m}^j: the table both the kernel and the plain
    version read stage s (m = 2^s) from."""
    log_n = 5
    tw = [int(v) for v in gl.to_int(ntt.twiddles(log_n, False, "cpu"))]
    for s in range(log_n):
        m = 1 << s
        w = gl.primitive_root_of_unity(s + 1)
        assert tw[m:2 * m] == [pow(w, j, gl.P) for j in range(m)]


def test_kernel_wrapper_takes_only_card_tensors():
    with pytest.raises(ValueError):
        ntt.ntt_kernel(torch.zeros(2, 16, dtype=torch.int64))
