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


@pytest.mark.parametrize("log_n", range(1, 33))
def test_plan_covers_every_stage_once(log_n):
    """The passes the CUDA kernel runs: stages 0 .. log_n - 1 in order; one
    pass up to 2^12, two up to 2^20; every tile within shared memory and,
    above 2^12, read in whole 32-byte sectors (4 words or more)."""
    passes = ntt.plan(log_n)
    assert [s0 for s0, _, _ in passes] == [sum(k for _, k, _ in passes[:i])
                                           for i in range(len(passes))]
    assert sum(k for _, k, _ in passes) == log_n
    s0, k, g = passes[0]
    assert (s0, k, g) == ((0, log_n, 0) if log_n <= 12 else (0, 11, 2))
    assert len(passes) == (1 if log_n <= 12 else 1 + -(-(log_n - 11) // 9))
    for s0, k, w in passes[1:]:
        assert 1 <= k <= ntt.UPPER_STAGES and k + w == ntt.TILE_BITS and 3 <= w <= s0


def _rev(v, bits: int):
    v = np.asarray(v, dtype=np.int64)
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def ntt_by_plan(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """A model of csrc/ntt.cu's passes: each block's loads, butterflies and
    stores, with the kernel's index arithmetic, in plain field ops."""
    B, n = x.shape
    log_n = n.bit_length() - 1
    tw = ntt.twiddles(log_n, inverse, "cpu")
    passes = ntt.plan(log_n)
    out = torch.empty_like(x)
    _, k, g = passes[0]
    log_res = log_n - k
    i = np.arange(1 << k)
    b = np.arange(1 << g)
    for r0 in range(0, 1 << log_res, 1 << g):  # one block of the first pass
        sh = x[:, (_rev(i, k)[None, :] << log_res) + r0 + b[:, None]].clone()
        for s in range(k):
            m = 1 << s
            u = np.arange(1 << (k - 1))
            j = u & (m - 1)
            i0 = ((u >> s) << (s + 1)) | j
            a, c = sh[..., i0], gl.mul(sh[..., i0 + m], tw[m + j])
            sh[..., i0], sh[..., i0 + m] = gl.add(a, c), gl.sub(a, c)
        out[:, (_rev(r0 + b, log_res)[:, None] << k) + i[None, :]] = sh
    for s0, k, w in passes[1:]:
        mid, lo = np.arange(1 << k), np.arange(1 << w)
        for top in range(1 << (log_n - s0 - k)):
            for low0 in range(0, 1 << s0, 1 << w):  # one tile of an upper pass
                where = (top << (s0 + k)) + (mid[:, None] << s0) + low0 + lo[None, :]
                sh = out[:, where].clone()
                for q in range(k):
                    m = 1 << q
                    u = np.arange(1 << (k - 1))
                    jm = u & (m - 1)
                    mid0 = ((u >> q) << (q + 1)) | jm
                    w_idx = (1 << (s0 + q)) + (jm[:, None] << s0) + low0 + lo[None, :]
                    a, c = sh[:, mid0], gl.mul(sh[:, mid0 + m], tw[w_idx])
                    sh[:, mid0], sh[:, mid0 + m] = gl.add(a, c), gl.sub(a, c)
                out[:, where] = sh
    if inverse:
        out = gl.mul(out, gl.scalar(pow(n, gl.P - 2, gl.P), "cpu"))
    return out


@pytest.mark.parametrize("log_n", [5, 13, 14])
def test_plan_index_model_matches_plain(log_n):
    x = convert.ints_to_tensor(columns(log_n, 1 << log_n))
    for inverse in (False, True):
        assert torch.equal(ntt_by_plan(x, inverse), ntt.ntt_plain(x, inverse))


def test_upper_pass_twiddles_are_powers_of_the_root():
    """An upper pass reads tw[2^s + j] for j up to 2^s - 1 at every stage s
    above the first pass: w_{2^(s+1)}^j, here for n = 2^14."""
    log_n = 14
    for inverse in (False, True):
        tw = [int(v) for v in gl.to_int(ntt.twiddles(log_n, inverse, "cpu"))]
        for s in range(ntt.FIRST_STAGES, log_n):
            w = gl.primitive_root_of_unity(s + 1)
            if inverse:
                w = pow(w, gl.P - 2, gl.P)
            for j in (0, 1, (1 << s) // 3, (1 << s) - 1):
                assert tw[(1 << s) + j] == pow(w, j, gl.P)


def test_kernel_wrapper_takes_only_card_tensors():
    with pytest.raises(ValueError):
        ntt.ntt_kernel(torch.zeros(2, 16, dtype=torch.int64))
