"""The port's Poseidon (the CUDA kernel's plain version on the CPU), sponge,
Merkle caps and transcript against the JAX package's."""

import numpy as np
import pytest
import torch

from blobstreamx_tpu.field import goldilocks as jgl
from blobstreamx_tpu.ops import poseidon as jpos
from blobstreamx_tpu.proof import merkle_cap as jmerkle
from blobstreamx_tpu.proof import transcript as jtranscript
from blobstreamx_tpu_torch import convert
from blobstreamx_tpu_torch.field import goldilocks as gl
from blobstreamx_tpu_torch.ops import poseidon as pos
from blobstreamx_tpu_torch.proof import merkle_cap
from blobstreamx_tpu_torch.proof import transcript

torch.set_num_threads(1)


def field(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)


def same(port_out, ref_out) -> bool:
    return np.array_equal(gl.to_int(port_out), jgl.to_int(np.asarray(ref_out)))


def test_instance_constants_match_reference():
    assert pos.round_constants() == jpos.round_constants()
    assert pos.mds_matrix() == jpos.mds_matrix()


def test_permute_matches_reference_and_python():
    s = field(1, (6, 12))
    s[0] = 0
    s[1] = gl.P - 1
    got = pos.permute(convert.ints_to_tensor(s), device="cpu")
    assert same(got, jpos.permute(jgl.from_int(s)))
    for row, out in zip(s, gl.to_int(got)):
        assert [int(v) for v in out] == jpos.permute_py([int(v) for v in row])
        assert pos.permute_py([int(v) for v in row]) == [int(v) for v in out]


@pytest.mark.parametrize("width", [0, 1, 8, 9, 21])
def test_hash_no_pad_matches_reference(width):
    x = field(width + 10, (5, width))
    got = pos.hash_no_pad(convert.ints_to_tensor(x), device="cpu")
    assert same(got, jpos.hash_no_pad(jgl.from_int(x)))
    assert [int(v) for v in gl.to_int(got)[2]] == pos.hash_no_pad_py([int(v) for v in x[2]])


def test_hash_no_pad_reads_column_major_rows():
    """Merkle leaves are the rows of a (columns, rows) LDE, read in place."""
    cols = convert.ints_to_tensor(field(3, (11, 9)))
    assert torch.equal(pos.hash_no_pad(cols.t(), device="cpu"),
                       pos.hash_no_pad(cols.t().contiguous(), device="cpu"))


def test_hash_two_to_one_matches_reference():
    left, right = field(4, (7, 4)), field(5, (7, 4))
    got = pos.hash_two_to_one(convert.ints_to_tensor(left),
                              convert.ints_to_tensor(right), device="cpu")
    assert same(got, jpos.hash_two_to_one(jgl.from_int(left), jgl.from_int(right)))
    assert [int(v) for v in gl.to_int(got)[0]] == pos.hash_two_to_one_py(
        [int(v) for v in left[0]], [int(v) for v in right[0]])


@pytest.mark.parametrize("n,width,cap_height", [(16, 3, 0), (64, 10, 2), (256, 4, 1)])
def test_merkle_cap_and_openings_match_reference(n, width, cap_height):
    leaves = field(n + width, (n, width))
    tree = merkle_cap.build_tree(convert.ints_to_tensor(leaves), cap_height)
    ref = jmerkle.build_tree(jgl.from_int(leaves), cap_height)
    assert tree.cap_ints() == ref.cap_ints()
    assert len(tree.layers) == len(ref.layers)
    for mine, theirs in zip(tree.layers, ref.layers):
        assert np.array_equal(mine, jgl.to_int(theirs))
    for index in (0, 5, n - 1):
        siblings = tree.open(index)
        assert siblings == [[int(v) for v in jgl.to_int(s)] for s in ref.open(index)]
        row = [int(v) for v in leaves[index]]
        assert merkle_cap.verify_opening(row, index, siblings, tree.cap)
        row[0] = (row[0] + 1) % gl.P
        assert not merkle_cap.verify_opening(row, index, siblings, tree.cap)


def test_transcript_matches_reference():
    mine, theirs = transcript.Transcript(), jtranscript.Transcript()
    values = [int(v) for v in field(6, 21)]
    for t in (mine, theirs):
        t.observe_elements(values[:13])
        t.observe_extension((values[13], values[14]))
    assert mine.get_extension_challenge() == theirs.get_extension_challenge()
    for t in (mine, theirs):
        t.observe_cap([values[15:19]])
    assert mine.get_indices(5, 10) == theirs.get_indices(5, 10)
    assert mine.fork().get_challenge() == theirs.fork().get_challenge()


def test_kernel_wrappers_take_only_card_tensors():
    with pytest.raises(ValueError):
        pos.permute_kernel(torch.zeros(2, 12, dtype=torch.int64))
    with pytest.raises(ValueError):
        pos.hash_no_pad_kernel(torch.zeros(2, 8, dtype=torch.int64))
