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


def permute_sparse_py(state: list) -> list:
    """The permutation in the sparse form the CUDA kernel runs, in python
    ints, fed from the constants that are handed to the kernel."""
    P = gl.P
    sc = pos.sparse_constants()
    mds = pos.mds_matrix()
    s = list(state)

    def full_round(r):
        t = [pow((x + c) % P, pos.SBOX_EXP, P) for x, c in zip(s, sc.full[r])]
        return [sum(m * x for m, x in zip(row, t)) % P for row in mds]

    half = pos.FULL_ROUNDS // 2
    for r in range(half):
        s = full_round(r)
    s = [(x + c) % P for x, c in zip(s, sc.first)]
    s = [s[0]] + [sum(m * x for m, x in zip(row, s[1:])) % P for row in sc.init]
    for k in range(pos.PARTIAL_ROUNDS):
        s0 = (pow(s[0], pos.SBOX_EXP, P) + sc.scalars[k]) % P
        s = [s0] + s[1:]
        new0 = sum(m * x for m, x in zip(sc.rows[k], s)) % P
        s = [new0] + [(x + v * s0) % P for x, v in zip(s[1:], sc.cols[k])]
    for r in range(half, pos.FULL_ROUNDS):
        s = full_round(r)
    return s


def sparse_test_states(seed: int = 11) -> np.ndarray:
    """64 states from the seed, the all-zero state and the all-(p-1) state."""
    s = field(seed, (66, 12))
    s[64] = 0
    s[65] = gl.P - 1
    return s


def test_sparse_form_matches_permute_py():
    """The sparse form (this model, and permute_py, which runs it) against
    the instance's round-by-round definition."""
    for row in sparse_test_states():
        ints = [int(v) for v in row]
        assert permute_sparse_py(ints) == pos.permute_py_rounds(ints) == pos.permute_py(ints)


def test_sparse_form_matches_reference_permute():
    """Against the JAX package's permute (its plain path at this batch)."""
    s = sparse_test_states()
    ref = jgl.to_int(np.asarray(jpos.permute(jgl.from_int(s))))
    for row, want in zip(s, ref):
        assert permute_sparse_py([int(v) for v in row]) == [int(v) for v in want]


def test_kernel_constants_shapes_and_range():
    """What bsx_poseidon_set_constants copies: shapes in its order,
    contiguous uint64, canonical (< p); the partial rounds' constants are
    the sparse form's, the last scalar 0, and the full rounds' constants
    are rounds 0-3 and 26-29 of the instance."""
    arrays = pos.kernel_constants()
    shapes = [(8, 12), (12,), (22,), (22, 11), (12, 12), (11, 11), (22, 12)]
    assert [a.shape for a in arrays] == shapes
    for a in arrays:
        assert a.dtype == np.uint64 and a.flags["C_CONTIGUOUS"]
        assert int(a.max()) < gl.P
    full, first, scalars, cols, mds, init, rows = arrays
    rc = np.array(pos.round_constants(), dtype=np.uint64).reshape(30, 12)
    assert np.array_equal(full, np.concatenate([rc[:4], rc[26:]]))
    assert np.array_equal(mds, np.array(pos.mds_matrix(), dtype=np.uint64))
    sc = pos.sparse_constants()
    assert np.array_equal(first, np.array(sc.first, dtype=np.uint64))
    assert np.array_equal(init, np.array(sc.init, dtype=np.uint64))
    assert np.array_equal(rows, np.array(sc.rows, dtype=np.uint64))
    assert np.array_equal(cols, np.array(sc.cols, dtype=np.uint64))
    assert int(scalars[-1]) == 0 and np.array_equal(scalars, np.array(sc.scalars, dtype=np.uint64))
    # every sparse round's row keeps M[0][0]; the last round's matrix is M's
    # own factor, so its column is M's column 0
    m = pos.mds_matrix()
    assert all(r[0] == m[0][0] for r in sc.rows)
    assert list(sc.cols[-1]) == [m[i][0] for i in range(1, 12)]


def test_kernel_wrappers_take_only_card_tensors():
    with pytest.raises(ValueError):
        pos.permute_kernel(torch.zeros(2, 12, dtype=torch.int64))
    with pytest.raises(ValueError):
        pos.hash_no_pad_kernel(torch.zeros(2, 8, dtype=torch.int64))
