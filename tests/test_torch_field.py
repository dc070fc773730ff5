"""The port's Goldilocks and GF(p^2) arithmetic against the JAX package's,
element for element, on seeded inputs with edge values; and the converters."""

import numpy as np
import pytest
import torch

from blobstreamx_tpu.field import extension as jext
from blobstreamx_tpu.field import goldilocks as jgl
from blobstreamx_tpu_torch import convert
from blobstreamx_tpu_torch.field import extension as ext
from blobstreamx_tpu_torch.field import goldilocks as gl

torch.set_num_threads(1)

P = gl.P
EDGE = [0, 1, P - 1, P - 2, 1 << 63, (1 << 32) + 1, (1 << 32) - 1, 1 << 32,
        (1 << 63) - 1, (1 << 64) - (1 << 32)]


def operands(seed: int, n: int = 64):
    """Every pair of edge values, then seeded random pairs: (a, b) as numpy
    uint64."""
    rng = np.random.default_rng(seed)
    a = [x for x in EDGE for _ in EDGE]
    b = [y for _ in EDGE for y in EDGE]
    a = np.array(a + list(rng.integers(0, P, size=n, dtype=np.uint64)), dtype=np.uint64)
    b = np.array(b + list(rng.integers(0, P, size=n, dtype=np.uint64)), dtype=np.uint64)
    return a, b


def port(values):
    return convert.ints_to_tensor(values)


def ref(values):
    return jgl.from_int(values)


def same(port_out, ref_out):
    return np.array_equal(gl.to_int(port_out), jgl.to_int(np.asarray(ref_out)))


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_reference(name):
    a, b = operands(1)
    got = getattr(gl, name)(port(a), port(b))
    want = getattr(jgl, name)(ref(a), ref(b))
    assert same(got, want)


@pytest.mark.parametrize("name", ["neg", "square"])
def test_unary_ops_match_reference(name):
    a, _ = operands(2)
    assert same(getattr(gl, name)(port(a)), getattr(jgl, name)(ref(a)))


@pytest.mark.parametrize("e", [0, 1, 7, (1 << 64) - 3])
def test_pow_matches_reference(e):
    a, _ = operands(3, n=16)
    assert same(gl.pow_const(port(a), e), jgl.pow_const(ref(a), e))


def test_inv_matches_reference():
    a, _ = operands(4, n=16)
    a = a[a != 0]
    got = gl.inv(port(a))
    assert same(got, jgl.inv(ref(a)))
    assert np.all(gl.to_int(gl.mul(got, port(a))) == 1)


def test_sum_is_field_sum():
    rng = np.random.default_rng(5)
    x = rng.integers(0, P, size=(7, 300), dtype=np.uint64)
    got = gl.to_int(gl.sum(port(x), 1))
    assert [int(v) for v in got] == [sum(int(v) for v in row) % P for row in x]


@pytest.mark.parametrize("bits", [0, 1, 4, 12, 19, 32])
def test_primitive_root_matches_reference(bits):
    assert gl.primitive_root_of_unity(bits) == jgl.primitive_root_of_unity(bits)


def ext_operands(seed: int):
    a, b = operands(seed, n=32)
    return a.reshape(-1, 2), b.reshape(-1, 2)


def port_ext(pairs):
    return port(pairs)


def ref_ext(pairs):
    return jext.from_int_pair(pairs[:, 0], pairs[:, 1])


def same_ext(port_out, ref_out):
    c0, c1 = jext.to_int_pair(ref_out)
    return np.array_equal(gl.to_int(port_out), np.stack([c0, c1], axis=-1))


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_extension_binary_ops_match_reference(name):
    a, b = ext_operands(6)
    got = getattr(ext, name)(port_ext(a), port_ext(b))
    assert same_ext(got, getattr(jext, name)(ref_ext(a), ref_ext(b)))


def test_extension_inv_and_scalar_mul_match_reference():
    a, b = ext_operands(7)
    a = a[(a[:, 0] != 0) | (a[:, 1] != 0)]
    assert same_ext(ext.inv(port_ext(a)), jext.inv(ref_ext(a)))
    s = b[: len(a), 0]
    assert same_ext(ext.scalar_mul(port_ext(a), port(s)),
                    jext.scalar_mul(ref_ext(a), ref(s)))


def test_extension_prefix_sum_is_running_sum():
    rng = np.random.default_rng(8)
    x = rng.integers(0, P, size=(37, 2), dtype=np.uint64)
    got = gl.to_int(ext.prefix_sum(port(x)))
    acc = (0, 0)
    for i in range(37):
        acc = ext.GFp2.add(acc, (int(x[i, 0]), int(x[i, 1])))
        assert (int(got[i, 0]), int(got[i, 1])) == acc


def test_converters_round_trip_reference_limbs():
    a, _ = operands(9)
    limbs = np.asarray(jgl.from_int(a))  # (n, 2) uint32 from the reference
    t = convert.limbs_to_tensor(limbs)
    assert np.array_equal(gl.to_int(t), a)
    assert np.array_equal(convert.tensor_to_limbs(t), limbs)
    assert torch.equal(convert.ints_to_tensor([int(v) for v in a]), t)


def test_port_imports_no_jax():
    """The port runs on a machine without JAX: no source line imports jax
    or the JAX package, and importing every module loads neither."""
    import pathlib
    import re
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|blobstreamx_tpu)\b", re.M)
    package = root / "blobstreamx_tpu_torch"
    files = sorted(f for f in package.rglob("*.py")
                   if f.relative_to(package).parts[0] != "build") + [root / "chip_smoke.py"]
    assert [str(f) for f in files if pattern.search(f.read_text())] == []
    modules = ["blobstreamx_tpu_torch." + ".".join(f.relative_to(root / "blobstreamx_tpu_torch")
                                                   .with_suffix("").parts)
               for f in files[:-1] if f.name != "__init__.py"] + ["chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'blobstreamx_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_missing_card():
    """device=None means the card; without one the port raises instead of
    moving to the CPU."""
    from blobstreamx_tpu_torch import device

    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            device.resolve(None)
    assert device.resolve("cpu").type == "cpu"
