"""The port's Goldilocks and GF(p^2) arithmetic against the JAX package's,
element for element, on seeded inputs with edge values; and the converters."""

import os

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
    """The port runs on a machine without JAX: no import statement of the
    package or of chip_smoke.py, at any depth (chip_smoke imports inside its
    phases), names jax or the JAX package, and importing every module of
    the package and every module chip_smoke.py names loads neither."""
    import ast
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    package = root / "blobstreamx_tpu_torch"
    files = sorted(f for f in package.rglob("*.py")
                   if f.relative_to(package).parts[0] != "build") + [root / "chip_smoke.py"]
    modules = {"chip_smoke"}
    for f in files:
        parts = ((f.relative_to(root).with_suffix("").parts) if f.parent != root
                 else (f.stem,))
        if f.name == "__init__.py":
            parts = parts[:-1]
        modules.add(".".join(parts))
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: inside the package
                    base = parts[:len(parts) - node.level + (f.name == "__init__.py")]
                    names = [".".join(base + ((node.module,) if node.module else ()))]
                else:
                    names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "blobstreamx_tpu"), \
                    f"{f.relative_to(root)} imports {name}"
                if name.split(".")[0] == "blobstreamx_tpu_torch":
                    modules.add(name)
    for new in ("frontend.builder", "frontend.witness", "circuits.map_job",
                "circuits.data_commitment", "circuits.input", "chips.cpu",
                "tendermint.header", "tendermint.merkle", "field.goldilocks_host",
                "testing.reference_digests", "ops.sha256"):
        assert "blobstreamx_tpu_torch." + new in modules
    code = ("import importlib, sys\n"
            f"for m in {sorted(modules)!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'blobstreamx_tpu')))")
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


def _entry_point_calls():
    """Each public function of the port that takes ``device``, called with
    the default (None: the card) on a small input."""
    from blobstreamx_tpu_torch.chips import bytes as bytes_chip
    from blobstreamx_tpu_torch.chips import poseidon as pos_chip
    from blobstreamx_tpu_torch.circuits import data_commitment, header_range, input, map_job
    from blobstreamx_tpu_torch.circuits import next_header
    from blobstreamx_tpu_torch.circuits.aggregate import ReduceCircuit
    from blobstreamx_tpu_torch.field import ntt
    from blobstreamx_tpu_torch.frontend import builder
    from blobstreamx_tpu_torch.ops import poseidon, sha256
    from blobstreamx_tpu_torch.parallel.mapreduce import MapReduceProver
    from blobstreamx_tpu_torch.proof import recursion, stark, system

    cfg = stark.StarkConfig(rate_bits=2, cap_height=0, num_query_rounds=1, pow_bits=0,
                            final_poly_bits=1)
    air = bytes_chip.BytesAir()
    spec = system.TableSpec("bytes", air, bytes_chip.build_trace(
        np.zeros(256, dtype=np.uint64)), [])
    b = builder.CircuitBuilder()
    b.evm_write_bytes32(b.evm_read_bytes32())
    circuit = b.build()
    pb = builder.CircuitBuilder()
    pb.pos_read(pb.pos_perm(pb.pos_new_chain(), 0, {0: pb.constant(1).wire}), 0)
    pos_circuit = pb.build()
    fixtures = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "blobstreamx_tpu", "fixtures", "mocha-4")
    return {
        "ntt.ntt": lambda: ntt.ntt(np.zeros(4, dtype=np.uint64)),
        "ntt.lde": lambda: ntt.lde(np.zeros(4, dtype=np.uint64), 1),
        "ntt.interpolate_coeffs": lambda: ntt.interpolate_coeffs(np.zeros(4, dtype=np.uint64)),
        "poseidon.permute": lambda: poseidon.permute(np.zeros(12, dtype=np.uint64)),
        "poseidon.hash_no_pad": lambda: poseidon.hash_no_pad(np.zeros(8, dtype=np.uint64)),
        "poseidon.hash_two_to_one": lambda: poseidon.hash_two_to_one(
            np.zeros(4, dtype=np.uint64), np.zeros(4, dtype=np.uint64)),
        "sha256.sha256_fixed_len": lambda: sha256.sha256_fixed_len(
            np.zeros((1, 4), dtype=np.uint8)),
        "sha256.sha256_fixed_len(cpu tensor)": lambda: sha256.sha256_fixed_len(
            torch.zeros((1, 4), dtype=torch.uint8)),
        "sha256.sha256_fixed_len(cpu tensor, cuda)": lambda: sha256.sha256_fixed_len(
            torch.zeros((1, 4), dtype=torch.uint8), device="cuda"),
        "stark.build": lambda: stark.build(air, 256, cfg),
        "system.prove_system": lambda: system.prove_system([spec], cfg),
        "system.verify_system": lambda: system.verify_system(
            [air], [[]], system.SystemProof([], []), cfg),
        "system.check_bus_balance": lambda: system.check_bus_balance([spec]),
        "CompiledCircuit.prove": lambda: circuit.prove({}, cfg),
        "CompiledCircuit.verify": lambda: circuit.verify(None, [0] * 64, cfg),
        "CompiledCircuit.build_keys": lambda: circuit.build_keys(cfg),
        "DataCommitmentCircuit.prove": lambda: data_commitment.DataCommitmentCircuit(
            2, input.InputDataFetcher(fixtures)).prove(10000, 10002, cfg),
        "SubchainMapCircuit.prove": lambda: map_job.SubchainMapCircuit(
            2, input.InputDataFetcher(fixtures)).prove(10000, 10004, bytes(32), cfg),
        "NextHeaderCircuit.prove": lambda: next_header.NextHeaderCircuit(
            vss=2, fetcher=input.StepInputFetcher(fixtures)).prove(10000, cfg),
        "NextHeaderCircuit.build_keys": lambda: next_header.NextHeaderCircuit(
            vss=2, fetcher=input.StepInputFetcher(fixtures)).build_keys(cfg),
        "HeaderRangeCircuit.prove": lambda: header_range.HeaderRangeCircuit(
            vss=2, fetcher=input.SkipInputFetcher(fixtures)).prove(10000, 10004, cfg),
        "HeaderRangeCircuit.build_keys": lambda: header_range.HeaderRangeCircuit(
            vss=2, fetcher=input.SkipInputFetcher(fixtures)).build_keys(cfg),
        "poseidon_chip.permute_capture": lambda: pos_chip.permute_capture(
            np.zeros((1, 12), dtype=np.uint64)),
        "poseidon_chip.build_trace": lambda: pos_chip.build_trace(
            pos_chip.pad_schedule([], 16), {}, {}, {}),
        "CompiledCircuit.traces(pos table)": lambda: pos_circuit.traces(
            pos_circuit.generate_witness({})),
        "recursion.inner_shapes": lambda: recursion.inner_shapes(circuit, cfg),
        "ReduceCircuit": lambda: ReduceCircuit(circuit, 2, cfg),
        "ReduceCircuit.prove": lambda: ReduceCircuit(circuit, 2, cfg, device="cpu").prove(
            10000, 10004, bytes(32), (None, []), (None, []), cfg),
        "ReduceCircuit.build_keys": lambda: ReduceCircuit(
            circuit, 2, cfg, device="cpu").build_keys(cfg),
        "MapReduceProver.prove_succinct": lambda: MapReduceProver(
            2, 2, input.InputDataFetcher(fixtures), cfg, succinct=True).prove_succinct(
            10000, 10004),
    }


ENTRY_POINTS = ["ntt.ntt", "ntt.lde", "ntt.interpolate_coeffs", "poseidon.permute",
                "poseidon.hash_no_pad", "poseidon.hash_two_to_one",
                "sha256.sha256_fixed_len", "sha256.sha256_fixed_len(cpu tensor)",
                "sha256.sha256_fixed_len(cpu tensor, cuda)", "stark.build", "system.prove_system",
                "system.verify_system", "system.check_bus_balance",
                "CompiledCircuit.prove", "CompiledCircuit.verify",
                "CompiledCircuit.build_keys", "DataCommitmentCircuit.prove",
                "SubchainMapCircuit.prove", "NextHeaderCircuit.prove",
                "NextHeaderCircuit.build_keys", "HeaderRangeCircuit.prove",
                "HeaderRangeCircuit.build_keys", "poseidon_chip.permute_capture",
                "poseidon_chip.build_trace", "CompiledCircuit.traces(pos table)",
                "recursion.inner_shapes", "ReduceCircuit", "ReduceCircuit.prove",
                "ReduceCircuit.build_keys", "MapReduceProver.prove_succinct"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_raises_without_a_card(name):
    """Called without ``device``, every entry point asks for the card and
    raises where there is none; none runs on the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    calls = _entry_point_calls()
    assert sorted(calls) == sorted(ENTRY_POINTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()
