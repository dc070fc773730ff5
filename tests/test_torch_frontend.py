"""The port's circuit layer against the JAX package's, on the recorded
mocha-4 fixtures, exactly (integer field arithmetic): Tendermint headers
and Merkle trees, the circuit builder's rows, the cpu table's preprocessed
columns, the batched witness engine (and its sequential oracle), every
table's trace, the public values, the data root against the fixture and
the port's bus balance. Nothing here proves: a prove on the CPU takes
minutes (tests/test_torch_circuits.py, marked slow)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from blobstreamx_tpu.circuits import data_commitment as jdc
from blobstreamx_tpu.circuits import input as jinput
from blobstreamx_tpu.circuits import map_job as jmap
from blobstreamx_tpu.field import extension as jext
from blobstreamx_tpu.frontend import builder as jbuilder
from blobstreamx_tpu.tendermint import header as jheader
from blobstreamx_tpu.tendermint import merkle as jmerkle
from blobstreamx_tpu_torch.circuits import data_commitment as dc
from blobstreamx_tpu_torch.circuits import input as pinput
from blobstreamx_tpu_torch.circuits import map_job
from blobstreamx_tpu_torch.field import extension as ext
from blobstreamx_tpu_torch.frontend import builder as pbuilder
from blobstreamx_tpu_torch.proof import system
from blobstreamx_tpu_torch.tendermint import header
from blobstreamx_tpu_torch.tendermint import merkle

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "blobstreamx_tpu", "fixtures", "mocha-4")
HEIGHTS = [10000, 10001, 10002, 10003, 10004]


# ---------------------------------------------------------------------------
# Tendermint headers and Merkle trees, every fixture height
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fetchers():
    return pinput.InputDataFetcher(FIXTURES), jinput.InputDataFetcher(FIXTURES)


@pytest.mark.parametrize("height", HEIGHTS)
def test_header_matches_reference(fetchers, height):
    port, ref = fetchers[0].get_header(height), fetchers[1].get_header(height)
    assert isinstance(port, header.Header)
    assert port.field_bytes() == ref.field_bytes()
    assert port.hash() == ref.hash()
    assert port.data_hash_proof() == ref.data_hash_proof()
    assert port.last_block_id_proof() == ref.last_block_id_proof()
    for i in range(header.HEADER_NUM_FIELDS):
        assert port.inclusion_proof(i) == ref.inclusion_proof(i)
    if height + 1 in HEIGHTS:  # the next header links back to this one
        nxt = fetchers[0].get_header(height + 1)
        assert nxt.last_block_id.hash == port.hash()


@pytest.mark.parametrize("height", HEIGHTS)
def test_merkle_matches_reference(fetchers, height):
    leaves = fetchers[0].get_header(height).field_bytes()
    root = merkle.hash_from_byte_slices(leaves)
    assert root == jmerkle.hash_from_byte_slices(leaves)
    proof_root, proofs = merkle.proofs_from_byte_slices(leaves)
    assert (proof_root, proofs) == jmerkle.proofs_from_byte_slices(leaves)
    for i, aunts in enumerate(proofs[:8]):  # complete-tree paths: the first 8
        assert merkle.verify_inclusion(root, leaves[i], i, aunts)
    for n in (1, 2, 3, 5, 8):
        assert (merkle.root_from_enabled_leaves(leaves[:8], n)
                == jmerkle.root_from_enabled_leaves(leaves[:8], n)
                == jmerkle.hash_from_byte_slices(leaves[:n]))


def test_data_commitment_inputs_match_reference(fetchers):
    for start, end, leaves in ((10000, 10002, 2), (10000, 10004, 4), (10002, 10004, 32),
                               (10004, 10004, 2)):
        port = fetchers[0].get_data_commitment_inputs(start, end, leaves)
        ref = fetchers[1].get_data_commitment_inputs(start, end, leaves)
        assert dataclasses.astuple(port) == dataclasses.astuple(ref)
        assert pinput.flatten_inputs(port) == jinput.flatten_inputs(ref)


def test_fetcher_takes_the_fixture_path(tmp_path):
    with pytest.raises(FileNotFoundError):
        pinput.InputDataFetcher(str(tmp_path / "missing"))
    assert pinput.InputDataFetcher(FIXTURES).get_data_commitment(10000, 10003) is None


# ---------------------------------------------------------------------------
# the two circuits of the slice, built by both packages
# ---------------------------------------------------------------------------

def _dc2(fetcher_port, fetcher_ref):
    port = dc.DataCommitmentCircuit(2, fetcher_port)
    ref = jdc.DataCommitmentCircuit(max_leaves=2, fetcher=fetcher_ref)
    f = fetcher_port
    pub = port.make_public_inputs(10000, f.get_header(10000).hash(),
                                  10002, f.get_header(10002).hash())
    return port, ref, pub, slice(80, 112), f.get_data_commitment(10000, 10002)


def _map2(fetcher_port, fetcher_ref):
    port = map_job.SubchainMapCircuit(2, fetcher_port)
    ref = jmap.SubchainMapCircuit(2, fetcher=fetcher_ref)
    f = fetcher_port
    pub = port.make_public_inputs(10000, 10004, f.get_header(10004).hash())
    # a batch of 2 from 10000 covers blocks 10000 and 10001
    return port, ref, pub, map_job.OUT_DATA_ROOT, f.get_data_commitment(10000, 10002)


CIRCUITS = {"data_commitment_2": _dc2, "map_job_2": _map2}


@pytest.fixture(scope="module", params=sorted(CIRCUITS))
def built(request, fetchers):
    """Both packages' circuit, witness and traces (no proof)."""
    port, ref, pub, root_slice, root = CIRCUITS[request.param](*fetchers)
    pc, rc = port.circuit, ref.circuit
    vals, rvals = pc.generate_witness(pub), rc.generate_witness(pub)
    return dict(name=request.param, port=pc, ref=rc, pub=pub, vals=vals, rvals=rvals,
                traces=pc.traces(vals), rtraces=rc.traces(rvals),
                root_slice=root_slice, root=root)


def test_builder_rows_and_events_match_reference(built):
    pb, rb = built["port"].b, built["ref"].b
    assert [dataclasses.astuple(r) for r in pb.rows] == [dataclasses.astuple(r) for r in rb.rows]
    assert pb.n_wires == rb.n_wires
    assert pb.public_wires == rb.public_wires
    assert pb.n_public_inputs == rb.n_public_inputs
    assert pb.range_checked == rb.range_checked
    assert ([dataclasses.astuple(c) for c in pb.sha_calls]
            == [dataclasses.astuple(c) for c in rb.sha_calls])
    assert [e[0] for e in pb.events] == [e[0] for e in rb.events]


def test_tables_and_preprocessed_columns_match_reference(built):
    pc, rc = built["port"], built["ref"]
    assert pc._table_names() == rc._table_names() == ["cpu", "sha", "bytes"]
    assert (pc.n_cpu_rows, pc.n_sha_rows) == (rc.n_cpu_rows, rc.n_sha_rows)
    for air, rair in zip(pc.airs(), rc.airs()):
        assert (air.width, air.pre_width, tuple(air.row_offsets), tuple(air.pre_offsets),
                air.max_constraint_degree) == (rair.width, rair.pre_width,
                                               tuple(rair.row_offsets),
                                               tuple(rair.pre_offsets),
                                               rair.max_constraint_degree)
    n = pc.n_cpu_rows
    assert np.array_equal(pc.cpu_air.preprocessed_columns(n),
                          rc.cpu_air.preprocessed_columns(n))
    assert [dataclasses.astuple(s) for s in pc.sha_schedule] == \
        [dataclasses.astuple(s) for s in rc.sha_schedule]


def test_witness_matches_reference(built):
    assert built["vals"].dtype == np.uint64
    assert np.array_equal(built["vals"], built["rvals"])


def test_witness_engine_matches_sequential_oracle(built):
    assert np.array_equal(built["port"].generate_witness_interp(built["pub"]), built["vals"])


def test_traces_match_reference(built):
    traces, rtraces = built["traces"], built["rtraces"]
    assert sorted(traces) == sorted(rtraces)
    for name in rtraces:
        assert traces[name].dtype == np.uint64
        assert np.array_equal(traces[name], rtraces[name]), name


def test_public_values_and_root(built):
    pc = built["port"]
    publics = pc.public_values(built["vals"])
    assert publics == built["ref"].public_values(built["rvals"])
    assert publics[:pc.n_public_inputs] == [built["pub"][i] for i in range(pc.n_public_inputs)]
    assert bytes(publics[built["root_slice"]]) == built["root"]
    assert pc.public_messages(publics) == built["ref"].public_messages(publics)


def test_bus_balances(built):
    pc = built["port"]
    specs = pc.specs(built["traces"])
    publics = pc.public_values(built["vals"])
    assert system.check_bus_balance(specs, pc.public_messages(publics), device="cpu")


def test_bus_rejects_a_wrong_public_byte(built):
    pc = built["port"]
    publics = pc.public_values(built["vals"])
    publics[built["root_slice"].start] ^= 1
    assert not system.check_bus_balance(pc.specs(built["traces"]),
                                        pc.public_messages(publics), device="cpu")


def test_partial_range_root_matches_fixture(fetchers):
    """A range shorter than max_leaves (the enabled-leaf logic)."""
    c = dc.DataCommitmentCircuit(2, fetchers[0])
    f = fetchers[0]
    pub = c.make_public_inputs(10000, f.get_header(10000).hash(),
                               10001, f.get_header(10001).hash())
    vals = c.circuit.generate_witness(pub)
    assert bytes(c.circuit.public_values(vals)[80:112]) == f.get_data_commitment(10000, 10001)


# ---------------------------------------------------------------------------
# every typed hint of the witness engine, against the reference's engine
# ---------------------------------------------------------------------------

def _hint_program(mod, F2):
    """One program that reaches each typed hint kind (and both SHA-256
    paths), written once for either package's builder module."""
    b = mod.CircuitBuilder()
    x = b.evm_read_u64()
    y = b.evm_read_u64()
    data = b.evm_read_bytes32()
    s = b.u64_add(x, y)                      # carry2, carry3, split4
    d = b.u64_sub(x, y)                      # borrow2, borrow3
    lt = b.u64_lt(y, x)
    z = b.is_zero(mod.Variable(d.lo.wire))   # inv0
    digest = b.sha256(list(data.bytes[:20]))  # hashlib path
    var = b.sha256_var(list(data.bytes[:40]), mod.U32Variable(b.constant(33).wire), 30)
    (split64_lo, split64_hi) = b.hint([b.mul(mod.Variable(s.lo.wire), mod.Variable(s.hi.wire))],
                                      2, lambda v: [v[0] & 0xFFFFFFFF, v[0] >> 32],
                                      kind="split64")
    (shr,) = b.hint([data.bytes[31]], 1, lambda v: [v[0] >> 7], kind="shr7")
    bits = b.hint([mod.Variable(s.lo.wire)], 64, lambda v: [(v[0] >> i) & 1 for i in range(64)],
                  kind="bits64")
    inv = b.hint([mod.Variable(s.lo.wire), mod.Variable(s.hi.wire)], 2,
                 lambda v: list(F2.inv((v[0], v[1]))), kind="f2inv")
    (called,) = b.hint([x.lo, y.hi], 1, lambda v: [(v[0] * 3 + v[1]) % 1000])
    for w in (split64_lo, split64_hi, shr, bits[0], bits[63], inv[0], inv[1], called,
              lt.wire, z.wire):
        b.evm_write_bytes32(mod.Bytes32Variable(tuple(mod.ByteVariable(w) for _ in range(32))))
    b.evm_write_bytes32(digest)
    b.evm_write_bytes32(var)
    pub = dict(enumerate(
        (0x0123456789ABCDEF).to_bytes(8, "big") + (0xFEDCBA9876543210).to_bytes(8, "big")
        + bytes(range(100, 132))))
    return b.build(), pub


def test_witness_engine_hint_kinds_match_reference():
    port, pub = _hint_program(pbuilder, ext.GFp2)
    ref, _ = _hint_program(jbuilder, jext.GFp2)
    kinds = {ev[4] for ev in port.b.events if ev[0] == "hint"}
    assert {"inv0", "split4", "carry2", "carry3", "borrow2", "borrow3", "split2", "split64",
            "shr7", "bits64", "f2inv", None} <= kinds
    vals = port.generate_witness(pub)
    assert np.array_equal(vals, port.generate_witness_interp(pub))
    assert np.array_equal(vals, ref.generate_witness(pub))
    traces, rtraces = port.traces(vals), ref.traces(vals)
    for name in rtraces:
        assert np.array_equal(traces[name], rtraces[name]), name
