"""Circuit proofs through the port: a tiny circuit end to end on the CPU
(tier-1), and, marked slow, the DataCommitmentCircuit(2) proof byte for
byte against the JAX package's, the recorded digest that the card checks
against the live reference proof, and the production map job's traces."""

import functools
import hashlib
import os

import numpy as np
import pytest
import torch

from blobstreamx_tpu_torch.circuits import data_commitment as dc
from blobstreamx_tpu_torch.circuits import input as pinput
from blobstreamx_tpu_torch.circuits import map_job
from blobstreamx_tpu_torch.frontend import builder as pbuilder
from blobstreamx_tpu_torch.proof import serde, stark, system
from blobstreamx_tpu_torch.testing import reference_digests as refs

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "blobstreamx_tpu", "fixtures", "mocha-4")
REF = refs.DATA_COMMITMENT_2
CFG = dict(rate_bits=3, cap_height=1, num_query_rounds=4, pow_bits=2, final_poly_bits=2)
# the tiny circuit's tables have degree <= 4: a blowup of 4 is enough, and
# halves the CPU's work
TINY_CFG = dict(CFG, rate_bits=2)


def tiny_circuit():
    """Reads a u64 and publishes x + x and whether x is zero: a cpu and a
    bytes table (no SHA-256 call, so the circuit has no sha table)."""
    b = pbuilder.CircuitBuilder()
    x = b.evm_read_u64()
    s = b.u64_add(x, x)
    z = b.is_zero(pbuilder.Variable(x.lo.wire))
    out = b.u64_to_be_bytes(s) + [pbuilder.ByteVariable(z.wire)] * 24
    b.evm_write_bytes32(pbuilder.Bytes32Variable(tuple(out)))
    return b.build()


def test_tiny_circuit_proves_verifies_and_rejects_tamper():
    circuit = tiny_circuit()
    assert circuit._table_names() == ["cpu", "bytes"]
    cfg = stark.StarkConfig(**TINY_CFG)
    x = 0x8123456789ABCDEF
    timer = system.PhaseTimer()
    proof, publics = circuit.prove(dict(enumerate(x.to_bytes(8, "big"))), cfg,
                                   device="cpu", timer=timer)
    assert bytes(publics[8:16]) == ((2 * x) % (1 << 64)).to_bytes(8, "big")
    assert publics[16:] == [0] * 24
    assert {"witness", "traces", "main_commits", "deep_fri"} <= set(timer.seconds)
    assert circuit.verify(serde.loads(serde.dumps(proof)), publics, cfg, device="cpu")
    bad = list(publics)
    bad[9] ^= 1
    assert circuit.verify(proof, bad, cfg, device="cpu") is False


def test_build_keys_give_the_prover_and_verifier_keys():
    circuit = tiny_circuit()
    cfg = stark.StarkConfig(**TINY_CFG)
    pks, vks = circuit.build_keys(cfg, device="cpu")
    assert len(pks) == len(vks) == len(circuit.airs()) == 2
    for air, pk, vk in zip(circuit.airs(), pks, vks):
        n = pk.pre_trace.shape[1]
        assert pk.pre_trace.shape == (air.pre_width, n)
        assert vk.pre_cap == pk.pre_tree.cap_ints()
    # memoized per air: the prover's own build returns the same keys
    assert stark.build(circuit.cpu_air, circuit.n_cpu_rows, cfg, "cpu")[1] is vks[0]


# ---------------------------------------------------------------------------
# slow: against the JAX package's proofs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_proof_text() -> str:
    """The JAX package's DataCommitmentCircuit(2) proof as serde text,
    computed once per process for the tests that need it (minutes)."""
    from blobstreamx_tpu.circuits.data_commitment import DataCommitmentCircuit
    from blobstreamx_tpu.circuits.input import InputDataFetcher
    from blobstreamx_tpu.proof import serde as jserde
    from blobstreamx_tpu.proof import stark as jstark

    c = DataCommitmentCircuit(max_leaves=2, fetcher=InputDataFetcher(FIXTURES))
    proof, _, _ = c.prove(REF["start_block"], REF["end_block"],
                          jstark.StarkConfig(**REF["config"]))
    return jserde.dumps(proof)


@pytest.mark.slow
def test_data_commitment_proof_matches_reference():
    fetcher = pinput.InputDataFetcher(FIXTURES)
    c = dc.DataCommitmentCircuit(2, fetcher)
    cfg = stark.StarkConfig(**REF["config"])
    proof, publics, root = c.prove(REF["start_block"], REF["end_block"], cfg, device="cpu")
    assert root == fetcher.get_data_commitment(REF["start_block"], REF["end_block"])
    text = serde.dumps(proof)
    assert text == reference_proof_text()
    assert hashlib.sha256(text.encode()).hexdigest() == REF["proof_sha256"]
    assert c.verify(proof, publics, cfg, device="cpu")
    bad = list(publics)
    bad[80] ^= 1
    assert c.verify(proof, bad, cfg, device="cpu") is False


@pytest.mark.slow
def test_recorded_digest_matches_live_reference_proof():
    assert REF["config"] == CFG
    digest = hashlib.sha256(reference_proof_text().encode()).hexdigest()
    assert digest == REF["proof_sha256"]


@pytest.mark.slow
def test_map_job_32_traces_match_reference():
    from blobstreamx_tpu.circuits import input as jinput
    from blobstreamx_tpu.circuits import map_job as jmap

    fetcher = pinput.InputDataFetcher(FIXTURES)
    port = map_job.SubchainMapCircuit(32, fetcher)
    ref = jmap.SubchainMapCircuit(32, fetcher=jinput.InputDataFetcher(FIXTURES))
    pub = port.make_public_inputs(10000, 10004, fetcher.get_header(10004).hash())
    vals = port.circuit.generate_witness(pub)
    rvals = ref.circuit.generate_witness(pub)
    assert np.array_equal(vals, rvals)
    traces, rtraces = port.circuit.traces(vals), ref.circuit.traces(rvals)
    assert {k: v.shape for k, v in traces.items()} == {
        "cpu": (1 << 17, 5), "sha": (1 << 16, 111), "bytes": (256, 1)}
    for name in rtraces:
        assert np.array_equal(traces[name], rtraces[name]), name
    assert sum(len(c.blocks_word_wires) for c in port.circuit.b.sha_calls) == 734
    publics = port.circuit.public_values(vals)
    assert bytes(publics[map_job.OUT_DATA_ROOT]) == fetcher.get_data_commitment(10000, 10004)
