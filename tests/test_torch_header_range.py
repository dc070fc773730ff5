"""The Tendermint circuits of the port against the JAX package's, exactly,
on the recorded mocha-4 fixtures: NextHeaderCircuit(vss=2) at 10000 and
HeaderRangeCircuit(vss=2, 1, 4) over 10000 -> 10004. Builder rows, the
witness, all six traces (cpu, sha, sha512, ed, range16, bytes), every
table's preprocessed columns, the ed chip's range counts, the public
values and public messages. Then the port's witness check accepts the
honest witnesses and names what rejects four attacks (after
tests/test_adversarial.py). Nothing in tier-1 proves: each circuit's
build, witness and traces are made once per process, for both packages.
Marked slow: the CPU proofs byte for byte against the JAX package's, and
the recorded digests that the card checks against the live reference."""

import dataclasses
import functools
import hashlib
import os

import numpy as np
import pytest
import torch

from blobstreamx_tpu.chips import ed25519 as jed_chip
from blobstreamx_tpu.chips import range16 as jrange16
from blobstreamx_tpu.chips import sha512 as jsha512
from blobstreamx_tpu.circuits import header_range as jheader_range
from blobstreamx_tpu.circuits import input as jinput
from blobstreamx_tpu.circuits import next_header as jnext_header
from blobstreamx_tpu.proof import air as jair
from blobstreamx_tpu.proof import stark as jstark_mod
from blobstreamx_tpu_torch.chips import ed25519 as ed_chip
from blobstreamx_tpu_torch.chips import range16
from blobstreamx_tpu_torch.chips import sha512
from blobstreamx_tpu_torch.circuits import header_range
from blobstreamx_tpu_torch.circuits import input as pinput
from blobstreamx_tpu_torch.circuits import next_header
from blobstreamx_tpu_torch.field.goldilocks import P
from blobstreamx_tpu_torch.proof import air as pair
from blobstreamx_tpu_torch.proof import check, serde, stark
from blobstreamx_tpu_torch.testing import reference_digests as refs
from torch_shared import shared_arrays, shared_dir  # noqa: F401 (fixture)

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "blobstreamx_tpu", "fixtures", "mocha-4")
TABLES = ["cpu", "sha", "sha512", "ed", "range16", "bytes"]
CIRCUITS = ["next_header", "header_range"]


def _next_header(fetcher=None):
    c = next_header.NextHeaderCircuit(vss=2, fetcher=fetcher or pinput.StepInputFetcher(FIXTURES))
    return c, c.make_public_inputs(10000, c.fetcher.get_header(10000).hash())


def _header_range(fetcher=None):
    c = header_range.HeaderRangeCircuit(vss=2, nb_map_jobs=1, batch_size=4,
                                        fetcher=fetcher or pinput.SkipInputFetcher(FIXTURES))
    return c, c.make_public_inputs(10000, c.fetcher.get_header(10000).hash(), 10004)


def _witness_and_traces(name, port, ref, pub, shared):
    """Both packages' witness and traces, made by the first worker that asks
    and read from the shared directory by the others (tracing the reference
    circuit takes seconds a worker)."""
    def make():
        vals, rvals = port.generate_witness(pub), ref.generate_witness(pub)
        arrays = {"vals": vals, "rvals": rvals}
        arrays.update({f"t_{k}": v for k, v in port.traces(vals).items()})
        arrays.update({f"r_{k}": v for k, v in ref.traces(rvals).items()})
        return arrays
    return shared_arrays(shared, f"torch_tendermint_{name}", make)


@functools.lru_cache(maxsize=None)
def built(name, shared):
    """Both packages' circuit, witness and traces (no proof), once a process;
    the witness and traces once a run."""
    if name == "next_header":
        port, pub = _next_header()
        ref = jnext_header.NextHeaderCircuit(vss=2, fetcher=jinput.StepInputFetcher(FIXTURES))
    else:
        port, pub = _header_range()
        ref = jheader_range.HeaderRangeCircuit(vss=2, nb_map_jobs=1, batch_size=4,
                                               fetcher=jinput.SkipInputFetcher(FIXTURES))
    pc, rc = port.circuit, ref.circuit
    arrays = _witness_and_traces(name, pc, rc, pub, shared)
    return dict(port=pc, ref=rc, pub=pub, vals=arrays["vals"], rvals=arrays["rvals"],
                traces={k[2:]: v for k, v in arrays.items() if k.startswith("t_")},
                rtraces={k[2:]: v for k, v in arrays.items() if k.startswith("r_")})


@pytest.mark.parametrize("name", CIRCUITS)
def test_rows_witness_and_publics_match_reference(name, shared_dir):
    c = built(name, shared_dir)
    pb, rb = c["port"].b, c["ref"].b
    assert [dataclasses.astuple(r) for r in pb.rows] == [dataclasses.astuple(r) for r in rb.rows]
    assert (pb.n_wires, pb.public_wires, pb.range_checked) == \
        (rb.n_wires, rb.public_wires, rb.range_checked)
    assert [e[0] for e in pb.events] == [e[0] for e in rb.events]
    for calls in ("sha_calls", "sha512_calls", "ed_calls"):
        assert ([dataclasses.astuple(x) for x in getattr(pb, calls)]
                == [dataclasses.astuple(x) for x in getattr(rb, calls)]), calls
    assert c["vals"].dtype == np.uint64
    assert np.array_equal(c["vals"], c["rvals"])
    publics = c["port"].public_values(c["vals"])
    assert publics == c["ref"].public_values(c["rvals"])
    assert c["port"].public_messages(publics) == c["ref"].public_messages(publics)
    fetcher = pinput.InputDataFetcher(FIXTURES)
    if name == "next_header":
        assert bytes(publics[40:72]) == fetcher.get_header(10001).hash()
        assert bytes(publics[72:104]) == fetcher.get_data_commitment(10000, 10001)
    else:
        assert bytes(publics[48:80]) == fetcher.get_header(10004).hash()
        assert bytes(publics[80:112]) == fetcher.get_data_commitment(10000, 10004)


@pytest.mark.parametrize("name", CIRCUITS)
def test_traces_and_range_counts_match_reference(name, shared_dir):
    c = built(name, shared_dir)
    traces, rtraces = c["traces"], c["rtraces"]
    assert sorted(traces) == sorted(rtraces) == sorted(TABLES)
    for table in TABLES:
        assert traces[table].dtype == np.uint64, table
        assert np.array_equal(traces[table], rtraces[table]), table
    air, rair = c["port"].ed_air, c["ref"].ed_air
    for port_counts, ref_counts in zip(ed_chip.range_counts(air, traces["ed"]),
                                       jed_chip.range_counts(rair, rtraces["ed"])):
        assert np.array_equal(port_counts, ref_counts)


@pytest.mark.parametrize("name", CIRCUITS)
def test_tables_and_preprocessed_columns_match_reference(name, shared_dir):
    c = built(name, shared_dir)
    pc, rc = c["port"], c["ref"]
    assert pc._table_names() == rc._table_names() == TABLES
    for table, air, rair in zip(TABLES, pc.airs(), rc.airs()):
        assert (air.width, air.pre_width, tuple(air.row_offsets), tuple(air.pre_offsets),
                air.max_constraint_degree) == (rair.width, rair.pre_width,
                                               tuple(rair.row_offsets),
                                               tuple(rair.pre_offsets),
                                               rair.max_constraint_degree), table
        if air.pre_width:
            n = c["traces"][table].shape[0]
            assert np.array_equal(air.preprocessed_columns(n),
                                  rair.preprocessed_columns(n)), table


def test_ed_trace_builder_holds_its_int64_bound():
    """Operand limbs stay under LIMB_BOUND (products of at most 17 pairs fit
    int64); a wider operand is refused, not silently wrapped."""
    regs = np.zeros((1, 192), dtype=np.int64)
    c = np.zeros((1, 9, 16), dtype=np.int64)
    spec = ([(1, ("c", 0))], ed_chip.THREEP)
    assert ed_chip._operand_limbs(spec, regs, c, None).max() < ed_chip.LIMB_BOUND
    c[0, 0, 3] = ed_chip.LIMB_BOUND
    with pytest.raises(OverflowError):
        ed_chip._operand_limbs(spec, regs, c, None)


# The new chips' AIRs (the port's Ed25519 AIR writes its identities as
# stacked constraints) against the reference's on the same random rows at a
# point: the constraints combined at a random alpha, and every bus message.
NEW_AIRS = {
    "ed": (lambda: ed_chip.Ed25519Air([ed_chip.SigInfo(0)], 2048),
           lambda: jed_chip.Ed25519Air([jed_chip.SigInfo(0)], 2048)),
    "sha512": (lambda: sha512.Sha512Air([], 512), lambda: jsha512.Sha512Air([], 512)),
    "range16": (range16.Range16Air, jrange16.Range16Air),
}


def _eval_at_point(air, builder_cls, backend, rows, pre, alpha, sels, combine, **kw):
    b = builder_cls(backend, rows=rows, publics=[], pre_rows=pre if air.pre_width else None,
                    **kw)
    air.eval(b)
    n_lanes = sum(len(c.expr) if isinstance(c.expr, list) else 1 for c in b.constraints)
    messages = [(i.channel, i.sign, [a.v for a in i.args], i.mult.v) for i in b.interactions]
    return combine(b, alpha, sels), n_lanes, messages


@pytest.mark.parametrize("chip", sorted(NEW_AIRS))
def test_air_matches_reference_at_a_random_point(chip):
    port_air, ref_air = (make() for make in NEW_AIRS[chip])
    assert (port_air.width, port_air.pre_width) == (ref_air.width, ref_air.pre_width)
    rng = np.random.default_rng(7)

    def rand():
        return tuple(int(x) for x in rng.integers(0, P, 2, dtype=np.uint64))

    rows = {k: [rand() for _ in range(port_air.width)] for k in port_air.row_offsets}
    pre = {k: [rand() for _ in range(port_air.pre_width)] for k in port_air.pre_offsets}
    alpha, sels = rand(), tuple(rand() for _ in range(4))
    got = _eval_at_point(port_air, pair.AirBuilder, pair.ExtPointBackend(), rows, pre,
                         alpha, sels, stark._combine_constraints_point)
    want = _eval_at_point(ref_air, jair.AirBuilder, jair.ExtPointBackend(), rows, pre,
                          alpha, sels, jstark_mod._combine_constraints_point, periodic=[])
    assert got[1] == want[1]  # constraint lanes
    assert got[0] == want[0]  # the lanes combined at alpha
    assert got[2] == want[2]  # bus messages: channel, sign, arguments, multiplicity


# ---------------------------------------------------------------------------
# the witness check: honest accepted, attacks rejected with the failure named
# ---------------------------------------------------------------------------

class TamperStepFetcher(pinput.StepInputFetcher):
    def __init__(self, tamper):
        super().__init__(FIXTURES)
        self.tamper = tamper

    def get_step_inputs(self, prev_block, vss):
        inp = super().get_step_inputs(prev_block, vss)
        self.tamper(inp)
        return inp


class TamperSkipFetcher(pinput.SkipInputFetcher):
    def __init__(self, tamper):
        super().__init__(FIXTURES)
        self.tamper = tamper

    def get_skip_inputs(self, trusted_block, target_block, vss):
        inp = super().get_skip_inputs(trusted_block, target_block, vss)
        self.tamper(inp)
        return inp


def _forge_signature(inp):
    """Flip one byte of a signed validator's signature (its R)."""
    v = next(v for v in inp.validators if v.signed)
    sig = bytearray(v.signature)
    sig[0] ^= 1
    v.signature = bytes(sig)


def _drop_target_quorum(inp):
    """Every signer claimed not to have signed: voting power below 2/3."""
    for v in inp.validators:
        if v.signed:
            v.signed, v.signature, v.msg = False, bytes(64), b""


def _drop_trusted_overlap(inp):
    """No trusted validator counted as overlapping: below 1/3."""
    for v in inp.trusted_validators:
        v.signed = False


def _break_header_link(pub):
    pub[8] = (pub[8] + 1) % 256  # first byte of the public prev header hash
    return pub


ATTACKS = {
    # name: (circuit, fetcher tamper, public-input tamper, what must fail)
    "forged_signature": (_next_header, TamperStepFetcher, _forge_signature, None, "table ed"),
    "target_quorum_below_two_thirds": (_next_header, TamperStepFetcher, _drop_target_quorum,
                                       None, "table cpu"),
    "broken_header_link": (_next_header, None, None, _break_header_link, "table cpu"),
    "trusted_overlap_below_one_third": (_header_range, TamperSkipFetcher, _drop_trusted_overlap,
                                        None, "table cpu"),
}


@pytest.mark.parametrize("name", CIRCUITS)
def test_witness_check_accepts_the_honest_witness(name):
    circuit, pub = (_next_header if name == "next_header" else _header_range)()
    assert check.witness_failures(circuit.circuit, pub) == []


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_witness_check_names_what_rejects_an_attack(attack):
    make, fetcher_cls, tamper, tamper_pub, expected = ATTACKS[attack]
    circuit, pub = make(fetcher_cls(tamper) if fetcher_cls else None)
    if tamper_pub:
        pub = tamper_pub(pub)
    failures = check.witness_failures(circuit.circuit, pub)
    assert failures, attack
    assert any(f.startswith(expected) for f in failures), failures


# ---------------------------------------------------------------------------
# slow: the proofs against the JAX package's, and the recorded digests
# ---------------------------------------------------------------------------

REFS = {"next_header": refs.NEXT_HEADER_2, "header_range": refs.HEADER_RANGE_2}


def _prove_args(name):
    return (10000,) if name == "next_header" else (10000, 10004)


@functools.lru_cache(maxsize=None)
def reference_proof_text(name) -> str:
    """The JAX package's proof of the circuit as serde text, once a process
    (tens of minutes on a CPU host)."""
    from blobstreamx_tpu.proof import serde as jserde
    from blobstreamx_tpu.proof import stark as jstark

    if name == "next_header":
        c = jnext_header.NextHeaderCircuit(vss=2, fetcher=jinput.StepInputFetcher(FIXTURES))
    else:
        c = jheader_range.HeaderRangeCircuit(vss=2, nb_map_jobs=1, batch_size=4,
                                             fetcher=jinput.SkipInputFetcher(FIXTURES))
    proof = c.prove(*_prove_args(name), jstark.StarkConfig(**REFS[name]["config"]))[0]
    return jserde.dumps(proof)


@pytest.mark.slow
@pytest.mark.parametrize("name", CIRCUITS)
def test_recorded_digest_matches_live_reference_proof(name):
    digest = hashlib.sha256(reference_proof_text(name).encode()).hexdigest()
    assert digest == REFS[name]["proof_sha256"]


@pytest.mark.slow
@pytest.mark.parametrize("name", CIRCUITS)
def test_cpu_proof_matches_reference(name):
    circuit = (_next_header if name == "next_header" else _header_range)()[0]
    cfg = stark.StarkConfig(**REFS[name]["config"])
    proof, publics, _, _ = circuit.prove(*_prove_args(name), cfg, device="cpu")
    text = serde.dumps(proof)
    assert text == reference_proof_text(name)
    assert hashlib.sha256(text.encode()).hexdigest() == REFS[name]["proof_sha256"]
    assert circuit.verify(proof, publics, cfg, device="cpu")
    bad = list(publics)
    bad[40 if name == "next_header" else 80] ^= 1
    assert circuit.verify(proof, bad, cfg, device="cpu") is False
