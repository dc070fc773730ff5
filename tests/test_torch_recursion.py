"""The Poseidon chip and the recursive verifier of the port against the JAX
package's, exactly, without proving through either in tier-1.

* The Poseidon AIR at a random point (constraint lanes, the lanes combined
  at a random alpha, every bus message) and its symbolic rounds.
* A sponge and a Merkle climb through the builder's Poseidon gadgets:
  rows, scheduled permutations, witness (batched and sequential), every
  trace and preprocessed column; ``permute_capture`` on the outer
  circuit's pos table input states against the JAX package's trace and
  its python-int permutation.
* The recursive verifier over the recorded tiny_inner proof
  (testing/tiny_inner_proof.json, made by the JAX package; both packages'
  ``serde`` read it): the flattened proof, the outer circuit's rows,
  witness, traces and preprocessed columns. The port's witness check
  accepts the honest witness and names the table that rejects a tampered
  cap and wrong publics.

The JAX package's pos traces are built with its Goldilocks ops under
``jax.jit`` (``jitted_field_ops``): the same integer arithmetic, compiled
once instead of dispatched op by op, which takes ``permute_capture`` from
about 47 s a call on an 8-core host to 2-4 s, whatever the number of rows.
The JAX side's outer witness and traces are made once a run and shared by
the xdist workers through a file. Marked slow: the outer circuit's CPU
proof against the JAX package's, byte for byte, and the recorded digest
that the card checks (``recursion_small`` in chip_smoke.py)."""

import contextlib
import dataclasses
import functools
import hashlib
import json
import types

import jax
import numpy as np
import pytest
import torch

from blobstreamx_tpu.chips import channels as jch
from blobstreamx_tpu.chips import poseidon as jpos_chip
from blobstreamx_tpu.frontend import builder as jbuilder
from blobstreamx_tpu.ops import poseidon as jpos
from blobstreamx_tpu.proof import air as jair
from blobstreamx_tpu.proof import recursion as jrec
from blobstreamx_tpu.proof import serde as jserde
from blobstreamx_tpu.proof import stark as jstark
from blobstreamx_tpu_torch.chips import poseidon as pos_chip
from blobstreamx_tpu_torch.field.goldilocks import P
from blobstreamx_tpu_torch.frontend import builder as pbuilder
from blobstreamx_tpu_torch.proof import air as pair
from blobstreamx_tpu_torch.proof import check, serde, stark
from blobstreamx_tpu_torch.proof import recursion as rec
from blobstreamx_tpu_torch.testing import recursion as trec
from blobstreamx_tpu_torch.testing import reference_digests as refs
from torch_shared import shared_arrays, shared_dir  # noqa: F401 (fixture)

torch.set_num_threads(1)

CFG = refs.TEST_CONFIG


@contextlib.contextmanager
def jitted_field_ops():
    """The JAX package's Poseidon chip sees its Goldilocks ``add``, ``mul``
    and ``square`` under ``jax.jit`` for the duration (exact integer
    arithmetic either way; the module's other names are unchanged)."""
    orig = jpos_chip.gl
    ops = types.SimpleNamespace(**vars(orig))
    for name in ("add", "mul", "square"):
        setattr(ops, name, jax.jit(getattr(orig, name)))
    jpos_chip.gl = ops
    try:
        yield
    finally:
        jpos_chip.gl = orig


# ---------------------------------------------------------------------------
# the Poseidon AIR
# ---------------------------------------------------------------------------

def _eval_at_point(air, builder_cls, backend, rows, pre, alpha, sels, combine, **kw):
    b = builder_cls(backend, rows=rows, publics=[], pre_rows=pre, **kw)
    air.eval(b)
    n_lanes = sum(len(c.expr) if isinstance(c.expr, list) else 1 for c in b.constraints)
    messages = [(i.channel, i.sign, [a.v for a in i.args], i.mult.v) for i in b.interactions]
    return combine(b, alpha, sels), n_lanes, messages


def test_poseidon_air_matches_reference_at_a_random_point():
    sched = pos_chip.pad_schedule([], 16)
    port_air = pos_chip.PoseidonAir(sched, 16)
    ref_air = jpos_chip.PoseidonAir(jpos_chip.pad_schedule([], 16), 16)
    assert (port_air.width, port_air.pre_width, port_air.row_offsets, port_air.pre_offsets) == \
        (ref_air.width, ref_air.pre_width, ref_air.row_offsets, ref_air.pre_offsets)
    rng = np.random.default_rng(11)

    def rand():
        return tuple(int(x) for x in rng.integers(0, P, 2, dtype=np.uint64))

    rows = {k: [rand() for _ in range(port_air.width)] for k in port_air.row_offsets}
    pre = {k: [rand() for _ in range(port_air.pre_width)] for k in port_air.pre_offsets}
    alpha, sels = rand(), tuple(rand() for _ in range(4))
    got = _eval_at_point(port_air, pair.AirBuilder, pair.ExtPointBackend(), rows, pre,
                         alpha, sels, stark._combine_constraints_point)
    want = _eval_at_point(ref_air, jair.AirBuilder, jair.ExtPointBackend(), rows, pre,
                          alpha, sels, jstark._combine_constraints_point, periodic=[])
    assert got[1] == want[1]  # constraint lanes
    assert got[0] == want[0]  # the lanes combined at alpha
    assert got[2] == want[2]  # bus messages: channel, sign, arguments, multiplicity


def test_symbolic_rounds_match_reference():
    assert pos_chip._symbolic_rounds() == jpos_chip._symbolic_rounds()


# ---------------------------------------------------------------------------
# a sponge and a Merkle climb through the builder's gadgets
# ---------------------------------------------------------------------------

def _merkle_case():
    """Leaves of 11 elements, a tree of 16 leaves under a cap of 2, the
    opening of leaf 13: (row, path bits, siblings, cap) as python ints."""
    rng = np.random.default_rng(5)
    leaves = [[int(v) for v in rng.integers(0, P, 11, dtype=np.uint64)] for _ in range(16)]
    level = [jpos.hash_no_pad_ref(x) for x in leaves]
    idx, bits, sibs = 13, [], []
    while len(level) > 2:
        bits.append(idx & 1)
        sibs.append(level[idx ^ 1])
        level = [jpos.hash_two_to_one_ref(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
        idx >>= 1
    bits.append(idx & 1)
    return leaves[13], bits, sibs, level


def _gadget_circuit(m, merkle_verify):
    """A sponge of 11 elements read out (absorb 8, then absorb 3 and carry
    9) and a Merkle climb of a leaf against a cap of 2 digests."""
    b = m.CircuitBuilder()
    row, bits, sibs, cap = _merkle_case()
    row_w = [b.constant(v).wire for v in row]
    chain = b.pos_new_chain()
    b.pos_perm(chain, 0, {i: w for i, w in enumerate(row_w[:8])})
    last = b.pos_perm(chain, 1, {i: w for i, w in enumerate(row_w[8:])},
                      carry=tuple(range(3, 12)))
    digest = [b.pos_read(last, j) for j in range(4)]
    for v, d in zip(jpos.hash_no_pad_ref(row), digest):
        b.assert_is_equal(d, b.constant(v))
    merkle_verify(b, row_w, [b.constant(x).wire for x in bits],
                  [[b.constant(v).wire for v in s] for s in sibs],
                  [[b.constant(v).wire for v in d] for d in cap])
    return b.build()


@functools.lru_cache(maxsize=None)
def gadgets():
    """Both packages' gadget circuits, witness and traces."""
    port = _gadget_circuit(pbuilder, rec.merkle_verify_circuit)
    ref = _gadget_circuit(jbuilder, jrec.merkle_verify_circuit)
    vals, rvals = port.generate_witness({}), ref.generate_witness({})
    with jitted_field_ops():
        rtraces = ref.traces(rvals)
    return dict(port=port, ref=ref, vals=vals, traces=port.traces(vals, "cpu"),
                rvals=rvals, rtraces=rtraces)


def _same_circuit(port, ref):
    pb, rb = port.b, ref.b
    assert [dataclasses.astuple(r) for r in pb.rows] == [dataclasses.astuple(r) for r in rb.rows]
    assert [dataclasses.astuple(p) for p in pb.pos_perms] == \
        [dataclasses.astuple(p) for p in rb.pos_perms]
    assert [e[0] for e in pb.events] == [e[0] for e in rb.events]
    assert (pb.n_wires, pb.public_wires, pb.range_checked) == \
        (rb.n_wires, rb.public_wires, rb.range_checked)
    assert port._table_names() == ref._table_names()
    assert [dataclasses.astuple(s) for s in port.pos_schedule] == \
        [dataclasses.astuple(s) for s in ref.pos_schedule]
    sizes = port.table_sizes()
    for name, air, rair in zip(port._table_names(), port.airs(), ref.airs()):
        if air.pre_width:
            n = sizes[name]
            assert np.array_equal(air.preprocessed_columns(n), rair.preprocessed_columns(n)), name


def _same_witness_and_traces(c):
    assert c["vals"].dtype == np.uint64
    assert np.array_equal(c["vals"], c["rvals"])
    assert sorted(c["traces"]) == sorted(c["rtraces"])
    for name, trace in c["traces"].items():
        assert trace.dtype == np.uint64, name
        assert np.array_equal(trace, c["rtraces"][name]), name


def test_gadget_circuit_matches_reference():
    c = gadgets()
    assert sorted(c["traces"]) == ["bytes", "cpu", "pos"]
    assert len(c["port"].b.pos_perms) == 2 + 2 + 3  # sponge, leaf sponge, 3 levels
    _same_circuit(c["port"], c["ref"])
    _same_witness_and_traces(c)
    assert np.array_equal(c["port"].generate_witness_interp({}), c["vals"])


def test_gadget_witness_check_accepts_and_names_a_bad_sibling():
    port = _gadget_circuit(pbuilder, rec.merkle_verify_circuit)
    assert check.witness_failures(port, {}, "cpu") == []
    # the same circuit with one sibling element off by one
    row, bits, sibs, cap = _merkle_case()
    b = pbuilder.CircuitBuilder()
    sibs[1] = [(sibs[1][0] + 1) % P] + sibs[1][1:]
    rec.merkle_verify_circuit(b, [b.constant(v).wire for v in row],
                              [b.constant(x).wire for x in bits],
                              [[b.constant(v).wire for v in s] for s in sibs],
                              [[b.constant(v).wire for v in d] for d in cap])
    failures = check.witness_failures(b.build(), {}, "cpu")
    assert failures and failures[0].startswith("table cpu: "), failures


# ---------------------------------------------------------------------------
# the recursive verifier over the recorded tiny_inner proof
# ---------------------------------------------------------------------------

def test_both_packages_read_the_recorded_proof():
    recorded = trec.load_tiny_inner()
    assert recorded["reference_of"] == "blobstreamx_tpu"
    with open(trec.TINY_INNER_PATH) as f:
        text = json.dumps(json.load(f)["proof"])
    assert recorded["text"] == text
    assert jserde.dumps(jserde.loads(text)) == text


@functools.lru_cache(maxsize=None)
def outer(publics_delta=0, tamper_cap=False):
    """The port's outer circuit over the recorded proof (optionally with a
    changed first public byte or a changed main-cap element), its inner
    shapes and the flattened proof."""
    recorded = trec.load_tiny_inner()
    cfg = stark.StarkConfig(**CFG)
    inner = trec.tiny_inner()
    proof = recorded["proof"]
    if tamper_cap:
        proof = serde.loads(recorded["text"])
        cap0 = list(proof.table_proofs[0].main_cap[0])
        cap0[0] = (cap0[0] + 1) % P
        proof.table_proofs[0].main_cap[0] = cap0
    publics = list(recorded["publics"])
    publics[0] = (publics[0] + publics_delta) % 256
    shapes = rec.inner_shapes(inner, cfg, "cpu")
    flat = rec.flatten_system_proof(proof, shapes, cfg)
    return dict(port=trec.outer_circuit(inner, publics, flat, cfg, "cpu"), flat=flat,
                shapes=shapes)


@functools.lru_cache(maxsize=None)
def reference_outer():
    """The JAX package's outer circuit over the same proof (tests/
    test_recursion.py's build_outer), its shapes and flattened proof."""
    recorded = trec.load_tiny_inner()
    jcfg = jstark.StarkConfig(**CFG)
    jinner = trec.tiny_inner(jbuilder)
    jshapes = jrec.inner_shapes(jinner, jcfg)
    jflat = jrec.flatten_system_proof(jserde.loads(recorded["text"]), jshapes, jcfg)
    ref = _reference_outer(jinner, recorded["publics"], jflat, jshapes, jcfg)
    return dict(ref=ref, jflat=jflat, jshapes=jshapes)


def _reference_outer(jinner, publics, jflat, jshapes, jcfg):
    """tests/test_recursion.py's build_outer, on the JAX package."""
    ob = jbuilder.CircuitBuilder()
    rv = jrec.RecursiveVerifier(ob, jshapes, jcfg)
    pw, flat_wires = rv.alloc_proof()
    ob.hint_into([], flat_wires, lambda vals, fv=list(jflat): fv)
    msgs = [(jch.PUBLIC, [p, jbuilder.Variable(ob.constant(v).wire)], -1)
            for p, v in enumerate(publics)]
    rv.verify(pw, msgs)
    return ob.build()


@functools.lru_cache(maxsize=None)
def reference_outer_arrays(shared):
    """The JAX package's outer witness and traces, made once a run."""
    def make():
        ref = reference_outer()["ref"]
        rvals = ref.generate_witness({})
        with jitted_field_ops():
            rtraces = ref.traces(rvals)
        return {"rvals": rvals, **{f"r_{k}": v for k, v in rtraces.items()}}
    arrays = shared_arrays(shared, "torch_recursion_outer", make)
    return dict(rvals=arrays["rvals"],
                rtraces={k[2:]: v for k, v in arrays.items() if k.startswith("r_")})


def test_inner_shapes_and_flattened_proof_match_reference():
    c = {**outer(), **reference_outer()}
    assert [(s.name, s.n, s.n_inter, s.vk_pre_cap) for s in c["shapes"]] == \
        [(s.name, s.n, s.n_inter, s.vk_pre_cap) for s in c["jshapes"]]
    assert c["flat"] == c["jflat"]
    inner = trec.tiny_inner()
    assert [dataclasses.astuple(r) for r in inner.b.rows] == \
        [dataclasses.astuple(r) for r in trec.tiny_inner(jbuilder).b.rows]


def test_outer_rows_and_columns_match_reference():
    port = outer()["port"]
    assert port.table_sizes() == {"cpu": 1 << 15, "pos": 1 << 10, "bytes": 256}
    _same_circuit(port, reference_outer()["ref"])


def test_outer_witness_and_traces_match_reference(shared_dir):
    port = outer()["port"]
    vals = port.generate_witness({})
    _same_witness_and_traces(dict(vals=vals, traces=port.traces(vals, "cpu"),
                                  **reference_outer_arrays(shared_dir)))
    assert port.public_values(vals) == []


def test_permute_capture_matches_reference(shared_dir):
    """The S-box columns of the outer circuit's pos trace and the outputs,
    on the trace's own input states: against the JAX package's trace and
    its python-int permutation."""
    rtrace = reference_outer_arrays(shared_dir)["rtraces"]["pos"]
    states = rtrace[:, pos_chip.COL_IN:pos_chip.COL_IN + 12]
    sb, out = pos_chip.permute_capture(states, "cpu")
    assert sb.dtype == out.dtype == np.uint64
    assert np.array_equal(sb, rtrace[:, pos_chip.COL_SB:pos_chip.COL_SB + pos_chip.N_SBOX])
    for i in range(len(states)):
        assert [int(v) for v in out[i]] == jpos.permute_ref([int(v) for v in states[i]])


def test_outer_witness_check_accepts_the_honest_proof():
    assert check.witness_failures(outer()["port"], {}, "cpu") == []


@pytest.mark.parametrize("attack", ["tampered_cap", "wrong_publics"])
def test_outer_witness_check_names_the_rejecting_table(attack):
    c = outer(publics_delta=int(attack == "wrong_publics"),
              tamper_cap=attack == "tampered_cap")
    failures = check.witness_failures(c["port"], {}, "cpu")
    assert failures and failures[0].startswith("table cpu: "), failures


# ---------------------------------------------------------------------------
# slow: the outer proof byte for byte, and the recorded digest
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_outer_proof_text():
    """The JAX package's outer proof (about 20 minutes on an 8-core CPU)."""
    proof, _ = reference_outer()["ref"].prove({}, jstark.StarkConfig(**CFG))
    return jserde.dumps(proof)


@pytest.mark.slow
def test_recorded_digest_matches_live_reference_proof():
    digest = hashlib.sha256(reference_outer_proof_text().encode()).hexdigest()
    assert digest == refs.RECURSION_TINY["proof_sha256"]


@pytest.mark.slow
def test_cpu_outer_proof_matches_reference():
    cfg = stark.StarkConfig(**CFG)
    port = outer()["port"]
    proof, publics = port.prove({}, cfg, device="cpu")
    text = serde.dumps(proof)
    assert text == reference_outer_proof_text()
    assert hashlib.sha256(text.encode()).hexdigest() == refs.RECURSION_TINY["proof_sha256"]
    assert port.verify(proof, publics, cfg, device="cpu")
