"""Succinct aggregation in the port: the reduce node (circuits/aggregate.py)
over two recorded SubchainMapCircuit(2) proofs at tests/test_aggregate.py's
config (testing/map_job_children.json.gz, made by the JAX package), and the
MapReduce prover's host side (parallel/mapreduce.py, parallel/prefetch.py).

Tier-1 runs the port alone and proves nothing: the reduce node's combined
root against the fixture data commitment, the disabled-right boundary case
(the left child passed through), every table's constraints on the honest
witness, and a tampered child cap and a forged child root each rejected by
the cpu table (``check.witness_failures`` names it). The node's cpu table
has 2^19 rows: a witness and its traces take about 20 s on one core, so
the honest linked and disabled ones are made once a run and shared by the
xdist workers through a file.

Marked slow: the reduce node's rows, witness and traces against the JAX
package's, the full check with the bus, and its CPU proof byte for byte
against the JAX package's."""

import copy
import dataclasses
import functools
import os
import threading

import numpy as np
import pytest
import torch

from blobstreamx_tpu_torch.circuits.aggregate import ReduceCircuit
from blobstreamx_tpu_torch.circuits.input import InputDataFetcher
from blobstreamx_tpu_torch.circuits.map_job import SubchainMapCircuit
from blobstreamx_tpu_torch.field.goldilocks import P
from blobstreamx_tpu_torch.parallel import mapreduce as mr
from blobstreamx_tpu_torch.parallel.prefetch import PrefetchingFetcher
from blobstreamx_tpu_torch.proof import check, serde, stark
from blobstreamx_tpu_torch.testing import recursion as trec
from torch_shared import shared_arrays, shared_dir  # noqa: F401 (fixture)

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "blobstreamx_tpu", "fixtures", "mocha-4")
CFG = trec.MAP_JOB_CHILD_CONFIG
TABLES = ("cpu", "sha", "pos", "bytes")


@functools.lru_cache(maxsize=None)
def node():
    """The reduce node over two map jobs of 2 blocks (span 4), its children's
    caps from the recorded verifier keys, once a process."""
    children, vks = trec.load_map_job_children()
    fetcher = InputDataFetcher(FIXTURES)
    child = SubchainMapCircuit(2, fetcher).circuit
    rc = ReduceCircuit(child, 4, stark.StarkConfig(**CFG), "cpu", child_vks=vks)
    return rc, children, fetcher


def _args(name):
    rc, children, fetcher = node()
    left, right = ("a0", "a1") if name == "linked" else ("d0", "d1")
    end = children[left]["global_end"]
    return (10000, end, fetcher.get_header(end).hash()) + trec.child_pair(children, left, right)


@functools.lru_cache(maxsize=None)
def honest(name, shared):
    """The node's witness and traces over the "linked" or "disabled"
    children, made once a run: (vals, {table: trace})."""
    rc, _, _ = node()

    def make():
        vals = rc.witness(*_args(name))
        return {"vals": vals, **{f"t_{k}": v for k, v in rc.circuit.traces(vals, "cpu").items()}}
    arrays = shared_arrays(shared, f"torch_aggregate_{name}", make)
    return arrays["vals"], {k[2:]: v for k, v in arrays.items() if k.startswith("t_")}


def test_recorded_children_are_the_expected_statements():
    rc, children, fetcher = node()
    assert [rec.name for rec in rc.child_shapes] == ["cpu", "sha", "bytes"]
    assert rc.circuit.table_sizes() == {"cpu": 1 << 19, "sha": 256, "pos": 1 << 14,
                                        "bytes": 256}
    assert len(rc.circuit.b.pos_perms) == 8222
    for name, (start, end) in {"a0": (10000, 10004), "a1": (10002, 10004),
                               "d0": (10000, 10002), "d1": (10002, 10002)}.items():
        c = children[name]
        assert (c["start"], c["global_end"]) == (start, end)
        assert bytes(c["publics"][:16]) == start.to_bytes(8, "big") + end.to_bytes(8, "big")
        assert bytes(c["publics"][16:48]) == fetcher.get_header(end).hash()
        assert c["proof"].table_proofs[0].n_rows == 1 << 13


def test_reduce_root_matches_fixture_commitment(shared_dir):
    rc, _, fetcher = node()
    publics = rc.circuit.public_values(honest("linked", shared_dir)[0])
    assert len(publics) == 144
    assert bytes(publics[112:144]) == fetcher.get_data_commitment(10000, 10004)
    assert bytes(publics[48:80]) == fetcher.get_header(10000).hash()
    assert bytes(publics[80:112]) == fetcher.get_header(10004).hash()
    assert bytes(publics[:48]) == (10000).to_bytes(8, "big") + (10004).to_bytes(8, "big") \
        + fetcher.get_header(10004).hash()


def test_reduce_witness_satisfies_every_table(shared_dir):
    rc, _, _ = node()
    vals, traces = honest("linked", shared_dir)
    assert check.trace_failures(rc.circuit, vals, traces, tables=TABLES) == []


def test_reduce_disabled_right_boundary(shared_dir):
    """Range [10000, 10002) with 2 jobs of 2: the right leaf is the empty
    pass-through proof, and the node passes the left child through."""
    rc, _, fetcher = node()
    vals, traces = honest("disabled", shared_dir)
    publics = rc.circuit.public_values(vals)
    assert bytes(publics[112:144]) == fetcher.get_data_commitment(10000, 10002)
    assert bytes(publics[80:112]) == fetcher.get_header(10002).hash()
    assert bytes(publics[48:80]) == fetcher.get_header(10000).hash()
    assert check.trace_failures(rc.circuit, vals, traces, tables=TABLES) == []


def test_reduce_rejects_tampered_child_cap():
    rc, _, _ = node()
    start, end, geh, left, right = _args("linked")
    bad = copy.deepcopy(right[0])
    cap0 = list(bad.table_proofs[0].main_cap[0])
    cap0[0] = (cap0[0] + 1) % P
    bad.table_proofs[0].main_cap[0] = cap0
    failures = rc.witness_failures(start, end, geh, left, (bad, right[1]), device="cpu",
                                   tables=("cpu",))
    assert len(failures) == 1 and failures[0].startswith("table cpu: "), failures


def test_reduce_rejects_forged_child_root():
    """Claiming a different right-child data root breaks the in-circuit
    binding of the child's proof to its public bytes."""
    rc, _, _ = node()
    start, end, geh, left, right = _args("linked")
    forged = list(right[1])
    forged[112] = (forged[112] + 1) % 256
    failures = rc.witness_failures(start, end, geh, left, (right[0], forged), device="cpu",
                                   tables=("cpu",))
    assert len(failures) == 1 and failures[0].startswith("table cpu: "), failures


# ---------------------------------------------------------------------------
# the MapReduce prover's host side
# ---------------------------------------------------------------------------

def _leaves():
    _, children, _ = node()
    return [mr.LeafProof(j, children[k]["start"], children[k]["publics"], children[k]["proof"])
            for j, k in enumerate(("a0", "a1"))]


def test_transparent_reduce_tree_and_proof_json():
    _, _, fetcher = node()
    leaves = _leaves()
    final = mr._reduce_tree([mr._leaf_to_subchain(lf, 2, 10004) for lf in leaves])
    assert final.data_merkle_root == fetcher.get_data_commitment(10000, 10004)
    assert (final.start_block, final.end_block) == (10000, 10004)
    agg = mr.MapReduceProof(10000, 10004, 2, fetcher.get_header(10004).hash(), leaves,
                            final.data_merkle_root)
    back = mr.mapreduce_proof_from_json(mr.mapreduce_proof_to_json(agg))
    assert [serde.dumps(lf.proof) for lf in back.leaves] == \
        [serde.dumps(lf.proof) for lf in leaves]
    assert dataclasses.replace(back, leaves=[]) == dataclasses.replace(agg, leaves=[])
    with pytest.raises(ValueError, match="not linked"):
        mr._reduce_tree([mr._leaf_to_subchain(lf, 2, 10004) for lf in leaves[::-1]])


class CountingFetcher:
    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def get_data_commitment_inputs(self, start, end, batch_size):
        with self.lock:
            self.calls.append((start, end, batch_size))
        return (start, end, batch_size)


def test_prefetch_is_claimed_once_and_released():
    inner = CountingFetcher()
    f = PrefetchingFetcher(inner, max_concurrent=2)
    f.prefetch(10000, 10002, 2)
    f.prefetch(10000, 10002, 2)  # idempotent per key
    f.prefetch(10002, 10004, 2)
    assert f.get_data_commitment_inputs(10000, 10002, 2) == (10000, 10002, 2)
    assert f.pending() == 1
    f.release()
    assert f.pending() == 0 and f._pool is None
    assert not [t for t in threading.enumerate() if t.name.startswith("witness-prefetch")]
    # an unannounced batch is fetched synchronously
    assert f.get_data_commitment_inputs(10004, 10006, 2) == (10004, 10006, 2)
    assert inner.calls.count((10000, 10002, 2)) == 1


def test_checkpointed_jobs_are_not_announced(tmp_path):
    """Jobs with a checkpoint are not proved again, so their fetches are
    not announced (the reference announced them and never claimed them)."""
    fetcher = PrefetchingFetcher(CountingFetcher())
    prover = mr.MapReduceProver(2, 2, fetcher=InputDataFetcher(FIXTURES),
                                checkpoint_dir=str(tmp_path), succinct=True)
    prover.fetcher = fetcher
    geh = bytes(32)
    path = prover._ckpt_path(10000, 10004, geh)
    with open(path, "w") as f:
        f.write("{}")
    prover._announce_prefetch(10000, 10004, geh)
    assert set(fetcher._futures) == {(10002, 10004, 2)}
    fetcher.release()
    assert prover._reduce_templates is None  # built at first use, on the device


# ---------------------------------------------------------------------------
# slow: against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_node():
    from blobstreamx_tpu.circuits.aggregate import ReduceCircuit as JReduce
    from blobstreamx_tpu.circuits.input import InputDataFetcher as JFetcher
    from blobstreamx_tpu.circuits.map_job import SubchainMapCircuit as JMap
    from blobstreamx_tpu.proof import stark as jstark

    child = JMap(2, JFetcher(FIXTURES)).circuit
    return JReduce(child, 4, jstark.StarkConfig(**CFG))


def _reference_children(name):
    from blobstreamx_tpu.proof import serde as jserde

    _, children, _ = node()
    left, right = ("a0", "a1") if name == "linked" else ("d0", "d1")
    return [(jserde.loads(children[k]["text"]), children[k]["publics"]) for k in (left, right)]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["linked", "disabled"])
def test_reduce_witness_and_traces_match_reference(name, shared_dir):
    rc, _, _ = node()
    ref = reference_node()
    assert [s.vk_pre_cap for s in rc.child_shapes] == [s.vk_pre_cap for s in ref.child_shapes]
    assert [dataclasses.astuple(r) for r in rc.circuit.b.rows] == \
        [dataclasses.astuple(r) for r in ref.circuit.b.rows]
    start, end, geh, left, right = _args(name)
    rleft, rright = _reference_children(name)
    pub = rc.make_public_inputs(start, end, geh)
    vals, traces = honest(name, shared_dir)
    ref._pending = (rleft[0], rleft[1], rright[0], rright[1])
    try:
        rvals = ref.circuit.generate_witness(pub)
    finally:
        ref._pending = None
    assert np.array_equal(vals, rvals)
    rtraces = ref.circuit.traces(rvals)
    assert sorted(traces) == sorted(rtraces)
    for table in traces:
        assert np.array_equal(traces[table], rtraces[table]), table
    assert check.trace_failures(rc.circuit, vals, traces) == []  # with the bus


@pytest.mark.slow
def test_cpu_reduce_proof_matches_reference():
    """The reduce node's CPU proof against the JAX package's, byte for byte
    (cpu 2^19 rows: hours on a CPU, in each package)."""
    from blobstreamx_tpu.proof import serde as jserde

    rc, _, _ = node()
    start, end, geh, left, right = _args("linked")
    proof, publics = rc.prove(start, end, geh, left, right, device="cpu")
    rleft, rright = _reference_children("linked")
    ref = reference_node()
    rproof, rpublics = ref.prove(start, end, geh, rleft, rright)
    assert serde.dumps(proof) == jserde.dumps(rproof)
    assert publics == list(rpublics)
    assert rc.verify(proof, publics, device="cpu")
