"""Recorded proofs for the recursive verifier, and the circuits over them.

``tiny_inner_proof.json`` holds a proof of ``tiny_inner`` (4 public bytes
in, echoed out, a little arithmetic) made by the JAX package at the tests'
config (``reference_of`` names the package); ``map_job_children.json.gz``
holds four ``SubchainMapCircuit(2)`` proofs over the recorded mocha-4
fixtures made by the JAX package at ``MAP_JOB_CHILD_CONFIG``: two linked
children over [10000, 10004) and a disabled-right pair over [10000,
10002), with the map job's verifier keys. Both packages' ``serde`` read
them, so the port's recursive verifier and the JAX package's see the same
proofs without proving in a test.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Tuple

from ..chips import channels as ch
from ..frontend import builder as port_builder
from ..frontend.builder import CircuitBuilder, CompiledCircuit, Variable
from ..proof import recursion as rec
from ..proof import serde, stark

HERE = os.path.dirname(os.path.abspath(__file__))
TINY_INNER_PATH = os.path.join(HERE, "tiny_inner_proof.json")
MAP_JOB_CHILDREN_PATH = os.path.join(HERE, "map_job_children.json.gz")

# tests/test_aggregate.py's config: the children's and their reduce node's
MAP_JOB_CHILD_CONFIG = dict(rate_bits=3, cap_height=1, num_query_rounds=8, pow_bits=4,
                            final_poly_bits=2)


def tiny_inner(builder=port_builder) -> CompiledCircuit:
    """4 public bytes in, echoed out, with a little arithmetic (the inner
    circuit of tests/test_recursion.py), built with the frontend module
    ``builder``: the port's, or a package's with the same CircuitBuilder."""
    b = builder.CircuitBuilder()
    ins = []
    for _ in range(4):
        byte = b.free_byte()
        b._public_byte(byte.wire)
        ins.append(byte)
    x = b.pack4(*ins)
    y = b.mul(x, x)
    b.assert_is_equal(y, y)
    for byte in ins:
        b._public_byte(byte.wire)
    return b.build()


def load_tiny_inner() -> dict:
    """The recorded tiny_inner proof: its config, publics and the proof
    (``serde`` JSON text under ``"text"``, the port's SystemProof under
    ``"proof"``)."""
    with open(TINY_INNER_PATH) as f:
        d = json.load(f)
    d["proof"] = serde.system_proof_from_json(d["proof"])
    d["text"] = serde.dumps(d["proof"])
    return d


def outer_circuit(inner: CompiledCircuit, publics: List[int], flat: List[int],
                  cfg: stark.StarkConfig, device=None) -> CompiledCircuit:
    """A circuit that verifies one proof of ``inner`` in-circuit: the proof
    enters as the hint ``flat`` (``recursion.flatten_system_proof``), the
    claimed public bytes as constants. The inner tables' preprocessed caps
    are committed on ``device`` (None: the card)."""
    shapes = rec.inner_shapes(inner, cfg, device)
    ob = CircuitBuilder()
    rv = rec.RecursiveVerifier(ob, shapes, cfg)
    pw, flat_wires = rv.alloc_proof()
    if len(flat_wires) != len(flat):
        raise ValueError(f"{len(flat)} proof elements for {len(flat_wires)} wires")
    ob.hint_into([], flat_wires, lambda vals, fv=list(flat): fv)
    msgs = [(ch.PUBLIC, [pos, Variable(ob.constant(v).wire)], -1)
            for pos, v in enumerate(publics)]
    rv.verify(pw, msgs)
    return ob.build()


def load_map_job_children() -> Tuple[Dict[str, dict], list]:
    """The recorded map-job proofs by name ("a0", "a1": [10000, 10004) from
    10000 and 10002; "d0", "d1": [10000, 10002) from 10000 and 10002), each
    {"start", "global_end", "publics", "text", "proof"}, and the map job's
    verifier keys at that config (its tables' preprocessed caps, committed
    by the port's ``stark.build``)."""
    with gzip.open(MAP_JOB_CHILDREN_PATH, "rt") as f:
        d = json.load(f)
    for child in d["children"].values():
        child["proof"] = serde.system_proof_from_json(child["proof"])
        child["text"] = serde.dumps(child["proof"])
    return d["children"], [stark.VerifierKey(cap) for cap in d["vk_pre_caps"]]


def child_pair(children: Dict[str, dict], left: str, right: str
               ) -> Tuple[Tuple[object, List[int]], Tuple[object, List[int]]]:
    """((proof, publics), (proof, publics)) of two recorded children."""
    return tuple((children[k]["proof"], children[k]["publics"]) for k in (left, right))
