#!/usr/bin/env python3
"""Record the proofs that the port's recursion tests read, made by the JAX
package (``blobstreamx_tpu``) on the CPU.

    JAX_PLATFORMS=cpu python scripts/record_recursion_proofs.py [--out DIR]

Writes into ``blobstreamx_tpu_torch/testing/`` (or ``--out``):

* ``tiny_inner_proof.json``: a proof of tests/test_recursion.py's
  ``tiny_inner`` circuit (public bytes 1, 2, 3, 4) at that test's config;
* ``map_job_children.json.gz``: four ``SubchainMapCircuit(2)`` proofs over
  the recorded mocha-4 fixtures at tests/test_aggregate.py's config
  (``a0``/``a1``: from 10000 and 10002 to 10004; ``d0``/``d1``: from 10000
  and 10002 to 10002, the disabled-right pair), with the map job's
  verifier keys, committed by the port on the CPU.

Proofs are deterministic, so a second run writes the same JSON. Each
prove's seconds are printed. The children are proved in parallel
processes (``--jobs``, 2 by default). This takes tens of minutes.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
import multiprocessing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURES = os.path.join(ROOT, "blobstreamx_tpu", "fixtures", "mocha-4")
CHILDREN = {"a0": (10000, 10004), "a1": (10002, 10004), "d0": (10000, 10002),
            "d1": (10002, 10002)}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")


def tiny_inner_record() -> dict:
    _jax()
    from blobstreamx_tpu.frontend import builder
    from blobstreamx_tpu.proof import serde, stark
    from blobstreamx_tpu_torch.testing import recursion as trec
    from blobstreamx_tpu_torch.testing import reference_digests as refs

    inner = trec.tiny_inner(builder)
    cfg = stark.StarkConfig(**refs.TEST_CONFIG)
    t0 = time.perf_counter()
    proof, publics = inner.prove({0: 1, 1: 2, 2: 3, 3: 4}, cfg)
    print(f"tiny_inner: prove {time.perf_counter() - t0:.1f} s", flush=True)
    assert inner.verify(proof, publics, cfg)
    return {
        "circuit": "tiny_inner: 4 public bytes in, echoed out, x = pack4(bytes), x * x",
        "public_inputs": [1, 2, 3, 4],
        "config": refs.TEST_CONFIG,
        "reference_of": "blobstreamx_tpu",
        "publics": [int(v) for v in publics],
        "proof": json.loads(serde.dumps(proof)),
    }


def map_job_child(name: str) -> tuple:
    _jax()
    from blobstreamx_tpu.circuits.input import InputDataFetcher
    from blobstreamx_tpu.circuits.map_job import SubchainMapCircuit
    from blobstreamx_tpu.proof import serde, stark
    from blobstreamx_tpu_torch.testing.recursion import MAP_JOB_CHILD_CONFIG

    start, end = CHILDREN[name]
    fetcher = InputDataFetcher(FIXTURES)
    cfg = stark.StarkConfig(**MAP_JOB_CHILD_CONFIG)
    t0 = time.perf_counter()
    proof, publics = SubchainMapCircuit(2, fetcher).prove(
        start, end, fetcher.get_header(end).hash(), cfg)
    print(f"{name}: prove {time.perf_counter() - t0:.1f} s", flush=True)
    return name, {"start": start, "global_end": end, "publics": [int(v) for v in publics],
                  "proof": json.loads(serde.dumps(proof))}


def children_record(jobs: int) -> dict:
    import torch

    from blobstreamx_tpu_torch.circuits.input import InputDataFetcher
    from blobstreamx_tpu_torch.circuits.map_job import SubchainMapCircuit
    from blobstreamx_tpu_torch.proof import stark
    from blobstreamx_tpu_torch.testing.recursion import MAP_JOB_CHILD_CONFIG

    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        children = dict(pool.map(map_job_child, sorted(CHILDREN)))
    torch.set_num_threads(4)
    circuit = SubchainMapCircuit(2, InputDataFetcher(FIXTURES)).circuit
    _, vks = circuit.build_keys(stark.StarkConfig(**MAP_JOB_CHILD_CONFIG), "cpu")
    return {
        "circuit": "SubchainMapCircuit(2) over the recorded mocha-4 fixtures",
        "config": MAP_JOB_CHILD_CONFIG,
        "reference_of": "blobstreamx_tpu",
        "vk_pre_caps": [vk.pre_cap for vk in vks],
        "tables": circuit._table_names(),
        "children": children,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "blobstreamx_tpu_torch", "testing"))
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args()
    with open(os.path.join(args.out, "tiny_inner_proof.json"), "w") as f:
        json.dump(tiny_inner_record(), f, separators=(",", ":"))
    record = children_record(args.jobs)
    with gzip.open(os.path.join(args.out, "map_job_children.json.gz"), "wt") as f:
        json.dump(record, f, separators=(",", ":"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
