"""Digests of proofs made by the JAX package (``blobstreamx_tpu``), recorded
so that a machine without JAX can hold the port's proofs against them.

Each entry names the circuit, the block range and the ``StarkConfig`` it
was proved under; ``proof_sha256`` is the SHA-256 of ``serde.dumps(proof)``
as UTF-8. The slow test ``tests/test_torch_circuits.py::
test_recorded_digest_matches_live_reference_proof`` recomputes it from the
JAX package, so the constant cannot drift from the reference.
"""

DATA_COMMITMENT_2 = dict(
    circuit="DataCommitmentCircuit(max_leaves=2)",
    start_block=10000,
    end_block=10002,
    config=dict(rate_bits=3, cap_height=1, num_query_rounds=4, pow_bits=2,
                final_poly_bits=2),
    proof_sha256="4f8c4777c63e707b11a20e17aa8a5ff2fd8e0f60235fdba51a0a1de9c00236fa",
)
