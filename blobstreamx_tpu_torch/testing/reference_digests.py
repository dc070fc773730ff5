"""Digests of proofs made by the JAX package (``blobstreamx_tpu``), recorded
so that a machine without JAX can hold the port's proofs against them.

Each entry names the circuit, the block range and the ``StarkConfig`` it
was proved under; ``proof_sha256`` is the SHA-256 of ``serde.dumps(proof)``
as UTF-8, and ``reference_of`` names the package that made the proof. The
slow tests ``test_recorded_digest_matches_live_reference_proof`` of
``tests/test_torch_circuits.py``, ``tests/test_torch_header_range.py`` and
``tests/test_torch_recursion.py`` recompute them from the JAX package, so the constants cannot drift from
the reference.
"""

# the tests' config: small, so that a CPU prove takes minutes
TEST_CONFIG = dict(rate_bits=3, cap_height=1, num_query_rounds=4, pow_bits=2,
                   final_poly_bits=2)

DATA_COMMITMENT_2 = dict(
    circuit="DataCommitmentCircuit(max_leaves=2)",
    start_block=10000,
    end_block=10002,
    config=TEST_CONFIG,
    proof_sha256="4f8c4777c63e707b11a20e17aa8a5ff2fd8e0f60235fdba51a0a1de9c00236fa",
)

NEXT_HEADER_2 = dict(
    circuit="NextHeaderCircuit(chain_id='mocha-4', vss=2)",
    prev_block=10000,
    config=TEST_CONFIG,
    reference_of="blobstreamx_tpu",
    proof_sha256="7bd3076a0de1924f593f0a6db5a8921375cb66327080dd4f67289a8293690779",
)

HEADER_RANGE_2 = dict(
    circuit="HeaderRangeCircuit(chain_id='mocha-4', vss=2, nb_map_jobs=1, batch_size=4)",
    trusted_block=10000,
    target_block=10004,
    config=TEST_CONFIG,
    reference_of="blobstreamx_tpu",
    proof_sha256="6ae5df249b565e01e28709bc12847ebc62b8277e3c2e75d5e65e3382e4666798",
)

# the outer circuit of tests/test_recursion.py: the recursive verifier over
# the recorded tiny_inner proof (testing/tiny_inner_proof.json)
RECURSION_TINY = dict(
    circuit="RecursiveVerifier over tiny_inner (testing/recursion.outer_circuit)",
    inner_proof="testing/tiny_inner_proof.json",
    config=TEST_CONFIG,
    reference_of="blobstreamx_tpu",
    proof_sha256="3071a968ded231fea58b634abf6db9fad887c74adb2f048560ffa1328f0a6ef4",
)
