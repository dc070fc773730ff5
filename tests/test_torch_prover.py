"""The port's prove_system / verify_system against the JAX package's: the same
tables give byte-identical ``serde.dumps``; the port's verifier accepts its
proofs and returns False (not an exception) on a wrong public claim."""

import numpy as np
import pytest
import torch

from blobstreamx_tpu.chips import bytes as jbytes
from blobstreamx_tpu.chips import sha256 as jsha_chip
from blobstreamx_tpu.proof import serde as jserde
from blobstreamx_tpu.proof import stark as jstark
from blobstreamx_tpu.proof import system as jsystem
from blobstreamx_tpu.proof.air import Air as JaxAir
from blobstreamx_tpu_torch.chips import bytes as bytes_chip
from blobstreamx_tpu_torch.chips import channels as ch
from blobstreamx_tpu_torch.chips import sha256 as sha_chip
from blobstreamx_tpu_torch.field import goldilocks as gl
from blobstreamx_tpu_torch.ops import sha256 as sha
from blobstreamx_tpu_torch.proof import serde, stark, system
from blobstreamx_tpu_torch.proof.air import Air

torch.set_num_threads(1)

CFG = dict(rate_bits=3, cap_height=1, num_query_rounds=4, pow_bits=2, final_poly_bits=2)
SHA_ROWS = 256


def fib_air(base):
    """The Fib AIR of __graft_entry__.py, on either package's Air."""

    class FibAir(base):
        width = 2
        max_constraint_degree = 2

        def eval(self, b):
            a, bb = b.local(0), b.local(1)
            an, bn = b.next(0), b.next(1)
            t = b.when_transition()
            t.assert_zero(an - bb)
            t.assert_zero(bn - (a + bb))
            b.when_first_row().assert_eq(a, b.public(0))
            b.when_first_row().assert_eq(bb, b.public(1))
            b.when_last_row().assert_eq(bb, b.public(2))

    return FibAir()


def fib_trace(n_rows: int = 32):
    tr = np.zeros((n_rows, 2), dtype=np.uint64)
    x, y = 1, 1
    for i in range(n_rows):
        tr[i] = (x, y)
        x, y = y, (x + y) % gl.P
    return tr, [1, 1, int(tr[-1, 1])]


def byte_counts(seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 3, size=256).astype(np.uint64)


def range_messages(counts):
    return [(ch.RANGE8, [v], +1) for v in range(256) for _ in range(int(counts[v]))]


def sha_messages():
    return [sha.pad_message(b"abc"), sha.pad_message(b"a" * 100)]


def sha_public_messages(messages):
    pubs = []
    for inst, blocks in enumerate(messages):
        for blk_i, blk in enumerate(np.asarray(blocks, dtype=np.uint32)):
            for slot in range(16):
                pubs.append((ch.SHA_W, [inst, blk_i, slot, int(blk[slot])], +1))
    for inst, words in enumerate(sha_chip.digests(messages)):
        for j in range(4):
            pubs.append((ch.SHA_OUT_A, [inst, j, words[j]], -1))
            pubs.append((ch.SHA_OUT_E, [inst, j, words[4 + j]], -1))
    return pubs


def sha_specs(chip_module, messages):
    sched = chip_module.schedule_for(messages, SHA_ROWS)
    air = chip_module.Sha256Air(sched, SHA_ROWS)
    return air, chip_module.build_trace(messages, SHA_ROWS, sched)


def test_fib_proof_matches_reference_and_verifies():
    trace, publics = fib_trace()
    cfg = stark.StarkConfig(**CFG)
    proof = system.prove_system([system.TableSpec("fib", fib_air(Air), trace, publics)],
                                cfg, device="cpu")
    ref = jsystem.prove_system([jsystem.TableSpec("fib", fib_air(JaxAir), trace, publics)],
                               jstark.StarkConfig(**CFG))
    assert serde.dumps(proof) == jserde.dumps(ref)
    assert system.verify_system([fib_air(Air)], [publics], proof, cfg,
                                public_messages=[], device="cpu")
    assert system.verify_system([fib_air(Air)], [[1, 1, publics[2] + 1]], proof, cfg,
                                public_messages=[], device="cpu") is False


def test_bytes_chip_proof_matches_reference_and_verifies():
    counts = byte_counts()
    cfg = stark.StarkConfig(**CFG)
    air = bytes_chip.BytesAir()
    proof = system.prove_system(
        [system.TableSpec("bytes", air, bytes_chip.build_trace(counts), [])], cfg, device="cpu")
    ref = jsystem.prove_system(
        [jsystem.TableSpec("bytes", jbytes.BytesAir(), jbytes.build_trace(counts), [])],
        jstark.StarkConfig(**CFG))
    text = serde.dumps(proof)
    assert text == jserde.dumps(ref)
    pubs = range_messages(counts)
    assert system.verify_system([air], [[]], serde.loads(text), cfg,
                                public_messages=pubs, device="cpu") is True
    wrong = list(pubs)
    wrong[0] = (ch.RANGE8, [wrong[0][1][0] + 1], +1)
    assert system.verify_system([air], [[]], proof, cfg, public_messages=wrong,
                                device="cpu") is False


@pytest.fixture(scope="module")
def sha_proof():
    messages = sha_messages()
    air, trace = sha_specs(sha_chip, messages)
    cfg = stark.StarkConfig(**CFG)
    proof = system.prove_system([system.TableSpec("sha", air, trace, [])], cfg, device="cpu")
    return air, cfg, proof, sha_public_messages(messages)


def test_sha_chip_proof_verifies(sha_proof):
    air, cfg, proof, pubs = sha_proof
    assert system.verify_system([air], [[]], proof, cfg, public_messages=pubs,
                                device="cpu") is True


def test_sha_chip_rejects_wrong_digest_claim(sha_proof):
    air, cfg, proof, pubs = sha_proof
    bad = list(pubs)
    chan, args, sign = bad[-1]
    bad[-1] = (chan, [args[0], args[1], (args[2] + 1) % (1 << 32)], sign)
    assert system.verify_system([air], [[]], proof, cfg, public_messages=bad,
                                device="cpu") is False


def test_sha_chip_rejects_forged_bus_total(sha_proof):
    air, cfg, proof, pubs = sha_proof
    forged = serde.loads(serde.dumps(proof))
    t = forged.bus_totals[0]
    forged.bus_totals[0] = ((t[0] + 1) % gl.P, t[1])
    assert system.verify_system([air], [[]], forged, cfg, public_messages=pubs,
                                device="cpu") is False


def test_sha_chip_bus_balances_at_witness_level():
    messages = sha_messages()
    air, trace = sha_specs(sha_chip, messages)
    spec = system.TableSpec("sha", air, trace, [])
    pubs = sha_public_messages(messages)
    assert system.check_bus_balance([spec], pubs, device="cpu")
    assert not system.check_bus_balance([spec], pubs[:-1], device="cpu")


def test_serde_round_trip_is_identity(sha_proof):
    _, _, proof, _ = sha_proof
    text = serde.dumps(proof)
    assert serde.dumps(serde.loads(text)) == text


@pytest.mark.slow
def test_sha_chip_proof_matches_reference():
    messages = sha_messages()
    air, trace = sha_specs(sha_chip, messages)
    proof = system.prove_system([system.TableSpec("sha", air, trace, [])],
                                stark.StarkConfig(**CFG), device="cpu")
    jair, jtrace = sha_specs(jsha_chip, messages)
    ref = jsystem.prove_system([jsystem.TableSpec("sha", jair, jtrace, [])],
                               jstark.StarkConfig(**CFG))
    assert serde.dumps(proof) == jserde.dumps(ref)
