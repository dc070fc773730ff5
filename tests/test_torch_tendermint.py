"""The port's host Tendermint layers against the JAX package's, exactly:
Ed25519 (RFC 8032), the canonical precommit sign-bytes and commit parsing
on the recorded mocha-4 commits, SHA-512, the step and skip fetchers, and
the synthetic chain writer. These reference modules are python ints and
numpy: no JAX computation runs, nothing proves."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest

from blobstreamx_tpu.circuits import input as jinput
from blobstreamx_tpu.ops import sha512 as jsha512
from blobstreamx_tpu.tendermint import ed25519 as jed
from blobstreamx_tpu.tendermint import vote as jvote
from blobstreamx_tpu.testing import synthetic as jsynthetic
from blobstreamx_tpu_torch.circuits import input as pinput
from blobstreamx_tpu_torch.ops import sha512
from blobstreamx_tpu_torch.tendermint import ed25519 as ed
from blobstreamx_tpu_torch.tendermint import header
from blobstreamx_tpu_torch.tendermint import vote
from blobstreamx_tpu_torch.testing import synthetic

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "blobstreamx_tpu", "fixtures", "mocha-4")
HEIGHTS = [10000, 10001, 10002, 10003, 10004]


def _signed_block(height):
    with open(os.path.join(FIXTURES, str(height), "signed_block.json")) as f:
        return json.load(f)["result"]


# ---------------------------------------------------------------------------
# Ed25519
# ---------------------------------------------------------------------------

def test_ed25519_rfc8032_vector_and_reference():
    # RFC 8032 section 7.1, TEST 1 (empty message)
    seed = bytes.fromhex("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
    pk = bytes.fromhex("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
    sig = bytes.fromhex("e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
                        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")
    assert ed.public_key(seed) == pk
    assert ed.sign(seed, b"") == sig
    assert ed.verify(pk, b"", sig)
    rng = np.random.default_rng(7)
    for i in range(4):
        seed = rng.bytes(32)
        msg = rng.bytes(int(rng.integers(0, 200)))
        pk = ed.public_key(seed)
        assert pk == jed.public_key(seed)
        sig = ed.sign(seed, msg)
        assert sig == jed.sign(seed, msg)
        assert ed.challenge_scalar(sig[:32], pk, msg) == jed.challenge_scalar(sig[:32], pk, msg)
        assert ed.decompress(pk) == jed.decompress(pk)
        assert ed.compress(ed.decompress(pk)) == pk
        assert ed.verify(pk, msg, sig) and jed.verify(pk, msg, sig)
        forged = bytearray(sig)
        forged[32 + i] ^= 1
        assert not ed.verify(pk, msg, bytes(forged))
        assert not jed.verify(pk, msg, bytes(forged))
        assert not ed.verify(pk, msg + b"x", sig)


# ---------------------------------------------------------------------------
# commits and sign-bytes, every fixture height
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("height", HEIGHTS)
def test_commit_sign_bytes_match_reference(height):
    blk = _signed_block(height)
    commit = vote.Commit.from_json(blk["commit"])
    rcommit = jvote.Commit.from_json(blk["commit"])
    assert dataclasses.astuple(commit) == dataclasses.astuple(rcommit)
    vals = [vote.Validator.from_json(v) for v in blk["validator_set"]["validators"]]
    rvals = [jvote.Validator.from_json(v) for v in blk["validator_set"]["validators"]]
    assert [dataclasses.astuple(v) for v in vals] == [dataclasses.astuple(v) for v in rvals]
    chain_id = blk["header"]["chain_id"]
    for i in range(len(commit.signatures)):
        assert commit.vote_sign_bytes(chain_id, i) == rcommit.vote_sign_bytes(chain_id, i)
    valid = vote.verify_commit(commit, vals, chain_id)
    assert valid == jvote.verify_commit(rcommit, rvals, chain_id)
    assert any(valid)
    hdr = header.Header.from_json(blk["header"])
    assert vote.validator_set_hash(vals) == hdr.validators_hash
    assert (vote.voting_power_signed(commit, vals, chain_id)
            == jvote.voting_power_signed(rcommit, rvals, chain_id))
    # the same votes under another chain id do not verify
    assert not any(vote.verify_commit(commit, vals, "mocha-5"))


# ---------------------------------------------------------------------------
# SHA-512
# ---------------------------------------------------------------------------

def test_sha512_matches_hashlib_and_reference():
    rng = np.random.default_rng(11)
    for n in (0, 1, 111, 112, 127, 128, 239, 300):
        msg = rng.bytes(n)
        assert sha512.sha512(msg) == hashlib.sha512(msg).digest() == jsha512.sha512(msg)
        blocks = sha512.pad_message(msg)
        assert np.array_equal(blocks, jsha512.pad_message(msg))
        state = sha512.H0[None]
        for blk in blocks:  # the compression chain gives hashlib's digest
            state = sha512.compress_blocks(blk[None], state)
        assert b"".join(int(v).to_bytes(8, "big") for v in state[0]) == \
            hashlib.sha512(msg).digest()
    blocks = rng.integers(0, 1 << 63, size=(5, 16), dtype=np.uint64) * np.uint64(2)
    state = np.repeat(sha512.H0[None], 5, axis=0)
    out, tr = sha512.compress_blocks(blocks, state, trace=True)
    rout, rtr = jsha512.compress_blocks(blocks, state, trace=True)
    assert np.array_equal(out, rout)
    assert np.array_equal(tr["w"], rtr["w"]) and np.array_equal(tr["state"], rtr["state"])


# ---------------------------------------------------------------------------
# fetchers
# ---------------------------------------------------------------------------

def test_step_inputs_match_reference():
    port, ref = pinput.StepInputFetcher(FIXTURES), jinput.StepInputFetcher(FIXTURES)
    for prev in HEIGHTS[:-1]:
        inp, rinp = port.get_step_inputs(prev, 2), ref.get_step_inputs(prev, 2)
        assert dataclasses.astuple(inp) == dataclasses.astuple(rinp)
        assert inp.next_header_hash == port.get_header(prev + 1).hash()
        assert any(v.signed for v in inp.validators)


def test_skip_inputs_match_reference():
    port, ref = pinput.SkipInputFetcher(FIXTURES), jinput.SkipInputFetcher(FIXTURES)
    for trusted, target in ((10000, 10004), (10001, 10003)):
        inp, rinp = port.get_skip_inputs(trusted, target, 2), ref.get_skip_inputs(trusted, target, 2)
        assert dataclasses.astuple(inp) == dataclasses.astuple(rinp)
        assert inp.target_header_hash == port.get_header(target).hash()


# ---------------------------------------------------------------------------
# synthetic chain
# ---------------------------------------------------------------------------

def _tree(path):
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def test_synthetic_chain_writes_the_reference_bytes(tmp_path):
    args = dict(n_validators=3, start=20000, n_blocks=2, ranges=[(20000, 20002)])
    chain = synthetic.make_chain_dir(str(tmp_path / "port"), **args)
    jsynthetic.make_chain_dir(str(tmp_path / "ref"), **args)
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "ref")
    assert sorted(files) == sorted(
        [f"{h}/{name}" for h in (20000, 20001, 20002)
         for name in ("header.json", "signed_block.json")]
        + ["20000-20002/data_commitment.json"])
    assert [v.pubkey for v in chain.validators] == [
        v.pubkey for v in jsynthetic.make_validators(3)]


def test_fetchers_read_a_synthetic_chain(tmp_path):
    chain = synthetic.make_chain_dir(str(tmp_path), n_validators=4, n_blocks=1,
                                     ranges=[(10000, 10001)])
    fetcher = pinput.SkipInputFetcher(str(tmp_path))
    step = fetcher.get_step_inputs(10000, 4)
    assert step.nb_validators == 4 and all(v.signed for v in step.validators)
    assert step.next_header_hash == chain.headers[10001].hash()
    assert fetcher.get_header(10001).last_block_id.hash == chain.headers[10000].hash()
    skip = fetcher.get_skip_inputs(10000, 10001, 4)
    assert all(v.signed for v in skip.trusted_validators)
    assert fetcher.get_data_commitment(10000, 10001) is not None
