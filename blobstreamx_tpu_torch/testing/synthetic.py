"""Synthetic Tendermint chain generator — fixtures of any length/validator
count in the exact JSON formats of the recorded mocha-4 fixtures
(SURVEY.md R17/D16). The port's copy of
``blobstreamx_tpu/testing/synthetic.py``: for the same arguments it writes
the same bytes.

The reference can only record fixtures from live RPC (`save: true`,
circuits/input.rs:89-95); heights 10000-10004 are the entire recorded
universe, capping every test and benchmark at 4-block ranges. This module
mints deterministic chains with real Ed25519 validator keys and real
signatures over canonical precommit bytes, so circuits and benchmarks run
at production-relevant shapes (32-64 block ranges, larger validator sets)
with the SAME fetchers (`InputDataFetcher` / `StepInputFetcher` /
`SkipInputFetcher` read the generated directory unchanged).

Every header links to its predecessor (last_block_id.hash), validator
hashes bind the set, and each commit's signatures verify under the
generated keys — the full light-client statement holds, so proofs over
synthetic ranges exercise exactly the production constraint set.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from dataclasses import dataclass
from typing import List, Optional

from ..tendermint import ed25519 as ed
from ..tendermint import header as hdr
from ..tendermint import vote as tvote


def _rng_bytes(tag: str, n: int = 32) -> bytes:
    out = b""
    i = 0
    while len(out) < n:
        out += hashlib.sha256(f"blobstreamx-synthetic:{tag}:{i}".encode()
                              ).digest()
        i += 1
    return out[:n]


def _ts(seconds: int, nanos: int) -> str:
    import datetime as dt

    t = dt.datetime(1970, 1, 1) + dt.timedelta(seconds=seconds)
    return t.strftime("%Y-%m-%dT%H:%M:%S") + f".{nanos:09d}Z"


@dataclass
class SyntheticValidator:
    seed: bytes
    pubkey: bytes
    address: bytes
    power: int


def make_validators(n: int, tag: str = "valset") -> List[SyntheticValidator]:
    out = []
    for i in range(n):
        seed = _rng_bytes(f"{tag}:seed:{i}")
        pk = ed.public_key(seed)
        addr = hashlib.sha256(pk).digest()[:20]
        out.append(SyntheticValidator(seed, pk, addr, 1_000_000 * (i + 1)))
    return out


class SyntheticChain:
    """Deterministic chain of signed blocks in the fixture JSON schema."""

    def __init__(self, chain_id: str = "mocha-4", n_validators: int = 4,
                 start: int = 10000, n_blocks: int = 8,
                 commit_round: int = 0, base_time: int = 1_700_000_000):
        self.chain_id = chain_id
        self.start = start
        self.commit_round = commit_round
        self.validators = make_validators(n_validators)
        self.headers: dict = {}
        self.commits: dict = {}
        vh = tvote.validator_set_hash([
            tvote.Validator(v.address, v.pubkey, v.power)
            for v in self.validators
        ])
        prev_hash: Optional[bytes] = None
        prev_part: Optional[bytes] = None
        for h in range(start, start + n_blocks + 1):
            last_block_id = None
            if prev_hash is not None:
                last_block_id = hdr.BlockId(prev_hash, 1, prev_part)
            header = hdr.Header(
                version_block=11, version_app=1, chain_id=chain_id,
                height=h, time_seconds=base_time + 12 * (h - start),
                time_nanos=228913686, last_block_id=last_block_id,
                last_commit_hash=_rng_bytes(f"lch:{h}"),
                data_hash=_rng_bytes(f"data:{h}"),
                validators_hash=vh, next_validators_hash=vh,
                consensus_hash=_rng_bytes("consensus"),
                app_hash=_rng_bytes(f"app:{h}"),
                last_results_hash=_rng_bytes(f"lrh:{h}"),
                evidence_hash=b"\xe3\xb0\xc4\x42\x98\xfc\x1c\x14\x9a\xfb"
                              b"\xf4\xc8\x99\x6f\xb9\x24\x27\xae\x41\xe4"
                              b"\x64\x9b\x93\x4c\xa4\x95\x99\x1b\x78\x52"
                              b"\xb8\x55",
                proposer_address=self.validators[0].address,
            )
            self.headers[h] = header
            part_hash = _rng_bytes(f"part:{h}")
            self.commits[h] = self._commit(header, part_hash)
            prev_hash = header.hash()
            prev_part = part_hash

    def _commit(self, header: hdr.Header, part_hash: bytes) -> tvote.Commit:
        sigs = []
        for i, v in enumerate(self.validators):
            secs = header.time_seconds + 11
            nanos = 798194168 + i  # vary per signer like real commits
            msg = tvote.canonical_vote_bytes(
                header.height, self.commit_round, header.hash(), 1,
                part_hash, secs, nanos, self.chain_id)
            sig = ed.sign(v.seed, msg)
            sigs.append(tvote.CommitSig(
                block_id_flag=2, validator_address=v.address,
                time_seconds=secs, time_nanos=nanos, signature=sig))
        return tvote.Commit(
            height=header.height, round=self.commit_round,
            block_id_hash=header.hash(), part_total=1,
            part_hash=part_hash, signatures=sigs)

    # -- JSON fixture emission ---------------------------------------------

    def _header_json(self, h: int) -> dict:
        hd = self.headers[h]
        lbi = {"hash": "", "parts": {"total": "0", "hash": ""}}
        if hd.last_block_id is not None:
            lbi = {
                "hash": hd.last_block_id.hash.hex().upper(),
                "parts": {
                    "total": str(hd.last_block_id.part_total),
                    "hash": hd.last_block_id.part_hash.hex().upper(),
                },
            }
        return {
            "version": {"block": str(hd.version_block),
                        "app": str(hd.version_app)},
            "chain_id": hd.chain_id,
            "height": str(hd.height),
            "time": _ts(hd.time_seconds, hd.time_nanos),
            "last_block_id": lbi,
            "last_commit_hash": hd.last_commit_hash.hex().upper(),
            "data_hash": hd.data_hash.hex().upper(),
            "validators_hash": hd.validators_hash.hex().upper(),
            "next_validators_hash": hd.next_validators_hash.hex().upper(),
            "consensus_hash": hd.consensus_hash.hex().upper(),
            "app_hash": hd.app_hash.hex().upper(),
            "last_results_hash": hd.last_results_hash.hex().upper(),
            "evidence_hash": hd.evidence_hash.hex().upper(),
            "proposer_address": hd.proposer_address.hex().upper(),
        }

    def _commit_json(self, h: int) -> dict:
        c = self.commits[h]
        return {
            "height": str(c.height),
            "round": c.round,
            "block_id": {
                "hash": c.block_id_hash.hex().upper(),
                "parts": {"total": str(c.part_total),
                          "hash": c.part_hash.hex().upper()},
            },
            "signatures": [
                {
                    "block_id_flag": s.block_id_flag,
                    "validator_address": s.validator_address.hex().upper(),
                    "timestamp": _ts(s.time_seconds, s.time_nanos),
                    "signature": base64.b64encode(s.signature).decode(),
                }
                for s in c.signatures
            ],
        }

    def _valset_json(self) -> dict:
        return {
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {"type": "tendermint/PubKeyEd25519",
                                "value": base64.b64encode(v.pubkey).decode()},
                    "voting_power": str(v.power),
                    "proposer_priority": "0",
                }
                for v in self.validators
            ],
        }

    def write(self, out_dir: str) -> str:
        """Emit the fixture tree: per-height header.json + signed_block.json
        and per-range data_commitment.json for every subrange used by the
        fetchers' on-demand lookups (ranges are written lazily via
        `write_data_commitment`)."""
        for h in self.headers:
            d = os.path.join(out_dir, str(h))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "header.json"), "w") as f:
                json.dump({"jsonrpc": "2.0", "id": -1,
                           "result": {"header": self._header_json(h)}}, f)
            with open(os.path.join(d, "signed_block.json"), "w") as f:
                json.dump({"jsonrpc": "2.0", "id": -1, "result": {
                    "header": self._header_json(h),
                    "commit": self._commit_json(h),
                    "data": {"txs": []},
                    "validator_set": self._valset_json(),
                }}, f)
        return out_dir

    def write_data_commitment(self, out_dir: str, start: int, end: int):
        """Node-computed expected root for [start, end) — the oracle the
        circuit output must equal (reference data_commitment.json)."""
        hashes = [self.headers[h].data_hash for h in range(start, end)]
        root = hdr.data_commitment_root(start, hashes)
        d = os.path.join(out_dir, f"{start}-{end}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "data_commitment.json"), "w") as f:
            json.dump({"jsonrpc": "2.0", "id": -1, "result": {
                "data_commitment": root.hex().upper()}}, f)
        return root


def make_chain_dir(out_dir: str, chain_id: str = "mocha-4",
                   n_validators: int = 4, start: int = 10000,
                   n_blocks: int = 8, commit_round: int = 0,
                   ranges: Optional[List] = None) -> SyntheticChain:
    chain = SyntheticChain(chain_id, n_validators, start, n_blocks,
                           commit_round)
    chain.write(out_dir)
    for s, e in (ranges or []):
        chain.write_data_commitment(out_dir, s, e)
    return chain
