"""Tendermint vote sign-bytes + validator-set hashing — native host layer.

The port's copy of ``blobstreamx_tpu/tendermint/vote.py``.

Capability parity with tendermintx's native message reconstruction
(SURVEY.md D13/D14/D15): rebuilds the exact protobuf `CanonicalVote`
sign-bytes each validator Ed25519-signs for a precommit, and the
`SimpleValidator` leaf encoding whose Merkle root is the header's
`validators_hash`. Verified bit-exactly against the signatures of the
recorded mocha-4 fixtures (signed_block.json commits).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import List, Optional

from . import merkle
from .header import encode_varint, parse_rfc3339, _field_bytes, _field_varint
from . import ed25519

PRECOMMIT_TYPE = 2
BLOCK_ID_FLAG_COMMIT = 2


def _sfixed64(value: int) -> bytes:
    return (value & (1 << 64) - 1).to_bytes(8, "little")


def encode_canonical_block_id(hash_: bytes, part_total: int, part_hash: bytes) -> bytes:
    psh = _field_varint(1, part_total) + _field_bytes(2, part_hash)
    out = _field_bytes(1, hash_)
    if psh:
        out += bytes([0x12]) + encode_varint(len(psh)) + psh
    return out


def encode_timestamp_field(num: int, seconds: int, nanos: int) -> bytes:
    body = _field_varint(1, seconds) + _field_varint(2, nanos)
    return bytes([(num << 3) | 2]) + encode_varint(len(body)) + body


def canonical_vote_bytes(
    height: int,
    round_: int,
    block_id_hash: bytes,
    part_total: int,
    part_hash: bytes,
    time_seconds: int,
    time_nanos: int,
    chain_id: str,
) -> bytes:
    """Length-prefixed marshal of CanonicalVote (the signed message).

    Field layout (canonical.proto): type=1 varint, height=2 sfixed64,
    round=3 sfixed64, block_id=4, timestamp=5, chain_id=6. height/round are
    omitted when zero (gogoproto); type omitted when zero.
    """
    body = _field_varint(1, PRECOMMIT_TYPE)
    if height:
        body += bytes([0x11]) + _sfixed64(height)
    if round_:
        body += bytes([0x19]) + _sfixed64(round_)
    bid = encode_canonical_block_id(block_id_hash, part_total, part_hash)
    if bid:
        body += bytes([0x22]) + encode_varint(len(bid)) + bid
    body += encode_timestamp_field(5, time_seconds, time_nanos)
    body += _field_bytes(6, chain_id.encode())
    return encode_varint(len(body)) + body


# ---------------------------------------------------------------------------
# validator sets
# ---------------------------------------------------------------------------

@dataclass
class Validator:
    address: bytes
    pub_key: bytes  # 32-byte Ed25519
    voting_power: int

    @classmethod
    def from_json(cls, v: dict) -> "Validator":
        assert v["pub_key"]["type"] == "tendermint/PubKeyEd25519"
        return cls(
            address=bytes.fromhex(v["address"]),
            pub_key=base64.b64decode(v["pub_key"]["value"]),
            voting_power=int(v["voting_power"]),
        )

    def simple_encode(self) -> bytes:
        """SimpleValidator{pub_key{ed25519=1}, voting_power} marshal — the
        validators_hash leaf."""
        pk = _field_bytes(1, self.pub_key)
        return _field_bytes(1, pk) + _field_varint(2, self.voting_power)


def validator_set_hash(validators: List[Validator]) -> bytes:
    return merkle.hash_from_byte_slices([v.simple_encode() for v in validators])


# ---------------------------------------------------------------------------
# commits
# ---------------------------------------------------------------------------

@dataclass
class CommitSig:
    block_id_flag: int
    validator_address: bytes
    time_seconds: int
    time_nanos: int
    signature: Optional[bytes]

    @classmethod
    def from_json(cls, s: dict) -> "CommitSig":
        secs, nanos = (0, 0)
        if s.get("timestamp") and not s["timestamp"].startswith("0001-01-01"):
            secs, nanos = parse_rfc3339(s["timestamp"])
        sig = base64.b64decode(s["signature"]) if s.get("signature") else None
        return cls(
            block_id_flag=int(s["block_id_flag"]),
            validator_address=bytes.fromhex(s["validator_address"] or ""),
            time_seconds=secs,
            time_nanos=nanos,
            signature=sig,
        )


@dataclass
class Commit:
    height: int
    round: int
    block_id_hash: bytes
    part_total: int
    part_hash: bytes
    signatures: List[CommitSig]

    @classmethod
    def from_json(cls, c: dict) -> "Commit":
        bid = c["block_id"]
        return cls(
            height=int(c["height"]),
            round=int(c["round"]),
            block_id_hash=bytes.fromhex(bid["hash"]),
            part_total=int(bid["parts"]["total"]),
            part_hash=bytes.fromhex(bid["parts"]["hash"]),
            signatures=[CommitSig.from_json(s) for s in c["signatures"]],
        )

    def vote_sign_bytes(self, chain_id: str, sig_idx: int) -> bytes:
        s = self.signatures[sig_idx]
        return canonical_vote_bytes(
            self.height,
            self.round,
            self.block_id_hash,
            self.part_total,
            self.part_hash,
            s.time_seconds,
            s.time_nanos,
            chain_id,
        )


def verify_commit(
    commit: Commit, validators: List[Validator], chain_id: str
) -> List[bool]:
    """Per-validator signature validity (address-matched by position)."""
    out = []
    by_addr = {v.address: v for v in validators}
    for i, s in enumerate(commit.signatures):
        if s.block_id_flag != BLOCK_ID_FLAG_COMMIT or s.signature is None:
            out.append(False)
            continue
        v = by_addr.get(s.validator_address)
        if v is None:
            out.append(False)
            continue
        msg = commit.vote_sign_bytes(chain_id, i)
        out.append(ed25519.verify(v.pub_key, msg, s.signature))
    return out


def voting_power_signed(commit: Commit, validators: List[Validator],
                        chain_id: str) -> int:
    valid = verify_commit(commit, validators, chain_id)
    total = 0
    for s, ok in zip(commit.signatures, valid):
        if ok:
            for v in validators:
                if v.address == s.validator_address:
                    total += v.voting_power
    return total


def is_valid_skip(trusted_validators: List[Validator],
                  target_commit: Commit, chain_id: str) -> bool:
    """≥1/3 of the trusted set's power signed the target commit — native
    analogue of tendermintx `is_valid_skip` (reference circuits/fetcher.rs:76-85)."""
    total = sum(v.voting_power for v in trusted_validators)
    signed = voting_power_signed(target_commit, trusted_validators, chain_id)
    return 3 * signed > total
