"""Tendermint header protobuf encoding + hashing — native host implementation.

A copy of ``blobstreamx_tpu/tendermint/header.py``. Capability parity with
the reference's tendermintx native input layer
(SURVEY.md D15/D16): reproduces celestia-core's ``Header.Hash()`` — a
Tendermint Merkle root over the 14 protobuf-encoded header fields — and the
depth-4 inclusion proofs for the ``data_hash`` (leaf index 6) and
``last_block_id`` (leaf index 4) leaves consumed by the data-commitment
circuits (reference circuits/consts.rs:21-23, circuits/input.rs:149-271).

Verified bit-exactly against the recorded mocha-4 fixtures
(header 10000's hash == header 10001's last_block_id.hash, etc.).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import merkle

HEADER_NUM_FIELDS = 14
DATA_HASH_INDEX = 6
LAST_BLOCK_ID_INDEX = 4
HEADER_PROOF_DEPTH = 4
PROTOBUF_HASH_SIZE_BYTES = 34
PROTOBUF_BLOCK_ID_SIZE_BYTES = 72


# ---------------------------------------------------------------------------
# protobuf primitives (gogoproto cdcEncode semantics)
# ---------------------------------------------------------------------------

def encode_varint(value: int) -> bytes:
    assert value >= 0
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(num: int, value: int, omit_zero: bool = True) -> bytes:
    if value == 0 and omit_zero:
        return b""
    return bytes([num << 3]) + encode_varint(value)


def _field_bytes(num: int, value: bytes, omit_empty: bool = True) -> bytes:
    if not value and omit_empty:
        return b""
    return bytes([(num << 3) | 2]) + encode_varint(len(value)) + value


def cdc_encode_bytes(value: bytes) -> bytes:
    """gogotypes.BytesValue{Value: v}.Marshal()"""
    return _field_bytes(1, value)


def cdc_encode_string(value: str) -> bytes:
    """gogotypes.StringValue{Value: v}.Marshal()"""
    return _field_bytes(1, value.encode())


def cdc_encode_int64(value: int) -> bytes:
    """gogotypes.Int64Value{Value: v}.Marshal()"""
    return _field_varint(1, value)


def encode_timestamp(seconds: int, nanos: int) -> bytes:
    return _field_varint(1, seconds) + _field_varint(2, nanos)


def encode_consensus_version(block: int, app: int) -> bytes:
    return _field_varint(1, block) + _field_varint(2, app)


def encode_part_set_header(total: int, hash_: bytes) -> bytes:
    return _field_varint(1, total) + _field_bytes(2, hash_)


def encode_block_id(hash_: bytes, part_total: int, part_hash: bytes) -> bytes:
    """Protobuf BlockID marshal (72 bytes when all fields are 32-byte hashes)."""
    psh = encode_part_set_header(part_total, part_hash)
    # gogoproto marshals the nested PartSetHeader unconditionally (it is a
    # non-nullable field) — encode even when empty.
    return _field_bytes(1, hash_) + bytes([0x12]) + encode_varint(len(psh)) + psh


def parse_rfc3339(ts: str) -> Tuple[int, int]:
    """RFC3339 'YYYY-MM-DDTHH:MM:SS[.fraction]Z' -> (unix_seconds, nanos)."""
    import calendar
    import datetime as dt

    assert ts.endswith("Z")
    body = ts[:-1]
    if "." in body:
        main, frac = body.split(".")
        nanos = int(frac.ljust(9, "0")[:9])
    else:
        main, nanos = body, 0
    t = dt.datetime.strptime(main, "%Y-%m-%dT%H:%M:%S")
    return calendar.timegm(t.timetuple()), nanos


# ---------------------------------------------------------------------------
# Header
# ---------------------------------------------------------------------------

@dataclass
class BlockId:
    hash: bytes
    part_total: int
    part_hash: bytes

    def encode(self) -> bytes:
        return encode_block_id(self.hash, self.part_total, self.part_hash)


@dataclass
class Header:
    version_block: int
    version_app: int
    chain_id: str
    height: int
    time_seconds: int
    time_nanos: int
    last_block_id: Optional[BlockId]
    last_commit_hash: bytes
    data_hash: bytes
    validators_hash: bytes
    next_validators_hash: bytes
    consensus_hash: bytes
    app_hash: bytes
    last_results_hash: bytes
    evidence_hash: bytes
    proposer_address: bytes

    @classmethod
    def from_json(cls, h: dict) -> "Header":
        """Parse the Tendermint RPC header JSON (fixture format)."""
        version = h.get("version", {})
        lbi = h.get("last_block_id")
        block_id = None
        if lbi and lbi.get("hash"):
            block_id = BlockId(
                hash=bytes.fromhex(lbi["hash"]),
                part_total=int(lbi["parts"]["total"]),
                part_hash=bytes.fromhex(lbi["parts"]["hash"]),
            )
        secs, nanos = parse_rfc3339(h["time"])

        def hx(key):
            v = h.get(key) or ""
            return bytes.fromhex(v)

        return cls(
            version_block=int(version.get("block", 0)),
            version_app=int(version.get("app", 0)),
            chain_id=h["chain_id"],
            height=int(h["height"]),
            time_seconds=secs,
            time_nanos=nanos,
            last_block_id=block_id,
            last_commit_hash=hx("last_commit_hash"),
            data_hash=hx("data_hash"),
            validators_hash=hx("validators_hash"),
            next_validators_hash=hx("next_validators_hash"),
            consensus_hash=hx("consensus_hash"),
            app_hash=hx("app_hash"),
            last_results_hash=hx("last_results_hash"),
            evidence_hash=hx("evidence_hash"),
            proposer_address=hx("proposer_address"),
        )

    def field_bytes(self) -> List[bytes]:
        """The 14 protobuf-encoded leaves hashed into the header hash."""
        lbi = self.last_block_id.encode() if self.last_block_id else encode_block_id(b"", 0, b"")
        return [
            encode_consensus_version(self.version_block, self.version_app),
            cdc_encode_string(self.chain_id),
            cdc_encode_int64(self.height),
            encode_timestamp(self.time_seconds, self.time_nanos),
            lbi,
            cdc_encode_bytes(self.last_commit_hash),
            cdc_encode_bytes(self.data_hash),
            cdc_encode_bytes(self.validators_hash),
            cdc_encode_bytes(self.next_validators_hash),
            cdc_encode_bytes(self.consensus_hash),
            cdc_encode_bytes(self.app_hash),
            cdc_encode_bytes(self.last_results_hash),
            cdc_encode_bytes(self.evidence_hash),
            cdc_encode_bytes(self.proposer_address),
        ]

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(self.field_bytes())

    def inclusion_proof(self, index: int) -> Tuple[bytes, List[bytes]]:
        """(leaf, aunts) for the given field index against self.hash()."""
        fields = self.field_bytes()
        _, proofs = merkle.proofs_from_byte_slices(fields)
        return fields[index], proofs[index]

    def data_hash_proof(self) -> Tuple[bytes, List[bytes]]:
        """34-byte protobuf data_hash leaf + depth-4 aunts."""
        return self.inclusion_proof(DATA_HASH_INDEX)

    def last_block_id_proof(self) -> Tuple[bytes, List[bytes]]:
        """72-byte protobuf last_block_id leaf + depth-4 aunts."""
        return self.inclusion_proof(LAST_BLOCK_ID_INDEX)


# ---------------------------------------------------------------------------
# Data commitments (Blobstream data-root tunnel)
# ---------------------------------------------------------------------------

def encode_data_root_tuple(height: int, data_hash: bytes) -> bytes:
    """abi.encode(height, data_hash): 32-byte BE height || 32-byte hash.

    Reference: circuits/builder.rs:82-103.
    """
    assert len(data_hash) == 32
    return height.to_bytes(32, "big") + data_hash


def data_commitment_root(start_height: int, data_hashes: List[bytes]) -> bytes:
    """Merkle root over abi.encode(height, data_hash) tuples for the range
    [start_height, start_height + len(data_hashes))."""
    leaves = [
        encode_data_root_tuple(start_height + i, dh) for i, dh in enumerate(data_hashes)
    ]
    return merkle.hash_from_byte_slices(leaves)
