"""Circuit constants — parity with reference circuits/consts.rs (R1); a copy of
``blobstreamx_tpu/circuits/consts.py``."""

HASH_SIZE = 32
PROTOBUF_HASH_SIZE_BYTES = 34  # 0x0a 0x20 || hash
PROTOBUF_BLOCK_ID_SIZE_BYTES = 72
HEADER_PROOF_DEPTH = 4
PROTOBUF_VARINT_SIZE_BYTES = 9
ENC_DATA_ROOT_TUPLE_SIZE_BYTES = 64  # 32-byte BE height || 32-byte data hash
HEIGHT_INDEX = 2
LAST_BLOCK_ID_INDEX = 4
DATA_HASH_INDEX = 6

# in-circuit merkle paths for the depth-4 header tree (LSB-first index bits;
# reference circuits/builder.rs:166-169)
DATA_HASH_PATH = (False, True, True, False)  # index 6
LAST_BLOCK_ID_PATH = (False, False, True, False)  # index 4
NEXT_VALIDATORS_HASH_INDEX = 8
NEXT_VALIDATORS_PATH = (False, False, False, True)  # index 8 (14-leaf tree)
VALIDATORS_HASH_INDEX = 7
VALIDATORS_PATH = (True, True, True, False)  # index 7
