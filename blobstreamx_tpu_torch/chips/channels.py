"""Bus channel ids shared by all chips (the values of
``blobstreamx_tpu/chips/channels.py``: a proof's fingerprints depend on them)."""

WIRE = 1        # (wire_index, value) — CPU dataflow routing
RANGE8 = 2      # (value) — byte range check against the bytes chip
SHA_W = 3       # (instance, block, slot, word) — message words to the SHA chip
SHA_OUT_A = 4   # (instance, j, word) — digest words 0..3 from the SHA chip
SHA_OUT_E = 5   # (instance, j, word) — digest words 4..7 from the SHA chip
SHA_CHAIN_A = 6 # (instance, block, j, word) — chip-internal chaining (a side)
SHA_CHAIN_E = 7 # (instance, block, j, word) — chip-internal chaining (e side)
PUBLIC = 8      # (position, value) — public inputs/outputs

# SHA-512 (64-bit words travel as u32 halves; halfslot = 2*slot + half, half 0 = lo)
SHA512_W = 9        # (instance, block, halfslot, half-word)
SHA512_OUT_A = 10   # (instance, halfj, half-word) — digest words 0..3
SHA512_OUT_E = 11   # (instance, halfj, half-word) — digest words 4..7
SHA512_CHAIN_A = 12 # (instance, block, halfj, half-word)
SHA512_CHAIN_E = 13 # (instance, block, halfj, half-word)

RANGE16 = 14    # (value) — 16-bit range check against the range16 chip

# Ed25519 EC chip (instance = signature index)
ED_SCALAR = 15  # (instance, which, limb_idx, limb) — scalars S (which=0) / k bytes
ED_POINT = 16   # (instance, which, byte_idx, byte) — compressed A (0) / R (1)
ED_OK = 17      # (instance, valid) — verification outcome bit

# Poseidon chip (instance = permutation id)
POS_IN = 18     # (instance, slot, value) — absorbed lanes 0..11, Merkle sib 12..15, dir 16
POS_OUT = 19    # (instance, lane, value) — output state lanes read by the CPU
