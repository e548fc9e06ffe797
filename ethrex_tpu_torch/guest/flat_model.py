"""Poseidon2 flat key/value model for the execution proof's account entries.

A copy of `ethrex_tpu/guest/flat_model.py` (host code).  Account entries
in the touched-state tree are Poseidon2 digests of structured data, not
opaque keccak commitments, so the transfer circuit
(models/transfer_air.py) can recompute them from account FIELDS entirely
in-trace:

  * account key   = pack32(P2_sponge([ACCOUNT_TAG, addr_limbs(address)]))
  * account value = pack32(P2_sponge(fields_limbs(state))), 0^32 if absent
    with fields_limbs = [nonce(3 limbs), balance(11), storage_root(11),
    code_hash(11)] — 36 BabyBear limbs, 24-bit big-endian groups.

`pack32` stores an 8-limb digest in 32 bytes as 8 x 3-byte low parts
followed by 8 x 1-byte high parts (each < 2^7, since BabyBear < 2^31), so
the 11 x 24-bit limbing the state-update AIR applies to any 32-byte flat
value needs NO bit alignment work against the digest limbs: the VM circuit
absorbs full digest limbs, the host unpacks the same limbs from the stored
bytes, and the state AIR's own limbing of the same bytes stays internally
consistent (both are derived from one canonical 32-byte string).

Storage entries keep their keccak-derived keys and raw 32-byte values —
they become circuit-visible in a later round when SLOAD/SSTORE semantics
are arithmetized (reference equivalent: the zkVM executes them natively,
crates/guest-program/src/common/execution.rs:42-209).
"""

from __future__ import annotations

from ..ops import babybear as bb
from ..ops.merkle import hash_leaf_ref
from ..primitives.account import AccountState

ACCOUNT_TAG = 1

# EIP-161/158 boundary constants as circuit limbs
NONCE_LIMBS = 3
BAL_LIMBS = 11
WORD_LIMBS = 11
FIELD_LIMBS = NONCE_LIMBS + BAL_LIMBS + 2 * WORD_LIMBS  # 36


def int_limbs(value: int, n: int) -> list[int]:
    """Unsigned int -> n big-endian 24-bit limbs."""
    if value < 0 or value >= 1 << (24 * n):
        raise ValueError(f"value does not fit {n} limbs")
    return [(value >> (24 * (n - 1 - i))) & 0xFFFFFF for i in range(n)]


def word_limbs24(word: bytes) -> list[int]:
    """32-byte word -> 11 limbs (10 x 3-byte + 1 x 2-byte), the same
    slicing stark/state_tree.word_limbs applies to flat values."""
    if len(word) != 32:
        raise ValueError("need a 32-byte word")
    return [int.from_bytes(word[i:i + 3], "big") for i in range(0, 32, 3)]


def addr_limbs(address: bytes) -> list[int]:
    """20-byte address -> 7 limbs (6 x 3-byte + 1 x 2-byte)."""
    if len(address) != 20:
        raise ValueError("need a 20-byte address")
    return [int.from_bytes(address[i:i + 3], "big")
            for i in range(0, 20, 3)]


def fields_limbs(state: AccountState) -> list[int]:
    return (int_limbs(state.nonce, NONCE_LIMBS)
            + int_limbs(state.balance, BAL_LIMBS)
            + word_limbs24(state.storage_root)
            + word_limbs24(state.code_hash))


def pack32(digest: list[int]) -> bytes:
    """8 BabyBear limbs -> 32 bytes: 3-byte low parts then 1-byte highs."""
    lows = b"".join((int(d) & 0xFFFFFF).to_bytes(3, "big") for d in digest)
    highs = bytes((int(d) >> 24) & 0x7F for d in digest)
    return lows + highs


def unpack32(value: bytes) -> list[int]:
    """Inverse of pack32 (returns the 8 digest limbs)."""
    if len(value) != 32:
        raise ValueError("need a 32-byte packed digest")
    return [int.from_bytes(value[3 * i:3 * i + 3], "big")
            | (value[24 + i] << 24) for i in range(8)]


def account_key_digest(address: bytes) -> list[int]:
    return hash_leaf_ref([ACCOUNT_TAG] + addr_limbs(address))


def account_key32(address: bytes) -> bytes:
    return pack32(account_key_digest(address))


def account_value_digest(state: AccountState) -> list[int]:
    return hash_leaf_ref(fields_limbs(state))


def account_value32(state_rlp: bytes) -> bytes:
    """Flat value of an account entry from its RLP (0^32 when absent)."""
    if not state_rlp:
        return b"\x00" * 32
    return pack32(account_value_digest(AccountState.decode(state_rlp)))


def digest_limbs_of_value32(value: bytes) -> list[int]:
    """Digest limbs a circuit absorbs for a flat account value: the
    unpacked digest, or eight zeros for the absent marker."""
    if value == b"\x00" * 32:
        return [0] * 8
    return [v % bb.P for v in unpack32(value)]
