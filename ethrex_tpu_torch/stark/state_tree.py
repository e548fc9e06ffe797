"""Touched-state commitment tree: the host side of the execution AIR.

A copy of `ethrex_tpu/stark/state_tree.py` (host code only).

The execution proof (models/state_update_air.py) binds the batch's state
transition as a chain of single-leaf updates on a dense Poseidon2 Merkle
tree over the *touched* key set — the prover-internal analog of the state
commitment the reference's zkVM guest maintains via the keccak MPT
(the guest program's `execute_blocks` state handling).

Key/value model (flat, uniform for accounts and storage):
  * account entry:  key = keccak(0x00 || address)          (20-byte address)
                    value = keccak(rlp(account_state)), or 0^32 if absent
  * storage entry:  key = keccak(0x01 || address || slot32)
                    value = the 32-byte slot value (0^32 when unset/cleared)

Leaves are hash_leaf_ref(limbs(key) || limbs(value)) — the framework's
Poseidon2 sponge leaf rule (ops/merkle.py) — so a leaf binds its own key:
opening a leaf at ANY position proves which key it carries, making the
(witness) path position irrelevant for key identity.  Unoccupied positions
hold the all-zero digest, which is not a sponge image of any in-range
preimage the prover can exhibit.

The verifier rebuilds this tree from the execution witness (whose MPT
proofs hash-check against the pre-state root) WITHOUT re-executing the EVM,
then checks the proof's public pre/post tree roots and replays the write
log into the MPT to validate the claimed post-state root.
"""

from __future__ import annotations

from ..ops.merkle import compress_ref, hash_leaf_ref

LIMBS_PER_WORD = 11  # 32 bytes -> 10 x 3-byte limbs + 1 x 2-byte limb


def word_limbs(word: bytes) -> list[int]:
    """32-byte big-endian word -> 11 BabyBear limbs (3-byte groups)."""
    if len(word) != 32:
        raise ValueError("state words are 32 bytes")
    return [int.from_bytes(word[i:i + 3], "big") for i in range(0, 32, 3)]


def leaf_limbs(key: bytes, value: bytes) -> list[int]:
    return word_limbs(key) + word_limbs(value)


EMPTY_LEAF = [0] * 8


class TouchedStateTree:
    """Dense Poseidon2 tree over the sorted touched-key set.

    Positions are assigned by sorting the key set once at construction; the
    same key always lives at the same position, so the sequential update
    chain proven in-circuit mirrors exactly what `update` does here.
    """

    def __init__(self, entries: dict[bytes, bytes], depth: int):
        if len(entries) > (1 << depth):
            raise ValueError(
                f"{len(entries)} touched keys exceed tree capacity 2^{depth}")
        self.depth = depth
        self.keys = sorted(entries)
        self.index = {k: i for i, k in enumerate(self.keys)}
        self.values = dict(entries)
        size = 1 << depth
        leaves = [hash_leaf_ref(leaf_limbs(k, entries[k]))
                  for k in self.keys]
        leaves += [list(EMPTY_LEAF)] * (size - len(leaves))
        self.levels = [leaves]
        while len(leaves) > 1:
            leaves = [compress_ref(leaves[i], leaves[i + 1])
                      for i in range(0, len(leaves), 2)]
            self.levels.append(leaves)

    @property
    def root(self) -> list[int]:
        return list(self.levels[-1][0])

    def path(self, index: int) -> tuple[list[list[int]], list[int]]:
        """(siblings bottom-up, direction bits) for leaf `index`."""
        sibs, bits = [], []
        idx = index
        for level in self.levels[:-1]:
            sibs.append(list(level[idx ^ 1]))
            bits.append(idx & 1)
            idx >>= 1
        return sibs, bits

    def update(self, key: bytes, new_value: bytes) -> "AccessRecord":
        """Apply one write; returns the record the AIR trace consumes.

        The siblings captured are shared by the old and new openings — a
        single-leaf update leaves every sibling on the path unchanged,
        which is exactly what the two in-circuit fold lanes rely on.
        """
        idx = self.index.get(key)
        if idx is None:
            raise KeyError(f"key {key.hex()} not in the touched set")
        old_value = self.values[key]
        sibs, bits = self.path(idx)
        rec = AccessRecord(key=key, old_value=old_value,
                           new_value=new_value, index=idx,
                           siblings=sibs, bits=bits)
        self.values[key] = new_value
        node = hash_leaf_ref(leaf_limbs(key, new_value))
        self.levels[0][idx] = node
        pos = idx
        for lvl in range(self.depth):
            sib = self.levels[lvl][pos ^ 1]
            if pos & 1:
                node = compress_ref(sib, node)
            else:
                node = compress_ref(node, sib)
            pos >>= 1
            self.levels[lvl + 1][pos] = node
        return rec


class AccessRecord:
    """One (key, old, new) write with its authentication path."""

    __slots__ = ("key", "old_value", "new_value", "index", "siblings",
                 "bits")

    def __init__(self, key: bytes, old_value: bytes, new_value: bytes,
                 index: int, siblings: list[list[int]], bits: list[int]):
        self.key = key
        self.old_value = old_value
        self.new_value = new_value
        self.index = index
        self.siblings = siblings
        self.bits = bits

    def msg_limbs(self) -> list[int]:
        """The 33 trace message limbs: key || old || new."""
        return (word_limbs(self.key) + word_limbs(self.old_value)
                + word_limbs(self.new_value))

    def old_leaf_digest(self) -> list[int]:
        return hash_leaf_ref(leaf_limbs(self.key, self.old_value))

    def new_leaf_digest(self) -> list[int]:
        return hash_leaf_ref(leaf_limbs(self.key, self.new_value))


def tree_depth_for(num_keys: int, minimum: int = 1) -> int:
    depth = max(minimum, (max(1, num_keys) - 1).bit_length())
    return depth
