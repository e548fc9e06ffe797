"""Batch-pre state oracles over the execution witness (a copy of
`ethrex_tpu/guest/witness_oracles.py`): the generic VM
circuit's source for reads the write log never captures (a slot only
SLOADed, an account only called).  Pure trie walks over the witness node
table — the same data `replay_log_against_witness` audits, so every
oracle answer the prover bakes into the fine log is re-checked against
the real MPT during verify_with_input.
"""

from __future__ import annotations

from ..crypto.keccak import keccak256
from ..primitives import rlp
from ..primitives.account import AccountState
from ..trie.trie import MissingNode, Trie


class WitnessOracles:
    """account_rlp / sload / code resolvers at the batch-initial root."""

    def __init__(self, witness, initial_root: bytes):
        self.nodes = {keccak256(n): bytes(n) for n in witness.nodes}
        self.codes = {keccak256(c): bytes(c) for c in witness.codes}
        self.root = initial_root

    def account_rlp(self, addr: bytes) -> bytes | None:
        try:
            trie = Trie.from_nodes(self.root, self.nodes, share=True)
            return trie.get(keccak256(addr)) or b""
        except MissingNode:
            return None

    def sload(self, addr: bytes, slot: int) -> int | None:
        acct = self.account_rlp(addr)
        if not acct:
            return 0 if acct == b"" else None
        try:
            st = AccountState.decode(acct)
            storage = Trie.from_nodes(st.storage_root, self.nodes,
                                      share=True)
            raw = storage.get(keccak256(slot.to_bytes(32, "big")))
            return rlp.decode_int(rlp.decode(raw)) if raw else 0
        except MissingNode:
            return None

    def code(self, code_hash: bytes) -> bytes | None:
        return self.codes.get(code_hash)
