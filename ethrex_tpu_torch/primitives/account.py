"""Account state types: a copy of `ethrex_tpu/primitives/account.py`
(the four-field account record and the empty-trie / empty-code hashes)."""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from . import rlp

# keccak256(rlp("")) — root of the empty trie
EMPTY_TRIE_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)
EMPTY_CODE_HASH = keccak256(b"")


@dataclasses.dataclass
class AccountState:
    """The four-field account record stored in the state trie."""

    nonce: int = 0
    balance: int = 0
    storage_root: bytes = EMPTY_TRIE_ROOT
    code_hash: bytes = EMPTY_CODE_HASH

    def encode(self) -> bytes:
        return rlp.encode(
            [self.nonce, self.balance, self.storage_root, self.code_hash]
        )

    @classmethod
    def decode(cls, data: bytes) -> "AccountState":
        n, b, sr, ch = rlp.decode(data)
        return cls(rlp.decode_int(n), rlp.decode_int(b), bytes(sr), bytes(ch))

    @property
    def is_empty(self) -> bool:
        return (self.nonce == 0 and self.balance == 0
                and self.code_hash == EMPTY_CODE_HASH)
