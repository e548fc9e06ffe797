"""Account state types: a copy of `ethrex_tpu/primitives/account.py`
(the four-field account record, the in-memory account of a genesis
allocation, and the empty-trie / empty-code hashes)."""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import _keccak256_py, keccak256
from . import rlp

# keccak256(rlp("")) — root of the empty trie
EMPTY_TRIE_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)
EMPTY_CODE_HASH = _keccak256_py(b"")


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


@dataclasses.dataclass
class Account:
    """Full account: state record + code + storage (in-memory form)."""

    state: AccountState = dataclasses.field(default_factory=AccountState)
    code: bytes = b""
    storage: dict = dataclasses.field(default_factory=dict)  # int -> int

    @classmethod
    def new(cls, nonce=0, balance=0, code=b"", storage=None) -> "Account":
        return cls(
            AccountState(nonce=nonce, balance=balance,
                         code_hash=keccak256(code) if code
                         else EMPTY_CODE_HASH),
            code=code, storage=dict(storage or {}),
        )
