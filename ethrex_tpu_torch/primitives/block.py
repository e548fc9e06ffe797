"""Block header/body types through Prague: a copy of
`ethrex_tpu/primitives/block.py`."""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import _keccak256_py, keccak256
from . import rlp
from .account import EMPTY_TRIE_ROOT
from .transaction import Transaction

EMPTY_UNCLE_HASH = _keccak256_py(rlp.encode([]))
ZERO_HASH = b"\x00" * 32
ZERO_ADDR = b"\x00" * 20
ZERO_BLOOM = b"\x00" * 256
ZERO_NONCE = b"\x00" * 8


@dataclasses.dataclass
class Withdrawal:
    index: int = 0
    validator_index: int = 0
    address: bytes = ZERO_ADDR
    amount: int = 0  # in gwei

    def to_fields(self):
        return [self.index, self.validator_index, self.address, self.amount]

    @classmethod
    def from_fields(cls, f):
        return cls(rlp.decode_int(f[0]), rlp.decode_int(f[1]), bytes(f[2]),
                   rlp.decode_int(f[3]))


@dataclasses.dataclass
class BlockHeader:
    parent_hash: bytes = ZERO_HASH
    uncles_hash: bytes = EMPTY_UNCLE_HASH
    coinbase: bytes = ZERO_ADDR
    state_root: bytes = EMPTY_TRIE_ROOT
    tx_root: bytes = EMPTY_TRIE_ROOT
    receipts_root: bytes = EMPTY_TRIE_ROOT
    bloom: bytes = ZERO_BLOOM
    difficulty: int = 0
    number: int = 0
    gas_limit: int = 0
    gas_used: int = 0
    timestamp: int = 0
    extra_data: bytes = b""
    prev_randao: bytes = ZERO_HASH     # mixHash pre-merge
    nonce: bytes = ZERO_NONCE
    base_fee_per_gas: int | None = None       # EIP-1559 (London)
    withdrawals_root: bytes | None = None     # Shanghai
    blob_gas_used: int | None = None          # Cancun
    excess_blob_gas: int | None = None        # Cancun
    parent_beacon_block_root: bytes | None = None  # Cancun
    requests_hash: bytes | None = None        # Prague (EIP-7685)

    def to_fields(self) -> list:
        f = [self.parent_hash, self.uncles_hash, self.coinbase,
             self.state_root, self.tx_root, self.receipts_root, self.bloom,
             self.difficulty, self.number, self.gas_limit, self.gas_used,
             self.timestamp, self.extra_data, self.prev_randao, self.nonce]
        optional = [self.base_fee_per_gas, self.withdrawals_root,
                    self.blob_gas_used, self.excess_blob_gas,
                    self.parent_beacon_block_root, self.requests_hash]
        # trailing optionals are only encoded up to the last present one,
        # and presence must be contiguous (fork-ordered)
        last = -1
        for i, v in enumerate(optional):
            if v is not None:
                last = i
        for i in range(last + 1):
            if optional[i] is None:
                raise ValueError("non-contiguous optional header fields")
            f.append(optional[i])
        return f

    def encode(self) -> bytes:
        return rlp.encode(self.to_fields())

    @classmethod
    def decode_fields(cls, f: list) -> "BlockHeader":
        if not 15 <= len(f) <= 21:
            raise rlp.RLPError(f"bad header field count {len(f)}")
        h = cls(
            parent_hash=bytes(f[0]), uncles_hash=bytes(f[1]),
            coinbase=bytes(f[2]), state_root=bytes(f[3]), tx_root=bytes(f[4]),
            receipts_root=bytes(f[5]), bloom=bytes(f[6]),
            difficulty=rlp.decode_int(f[7]), number=rlp.decode_int(f[8]),
            gas_limit=rlp.decode_int(f[9]), gas_used=rlp.decode_int(f[10]),
            timestamp=rlp.decode_int(f[11]), extra_data=bytes(f[12]),
            prev_randao=bytes(f[13]), nonce=bytes(f[14]),
        )
        if len(f) > 15:
            h.base_fee_per_gas = rlp.decode_int(f[15])
        if len(f) > 16:
            h.withdrawals_root = bytes(f[16])
        if len(f) > 17:
            h.blob_gas_used = rlp.decode_int(f[17])
        if len(f) > 18:
            h.excess_blob_gas = rlp.decode_int(f[18])
        if len(f) > 19:
            h.parent_beacon_block_root = bytes(f[19])
        if len(f) > 20:
            h.requests_hash = bytes(f[20])
        return h

    @classmethod
    def decode(cls, data: bytes) -> "BlockHeader":
        return cls.decode_fields(rlp.decode(data))

    @property
    def hash(self) -> bytes:
        return keccak256(self.encode())


@dataclasses.dataclass
class BlockBody:
    transactions: list = dataclasses.field(default_factory=list)
    uncles: list = dataclasses.field(default_factory=list)  # raw header fields
    withdrawals: list | None = None

    def to_fields(self) -> list:
        txs = []
        for tx in self.transactions:
            if tx.tx_type == 0:
                txs.append(tx._payload_fields(for_signing=False))
            else:
                txs.append(tx.encode_canonical())
        f = [txs, self.uncles]
        if self.withdrawals is not None:
            f.append([wd.to_fields() for wd in self.withdrawals])
        return f

    @classmethod
    def from_fields(cls, f: list) -> "BlockBody":
        txs = []
        for item in f[0]:
            if isinstance(item, list):
                txs.append(Transaction._decode_legacy(item))
            else:
                txs.append(Transaction.decode_canonical(bytes(item)))
        body = cls(transactions=txs, uncles=f[1])
        if len(f) > 2:
            body.withdrawals = [Withdrawal.from_fields(w) for w in f[2]]
        return body


@dataclasses.dataclass
class Block:
    header: BlockHeader
    body: BlockBody

    def encode(self) -> bytes:
        return rlp.encode([self.header.to_fields()] + self.body.to_fields())

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        f = rlp.decode(data)
        header = BlockHeader.decode_fields(f[0])
        body = BlockBody.from_fields(f[1:])
        return cls(header, body)

    @property
    def hash(self) -> bytes:
        return self.header.hash
