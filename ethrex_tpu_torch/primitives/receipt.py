"""Receipts, logs, bloom filters: a copy of
`ethrex_tpu/primitives/receipt.py`."""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from . import rlp


@dataclasses.dataclass
class Log:
    address: bytes
    topics: list          # list[bytes32]
    data: bytes

    def to_fields(self):
        return [self.address, [bytes(t) for t in self.topics], self.data]

    @classmethod
    def from_fields(cls, f):
        return cls(bytes(f[0]), [bytes(t) for t in f[1]], bytes(f[2]))


def bloom_add(bloom: bytearray, value: bytes):
    h = keccak256(value)
    for i in (0, 2, 4):
        bit = ((h[i] << 8) | h[i + 1]) & 0x7FF
        bloom[256 - 1 - bit // 8] |= 1 << (bit % 8)


def logs_bloom(logs) -> bytes:
    bloom = bytearray(256)
    for log in logs:
        bloom_add(bloom, log.address)
        for t in log.topics:
            bloom_add(bloom, bytes(t))
    return bytes(bloom)


@dataclasses.dataclass
class Receipt:
    tx_type: int = 0
    succeeded: bool = True
    cumulative_gas_used: int = 0
    logs: list = dataclasses.field(default_factory=list)

    @property
    def bloom(self) -> bytes:
        return logs_bloom(self.logs)

    def to_fields(self) -> list:
        return [
            b"\x01" if self.succeeded else b"",
            self.cumulative_gas_used,
            self.bloom,
            [log.to_fields() for log in self.logs],
        ]

    @classmethod
    def from_fields(cls, f: list, tx_type: int = 0) -> "Receipt":
        return cls(
            tx_type=tx_type,
            succeeded=rlp.decode_int(f[0]) == 1,
            cumulative_gas_used=rlp.decode_int(f[1]),
            logs=[Log.from_fields(lf) for lf in f[3]],
        )

    def encode(self) -> bytes:
        """Canonical encoding (typed receipts get their type prefix)."""
        payload = rlp.encode(self.to_fields())
        if self.tx_type == 0:
            return payload
        return bytes([self.tx_type]) + payload

    @classmethod
    def decode(cls, data: bytes) -> "Receipt":
        data = bytes(data)
        tx_type = 0
        if data and data[0] < 0xC0:
            tx_type = data[0]
            data = data[1:]
        return cls.from_fields(rlp.decode(data), tx_type)
