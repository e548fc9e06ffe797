"""Transaction types: Legacy, EIP-2930, EIP-1559, EIP-4844, EIP-7702.

A copy of `ethrex_tpu/primitives/transaction.py`: one dataclass for every
type, with shared encode/sign/recover logic.

Wire forms:
  * canonical: legacy = rlp(fields); typed = type_byte || rlp(fields)
  * in-block: same (typed txs appear as byte strings inside the tx list)
"""

from __future__ import annotations

import dataclasses

from ..crypto import secp256k1
from ..crypto.keccak import keccak256
from . import rlp

TYPE_LEGACY = 0x00
TYPE_ACCESS_LIST = 0x01
TYPE_DYNAMIC_FEE = 0x02
TYPE_BLOB = 0x03
TYPE_SET_CODE = 0x04
# L2 privileged transaction (L1-originated deposit/message; no signature —
# authorized by inclusion on L1, like the reference's PrivilegedL2Transaction)
TYPE_PRIVILEGED = 0x7E

# Memoized "signature recovery failed" marker for the `_sender` cache.
# `None` there means "not computed yet", so failures need a distinct value
# or every sender() call on an invalid-signature tx re-runs full EC math.
SENDER_INVALID = object()


def _addr(b) -> bytes:
    b = bytes(b)
    if len(b) not in (0, 20):
        raise ValueError(f"bad address length {len(b)}")
    return b


def _encode_access_list(al):
    return [[addr, [s.to_bytes(32, "big") if isinstance(s, int) else s
                    for s in slots]] for addr, slots in al]


def _decode_access_list(raw):
    return [(bytes(entry[0]),
             [int.from_bytes(bytes(s), "big") for s in entry[1]])
            for entry in raw]


@dataclasses.dataclass
class Transaction:
    """Unified transaction; `tx_type` selects the wire format.

    Unused fields stay at their defaults for older types (e.g. legacy txs
    ignore max_fee_per_blob_gas / authorization_list).
    """

    tx_type: int = TYPE_LEGACY
    chain_id: int | None = None     # None = pre-EIP-155 legacy
    nonce: int = 0
    gas_price: int = 0              # legacy/2930
    max_priority_fee_per_gas: int = 0
    max_fee_per_gas: int = 0
    gas_limit: int = 0
    to: bytes = b""                 # empty = create
    value: int = 0
    data: bytes = b""
    access_list: list = dataclasses.field(default_factory=list)
    max_fee_per_blob_gas: int = 0
    blob_versioned_hashes: list = dataclasses.field(default_factory=list)
    authorization_list: list = dataclasses.field(default_factory=list)
    v: int = 0                      # legacy: full v; typed: y_parity
    r: int = 0
    s: int = 0
    from_addr: bytes = b""          # privileged txs: explicit sender

    # caches (excluded from equality: two equal txs must compare equal
    # regardless of which has computed hash/sender)
    _sender: bytes | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _hash: bytes | None = dataclasses.field(
        default=None, repr=False, compare=False)

    # ---------------- encoding ----------------
    def _fee_fields(self):
        if self.tx_type in (TYPE_LEGACY, TYPE_ACCESS_LIST):
            return [self.gas_price]
        return [self.max_priority_fee_per_gas, self.max_fee_per_gas]

    def _payload_fields(self, for_signing: bool) -> list:
        t = self.tx_type
        if t == TYPE_PRIVILEGED:
            return [self.chain_id or 0, self.nonce, self.from_addr,
                    self.to, self.value, self.gas_limit, self.data]
        if t == TYPE_LEGACY:
            f = [self.nonce, self.gas_price, self.gas_limit, self.to,
                 self.value, self.data]
            if for_signing:
                if self.chain_id is not None:
                    f += [self.chain_id, b"", b""]
            else:
                f += [self.v, self.r, self.s]
            return f
        f = [self.chain_id or 0, self.nonce]
        f += self._fee_fields()
        f += [self.gas_limit, self.to, self.value, self.data,
              _encode_access_list(self.access_list)]
        if t == TYPE_BLOB:
            f += [self.max_fee_per_blob_gas,
                  [bytes(h) for h in self.blob_versioned_hashes]]
        if t == TYPE_SET_CODE:
            f += [[self._encode_auth(a) for a in self.authorization_list]]
        if not for_signing:
            f += [self.v, self.r, self.s]
        return f

    @staticmethod
    def _encode_auth(a) -> list:
        # authorization tuple: (chain_id, address, nonce, y_parity, r, s)
        return [a["chain_id"], a["address"], a["nonce"],
                a["y_parity"], a["r"], a["s"]]

    @staticmethod
    def _decode_auth(raw) -> dict:
        return {
            "chain_id": rlp.decode_int(raw[0]), "address": bytes(raw[1]),
            "nonce": rlp.decode_int(raw[2]), "y_parity": rlp.decode_int(raw[3]),
            "r": rlp.decode_int(raw[4]), "s": rlp.decode_int(raw[5]),
        }

    def encode_canonical(self) -> bytes:
        body = rlp.encode(self._payload_fields(for_signing=False))
        if self.tx_type == TYPE_LEGACY:
            return body
        return bytes([self.tx_type]) + body

    def signing_hash(self) -> bytes:
        body = rlp.encode(self._payload_fields(for_signing=True))
        if self.tx_type == TYPE_LEGACY:
            return keccak256(body)
        return keccak256(bytes([self.tx_type]) + body)

    @property
    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = keccak256(self.encode_canonical())
        return self._hash

    # ---------------- decoding ----------------
    @classmethod
    def decode_canonical(cls, data: bytes) -> "Transaction":
        data = bytes(data)
        if not data:
            raise rlp.RLPError("empty transaction")
        if data[0] >= 0xC0:
            return cls._decode_legacy(rlp.decode(data))
        t = data[0]
        fields = rlp.decode(data[1:])
        return cls._decode_typed(t, fields)

    @classmethod
    def _decode_legacy(cls, f) -> "Transaction":
        if len(f) != 9:
            raise rlp.RLPError("legacy tx must have 9 fields")
        v = rlp.decode_int(f[6])
        chain_id = None
        if v >= 35:
            chain_id = (v - 35) // 2
        tx = cls(
            tx_type=TYPE_LEGACY, chain_id=chain_id,
            nonce=rlp.decode_int(f[0]), gas_price=rlp.decode_int(f[1]),
            gas_limit=rlp.decode_int(f[2]), to=_addr(f[3]),
            value=rlp.decode_int(f[4]), data=bytes(f[5]),
            v=v, r=rlp.decode_int(f[7]), s=rlp.decode_int(f[8]),
        )
        return tx

    @classmethod
    def _decode_typed(cls, t: int, f: list) -> "Transaction":
        if t == TYPE_PRIVILEGED:
            if len(f) != 7:
                raise rlp.RLPError("privileged tx must have 7 fields")
            return cls(
                tx_type=t, chain_id=rlp.decode_int(f[0]),
                nonce=rlp.decode_int(f[1]), from_addr=bytes(f[2]),
                to=_addr(f[3]), value=rlp.decode_int(f[4]),
                gas_limit=rlp.decode_int(f[5]), data=bytes(f[6]),
            )
        base_len = {TYPE_ACCESS_LIST: 8, TYPE_DYNAMIC_FEE: 9,
                    TYPE_BLOB: 11, TYPE_SET_CODE: 10}.get(t)
        if base_len is None:
            raise rlp.RLPError(f"unknown tx type {t}")
        if len(f) != base_len + 3:
            raise rlp.RLPError(f"type-{t} tx must have {base_len + 3} fields")
        i = 0
        chain_id = rlp.decode_int(f[i]); i += 1
        nonce = rlp.decode_int(f[i]); i += 1
        if t == TYPE_ACCESS_LIST:
            gas_price = rlp.decode_int(f[i]); i += 1
            prio = fee = 0
        else:
            prio = rlp.decode_int(f[i]); i += 1
            fee = rlp.decode_int(f[i]); i += 1
            gas_price = 0
        gas_limit = rlp.decode_int(f[i]); i += 1
        to = _addr(f[i]); i += 1
        value = rlp.decode_int(f[i]); i += 1
        data = bytes(f[i]); i += 1
        access_list = _decode_access_list(f[i]); i += 1
        max_blob_fee = 0
        blob_hashes = []
        auths = []
        if t == TYPE_BLOB:
            max_blob_fee = rlp.decode_int(f[i]); i += 1
            blob_hashes = [bytes(h) for h in f[i]]; i += 1
            if not to:
                raise rlp.RLPError("blob tx cannot create")
        if t == TYPE_SET_CODE:
            auths = [cls._decode_auth(a) for a in f[i]]; i += 1
        v = rlp.decode_int(f[i])
        r = rlp.decode_int(f[i + 1])
        s = rlp.decode_int(f[i + 2])
        return cls(
            tx_type=t, chain_id=chain_id, nonce=nonce, gas_price=gas_price,
            max_priority_fee_per_gas=prio, max_fee_per_gas=fee,
            gas_limit=gas_limit, to=to, value=value, data=data,
            access_list=access_list, max_fee_per_blob_gas=max_blob_fee,
            blob_versioned_hashes=blob_hashes, authorization_list=auths,
            v=v, r=r, s=s,
        )

    # ---------------- signature ----------------
    def sign(self, secret: int) -> "Transaction":
        r, s, rec = secp256k1.sign(self.signing_hash(), secret)
        self.r, self.s = r, s
        if self.tx_type == TYPE_LEGACY:
            if self.chain_id is not None:
                self.v = rec + 35 + 2 * self.chain_id
            else:
                self.v = rec + 27
        else:
            self.v = rec
        self._sender = None
        self._hash = None
        return self

    def recovery_id(self) -> int | None:
        """None = consensus-invalid v encoding."""
        if self.tx_type != TYPE_LEGACY:
            return self.v if self.v in (0, 1) else None
        if self.v in (27, 28):
            return self.v - 27
        if self.v >= 35:
            return (self.v - 35) % 2
        return None

    def sender(self) -> bytes | None:
        if self.tx_type == TYPE_PRIVILEGED:
            return self.from_addr
        if self._sender is None:
            # EIP-2: reject high-s for all included txs (homestead onward)
            if self.s > secp256k1.N // 2:
                self._sender = SENDER_INVALID
            else:
                rec = self.recovery_id()
                if rec is None:
                    self._sender = SENDER_INVALID
                else:
                    addr = secp256k1.recover_address(
                        self.signing_hash(), self.r, self.s, rec
                    )
                    # memoize failures too: without the sentinel an
                    # invalid signature re-runs full EC recovery on
                    # every sender() call
                    self._sender = SENDER_INVALID if addr is None else addr
        return None if self._sender is SENDER_INVALID else self._sender

    # ---------------- fee helpers ----------------
    def max_fee(self) -> int:
        if self.tx_type in (TYPE_LEGACY, TYPE_ACCESS_LIST):
            return self.gas_price
        return self.max_fee_per_gas

    def priority_fee(self) -> int:
        if self.tx_type in (TYPE_LEGACY, TYPE_ACCESS_LIST):
            return self.gas_price
        return self.max_priority_fee_per_gas

    def effective_gas_price(self, base_fee: int) -> int | None:
        if self.tx_type in (TYPE_LEGACY, TYPE_ACCESS_LIST):
            if self.gas_price < base_fee:
                return None
            return self.gas_price
        if self.max_fee_per_gas < base_fee:
            return None
        return min(self.max_fee_per_gas,
                   base_fee + self.max_priority_fee_per_gas)

    @property
    def is_create(self) -> bool:
        return len(self.to) == 0
