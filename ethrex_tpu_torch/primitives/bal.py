"""Block Access Lists (EIP-7928): types, canonical RLP, recorder, and
validation.

A copy of `ethrex_tpu/primitives/bal.py`.  Parity target: upstream
ethrex's crates/common/types/block_access_list.rs — AccountChanges
rows sorted by address carrying per-tx storage writes (slot -> [(index,
post_value)]), storage reads, balance/nonce/code changes, with
block_access_index 0 = pre-execution system ops, 1..n = transactions,
n+1 = post-execution (withdrawals/requests).  Net-zero writes within one
index demote to reads; SYSTEM_ADDRESS account changes during system
calls are transient and filtered.

The recorder is journal-driven instead of a write-through
shim: the StateDB journals every mutation with its OLD value
(evm/db.py), so one `record_phase` pass after each begin_tx/finalize_tx
window derives writes (first journal old = pre-phase value, current
state = post), reads (journaled storage loads + warmed slots that were
never written), and touched addresses — no recorder calls inside the
interpreter hot loop.
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from . import rlp

SYSTEM_ADDRESS = bytes.fromhex("fffffffffffffffffffffffffffffffffffffffe")


@dataclasses.dataclass
class AccountChanges:
    address: bytes
    # slot -> [(index, post_value)], per-index ascending
    storage_changes: dict
    storage_reads: set
    balance_changes: list   # [(index, post_balance)]
    nonce_changes: list     # [(index, post_nonce)]
    code_changes: list      # [(index, code_bytes)]

    def is_empty_but_touched(self) -> bool:
        return not (self.storage_changes or self.storage_reads
                    or self.balance_changes or self.nonce_changes
                    or self.code_changes)


@dataclasses.dataclass
class BlockAccessList:
    accounts: list          # AccountChanges sorted by address

    def item_count(self) -> int:
        n = 0
        for ac in self.accounts:
            n += 1 + len(ac.storage_reads) + len(ac.storage_changes)
        return n

    # -- canonical wire form (sorted, per upstream's encoder) -------
    def to_rlp_obj(self):
        rows = []
        for ac in sorted(self.accounts, key=lambda a: a.address):
            changes = [
                [slot, [[i, v] for i, v in entries]]
                for slot, entries in sorted(ac.storage_changes.items())
            ]
            rows.append([
                ac.address,
                changes,
                sorted(ac.storage_reads),
                [[i, v] for i, v in sorted(ac.balance_changes)],
                [[i, v] for i, v in sorted(ac.nonce_changes)],
                [[i, c] for i, c in sorted(ac.code_changes,
                                           key=lambda e: e[0])],
            ])
        return rows

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp_obj())

    def hash(self) -> bytes:
        return keccak256(self.encode())

    @classmethod
    def decode(cls, data: bytes) -> "BlockAccessList":
        obj = rlp.decode(data)
        accounts = []
        for row in obj:
            addr, changes, reads, bals, nonces, codes = row
            accounts.append(AccountChanges(
                address=bytes(addr),
                storage_changes={
                    rlp.decode_int(slot): [(rlp.decode_int(i),
                                            rlp.decode_int(v))
                                           for i, v in entries]
                    for slot, entries in changes
                },
                storage_reads={rlp.decode_int(s) for s in reads},
                balance_changes=[(rlp.decode_int(i), rlp.decode_int(v))
                                 for i, v in bals],
                nonce_changes=[(rlp.decode_int(i), rlp.decode_int(v))
                               for i, v in nonces],
                code_changes=[(rlp.decode_int(i), bytes(c))
                              for i, c in codes],
            ))
        return cls(accounts=accounts)

    def validate_ordering(self) -> None:
        """Canonical ordering per EIP-7928 (the decoder side of
        block_access_list.rs validate_ordering)."""
        prev = None
        for ac in self.accounts:
            if prev is not None and prev >= ac.address:
                raise ValueError("BAL accounts out of order")
            prev = ac.address
            for slot, entries in ac.storage_changes.items():
                if [i for i, _ in entries] != sorted(
                        {i for i, _ in entries}):
                    raise ValueError("BAL storage indices out of order")
            for seq in (ac.balance_changes, ac.nonce_changes,
                        ac.code_changes):
                idxs = [i for i, _ in seq]
                if idxs != sorted(set(idxs)):
                    raise ValueError("BAL change indices out of order")


class BalRecorder:
    """Builds a BlockAccessList from the StateDB's per-phase journals.

    Usage (blockchain/blockchain.py): after every begin_tx/finalize_tx
    window call `record_phase(state, index)` with the EIP-7928 index
    (0 pre-exec, 1..n txs, n+1 post-exec) BEFORE the next begin_tx
    clears the journal.
    """

    def __init__(self):
        self.sink: list = []      # journal drain (StateDB.journal_sink)
        self.touched: set[bytes] = set()
        self.writes: dict[bytes, dict[int, list]] = {}
        self.reads: dict[bytes, set[int]] = {}
        self.balances: dict[bytes, list] = {}
        self.nonces: dict[bytes, list] = {}
        self.codes: dict[bytes, list] = {}

    def attach(self, state) -> None:
        state.journal_sink = self.sink

    def record_phase(self, state, index: int) -> None:
        pre_bal: dict[bytes, int] = {}
        pre_nonce: dict[bytes, int] = {}
        pre_code: dict[bytes, bytes] = {}
        pre_slot: dict[tuple, int] = {}
        loads: set[tuple] = set()
        for entry in self.sink + state.journal:
            kind = entry[0]
            if kind == "balance":
                pre_bal.setdefault(entry[1], entry[2])
            elif kind == "nonce":
                pre_nonce.setdefault(entry[1], entry[2])
            elif kind == "code":
                pre_code.setdefault(entry[1], entry[3])
            elif kind == "storage":
                pre_slot.setdefault((entry[1], entry[2]), entry[3])
            elif kind == "storage_load":
                loads.add((entry[1], entry[2]))
            elif kind == "destroy":
                # selfdestruct (same-tx create only, post-Cancun): the
                # account zeroes; post values surface via the balance /
                # nonce / code comparisons below
                pre_bal.setdefault(entry[1], entry[3])
                pre_nonce.setdefault(entry[1], entry[2])

        for addr in state.accessed_addresses:
            if addr != SYSTEM_ADDRESS:
                self.touched.add(addr)

        for addr, old in pre_bal.items():
            if addr == SYSTEM_ADDRESS:
                continue
            post = state.get_balance(addr)
            self.touched.add(addr)
            if post != old:
                self.balances.setdefault(addr, []).append((index, post))
        for addr, old in pre_nonce.items():
            if addr == SYSTEM_ADDRESS:
                continue
            post = state.get_nonce(addr)
            self.touched.add(addr)
            if post != old:
                self.nonces.setdefault(addr, []).append((index, post))
        for addr, old in pre_code.items():
            if addr == SYSTEM_ADDRESS:
                continue
            post = state.get_code(addr)
            self.touched.add(addr)
            if post != old:
                self.codes.setdefault(addr, []).append((index, post))
        for (addr, slot), old in pre_slot.items():
            post = state.get_storage(addr, slot)
            self.touched.add(addr)
            if post != old:
                # net-zero writes demote to reads (EIP-7928)
                self.writes.setdefault(addr, {}).setdefault(
                    slot, []).append((index, post))
            else:
                self.reads.setdefault(addr, set()).add(slot)
        for (addr, slot) in loads:
            self.touched.add(addr)
            if slot not in self.writes.get(addr, {}):
                self.reads.setdefault(addr, set()).add(slot)
        self.sink.clear()

    def build(self) -> BlockAccessList:
        accounts = []
        for addr in sorted(self.touched):
            writes = self.writes.get(addr, {})
            reads = {s for s in self.reads.get(addr, set())
                     if s not in writes}
            accounts.append(AccountChanges(
                address=addr,
                storage_changes=writes,
                storage_reads=reads,
                balance_changes=self.balances.get(addr, []),
                nonce_changes=self.nonces.get(addr, []),
                code_changes=self.codes.get(addr, []),
            ))
        return BlockAccessList(accounts=accounts)
