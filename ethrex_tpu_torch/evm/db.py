"""VM state database: journaled account/storage cache over a pluggable
backing source.  A copy of `ethrex_tpu/evm/db.py` without the sources and
hooks that only the node uses (its in-memory source, the pipelined
importer's `drain_dirty`/`rebase` and the block-access-list journal
feed); the prover's backing source is
`guest.execution.WitnessSource`, pruned witness tries.

`StateDB` layers an intra-block cache + journal on top: every mutation
pushes an undo entry; snapshot/revert are list indices (cheap, like the
reference's CallFrameBackup, crates/vm/levm/src/call_frame.rs).
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from ..primitives.account import EMPTY_CODE_HASH, AccountState


class VmDatabase:
    """Read-only backing source interface."""

    def get_account_state(self, address: bytes) -> AccountState | None:
        raise NotImplementedError

    def get_code(self, code_hash: bytes) -> bytes:
        raise NotImplementedError

    def get_storage(self, address: bytes, slot: int) -> int:
        raise NotImplementedError

    def get_block_hash(self, number: int) -> bytes:
        raise NotImplementedError

    def account_has_storage(self, address: bytes) -> bool:
        """EIP-7610: does the account have a non-empty storage trie?"""
        return False


class TrieSource(VmDatabase):
    """Shared trie-backed account/storage resolution over a node table.

    Subclasses supply the node table + code/header lookup; the MPT walk,
    slot hashing, and RLP decoding live here once.
    """

    def __init__(self, nodes: dict, state_root: bytes):
        from ..trie.trie import Trie

        self.nodes = nodes
        self._trie = Trie.from_nodes(state_root, nodes, share=True)
        self._storage_tries: dict[bytes, object] = {}

    def get_account_state(self, address: bytes):
        raw = self._trie.get(keccak256(address))
        return AccountState.decode(raw) if raw else None

    def get_storage(self, address: bytes, slot: int) -> int:
        from ..primitives import rlp
        from ..trie.trie import Trie

        st = self._storage_tries.get(address)
        if st is None:
            acct = self.get_account_state(address)
            if acct is None:
                return 0
            st = Trie.from_nodes(acct.storage_root, self.nodes, share=True)
            self._storage_tries[address] = st
        raw = st.get(keccak256(slot.to_bytes(32, "big")))
        return rlp.decode_int(rlp.decode(raw)) if raw else 0

    def account_has_storage(self, address: bytes) -> bool:
        from ..primitives.account import EMPTY_TRIE_ROOT

        acct = self.get_account_state(address)
        return acct is not None and acct.storage_root != EMPTY_TRIE_ROOT


@dataclasses.dataclass
class CachedAccount:
    nonce: int = 0
    balance: int = 0
    code_hash: bytes = EMPTY_CODE_HASH
    code: bytes | None = None       # lazily loaded
    storage: dict = dataclasses.field(default_factory=dict)  # slot -> value
    exists: bool = False            # account present in state
    destroyed: bool = False         # selfdestructed this tx (EIP-6780 path)
    storage_cleared: bool = False   # storage wiped (destroy+recreate)

    @property
    def is_empty(self) -> bool:
        return (self.nonce == 0 and self.balance == 0
                and self.code_hash == EMPTY_CODE_HASH)


class StateDB:
    """Journaled mutable state for block execution."""

    def __init__(self, source: VmDatabase):
        self.source = source
        self.accounts: dict[bytes, CachedAccount] = {}
        self.journal: list = []
        # EIP-161 (Spurious Dragon+): delete touched-empty accounts at
        # merkleize time; pre-161 forks keep them (executor sets this)
        self.clear_empty = True
        # tx-scoped substate
        self.accessed_addresses: set[bytes] = set()
        self.accessed_slots: set[tuple[bytes, int]] = set()
        self.refund: int = 0
        self.logs: list = []
        self.transient: dict[tuple[bytes, int], int] = {}
        self.created_accounts: set[bytes] = set()
        self.destroyed_accounts: set[bytes] = set()  # pre-London SD refund
        # original (pre-tx) storage values for SSTORE gas: (addr,slot) -> val
        self._tx_original: dict[tuple[bytes, int], int] = {}
        # block-scoped write-back tracking (consumed by apply_account_updates)
        self.dirty_accounts: set[bytes] = set()
        self.dirty_storage: dict[bytes, set[int]] = {}

    # ---------------- account loading ----------------
    def _load(self, address: bytes) -> CachedAccount:
        acct = self.accounts.get(address)
        if acct is None:
            st = self.source.get_account_state(address)
            if st is None:
                acct = CachedAccount(exists=False)
            else:
                acct = CachedAccount(nonce=st.nonce, balance=st.balance,
                                     code_hash=st.code_hash, exists=True)
            self.accounts[address] = acct
        return acct

    def get_nonce(self, address: bytes) -> int:
        return self._load(address).nonce

    def get_balance(self, address: bytes) -> int:
        return self._load(address).balance

    def get_code(self, address: bytes) -> bytes:
        acct = self._load(address)
        if acct.code is None:
            acct.code = (b"" if acct.code_hash == EMPTY_CODE_HASH
                         else self.source.get_code(acct.code_hash))
        return acct.code

    def account_exists(self, address: bytes) -> bool:
        return self._load(address).exists

    def is_empty(self, address: bytes) -> bool:
        return self._load(address).is_empty

    def get_storage(self, address: bytes, slot: int) -> int:
        acct = self._load(address)
        if slot in acct.storage:
            return acct.storage[slot]
        value = 0
        if acct.exists and not acct.storage_cleared:
            value = self.source.get_storage(address, slot)
        acct.storage[slot] = value
        self.journal.append(("storage_load", address, slot))
        return value

    def has_nonempty_storage(self, address: bytes) -> bool:
        """EIP-7610 collision predicate: any non-zero storage on the account
        (cached writes this block, or the backing source's storage trie)."""
        acct = self._load(address)
        if any(v != 0 for v in acct.storage.values()):
            return True
        if not acct.exists or acct.storage_cleared:
            return False
        return self.source.account_has_storage(address)

    def get_original_storage(self, address: bytes, slot: int) -> int:
        """EIP-2200 'original' value: the slot's value at TX start.  For a
        slot not yet written this tx that is simply the current value
        (which may come from the intra-block cache — an earlier tx or an
        earlier batch-imported block may have modified it; reading the
        backing source here would be stale).  set_storage records the
        pre-write value on first write, covering slots already modified."""
        key = (address, slot)
        if key in self._tx_original:
            return self._tx_original[key]
        return self.get_storage(address, slot)

    # ---------------- mutations (journaled) ----------------
    def set_balance(self, address: bytes, value: int):
        acct = self._load(address)
        self.journal.append(("balance", address, acct.balance, acct.exists))
        acct.balance = value
        acct.exists = True
        self.dirty_accounts.add(address)

    def add_balance(self, address: bytes, delta: int):
        self.set_balance(address, self.get_balance(address) + delta)

    def sub_balance(self, address: bytes, delta: int):
        self.set_balance(address, self.get_balance(address) - delta)

    def set_nonce(self, address: bytes, nonce: int):
        acct = self._load(address)
        self.journal.append(("nonce", address, acct.nonce, acct.exists))
        acct.nonce = nonce
        acct.exists = True
        self.dirty_accounts.add(address)

    def increment_nonce(self, address: bytes):
        self.set_nonce(address, self.get_nonce(address) + 1)

    def set_code(self, address: bytes, code: bytes):
        acct = self._load(address)
        self.journal.append(
            ("code", address, acct.code_hash, acct.code, acct.exists))
        acct.code = code
        acct.code_hash = keccak256(code) if code else EMPTY_CODE_HASH
        acct.exists = True
        self.dirty_accounts.add(address)

    def set_storage(self, address: bytes, slot: int, value: int):
        current = self.get_storage(address, slot)
        # first write this tx: the pre-write value IS the tx-start original
        self._tx_original.setdefault((address, slot), current)
        acct = self._load(address)
        self.journal.append(("storage", address, slot, current))
        acct.storage[slot] = value
        self.dirty_accounts.add(address)
        self.dirty_storage.setdefault(address, set()).add(slot)

    def set_transient(self, address: bytes, slot: int, value: int):
        key = (address, slot)
        self.journal.append(("transient", key, self.transient.get(key, 0)))
        self.transient[key] = value

    def get_transient(self, address: bytes, slot: int) -> int:
        return self.transient.get((address, slot), 0)

    def add_refund(self, amount: int):
        self.journal.append(("refund", self.refund))
        self.refund += amount

    def sub_refund(self, amount: int):
        self.journal.append(("refund", self.refund))
        self.refund -= amount

    def add_log(self, log):
        self.journal.append(("log",))
        self.logs.append(log)

    def warm_address(self, address: bytes) -> bool:
        """Returns True if it was already warm."""
        if address in self.accessed_addresses:
            return True
        self.journal.append(("warm_addr", address))
        self.accessed_addresses.add(address)
        return False

    def warm_slot(self, address: bytes, slot: int) -> bool:
        key = (address, slot)
        if key in self.accessed_slots:
            return True
        self.journal.append(("warm_slot", key))
        self.accessed_slots.add(key)
        return False

    def create_empty(self, address: bytes):
        """Pre-EIP-161 call semantics: instantiate an empty account
        (journaled; no-op when it already exists)."""
        acct = self._load(address)
        if acct.exists:
            return
        self.journal.append(("exists", address, acct.exists))
        acct.exists = True
        self.dirty_accounts.add(address)

    def mark_created(self, address: bytes):
        self.journal.append(("created", address))
        self.created_accounts.add(address)
        acct = self._load(address)
        self.journal.append(
            ("recreate", address, acct.storage_cleared, dict(acct.storage)))
        acct.storage_cleared = True
        acct.storage = {}

    def destroy_account(self, address: bytes):
        if address not in self.destroyed_accounts:
            self.journal.append(("destroyed_set", address))
            self.destroyed_accounts.add(address)
        acct = self._load(address)
        self.journal.append(
            ("destroy", address, acct.nonce, acct.balance, acct.code_hash,
             acct.code, acct.exists, acct.destroyed, dict(acct.storage),
             acct.storage_cleared))
        acct.nonce = 0
        acct.balance = 0
        acct.code_hash = EMPTY_CODE_HASH
        acct.code = b""
        acct.exists = False
        acct.destroyed = True
        acct.storage = {}
        acct.storage_cleared = True
        self.dirty_accounts.add(address)

    # ---------------- snapshots ----------------
    def snapshot(self) -> int:
        return len(self.journal)

    def revert(self, snap: int):
        while len(self.journal) > snap:
            entry = self.journal.pop()
            kind = entry[0]
            if kind == "balance":
                _, addr, bal, existed = entry
                acct = self.accounts[addr]
                acct.balance = bal
                acct.exists = existed
            elif kind == "nonce":
                _, addr, nonce, existed = entry
                acct = self.accounts[addr]
                acct.nonce = nonce
                acct.exists = existed
            elif kind == "code":
                _, addr, ch, code, existed = entry
                acct = self.accounts[addr]
                acct.code_hash = ch
                acct.code = code
                acct.exists = existed
            elif kind == "storage":
                _, addr, slot, val = entry
                self.accounts[addr].storage[slot] = val
            elif kind == "storage_load":
                _, addr, slot = entry
                self.accounts[addr].storage.pop(slot, None)
            elif kind == "transient":
                _, key, val = entry
                if val == 0:
                    self.transient.pop(key, None)
                else:
                    self.transient[key] = val
            elif kind == "refund":
                self.refund = entry[1]
            elif kind == "log":
                self.logs.pop()
            elif kind == "warm_addr":
                self.accessed_addresses.discard(entry[1])
            elif kind == "warm_slot":
                self.accessed_slots.discard(entry[1])
            elif kind == "created":
                self.created_accounts.discard(entry[1])
            elif kind == "destroyed_set":
                self.destroyed_accounts.discard(entry[1])
            elif kind == "exists":
                _, addr, existed = entry
                self.accounts[addr].exists = existed
            elif kind == "recreate":
                _, addr, cleared, storage = entry
                acct = self.accounts[addr]
                acct.storage_cleared = cleared
                acct.storage = storage
            elif kind == "destroy":
                (_, addr, nonce, bal, ch, code, existed, destroyed,
                 storage, cleared) = entry
                acct = self.accounts[addr]
                acct.nonce, acct.balance = nonce, bal
                acct.code_hash, acct.code = ch, code
                acct.exists, acct.destroyed = existed, destroyed
                acct.storage, acct.storage_cleared = storage, cleared

    # ---------------- tx lifecycle ----------------
    def begin_tx(self):
        self.journal.clear()
        self.accessed_addresses = set()
        self.accessed_slots = set()
        self.refund = 0
        self.logs = []
        self.transient = {}
        self.created_accounts = set()
        self.destroyed_accounts = set()
        self._tx_original = {}

    def finalize_tx(self):
        """Clear journal; keep account cache for the rest of the block."""
        self.journal.clear()
