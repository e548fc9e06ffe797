"""Store: the in-memory core of the node's chain and state facade, and the
merkleize step of execution — a copy of `ethrex_tpu/storage/store.py`
without its persistence, node-table layering, canonical-index repair,
block import and witness-recording hooks.

Layout mirrors the reference's tables: headers, bodies, receipts,
canonical index, trie nodes (one shared node db for the account trie and
all storage tries, keyed by node hash), code by hash.  The trie mutations
of `apply_updates_to_tries` run in the native MPT engine
(`trie/native_mpt.py`) unless ETHREX_TPU_NATIVE_MPT=0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

from ..crypto.keccak import keccak256
from ..evm.db import StateDB, TrieSource
from ..primitives import rlp
from ..primitives.account import AccountState, EMPTY_CODE_HASH, EMPTY_TRIE_ROOT
from ..primitives.block import BlockBody, BlockHeader
from ..primitives.genesis import Genesis
from ..trie.trie import Trie


class StorageBackend:
    """KV-table backend interface."""

    def table(self, name: str) -> dict:
        raise NotImplementedError

    def batch(self):
        """Atomic multi-table write group; volatile backends need no
        journal, so the base is a no-op context."""
        return contextlib.nullcontext(self)


class InMemoryBackend(StorageBackend):
    def __init__(self):
        self._tables: dict[str, dict] = {}

    def table(self, name: str) -> dict:
        return self._tables.setdefault(name, {})


def _config_fingerprint(config) -> bytes:
    """Stable bytes identifying a ChainConfig (fork schedule + chain id)."""
    parts = [str(config.chain_id), str(config.terminal_total_difficulty)]
    parts += [f"{int(f)}:{b}" for f, b in sorted(config.block_forks.items())]
    parts += [f"t{int(f)}:{t}" for f, t in sorted(config.time_forks.items())]
    return "|".join(parts).encode()


class Store:
    def __init__(self, backend: StorageBackend | None = None):
        self.backend = backend or InMemoryBackend()
        b = self.backend
        self.headers = b.table("headers")          # hash -> BlockHeader
        self.bodies = b.table("bodies")            # hash -> BlockBody
        self.receipts = b.table("receipts")        # hash -> list[Receipt]
        self.canonical = b.table("canonical")      # number -> hash
        self.nodes = b.table("trie_nodes")         # node_hash -> encoded
        self.code = b.table("code")                # code_hash -> bytes
        self.meta = b.table("meta")                # misc: head, genesis...
        self.lock = threading.RLock()
        self.genesis_config = None

    # ---------------- genesis ----------------
    def init_genesis(self, genesis: Genesis) -> BlockHeader:
        with self.lock:
            self.genesis_config = genesis.config
            existing = self.meta.get("genesis")
            config_fp = _config_fingerprint(genesis.config)
            if existing is not None:
                # reopened persistent store: refuse to resume a DIFFERENT
                # chain than the supplied genesis describes (the header hash
                # covers the state/alloc; the fingerprint covers the chain
                # config, which the header does not encode)
                expected = Store().init_genesis(genesis).hash
                if existing != expected:
                    raise ValueError(
                        f"stored chain genesis 0x{existing.hex()} does not "
                        f"match the supplied genesis 0x{expected.hex()}")
                stored_fp = self.meta.get("config")
                if stored_fp is not None and stored_fp != config_fp:
                    raise ValueError(
                        "stored chain config does not match the supplied "
                        "genesis config")
                header = self.headers[existing]
                if header.number != 0:
                    raise ValueError("corrupt store: genesis not block 0")
                return header
            state = Trie.from_nodes(EMPTY_TRIE_ROOT, self.nodes, share=True)
            for addr, acct in genesis.alloc.items():
                storage_root = EMPTY_TRIE_ROOT
                if acct.storage:
                    st = Trie.from_nodes(EMPTY_TRIE_ROOT, self.nodes,
                                         share=True)
                    for slot, value in acct.storage.items():
                        if value:
                            st.insert(keccak256(slot.to_bytes(32, "big")),
                                      rlp.encode(value))
                    storage_root = st.commit()
                if acct.code:
                    self.code[acct.state.code_hash] = acct.code
                st8 = dataclasses.replace(acct.state,
                                          storage_root=storage_root)
                state.insert(keccak256(addr), st8.encode())
            root = state.commit()
            header = genesis.header(root)
            block_hash = header.hash
            # the genesis chain records are one journaled unit (trie
            # nodes above are content-addressed: a partial alloc write
            # is invisible without these records and re-written on the
            # next init)
            with self.write_group():
                self.headers[block_hash] = header
                self.bodies[block_hash] = BlockBody(
                    withdrawals=[] if header.withdrawals_root is not None
                    else None)
                self.receipts[block_hash] = []
                self.canonical[0] = block_hash
                self.meta["head"] = block_hash
                self.meta["safe"] = block_hash
                self.meta["finalized"] = block_hash
                self.meta["genesis"] = block_hash
                self.meta["config"] = config_fp
            return header

    def write_group(self):
        """Atomic multi-table write group (the backend's `batch`; a no-op
        context in memory)."""
        return self.backend.batch()

    def canonical_hash(self, number: int) -> bytes | None:
        return self.canonical.get(number)

    # ---------------- state access ----------------
    def state_source(self, state_root: bytes) -> "StoreSource":
        return StoreSource(self, state_root)

    def state_db(self, state_root: bytes) -> StateDB:
        return StateDB(self.state_source(state_root))

    # ---------------- state write-back ----------------
    def apply_account_updates(self, parent_root: bytes,
                              state_db: StateDB) -> bytes:
        """Write dirty accounts/slots from an executed block into the tries;
        returns the new state root (the merkleize step of the reference's
        add_block pipeline, blockchain.rs apply_account_updates_batch)."""
        with self.lock:
            # one native engine over the store's own table: the C++ map
            # warms up once and later applies skip Python
            return apply_updates_to_tries(self.nodes, self.code, parent_root,
                                          state_db,
                                          native=self._native_engine())

    def _native_engine(self):
        engine = getattr(self, "_native_mpt", "unset")
        if engine == "unset":
            engine = _make_native_engine()
            self._native_mpt = engine
        return engine


def _make_native_engine():
    """A NativeMpt, or None when ETHREX_TPU_NATIVE_MPT=0 (callers then
    run the Python trie).  A failed build raises."""
    if os.environ.get("ETHREX_TPU_NATIVE_MPT") == "0":
        return None
    from ..trie.native_mpt import NativeMpt

    return NativeMpt()


def apply_updates_to_tries(node_table: dict, code_table, parent_root: bytes,
                           state_db: StateDB,
                           write_log: list | None = None,
                           native=None) -> bytes:
    """Shared merkleize step: dirty StateDB -> trie updates -> new root.
    Used by the Store and the stateless guest program.

    Inserts are applied BEFORE deletes (per trie): a delete after an insert
    into the same branch avoids collapse paths that would need sibling
    nodes a pruned witness doesn't carry (same ordering rule as the
    reference's guest state application, block_execution_witness.rs:541).

    `write_log` (optional) collects the block's state writes for the
    execution proof (guest/access_log.py): ("acct", addr, None, old_rlp,
    new_rlp, storage_cleared) and ("slot", addr, slot, old_int, new_int)
    tuples, in the deterministic application order above.

    `native` (optional NativeMpt) runs every trie MUTATION batch in the
    C++ engine (native/mpt.cpp) — reads still go through the Python trie;
    both paths produce identical roots and node sets
    (tests/test_torch_native_host.py).
    """
    trie = Trie.from_nodes(parent_root, node_table, share=True)
    account_inserts = []
    account_deletes = []
    clear_empty = getattr(state_db, "clear_empty", True)
    for addr in sorted(state_db.dirty_accounts):
        cached = state_db.accounts[addr]
        key = keccak256(addr)
        if not cached.exists or (cached.is_empty and clear_empty):
            # EIP-161 state clearing / destroyed accounts (pre-Spurious
            # forks persist touched-empty accounts: clear_empty=False)
            if write_log is not None:
                raw = trie.get(key)
                if raw:
                    write_log.append(("acct", addr, None, raw, b"", False))
            account_deletes.append(key)
            continue
        raw = trie.get(key)
        prev = AccountState.decode(raw) if raw else AccountState()
        storage_root = (EMPTY_TRIE_ROOT if cached.storage_cleared
                        else prev.storage_root)
        slots = state_db.dirty_storage.get(addr, ())
        if slots or cached.storage_cleared:
            slot_inserts = []
            slot_deletes = []
            if write_log is not None and cached.storage_cleared:
                # destroy+recreate: downstream consumers reset this
                # account's flat slot entries to zero (the old trie is
                # NEVER walked here — a pruned witness legitimately
                # omits it, and execution reads skip it too)
                write_log.append(("clear", addr))
            for slot in sorted(slots):
                # read through the StateDB: a reverted tx's journal undo can
                # pop the cache entry, and the raw cache default of 0 would
                # wrongly delete a live slot
                value = state_db.get_storage(addr, slot)
                if not cached.storage_cleared:
                    # skip net-zero writes: a removal of a never-present key
                    # (or rewrite of an unchanged one) walks trie paths a
                    # pruned witness legitimately omits
                    pre = state_db.source.get_storage(addr, slot)
                    if value == pre:
                        continue
                else:
                    pre = 0  # post-clear semantics: every old value is 0
                skey = keccak256(slot.to_bytes(32, "big"))
                if write_log is not None and value != pre:
                    write_log.append(("slot", addr, slot, pre, value))
                if value:
                    slot_inserts.append((skey, rlp.encode(value)))
                else:
                    slot_deletes.append((skey, b""))
            if native is not None:
                storage_root = native.apply(node_table, storage_root,
                                            slot_inserts + slot_deletes)
            else:
                st = Trie.from_nodes(storage_root, node_table, share=True)
                for skey, v in slot_inserts:
                    st.insert(skey, v)
                for skey, _ in slot_deletes:
                    st.remove(skey)
                storage_root = st.commit()
        if (cached.code is not None
                and cached.code_hash != EMPTY_CODE_HASH):
            code_table[cached.code_hash] = cached.code
        new_state = AccountState(
            nonce=cached.nonce, balance=cached.balance,
            storage_root=storage_root, code_hash=cached.code_hash)
        encoded = new_state.encode()
        if write_log is not None and encoded != (raw or b""):
            write_log.append(("acct", addr, None, raw or b"", encoded,
                              bool(cached.storage_cleared)))
        account_inserts.append((key, encoded))
    if native is not None:
        return native.apply(node_table, parent_root,
                            account_inserts
                            + [(k, b"") for k in account_deletes])
    for key, encoded in account_inserts:
        trie.insert(key, encoded)
    for key in account_deletes:
        trie.remove(key)
    return trie.commit()


class StoreSource(TrieSource):
    """VmDatabase over the Store's tries at a fixed state root."""

    def __init__(self, store: Store, state_root: bytes):
        super().__init__(store.nodes, state_root)
        self.store = store
        self.state_root = state_root

    def get_code(self, code_hash: bytes) -> bytes:
        if code_hash == EMPTY_CODE_HASH:
            return b""
        return self.store.code.get(code_hash, b"")

    def get_block_hash(self, number: int) -> bytes:
        return self.store.canonical_hash(number) or b"\x00" * 32
