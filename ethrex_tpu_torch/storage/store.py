"""Store: the node's chain and state facade, and the merkleize step of
execution — a copy of `ethrex_tpu/storage/store.py` over StorageBackend
traits.  The in-memory backend is the one here; the persistent backend
(`storage/persistent.py` over a native key-value log) is not copied yet,
so `CorruptRecord`, `flush` and `close` serve only a backend that
brings them.

Layout mirrors upstream ethrex's tables: headers, bodies, receipts,
canonical index, tx locations, trie nodes (one shared node db for the
account trie and all storage tries, keyed by node hash), code by hash.
The trie mutations of `apply_updates_to_tries` run in the native MPT
engine (`trie/native_mpt.py`) unless ETHREX_TPU_NATIVE_MPT=0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading

from ..crypto.keccak import keccak256
from ..primitives import rlp
from ..primitives.account import AccountState, EMPTY_CODE_HASH, EMPTY_TRIE_ROOT
from ..primitives.block import Block, BlockHeader
from ..primitives.genesis import Genesis
from ..evm.db import StateDB, TrieSource, VmDatabase
from ..trie.trie import Trie


log = logging.getLogger("ethrex_tpu_torch.storage.store")


class CorruptRecord(RuntimeError):
    """A persistent record failed its checksum on read.  The record has
    been quarantined (deleted from the KV log): derivable tables
    (canonical index) are rebuilt from surviving chain data; anything
    else needs a resync or a snapshot restore — the corrupt bytes are
    never decoded or served."""

    def __init__(self, table: str, key, path: str = ""):
        self.table = table
        self.key = key
        key_repr = key.hex() if isinstance(key, (bytes, bytearray)) \
            else repr(key)
        where = f" ({path})" if path else ""
        super().__init__(
            f"checksum mismatch in table {table!r} key {key_repr}{where}"
            " — record quarantined; re-derive it or restore from a snapshot")


class StorageBackend:
    """KV-table backend interface (in-memory, or the native C++ log store)."""

    def table(self, name: str) -> dict:
        raise NotImplementedError

    def flush(self):
        """Durability barrier; no-op for volatile backends."""

    def batch(self):
        """Atomic multi-table write group; volatile backends need no
        journal, so the base is a no-op context."""
        return contextlib.nullcontext(self)

    def close(self):
        """Release the backing resources; no-op for volatile backends."""


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
        self.tx_index = b.table("tx_index")        # tx_hash -> (blk_hash, idx)
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
            from ..primitives.block import BlockBody
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

    # ---------------- chain data ----------------
    def add_block(self, block: Block, receipts: list):
        with self.lock:
            h = block.hash
            # header+body+receipts+txloc land as one journaled unit —
            # a crash between them cannot leave a half-imported block
            with self.write_group():
                self.headers[h] = block.header
                self.bodies[h] = block.body
                self.receipts[h] = receipts
                for i, tx in enumerate(block.body.transactions):
                    # a sibling block may repeat a tx that is already
                    # canonically included — keep the canonical
                    # location; fork choice rewrites it if the sibling
                    # ever wins (docs/CHAIN_RESILIENCE.md)
                    loc = self.tx_index.get(tx.hash)
                    if loc is not None and loc[0] != h:
                        hdr = self.headers.get(loc[0])
                        if hdr is not None and \
                                self.canonical_hash(hdr.number) == loc[0]:
                            continue
                    self.tx_index[tx.hash] = (h, i)

    def set_canonical(self, number: int, block_hash: bytes):
        with self.lock:
            self.canonical[number] = block_hash

    def delete_canonical(self, number: int):
        """Drop a canonical-index entry (fork choice retiring heights
        above a new, lower head).  Goes through the table's delete path
        so the drop journals with the rest of the write group — a raw
        pop on the backing dict would bypass the batch on persistent
        backends."""
        with self.lock:
            self.canonical.pop(number, None)

    def set_tx_location(self, tx_hash: bytes, block_hash: bytes,
                        index: int):
        with self.lock:
            self.tx_index[tx_hash] = (block_hash, index)

    def delete_tx_location(self, tx_hash: bytes):
        with self.lock:
            self.tx_index.pop(tx_hash, None)

    def canonical_tx_location(self, tx_hash: bytes):
        """(block_hash, index) for a tx ONLY if the referenced block is
        still canonical at its height — the verify-on-read guard: fork
        choice prunes tx locations inside the reorg write group, but an
        orphaned inclusion must never be served even if a stale entry
        survives (docs/CHAIN_RESILIENCE.md)."""
        loc = self.tx_index.get(tx_hash)
        if loc is None:
            return None
        header = self.headers.get(loc[0])
        if header is None or self.canonical_hash(header.number) != loc[0]:
            from ..utils.metrics import record_txloc_stale_read

            record_txloc_stale_read()
            return None
        return loc

    def set_head(self, block_hash: bytes):
        with self.lock:
            self.meta["head"] = block_hash

    def flush(self):
        """Durability barrier (persistent backends); no-op in memory."""
        self.backend.flush()

    def write_group(self):
        """Atomic multi-table write group (reentrant per thread): on a
        persistent backend the writes commit through one write-ahead
        journal, so a crash at any byte offset applies all of them or
        none (see docs/STORAGE_RESILIENCE.md)."""
        return self.backend.batch()

    def close(self):
        """Flush-and-close for persistent backends; idempotent.  Settles
        any pending node-diff layers first so a clean shutdown leaves no
        restart re-import tail."""
        with self.lock:
            if self.layering_enabled():
                with self.write_group():
                    self.nodes.flatten_all()
            self.flush()
            self.backend.close()

    # -- node-table diff layering (storage/layering.py) --------------------
    def enable_layering(self) -> None:
        """Stack per-block diff layers over the trie-node table: nodes
        reach the durable backend only when their block finalizes
        (upstream seat: crates/storage/layering.rs)."""
        from .layering import LayeredTable

        if not isinstance(self.nodes, LayeredTable):
            self.nodes = LayeredTable(self.nodes)

    def layering_enabled(self) -> bool:
        from .layering import LayeredTable

        return isinstance(self.nodes, LayeredTable)

    # chains without a finality signal (dev mode) still settle layers
    # once they fall this many blocks behind the tip — bounding both the
    # RAM window and the restart re-import tail.  STRIDE adds hysteresis
    # so a full window settles ~once per STRIDE blocks in one burst
    # instead of re-introducing a per-block fsync trickle
    MAX_NODE_LAYERS = 64
    SETTLE_STRIDE = 16

    def push_node_layer(self, number: int, block_hash: bytes) -> None:
        if not self.layering_enabled():
            return
        self.nodes.push_layer((number, block_hash))
        if len(self.nodes.layers) > \
                self.MAX_NODE_LAYERS + self.SETTLE_STRIDE:
            self._settle_node_layers(number - self.MAX_NODE_LAYERS)

    def discard_node_layer(self, number: int, block_hash: bytes) -> None:
        """Fold a failed import's layer into its surroundings."""
        if self.layering_enabled():
            self.nodes.merge_down((number, block_hash))

    def finalize_node_layers(self, finalized_number: int) -> None:
        """Flatten every layer at or below the finalized height into the
        backend — INCLUDING stale-branch layers.  Dropping stale layers
        would be unsound here: the node tables are content-addressed and
        the native MPT engine de-duplicates, so a node first written by a
        stale branch may be silently shared by the canonical chain;
        selective dropping needs per-node refcounting,
        which is future work.  What layering buys today is WRITE
        BATCHING (one durable burst per settle instead of a per-block
        trickle) and a bounded restart-regeneration tail."""
        if self.layering_enabled():
            self._settle_node_layers(finalized_number)

    def _settle_node_layers(self, cutoff_number: int) -> None:
        settled = False
        # the settle burst is one journaled unit: a crash mid-flatten
        # must not leave half a layer's nodes durable with the layer
        # gone on restart (the re-import tail regenerates from the last
        # full settle)
        with self.write_group():
            for tag in list(self.nodes.layer_tags()):
                number, _block_hash = tag
                if number > cutoff_number:
                    continue
                self.nodes.flatten_layer(tag)
                settled = True
        if settled:
            self.flush()

    def head_header(self) -> BlockHeader:
        return self.headers[self.meta["head"]]

    def get_header(self, block_hash: bytes) -> BlockHeader | None:
        return self.headers.get(block_hash)

    def get_body(self, block_hash: bytes):
        return self.bodies.get(block_hash)

    def get_block(self, block_hash: bytes) -> Block | None:
        h = self.headers.get(block_hash)
        b = self.bodies.get(block_hash)
        if h is None or b is None:
            return None
        return Block(h, b)

    def canonical_hash(self, number: int) -> bytes | None:
        try:
            return self.canonical.get(number)
        except CorruptRecord:
            # the canonical index is derivable: walk parent hashes down
            # from the head and rewrite the quarantined entry
            return self._rebuild_canonical(number)

    def _rebuild_canonical(self, number: int) -> bytes | None:
        with self.lock:
            cursor = self.head_header()
            while cursor.number > number:
                parent = self.headers.get(cursor.parent_hash)
                if parent is None:
                    return None
                cursor = parent
            if cursor.number != number:
                return None
            self.canonical[number] = cursor.hash
            log.warning("rebuilt quarantined canonical entry %d -> 0x%s",
                        number, cursor.hash.hex())
            from ..utils.metrics import record_store_rebuild

            record_store_rebuild()
            return cursor.hash

    def get_canonical_block(self, number: int) -> Block | None:
        h = self.canonical_hash(number)
        return self.get_block(h) if h else None

    def get_receipts(self, block_hash: bytes):
        return self.receipts.get(block_hash)

    def latest_number(self) -> int:
        return self.head_header().number

    # ---------------- state access ----------------
    def state_source(self, state_root: bytes) -> "StoreSource":
        return StoreSource(self, state_root)

    def state_db(self, state_root: bytes) -> StateDB:
        return StateDB(self.state_source(state_root))

    def account_state(self, state_root: bytes,
                      address: bytes) -> AccountState | None:
        trie = Trie.from_nodes(state_root, self.nodes, share=True)
        raw = trie.get(keccak256(address))
        return AccountState.decode(raw) if raw else None

    def storage_at(self, state_root: bytes, address: bytes,
                   slot: int) -> int:
        acct = self.account_state(state_root, address)
        if acct is None or acct.storage_root == EMPTY_TRIE_ROOT:
            return 0
        st = Trie.from_nodes(acct.storage_root, self.nodes, share=True)
        raw = st.get(keccak256(slot.to_bytes(32, "big")))
        return rlp.decode_int(rlp.decode(raw)) if raw else 0

    # ---------------- state write-back ----------------
    def apply_account_updates(self, parent_root: bytes, state_db: StateDB,
                              nodes: dict | None = None,
                              write_log: list | None = None) -> bytes:
        """Write dirty accounts/slots from an executed block into the tries;
        returns the new state root (the merkleize step of upstream's
        add_block pipeline, blockchain.rs apply_account_updates_batch).

        `nodes` overrides the node table (witness recording / stateless
        execution use a recording or witness-only table); `write_log`
        (optional list) collects the raw trie writes exactly like the
        stateless path's log."""
        with self.lock:
            if nodes is None:
                # persistent native engine over the store's own table: the
                # C++ map warms up once and batch applies skip Python
                native = self._native_engine()
            else:
                native = _make_native_engine()
            return apply_updates_to_tries(
                nodes if nodes is not None else self.nodes,
                self.code, parent_root, state_db, native=native,
                write_log=write_log)

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
    nodes a pruned witness doesn't carry (same ordering rule as
    upstream's guest state application, block_execution_witness.rs:541).

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
    """VmDatabase over the Store's tries at a fixed state root.

    `nodes` overrides the node table (recording table for witness
    generation); `on_code` / `on_block_hash` are optional observation hooks.
    """

    def __init__(self, store: Store, state_root: bytes,
                 nodes: dict | None = None, on_code=None, on_block_hash=None,
                 header_overrides: dict | None = None):
        super().__init__(nodes if nodes is not None else store.nodes,
                         state_root)
        self.store = store
        self.state_root = state_root
        self.on_code = on_code
        self.on_block_hash = on_block_hash
        # number -> hash for blocks not yet canonical (batch import)
        self.header_overrides = header_overrides or {}

    def get_code(self, code_hash: bytes) -> bytes:
        if code_hash == EMPTY_CODE_HASH:
            return b""
        code = self.store.code.get(code_hash, b"")
        if code and self.on_code:
            self.on_code(code_hash, code)
        return code

    def get_block_hash(self, number: int) -> bytes:
        h = self.header_overrides.get(number) \
            or self.store.canonical_hash(number)
        if h and self.on_block_hash:
            self.on_block_hash(number, h)
        return h if h else b"\x00" * 32
