"""The merkleize step of stateless execution: `apply_updates_to_tries` of
`ethrex_tpu/storage/store.py` on its Python trie path (the reference's own
path when its native MPT engine is absent).  The node's `Store` is not
part of the prover and is not copied."""

from __future__ import annotations

from ..crypto.keccak import keccak256
from ..evm.db import StateDB
from ..primitives import rlp
from ..primitives.account import (EMPTY_CODE_HASH, EMPTY_TRIE_ROOT,
                                  AccountState)
from ..trie.trie import Trie


def apply_updates_to_tries(node_table: dict, code_table, parent_root: bytes,
                           state_db: StateDB,
                           write_log: list | None = None) -> bytes:
    """Shared merkleize step: dirty StateDB -> trie updates -> new root.
    Used by the stateless guest program.

    Inserts are applied BEFORE deletes (per trie): a delete after an insert
    into the same branch avoids collapse paths that would need sibling
    nodes a pruned witness doesn't carry (same ordering rule as the
    reference's guest state application, block_execution_witness.rs:541).

    `write_log` (optional) collects the block's state writes for the
    execution proof (guest/access_log.py): ("acct", addr, None, old_rlp,
    new_rlp, storage_cleared) and ("slot", addr, slot, old_int, new_int)
    tuples, in the deterministic application order above.
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
    for key, encoded in account_inserts:
        trie.insert(key, encoded)
    for key in account_deletes:
        trie.remove(key)
    return trie.commit()
