"""Write-log normalization and the witness replay audit for the execution
proof: a copy of `ethrex_tpu/guest/access_log.py`.

Bridges the guest's per-block trie write log (storage/store.py
apply_updates_to_tries) to:

  1. the FLAT touched-state commitment the state-update AIR proves over
     (stark/state_tree.py, models/state_update_air.py), and
  2. a non-executing VERIFIER audit (`replay_log_against_witness`) that
     replays the claimed writes into the witness MPT — trie ops only, no
     EVM — validating every logged old value, every storage root, and the
     final keccak state root.

Flat key/value model (32-byte words):
  * account:  key = pack32(P2([ACCOUNT_TAG, addr_limbs]))     (flat_model)
              value = pack32(P2(fields_limbs)), 0^32 when absent/cleared
  * storage:  key = keccak(0x01 || address || slot32)
              value = the raw 32-byte slot value (0^32 when unset)
Account entries use Poseidon2 digests of structured field data so the VM
circuit (models/transfer_air.py) can recompute them from account fields
in-trace; storage entries stay keccak/raw until their semantics are
arithmetized.

The slot entries audit per-slot history across the batch; the account
entries are the authoritative state commitment (an account's value hashes
its storage_root, so storage changes always surface in an account entry
too).  This mirrors how the reference guest re-merkleizes accounts after
storage updates (crates/guest-program/src/common/execution.rs:42-209).

Raw log wire form (carried inside the proof): one list per block of
  ["a", addr_hex, old_rlp_hex, new_rlp_hex, cleared]   account upsert/delete
  ["s", addr_hex, slot_hex, old32_hex, new32_hex]      storage write
  ["c", addr_hex]                                      storage clear marker

Storage clearing (destroy+recreate): execution never reads the old
storage trie of a cleared account, so a pruned witness legitimately omits
it — neither the prover nor the verifier walks it.  The clear marker
resets the account's previously-seen flat slot entries to zero (keeping
the in-circuit old-value chain consistent), cleared slots log old = 0,
and the replay audit rebuilds the cleared storage trie from the empty
root, checking only the resulting storage_root.
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from ..primitives import rlp
from ..primitives.account import EMPTY_TRIE_ROOT, AccountState
from ..stark.state_tree import TouchedStateTree, tree_depth_for
from ..trie.trie import MissingNode, Trie
from . import flat_model

ZERO32 = b"\x00" * 32


def account_key(address: bytes) -> bytes:
    return flat_model.account_key32(address)


def storage_key(address: bytes, slot: int) -> bytes:
    return keccak256(b"\x01" + address + slot.to_bytes(32, "big"))


@dataclasses.dataclass
class WriteEntry:
    """One normalized flat write (what the AIR's msg limbs carry)."""

    key: bytes
    old: bytes
    new: bytes


class LogAuditError(Exception):
    pass


def raw_log_to_json(blocks_log: list) -> list:
    out = []
    for block in blocks_log:
        rows = []
        for entry in block:
            if entry[0] == "acct":
                _, addr, _, old, new, cleared = entry
                rows.append(["a", addr.hex(), old.hex(), new.hex(),
                             bool(cleared)])
            elif entry[0] == "clear":
                rows.append(["c", entry[1].hex()])
            else:
                _, addr, slot, old, new = entry
                rows.append(["s", addr.hex(), "%064x" % slot,
                             "%064x" % old, "%064x" % new])
        out.append(rows)
    return out


def raw_log_from_json(obj: list) -> list:
    blocks = []
    for rows in obj:
        block = []
        for row in rows:
            if row[0] == "a":
                block.append(("acct", bytes.fromhex(row[1]), None,
                              bytes.fromhex(row[2]), bytes.fromhex(row[3]),
                              bool(row[4])))
            elif row[0] == "s":
                block.append(("slot", bytes.fromhex(row[1]),
                              int(row[2], 16), int(row[3], 16),
                              int(row[4], 16)))
            elif row[0] == "c":
                block.append(("clear", bytes.fromhex(row[1])))
            else:
                raise LogAuditError(f"unknown log entry kind {row[0]!r}")
        blocks.append(block)
    return blocks


def flatten_entries(blocks_log: list) -> list[WriteEntry]:
    """Per-block raw tuples -> ordered flat WriteEntries.

    A clear marker becomes explicit zero-writes for every slot key of
    that account seen so far, so the flat chain stays consistent with the
    post-clear old = 0 values of subsequent writes.
    """
    out = []
    current: dict[bytes, bytes] = {}
    slots_of: dict[bytes, set] = {}

    def emit(key: bytes, old: bytes, new: bytes):
        out.append(WriteEntry(key, old, new))
        current[key] = new

    for block in blocks_log:
        for entry in block:
            if entry[0] == "acct":
                _, addr, _, old, new, _cleared = entry
                emit(account_key(addr),
                     flat_model.account_value32(old),
                     flat_model.account_value32(new))
            elif entry[0] == "clear":
                addr = entry[1]
                for key in sorted(slots_of.get(addr, ())):
                    prev = current.get(key, ZERO32)
                    if prev != ZERO32:
                        emit(key, prev, ZERO32)
            else:
                _, addr, slot, old, new = entry
                key = storage_key(addr, slot)
                slots_of.setdefault(addr, set()).add(key)
                emit(key, int(old).to_bytes(32, "big"),
                     int(new).to_bytes(32, "big"))
    return out


def build_access_records(entries: list[WriteEntry],
                         depth: int | None = None):
    """Build the touched-state tree from the log's first-seen old values
    and replay every write through it.

    Returns (records, r_pre, r_post, depth).  The chain is self-consistent
    by construction when each entry's `old` equals the current flat value
    of its key; a log violating that (an executor bug or a forged log)
    raises, because the proof it would produce could never satisfy the
    old-lane root checks anyway.
    """
    initial: dict[bytes, bytes] = {}
    current: dict[bytes, bytes] = {}
    for e in entries:
        if e.key not in initial:
            initial[e.key] = e.old
            current[e.key] = e.old
        if current[e.key] != e.old:
            raise LogAuditError(
                f"write log inconsistent at key {e.key.hex()}: "
                f"old {e.old.hex()} != current {current[e.key].hex()}")
        current[e.key] = e.new
    if depth is None:
        depth = tree_depth_for(len(initial))
    tree = TouchedStateTree(initial, depth)
    r_pre = tree.root
    records = [tree.update(e.key, e.new) for e in entries]
    return records, r_pre, tree.root, depth


# ---------------------------------------------------------------------------
# Verifier-side audit: replay the claimed writes into the witness MPT
# ---------------------------------------------------------------------------

def replay_log_against_witness(blocks_log: list, witness_nodes: list,
                               initial_root: bytes,
                               final_root: bytes) -> None:
    """Validate a claimed write log against the execution witness WITHOUT
    executing the EVM — trie operations only.

    Per block, per account: check the logged old account RLP against the
    replayed state trie, replay the account's logged slot writes from its
    old storage root (or the empty root when cleared) and require the
    resulting storage root to equal the one inside the logged new account
    RLP, check each slot's logged old value against the pre-block storage
    trie, then apply the account write.  After all blocks the replayed
    state root must equal `final_root`.

    Raises LogAuditError on any divergence; MissingNode (a log that walks
    paths the witness doesn't carry) is reported as an audit failure too.
    """
    nodes = {keccak256(n): bytes(n) for n in witness_nodes}
    root = initial_root
    try:
        _replay(blocks_log, nodes, root, final_root)
    except MissingNode as e:
        raise LogAuditError(f"log walks outside the witness: {e}")


def _replay(blocks_log, nodes, root, final_root):
    # Slot rows precede the account entry that absorbs them (the order
    # apply_updates_to_tries emits, and the order the fine per-tx logs
    # keep).  Within one block an address may have SEVERAL account entries
    # (fine logs emit one per transaction): each consumes the slot rows
    # buffered for it since the previous one, and old values chain — the
    # first claim of a key is checked against the pre-entry storage trie,
    # later claims against the previous new value.
    for bi, block in enumerate(blocks_log):
        trie = Trie.from_nodes(root, nodes, share=True)
        pending: dict[bytes, list] = {}
        deletes = []
        for entry in block:
            if entry[0] == "slot":
                pending.setdefault(entry[1], []).append(entry)
                continue
            if entry[0] == "clear":
                continue  # clearing is carried by the acct entry's flag
            _, addr, _, old_rlp, new_rlp, cleared = entry
            key = keccak256(addr)
            have = trie.get(key) or b""
            if have != old_rlp:
                raise LogAuditError(
                    f"block {bi}: old account mismatch for {addr.hex()}")
            old_state = AccountState.decode(old_rlp) if old_rlp \
                else AccountState()
            addr_slots = pending.pop(addr, [])
            if addr_slots or cleared:
                base = EMPTY_TRIE_ROOT if cleared else \
                    old_state.storage_root
                pre = Trie.from_nodes(old_state.storage_root, nodes,
                                      share=True)
                st = Trie.from_nodes(base, nodes, share=True)
                chained: dict[bytes, int] = {}
                slot_deletes = []
                for _, _, slot, old_v, new_v in addr_slots:
                    skey = keccak256(slot.to_bytes(32, "big"))
                    if cleared:
                        # the old trie is legitimately absent from pruned
                        # witnesses; post-clear old values must chain from
                        # 0 and only the resulting storage_root is checked
                        want = chained.get(skey, 0)
                        if old_v != want:
                            raise LogAuditError(
                                f"block {bi}: cleared-storage write at "
                                f"{addr.hex()}[{slot:#x}] breaks the "
                                "old-value chain")
                    elif skey in chained:
                        if old_v != chained[skey]:
                            raise LogAuditError(
                                f"block {bi}: old slot chain mismatch at "
                                f"{addr.hex()}[{slot:#x}]")
                    else:
                        have_v = pre.get(skey)
                        have_i = rlp.decode_int(rlp.decode(have_v)) \
                            if have_v else 0
                        if have_i != old_v:
                            raise LogAuditError(
                                f"block {bi}: old slot mismatch at "
                                f"{addr.hex()}[{slot:#x}]")
                    chained[skey] = new_v
                for skey, final_v in chained.items():
                    if final_v:
                        st.insert(skey, rlp.encode(final_v))
                    else:
                        slot_deletes.append(skey)
                for skey in slot_deletes:
                    st.remove(skey)
                new_storage_root = st.commit()
                if new_rlp:
                    claimed = AccountState.decode(new_rlp).storage_root
                    if claimed != new_storage_root:
                        raise LogAuditError(
                            f"block {bi}: storage root mismatch for "
                            f"{addr.hex()}")
            if new_rlp:
                trie.insert(key, new_rlp)
            else:
                deletes.append(key)
        if pending:
            addr = next(iter(pending))
            raise LogAuditError(
                f"block {bi}: slot writes for {addr.hex()} without an "
                "account entry")
        for key in deletes:
            trie.remove(key)
        root = trie.commit()
    if root != final_root:
        raise LogAuditError(
            f"replayed state root {root.hex()} != claimed "
            f"{final_root.hex()}")
