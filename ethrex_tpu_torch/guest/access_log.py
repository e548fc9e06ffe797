"""Write-log normalization for the execution proof: the prover's half of
`ethrex_tpu/guest/access_log.py`.

Bridges the guest's per-block trie write log (storage/store.py
apply_updates_to_tries) to the FLAT touched-state commitment the
state-update AIR proves over (stark/state_tree.py,
models/state_update_air.py).  The verifier's half (the wire log's parser
and the witness replay audit, `replay_log_against_witness`) is not
copied.

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
too).

Raw log wire form (carried inside the proof): one list per block of
  ["a", addr_hex, old_rlp_hex, new_rlp_hex, cleared]   account upsert/delete
  ["s", addr_hex, slot_hex, old32_hex, new32_hex]      storage write
  ["c", addr_hex]                                      storage clear marker

Storage clearing (destroy+recreate): execution never reads the old
storage trie of a cleared account, so a pruned witness legitimately omits
it — neither the prover nor the verifier walks it.  The clear marker
resets the account's previously-seen flat slot entries to zero (keeping
the in-circuit old-value chain consistent) and cleared slots log
old = 0.
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from ..stark.state_tree import TouchedStateTree, tree_depth_for
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
