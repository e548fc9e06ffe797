"""Execution witness generation — a copy of `ethrex_tpu/guest/witness.py`
(upstream ethrex's Blockchain::generate_witness_for_blocks,
crates/blockchain/blockchain.rs, and the ExecutionWitness type,
crates/common/types/block_execution_witness.rs).

A witness = the minimal set of trie nodes + contract codes + ancestor headers
needed to statelessly re-execute a batch of blocks.  We collect it by
re-executing against a recording node table (every resolved trie node is the
proof of its own path).  The sequencer's node generates it; the prover only
reads it.
"""

from __future__ import annotations

import dataclasses

from ..primitives.block import Block, BlockHeader


class RecordingDict:
    """Node-table wrapper recording every key successfully read."""

    def __init__(self, inner: dict):
        self.inner = inner
        self.accessed: dict = {}

    def get(self, key, default=None):
        value = self.inner.get(key, default)
        if value is not None and key not in self.accessed:
            self.accessed[key] = value
        return value

    def __contains__(self, key):
        return key in self.inner

    def __getitem__(self, key):
        value = self.inner[key]
        self.accessed[key] = value
        return value

    def __setitem__(self, key, value):
        # trie commits during re-execution are not part of the witness;
        # nodes are content-addressed, so skip keys the store already has
        # (a persistent backend would otherwise append a duplicate record
        # per recomputed node on every witness request)
        if key not in self.inner:
            self.inner[key] = value


@dataclasses.dataclass
class ExecutionWitness:
    """Self-contained input for stateless execution."""

    nodes: list            # encoded trie nodes (state + storage tries)
    codes: list            # contract bytecodes
    block_headers: list    # ancestor headers (for parent + BLOCKHASH)
    first_block_number: int

    def to_json(self) -> dict:
        return {
            "nodes": ["0x" + bytes(n).hex() for n in self.nodes],
            "codes": ["0x" + bytes(c).hex() for c in self.codes],
            "headers": ["0x" + h.encode().hex() for h in self.block_headers],
            "firstBlock": self.first_block_number,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ExecutionWitness":
        return cls(
            nodes=[bytes.fromhex(n[2:]) for n in obj["nodes"]],
            codes=[bytes.fromhex(c[2:]) for c in obj["codes"]],
            block_headers=[
                BlockHeader.decode(bytes.fromhex(h[2:]))
                for h in obj["headers"]],
            first_block_number=obj["firstBlock"],
        )


def generate_witness(chain, blocks: list[Block],
                     write_log: list | None = None,
                     receipts_out: list | None = None) -> ExecutionWitness:
    """Re-execute `blocks` recording every touched node/code/header.

    `chain` is a Blockchain whose store contains the blocks' ancestors and
    the pre-state of blocks[0].  `write_log`/`receipts_out` (optional)
    capture the per-block raw trie writes and receipts during the same
    pass — the committer derives the batch's VM coverage from them
    without a second execution.
    """
    from ..evm.db import StateDB
    from ..storage.store import StoreSource

    store = chain.store
    parent = store.get_header(blocks[0].header.parent_hash)
    if parent is None:
        raise ValueError("parent of first block not in store")

    recorder = RecordingDict(store.nodes)
    codes_used: dict[bytes, bytes] = {}
    headers: dict[int, BlockHeader] = {parent.number: parent}

    def on_code(code_hash, code):
        codes_used[code_hash] = code

    def on_block_hash(number, h):
        hdr = store.get_header(h)
        if hdr is not None:
            headers[number] = hdr

    state_root = parent.state_root
    prev = parent
    for block in blocks:
        src = StoreSource(store, state_root, nodes=recorder,
                          on_code=on_code, on_block_hash=on_block_hash)
        state_db = StateDB(src)
        outcome = chain.execute_block(block, prev, state_db)
        if receipts_out is not None:
            receipts_out.append(outcome.receipts)
        block_log = None if write_log is None else []
        state_root = store.apply_account_updates(state_root, state_db,
                                                 nodes=recorder,
                                                 write_log=block_log)
        if write_log is not None:
            write_log.append(block_log)
        prev = block.header

    # the guest validates ancestor headers as a hash-linked chain, so fill
    # any gaps between the oldest touched header and the parent
    oldest = min(headers)
    cursor = parent
    while cursor.number > oldest:
        prev_hdr = store.get_header(cursor.parent_hash)
        if prev_hdr is None:
            break
        headers[prev_hdr.number] = prev_hdr
        cursor = prev_hdr
    ancestor_headers = [headers[n] for n in sorted(headers)
                        if n < blocks[0].header.number]
    return ExecutionWitness(
        nodes=list(recorder.accessed.values()),
        codes=list(codes_used.values()),
        block_headers=ancestor_headers,
        first_block_number=blocks[0].header.number,
    )
