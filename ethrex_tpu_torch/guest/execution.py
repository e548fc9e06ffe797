"""Stateless guest execution: witness -> pruned tries -> execute -> root check.

A copy of `ethrex_tpu/guest/execution.py`: the provable program whose
artifacts (output, write log, receipts) the prover arithmetizes.
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from ..evm.db import StateDB, TrieSource
from ..primitives.account import EMPTY_CODE_HASH
from ..primitives.block import Block
from ..primitives.genesis import ChainConfig
from ..primitives.transaction import TYPE_PRIVILEGED
from ..trie.trie import MissingNode
from .witness import ExecutionWitness


class StatelessExecutionError(Exception):
    pass


class WitnessSource(TrieSource):
    """VmDatabase over pruned witness tries (a shared mutable node table, so
    roots computed after each block extend the same table).  The trie walk
    itself lives in TrieSource, shared with the node's StoreSource."""

    def __init__(self, nodes: dict, codes: dict, headers_by_number: dict,
                 state_root: bytes):
        super().__init__(nodes, state_root)
        self.codes = codes
        self.headers_by_number = headers_by_number

    def get_code(self, code_hash: bytes) -> bytes:
        if code_hash == EMPTY_CODE_HASH:
            return b""
        code = self.codes.get(code_hash)
        if code is None:
            raise StatelessExecutionError(
                f"witness missing code {code_hash.hex()}")
        return code

    def get_block_hash(self, number: int) -> bytes:
        hdr = self.headers_by_number.get(number)
        if hdr is None:
            raise StatelessExecutionError(
                f"witness missing header {number}")
        return hdr.hash


@dataclasses.dataclass
class ProgramInput:
    """Input to the provable program (reference: l1/input.rs ProgramInput /
    the L2 ProverInputData payload)."""

    blocks: list
    witness: ExecutionWitness
    config: ChainConfig

    def to_json(self) -> dict:
        return {
            "blocks": ["0x" + b.encode().hex() for b in self.blocks],
            "witness": self.witness.to_json(),
            "config": {
                "chainId": self.config.chain_id,
                "blockForks": {int(k): v for k, v
                               in self.config.block_forks.items()},
                "timeForks": {int(k): v for k, v
                              in self.config.time_forks.items()},
                "ttd": self.config.terminal_total_difficulty,
            },
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ProgramInput":
        from ..primitives.genesis import Fork

        cfg = ChainConfig(chain_id=obj["config"]["chainId"])
        cfg.block_forks = {Fork(int(k)): v for k, v
                           in obj["config"]["blockForks"].items()}
        cfg.time_forks = {Fork(int(k)): v for k, v
                          in obj["config"]["timeForks"].items()}
        cfg.terminal_total_difficulty = obj["config"]["ttd"]
        return cls(
            blocks=[Block.decode(bytes.fromhex(b[2:]))
                    for b in obj["blocks"]],
            witness=ExecutionWitness.from_json(obj["witness"]),
            config=cfg,
        )


@dataclasses.dataclass
class ProgramOutput:
    """Public output committed by the proof (reference: l2/output.rs).

    `privileged_digest` = keccak chain over the executed privileged tx
    hashes — the L1 verifier binds it to the bridge's deposit queue so the
    proven execution cannot include fabricated mints.
    """

    initial_state_root: bytes
    final_state_root: bytes
    last_block_hash: bytes
    first_block_number: int
    last_block_number: int
    privileged_digest: bytes = b"\x00" * 32
    messages_root: bytes = b"\x00" * 32  # L2->L1 withdrawal Merkle root

    def encode(self) -> bytes:
        return (self.initial_state_root + self.final_state_root
                + self.last_block_hash
                + self.first_block_number.to_bytes(8, "big")
                + self.last_block_number.to_bytes(8, "big")
                + self.privileged_digest + self.messages_root)

    @classmethod
    def decode(cls, data: bytes) -> "ProgramOutput":
        if len(data) != 176:
            raise ValueError(
                f"ProgramOutput must be 176 bytes, got {len(data)}")
        return cls(data[0:32], data[32:64], data[64:96],
                   int.from_bytes(data[96:104], "big"),
                   int.from_bytes(data[104:112], "big"),
                   data[112:144], data[144:176])


def privileged_tx_digest(tx_hashes: list[bytes]) -> bytes:
    acc = b"\x00" * 32
    for h in tx_hashes:
        acc = keccak256(acc + h)
    return acc


class _GuestChainView:
    """Just enough of a Store for Blockchain's execution helpers (they only
    touch it when not handed an explicit StateDB, which we always do)."""

    def state_db(self, _root):  # pragma: no cover — guarded by callers
        raise StatelessExecutionError("guest execution requires witness db")


def execution_program(program_input: ProgramInput,
                      write_log: list | None = None,
                      receipts_out: list | None = None) -> ProgramOutput:
    """The stateless batch-execution program.

    1. rebuild pruned tries from the witness; check the initial root
    2. per block: validate linkage + header rules + body roots, execute,
       apply account updates, check the block's state root
    3. return the (initial_root, final_root, last_hash) commitment

    `write_log` (optional) collects every trie write across the batch in
    application order — the input to the execution proof's access-log
    binding (guest/access_log.py).  `receipts_out` (optional) collects the
    per-block receipt lists (`build_vm_batch` reads per-tx gas from
    them; their correctness is already bound by the receipts-root check
    below).
    """
    from ..blockchain.blockchain import (Blockchain, InvalidBlock,
                                         compute_receipts_root)
    from ..storage.store import _make_native_engine, apply_updates_to_tries

    blocks = program_input.blocks
    witness = program_input.witness
    if not blocks:
        raise StatelessExecutionError("empty batch")
    parent_header = witness.block_headers[-1] if witness.block_headers \
        else None
    if parent_header is None or \
            parent_header.hash != blocks[0].header.parent_hash:
        raise StatelessExecutionError("witness parent header mismatch")
    initial_root = parent_header.state_root

    nodes = {keccak256(n): bytes(n) for n in witness.nodes}
    codes = {keccak256(c): bytes(c) for c in witness.codes}
    # ancestor headers must form a hash-linked chain ending at the parent,
    # otherwise BLOCKHASH values inside the proven execution are forgeable
    headers = {}
    chain_cursor = parent_header
    for hdr in reversed(witness.block_headers):
        if hdr.hash != chain_cursor.hash and \
                hdr.hash != chain_cursor.parent_hash:
            raise StatelessExecutionError(
                f"witness header {hdr.number} not hash-linked")
        headers[hdr.number] = hdr
        chain_cursor = hdr

    native = _make_native_engine()  # per-batch C++ merkleizer (or None)
    chain = Blockchain(_GuestChainView(), program_input.config)
    state_root = initial_root
    prev = parent_header
    privileged_hashes = []
    receipts_per_block = []
    for block in blocks:
        privileged_hashes.extend(
            tx.hash for tx in block.body.transactions
            if tx.tx_type == TYPE_PRIVILEGED)
        if block.header.parent_hash != prev.hash:
            raise StatelessExecutionError("non-contiguous batch")
        try:
            chain.validate_header(block.header, prev)
            chain._validate_body_roots(block)
        except InvalidBlock as e:
            raise StatelessExecutionError(f"invalid header/body: {e}")
        source = WitnessSource(nodes, codes, headers, state_root)
        state_db = StateDB(source)
        try:
            outcome = chain.execute_block(block, prev, state_db)
        except (InvalidBlock, MissingNode) as e:
            raise StatelessExecutionError(f"execution failed: {e}")
        if outcome.gas_used != block.header.gas_used:
            raise StatelessExecutionError("gas used mismatch")
        if compute_receipts_root(outcome.receipts) != \
                block.header.receipts_root:
            raise StatelessExecutionError("receipts root mismatch")
        receipts_per_block.append(outcome.receipts)
        if receipts_out is not None:
            receipts_out.append(outcome.receipts)
        block_log = None if write_log is None else []
        try:
            state_root = apply_updates_to_tries(nodes, codes, state_root,
                                                state_db,
                                                write_log=block_log,
                                                native=native)
        except MissingNode as e:
            raise StatelessExecutionError(f"witness incomplete: {e}")
        if state_root != block.header.state_root:
            raise StatelessExecutionError(
                f"state root mismatch at block {block.header.number}")
        if write_log is not None:
            write_log.append(block_log)
        headers[block.header.number] = block.header
        prev = block.header

    from ..l2.messages import collect_messages, message_root

    messages = collect_messages(blocks, receipts_per_block)
    return ProgramOutput(
        initial_state_root=initial_root,
        final_state_root=state_root,
        last_block_hash=prev.hash,
        first_block_number=blocks[0].header.number,
        last_block_number=prev.number,
        privileged_digest=privileged_tx_digest(privileged_hashes),
        messages_root=message_root(messages),
    )
