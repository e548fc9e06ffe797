"""Chain management: block validation, execution and import — a copy of
`ethrex_tpu/blockchain/blockchain.py` (upstream ethrex's
crates/blockchain/blockchain.rs: add_block = validate_block + execute +
merkleize + store, with the pipelined and batch importers and the
EIP-7928 block access list).  Stateless execution (`guest.execution`)
runs `validate_header`, `execute_block` and `_validate_body_roots` over
a chain view with no store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading

from ..crypto.keccak import keccak256
from ..primitives import rlp
from ..primitives.account import EMPTY_TRIE_ROOT
from ..primitives.block import Block, BlockHeader
from ..primitives.genesis import ChainConfig, Fork
from ..primitives.receipt import Receipt, logs_bloom
from ..evm import gas as G
from ..evm.db import StateDB
from ..evm.executor import InvalidTransaction, execute_tx
from ..evm.vm import EVM, BlockEnv, Message
from ..storage.store import Store
from ..trie.trie import trie_root_from_items
from . import sender_recovery

ELASTICITY_MULTIPLIER = 2
BASE_FEE_MAX_CHANGE_DENOMINATOR = 8
GAS_LIMIT_ADJUSTMENT_FACTOR = 1024
MIN_GAS_LIMIT = 5000

SYSTEM_ADDRESS = bytes.fromhex("fffffffffffffffffffffffffffffffffffffffe")
BEACON_ROOTS_ADDRESS = bytes.fromhex(
    "000f3df6d732807ef1319fb7b8bb8522d0beac02")
HISTORY_STORAGE_ADDRESS = bytes.fromhex(
    "0000f90827f1c53a10cb7a02335b175320002935")
WITHDRAWAL_REQUESTS_ADDRESS = bytes.fromhex(
    "00000961ef480eb55e80d19ad83579a64c007002")
CONSOLIDATION_REQUESTS_ADDRESS = bytes.fromhex(
    "0000bbddc7ce488642fb579f8b00f3a590007251")
DEPOSIT_CONTRACT_ADDRESS = bytes.fromhex(
    "00000000219ab540356cbb839cbe05303d7705fa")

GWEI = 10**9


class InvalidBlock(Exception):
    pass


def _note_import_stage(stage: str, seconds: float) -> None:
    """Sub-stage attribution (execute / merkleize / store_write) for
    both import paths: the block_import_stage_seconds histogram plus the
    perf profiler tree.  Telemetry contract: never raises into an
    import."""
    try:
        from ..perf.profiler import record_stage
        from ..utils.metrics import observe_import_stage

        observe_import_stage(stage, seconds)
        record_stage("l1_import", stage, seconds)
    except Exception:
        pass


class DirtySnapshot:
    """Frozen copy of one block's dirty write set, duck-typing the slice
    of StateDB that apply_updates_to_tries consumes (dirty_accounts,
    dirty_storage, accounts, get_storage, source).  Lets the pipelined
    importer merkleize block N on a worker thread while block N+1 keeps
    executing — and mutating — the live StateDB."""

    def __init__(self, db: StateDB):
        self.dirty_accounts = set(db.dirty_accounts)
        self.dirty_storage = {a: set(s)
                              for a, s in db.dirty_storage.items()}
        self.accounts = {}
        for addr in self.dirty_accounts | set(self.dirty_storage):
            acct = db.accounts.get(addr)
            if acct is None:
                continue
            frozen = dataclasses.replace(acct)
            frozen.storage = dict(acct.storage)
            self.accounts[addr] = frozen
        self.source = None  # the worker chains StoreSource(prev_root)

    def get_storage(self, addr: bytes, slot: int) -> int:
        acct = self.accounts[addr]
        if slot in acct.storage:
            return acct.storage[slot]
        if acct.exists and not acct.storage_cleared:
            return self.source.get_storage(addr, slot)
        return 0


@dataclasses.dataclass
class ExecutionOutcome:
    receipts: list
    state_db: StateDB
    gas_used: int
    blob_gas_used: int
    requests: list  # raw request bytes (type || data), non-empty only


class Blockchain:
    def __init__(self, store: Store, config: ChainConfig):
        self.store = store
        self.config = config

    # ------------------------------------------------------------------
    # header validation (parent-relative)
    # ------------------------------------------------------------------
    def validate_header(self, header: BlockHeader, parent: BlockHeader):
        if header.number != parent.number + 1:
            raise InvalidBlock("bad block number")
        if header.timestamp <= parent.timestamp:
            raise InvalidBlock("timestamp not after parent")
        if len(header.extra_data) > 32:
            raise InvalidBlock("extra data too long")
        fork = self.config.fork_at(header.number, header.timestamp)
        # gas limit bounds
        diff = abs(header.gas_limit - parent.gas_limit)
        if diff >= parent.gas_limit // GAS_LIMIT_ADJUSTMENT_FACTOR:
            raise InvalidBlock("gas limit change too large")
        if header.gas_limit < MIN_GAS_LIMIT:
            raise InvalidBlock("gas limit too low")
        if header.gas_used > header.gas_limit:
            raise InvalidBlock("gas used above limit")
        if fork >= Fork.LONDON:
            expected = next_base_fee(parent)
            if header.base_fee_per_gas != expected:
                raise InvalidBlock(
                    f"bad base fee {header.base_fee_per_gas} != {expected}")
        if fork >= Fork.PARIS:
            if header.difficulty != 0 or header.nonce != b"\x00" * 8:
                raise InvalidBlock("post-merge difficulty/nonce must be zero")
        if fork >= Fork.SHANGHAI and header.withdrawals_root is None:
            raise InvalidBlock("missing withdrawals root")
        if fork >= Fork.CANCUN:
            if header.blob_gas_used is None or header.excess_blob_gas is None:
                raise InvalidBlock("missing blob gas fields")
            # spec + upstream (block.rs validate_excess_blob_gas): the
            # schedule and fork are resolved at the NEW block's timestamp
            target, max_bg, fraction = self.config.blob_params_at(
                header.timestamp)
            expected_excess = G.calc_excess_blob_gas(
                parent.excess_blob_gas or 0, parent.blob_gas_used or 0,
                target, max_bg, fraction,
                parent_base_fee=parent.base_fee_per_gas or 0,
                eip7918=fork >= Fork.OSAKA)
            if header.excess_blob_gas != expected_excess:
                raise InvalidBlock("bad excess blob gas")
            if header.parent_beacon_block_root is None:
                raise InvalidBlock("missing parent beacon block root")
        if fork >= Fork.PRAGUE and header.requests_hash is None:
            raise InvalidBlock("missing requests hash")

    # ------------------------------------------------------------------
    # system operations
    # ------------------------------------------------------------------
    def _system_call(self, state: StateDB, block_env: BlockEnv,
                     target: bytes, data: bytes):
        if not state.get_code(target):
            return None
        evm = EVM(state, block_env, self.config)
        ok, _, out = evm.execute_message(Message(
            caller=SYSTEM_ADDRESS, to=target, code_address=target,
            value=0, data=data, gas=30_000_000))
        return out if ok else None

    def _pre_tx_system_ops(self, state: StateDB, env: BlockEnv,
                           header: BlockHeader, fork: Fork):
        state.begin_tx()
        if fork >= Fork.CANCUN and header.parent_beacon_block_root:
            self._system_call(state, env, BEACON_ROOTS_ADDRESS,
                              header.parent_beacon_block_root)
        if fork >= Fork.PRAGUE:
            self._system_call(state, env, HISTORY_STORAGE_ADDRESS,
                              header.parent_hash)
        state.finalize_tx()

    def _post_tx_requests(self, state: StateDB, env: BlockEnv,
                          receipts: list, fork: Fork) -> list:
        if fork < Fork.PRAGUE:
            return []
        requests = []
        # EIP-6110 deposits from the deposit contract logs
        deposit_data = b""
        for rec in receipts:
            for log in rec.logs:
                if log.address == DEPOSIT_CONTRACT_ADDRESS and log.topics:
                    deposit_data += _parse_deposit_log(log.data)
        if deposit_data:
            requests.append(b"\x00" + deposit_data)
        state.begin_tx()
        out = self._system_call(state, env, WITHDRAWAL_REQUESTS_ADDRESS, b"")
        if out:
            requests.append(b"\x01" + out)
        out = self._system_call(state, env, CONSOLIDATION_REQUESTS_ADDRESS,
                                b"")
        if out:
            requests.append(b"\x02" + out)
        state.finalize_tx()
        return requests

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute_block(self, block: Block, parent: BlockHeader,
                      state_db: StateDB | None = None,
                      bal_recorder=None) -> ExecutionOutcome:
        """`bal_recorder` (primitives/bal.BalRecorder, optional) collects
        the EIP-7928 Block Access List from the per-phase journals —
        index 0 = pre-exec system ops, 1..n = txs, n+1 = post
        (withdrawals + requests), mirroring upstream's recorder
        (block_access_list.rs:791-795)."""
        header = block.header
        fork = self.config.fork_at(header.number, header.timestamp)
        env = BlockEnv(
            number=header.number, coinbase=header.coinbase,
            timestamp=header.timestamp, gas_limit=header.gas_limit,
            prev_randao=header.prev_randao,
            base_fee=header.base_fee_per_gas or 0,
            excess_blob_gas=header.excess_blob_gas or 0,
            parent_beacon_block_root=header.parent_beacon_block_root
            or b"\x00" * 32,
            difficulty=header.difficulty,
        )
        state = state_db or self.store.state_db(parent.state_root)
        if bal_recorder is not None:
            bal_recorder.attach(state)
        self._pre_tx_system_ops(state, env, header, fork)
        if bal_recorder is not None:
            bal_recorder.record_phase(state, 0)

        receipts = []
        gas_used = 0
        blob_gas_used = 0
        for i, tx in enumerate(block.body.transactions):
            try:
                result = execute_tx(tx, state, env, self.config)
            except InvalidTransaction as e:
                raise InvalidBlock(f"tx {i} invalid: {e}")
            if bal_recorder is not None:
                bal_recorder.record_phase(state, i + 1)
            gas_used += result.gas_used
            if gas_used > header.gas_limit:
                raise InvalidBlock("block gas limit exceeded")
            blob_gas_used += G.BLOB_GAS_PER_BLOB * len(
                tx.blob_versioned_hashes)
            receipts.append(Receipt(
                tx_type=tx.tx_type, succeeded=result.success,
                cumulative_gas_used=gas_used, logs=result.logs))
        _, max_blob_gas, _ = self.config.blob_params_at(header.timestamp)
        if blob_gas_used > max_blob_gas:
            raise InvalidBlock("blob gas above maximum")

        post_index = len(block.body.transactions) + 1
        # withdrawals
        had_post_ops = False
        if block.body.withdrawals:
            for wd in block.body.withdrawals:
                if wd.amount:
                    state.begin_tx()
                    state.add_balance(wd.address, wd.amount * GWEI)
                    state.finalize_tx()
                    had_post_ops = True
        requests = self._post_tx_requests(state, env, receipts, fork)
        # ONE record for the whole post-exec phase (withdrawals +
        # requests): per-withdrawal records would emit duplicate
        # block_access_index entries for a shared withdrawal address and
        # the honest BAL would fail its own ordering check; the journal sink accumulates across the windows
        if bal_recorder is not None and \
                (had_post_ops or fork >= Fork.PRAGUE):
            bal_recorder.record_phase(state, post_index)
        return ExecutionOutcome(receipts=receipts, state_db=state,
                                gas_used=gas_used,
                                blob_gas_used=blob_gas_used,
                                requests=requests)

    # ------------------------------------------------------------------
    # import
    # ------------------------------------------------------------------
    def _validate_block_outcome(self, header: BlockHeader,
                                outcome: "ExecutionOutcome") -> None:
        """Post-execution consensus checks shared by the per-block and
        batch import paths (gas, blob gas, receipts root, bloom, Prague
        requests) — everything except the state root."""
        if outcome.gas_used != header.gas_used:
            raise InvalidBlock(
                f"gas used mismatch in block {header.number}: "
                f"{outcome.gas_used} != {header.gas_used}")
        if header.blob_gas_used is not None \
                and outcome.blob_gas_used != header.blob_gas_used:
            raise InvalidBlock(
                f"blob gas used mismatch in block {header.number}")
        if compute_receipts_root(outcome.receipts) != header.receipts_root:
            raise InvalidBlock(
                f"receipts root mismatch in block {header.number}")
        bloom = logs_bloom(
            [log for r in outcome.receipts for log in r.logs])
        if bloom != header.bloom:
            raise InvalidBlock(f"logs bloom mismatch in block {header.number}")
        fork = self.config.fork_at(header.number, header.timestamp)
        if fork >= Fork.PRAGUE:
            if compute_requests_hash(outcome.requests) != \
                    header.requests_hash:
                raise InvalidBlock(
                    f"requests hash mismatch in block {header.number}")

    def regenerate_head_state(self) -> int:
        """Re-execute the canonical tail whose trie nodes never reached
        the durable backend (diff layering keeps unfinalized state in
        RAM; a restart must rebuild it — upstream makes the same
        trade, ethrex.rs:62-64 / initializers regenerate_head_state).

        Walks back from the head to the newest ancestor whose state root
        resolves, then re-imports forward.  Layers flatten oldest-first
        and atomically per block, so root presence implies completeness.
        Returns the number of re-imported blocks."""
        head = self.store.head_header()
        if head is None or self.store.nodes.get(head.state_root) is not None:
            return 0
        tail = []
        cursor = head
        while cursor.number > 0 and \
                self.store.nodes.get(cursor.state_root) is None:
            body = self.store.get_body(cursor.hash)
            if body is None:
                break
            tail.append(Block(header=cursor, body=body))
            cursor = self.store.get_header(cursor.parent_hash)
            if cursor is None:
                break
        for block in reversed(tail):
            self.add_block(block)
        return len(tail)

    def add_block(self, block: Block, bal=None) -> None:
        """`bal` (primitives/bal.BlockAccessList, optional): the claimed
        EIP-7928 Block Access List.  When given, the import prefetches
        the listed state in parallel (warm_from_bal), re-derives the BAL
        during execution, and REJECTS the block if the claim does not
        match — a tampered list cannot ride a valid block (upstream:
        blockchain.rs:552 BAL validation)."""
        import time as _time

        from ..utils.metrics import (observe_block_execution,
                                     observe_block_import)

        t_import = _time.perf_counter()
        header = block.header
        parent = self.store.get_header(header.parent_hash)
        if parent is None:
            raise InvalidBlock("unknown parent")
        self.validate_header(header, parent)
        self._validate_body_roots(block)
        # batched sender recovery ahead of execution (ethrex
        # add_block_pipeline): the executor's inline tx.sender() becomes
        # a cache hit; the batch wall lands in evm/sig_recovery
        sender_recovery.recover_senders(block.body.transactions)
        # diff layering (storage/layering.py): this block's trie nodes go
        # into a per-block in-memory layer; settling flattens layers to
        # the durable backend once finalized (or past the settle window)
        self.store.push_node_layer(header.number, header.hash)
        try:
            recorder = None
            state_db = None
            if bal is not None:
                from ..primitives.bal import BalRecorder

                try:
                    bal.validate_ordering()
                except ValueError as e:
                    raise InvalidBlock(f"block access list: {e}")
                recorder = BalRecorder()
                state_db = self.store.state_db(parent.state_root)
                self.warm_from_bal(state_db, bal)
            t_exec = _time.perf_counter()
            outcome = self.execute_block(block, parent, state_db,
                                         bal_recorder=recorder)
            dt_exec = _time.perf_counter() - t_exec
            observe_block_execution(dt_exec)
            _note_import_stage("execute", dt_exec)
            self._validate_block_outcome(header, outcome)
            if recorder is not None and \
                    recorder.build().hash() != bal.hash():
                raise InvalidBlock("block access list mismatch")
            t_mk = _time.perf_counter()
            new_root = self.store.apply_account_updates(
                parent.state_root, outcome.state_db)
            _note_import_stage("merkleize", _time.perf_counter() - t_mk)
            if new_root != header.state_root:
                raise InvalidBlock(
                    f"state root mismatch: {new_root.hex()} != "
                    f"{header.state_root.hex()}")
        except BaseException:
            # a failed import must not leak an orphaned top layer that
            # would absorb unrelated writes
            self.store.discard_node_layer(header.number, header.hash)
            raise
        t_sw = _time.perf_counter()
        self.store.add_block(block, outcome.receipts)
        _note_import_stage("store_write", _time.perf_counter() - t_sw)
        observe_block_import(_time.perf_counter() - t_import)

    def generate_bal(self, block: Block, parent: BlockHeader):
        """Derive the block's EIP-7928 Block Access List (the producer's
        side: upstream generates it during payload building,
        blockchain.rs:552)."""
        from ..primitives.bal import BalRecorder

        recorder = BalRecorder()
        self.execute_block(block, parent, bal_recorder=recorder)
        return recorder.build()

    def warm_from_bal(self, state_db: StateDB, bal) -> None:
        """BAL-driven state prefetch (upstream's warm_block_from_bal
        seat, levm/mod.rs:2817): pull every listed account, its code and
        its listed slots into the execution cache before the first tx
        runs.  On a multi-core host the per-account fetches fan out over
        a thread pool — the trie-walk keccaks and the native extensions
        drop the GIL; single-core hosts prefetch inline (same cache
        effect, no fan-out)."""
        import os

        accounts = bal.accounts
        if not accounts:
            return
        # warm the SOURCE layer only (trie objects + node caches), never
        # the StateDB account cache: a pre-seeded StateDB slot skips the
        # read journal during execution, so the derived BAL would lose
        # honest reads — and journaled warming loads would let a claimed
        # list padded with bogus reads self-certify
        src = state_db.source

        def prefetch(ac):
            try:
                src.get_account_state(ac.address)
                for slot in ac.storage_reads:
                    src.get_storage(ac.address, slot)
                for slot in ac.storage_changes:
                    src.get_storage(ac.address, slot)
            except Exception:
                pass  # missing state surfaces during execution

        cpus = os.cpu_count() or 1
        if cpus > 1 and len(accounts) > 8:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, cpus)) as pool:
                list(pool.map(prefetch, accounts))
        else:
            for ac in accounts:
                prefetch(ac)

    def add_blocks_pipelined(self, blocks: list[Block]) -> None:
        """Pipelined import: execute block N+1 WHILE block N merkleizes
        and stores on a worker thread (upstream: blockchain.rs
        add_block_pipeline + execute_block_pipeline streaming account
        updates to the merkleizer).  Unlike the batch path, EVERY block's
        state root is validated.  The overlap is real under CPython: the
        merkleize step runs in the native C++ MPT engine via ctypes,
        which releases the GIL.

        Execution state chains through one shared StateDB cache; each
        block's dirty writes are snapshotted (DirtySnapshot) at handoff,
        and the worker chains the trie roots block by block."""
        import time as _time

        if not blocks:
            return
        # one diff layer per BATCH, tagged by its tail block: bulk-imported
        # nodes settle when the tail settles instead of being attributed
        # to whatever unrelated layer was open
        self.store.push_node_layer(blocks[-1].header.number,
                                   blocks[-1].header.hash)
        t0 = _time.perf_counter()
        try:
            self._add_blocks_pipelined(blocks)
        except BaseException:
            # mirror add_block: a failed pipelined import must not leak
            # the batch layer (it would absorb unrelated writes and stall
            # their durability behind a never-imported tail block)
            self.store.discard_node_layer(blocks[-1].header.number,
                                          blocks[-1].header.hash)
            raise
        wall = _time.perf_counter() - t0
        try:
            from ..utils.metrics import record_import_throughput

            gas = sum(b.header.gas_used for b in blocks)
            if wall > 0:
                record_import_throughput(gas / wall / 1e6)
        except Exception:
            pass

    def _add_blocks_pipelined(self, blocks: list[Block]) -> None:
        import queue as queue_mod
        import time as _time

        from ..evm.db import StateDB
        from ..storage.store import StoreSource

        parent = self.store.get_header(blocks[0].header.parent_hash)
        if parent is None:
            raise InvalidBlock("unknown parent")
        overrides = {parent.number: parent.hash}
        state_db = StateDB(StoreSource(self.store, parent.state_root,
                                       header_overrides=overrides))
        q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        failure: list[Exception] = []

        def merkleizer():
            prev_root = parent.state_root
            while True:
                item = q.get()
                if item is None:
                    return
                block, receipts, snap = item
                try:
                    snap.source = StoreSource(self.store, prev_root,
                                              header_overrides=overrides)
                    t_mk = _time.perf_counter()
                    new_root = self.store.apply_account_updates(
                        prev_root, snap)
                    _note_import_stage(
                        "merkleize", _time.perf_counter() - t_mk)
                    if new_root != block.header.state_root:
                        raise InvalidBlock(
                            f"state root mismatch at block "
                            f"{block.header.number}: {new_root.hex()} != "
                            f"{block.header.state_root.hex()}")
                    t_sw = _time.perf_counter()
                    self.store.add_block(block, receipts)
                    _note_import_stage(
                        "store_write", _time.perf_counter() - t_sw)
                    prev_root = new_root
                except Exception as exc:  # noqa: BLE001 — joined below
                    failure.append(exc)
                    # keep draining so the producer's put() never blocks
                    # against a dead consumer
                    while q.get() is not None:
                        pass
                    return

        worker = threading.Thread(target=merkleizer, daemon=True)
        worker.start()
        prev = parent
        # overlap sender recovery with execution: block N+1's senders
        # recover on the pool while block N executes/merkleizes (the
        # native engine's C calls drop the GIL, so this is real overlap)
        pending = sender_recovery.recover_senders_async(
            blocks[0].body.transactions)
        try:
            for i, block in enumerate(blocks):
                if failure:
                    break
                header = block.header
                if header.parent_hash != prev.hash:
                    raise InvalidBlock("non-contiguous batch")
                self.validate_header(header, prev)
                self._validate_body_roots(block)
                nxt = None
                if i + 1 < len(blocks):
                    nxt = sender_recovery.recover_senders_async(
                        blocks[i + 1].body.transactions)
                pending.wait()
                t_exec = _time.perf_counter()
                outcome = self.execute_block(block, prev, state_db)
                _note_import_stage("execute", _time.perf_counter() - t_exec)
                if nxt is not None:
                    pending = nxt
                self._validate_block_outcome(header, outcome)
                snap = DirtySnapshot(state_db)
                state_db.drain_dirty()
                q.put((block, outcome.receipts, snap))
                overrides[header.number] = header.hash
                prev = header
        finally:
            q.put(None)
            worker.join()
        if failure:
            raise failure[0]

    VERIFY_INTERVAL = 256  # bound on unverified intermediate state roots

    def add_blocks_in_batch(self, blocks: list[Block]) -> None:
        """Bulk import: execute every block against ONE shared state cache
        and merkleize at VERIFY_INTERVAL boundaries + the end (upstream:
        blockchain.rs add_blocks_in_batch — full-sync bulk path).  All
        header/body rules, receipts roots, blooms and gas are validated per
        block; state roots are validated every VERIFY_INTERVAL blocks and
        for the final block, so a malicious bulk peer can persist at most
        VERIFY_INTERVAL-1 headers with bogus intermediate roots before the
        whole batch is rejected (bounding the trusted-chunk trade the
        upstream makes for bulk sync throughput)."""
        from ..storage.store import StoreSource

        if not blocks:
            return
        parent = self.store.get_header(blocks[0].header.parent_hash)
        if parent is None:
            raise InvalidBlock("unknown parent")
        # recover every sender in the batch up front, in one parallel
        # pass (ethrex add_blocks_in_batch recovers ahead of the loop)
        sender_recovery.recover_senders(
            [tx for b in blocks for tx in b.body.transactions])
        overrides = {parent.number: parent.hash}
        source = StoreSource(self.store, parent.state_root,
                             header_overrides=overrides)
        state_db = StateDB(source)
        prev = parent
        per_block = []
        verified_root = parent.state_root
        for i, block in enumerate(blocks):
            header = block.header
            if header.parent_hash != prev.hash:
                raise InvalidBlock("non-contiguous batch")
            self.validate_header(header, prev)
            self._validate_body_roots(block)
            outcome = self.execute_block(block, prev, state_db)
            self._validate_block_outcome(header, outcome)
            per_block.append((block, outcome.receipts))
            overrides[header.number] = header.hash
            prev = header
            if (i + 1) % self.VERIFY_INTERVAL == 0 and i + 1 < len(blocks):
                verified_root = self.store.apply_account_updates(
                    verified_root, state_db)
                if verified_root != header.state_root:
                    raise InvalidBlock(
                        f"intermediate state root mismatch at block "
                        f"{header.number}: {verified_root.hex()} != "
                        f"{header.state_root.hex()}")
                state_db.rebase(StoreSource(self.store, verified_root,
                                            header_overrides=overrides))
        new_root = self.store.apply_account_updates(verified_root, state_db)
        if new_root != blocks[-1].header.state_root:
            raise InvalidBlock(
                f"final state root mismatch: {new_root.hex()} != "
                f"{blocks[-1].header.state_root.hex()}")
        for block, receipts in per_block:
            self.store.add_block(block, receipts)

    def _validate_body_roots(self, block: Block):
        header = block.header
        if compute_tx_root(block.body.transactions) != header.tx_root:
            raise InvalidBlock("transactions root mismatch")
        if block.body.withdrawals is not None:
            wroot = compute_withdrawals_root(block.body.withdrawals)
            if wroot != header.withdrawals_root:
                raise InvalidBlock("withdrawals root mismatch")
        if header.uncles_hash != keccak256(rlp.encode(block.body.uncles)):
            raise InvalidBlock("uncles hash mismatch")


def _parse_deposit_log(data: bytes) -> bytes:
    """Extract the 7685 deposit request payload from a deposit-event log."""
    # DepositEvent(bytes pubkey, bytes wc, bytes amount, bytes sig, bytes idx)
    # ABI-encoded dynamic fields; offsets at fixed positions.
    try:
        out = b""
        for i in range(5):
            off = int.from_bytes(data[32 * i:32 * (i + 1)], "big")
            ln = int.from_bytes(data[off:off + 32], "big")
            out += data[off + 32:off + 32 + ln]
        return out
    except Exception:
        return b""


def next_base_fee(parent: BlockHeader) -> int:
    """EIP-1559 base fee update."""
    if parent.base_fee_per_gas is None:
        return 1_000_000_000  # first London block
    parent_base = parent.base_fee_per_gas
    target = parent.gas_limit // ELASTICITY_MULTIPLIER
    if parent.gas_used == target:
        return parent_base
    if parent.gas_used > target:
        delta = max(
            parent_base * (parent.gas_used - target) // target
            // BASE_FEE_MAX_CHANGE_DENOMINATOR, 1)
        return parent_base + delta
    delta = parent_base * (target - parent.gas_used) // target \
        // BASE_FEE_MAX_CHANGE_DENOMINATOR
    return parent_base - delta


def compute_tx_root(txs) -> bytes:
    return trie_root_from_items(
        [(rlp.encode(i), tx.encode_canonical()) for i, tx in enumerate(txs)])


def compute_receipts_root(receipts) -> bytes:
    return trie_root_from_items(
        [(rlp.encode(i), r.encode()) for i, r in enumerate(receipts)])


def compute_withdrawals_root(withdrawals) -> bytes:
    return trie_root_from_items(
        [(rlp.encode(i), rlp.encode(w.to_fields()))
         for i, w in enumerate(withdrawals)])


def compute_requests_hash(requests: list[bytes]) -> bytes:
    acc = hashlib.sha256()
    for req in requests:
        if len(req) > 1:
            acc.update(hashlib.sha256(req).digest())
    return acc.digest()
