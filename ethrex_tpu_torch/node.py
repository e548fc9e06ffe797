"""Node: wires store + blockchain + mempool + fork choice + dev block
producer — a copy of `ethrex_tpu/node.py` (upstream ethrex's cmd/ethrex
init flow, initializers.rs init_l1).  RPC, p2p and the telemetry sampler
(`start_telemetry`, over `utils/timeseries.py`) are not copied yet, nor
the block and reorg listeners and the gossip relay that serve them.

`produce_block` builds a block from forced transactions and the mempool,
imports it and moves the head; `guest.witness.generate_witness` over
`Node.chain` then turns the produced blocks into a prover's
`ProgramInput` (`fixtures/build.py`)."""

from __future__ import annotations

import logging
import threading
import time

from .blockchain.blockchain import Blockchain
from .blockchain.fork_choice import ReorgHandler
from .blockchain.mempool import Mempool, MempoolError
from .blockchain.payload import build_payload, create_payload_header
from .evm.executor import InvalidTransaction
from .primitives.genesis import Genesis
from .storage.store import Store

log = logging.getLogger("ethrex_tpu_torch.node")


class Node:
    def __init__(self, genesis: Genesis, coinbase: bytes = b"\x00" * 20,
                 store: Store | None = None):
        self.store = store if store is not None else Store()
        self.genesis_header = self.store.init_genesis(genesis)
        self.config = genesis.config
        self.chain = Blockchain(self.store, self.config)
        self.chain.regenerate_head_state()
        self.mempool = Mempool()
        self.coinbase = coinbase
        self._producer_thread = None
        self._stop = threading.Event()
        self.lock = threading.RLock()
        # the reorg seam: every head move (producer, p2p import, engine
        # forkchoiceUpdated) goes through one handler so the mempool is
        # re-injected/evicted/revalidated on every reorg
        # (docs/CHAIN_RESILIENCE.md).  Shares the node lock
        # so engine-driven reorgs serialize with block production.
        self.reorg_handler = ReorgHandler(self.store, self.mempool,
                                          lock=self.lock)
        # crash-only restart: if a previous process died between the
        # canonical rewrite and the mempool settlement, replay the
        # journaled re-injection now (no transaction silently lost)
        self.reorg_handler.recover_pending()

    # ------------------------------------------------------------------
    def head_state_root(self) -> bytes:
        return self.store.head_header().state_root

    def pending_nonce(self, address: bytes) -> int:
        acct = self.store.account_state(self.head_state_root(), address)
        nonce = acct.nonce if acct else 0
        queue = self.mempool.by_sender.get(address, {})
        while nonce in queue:
            nonce += 1
        return nonce

    def submit_transaction(self, tx) -> bytes:
        from .primitives.transaction import TYPE_PRIVILEGED

        if tx.tx_type == TYPE_PRIVILEGED:
            # only the L1 watcher may create privileged txs — an unsigned
            # 0x7E tx over RPC would be an arbitrary unauthenticated mint
            raise InvalidTransaction(
                "privileged transactions cannot be submitted directly")
        sender = tx.sender()
        if sender is None:
            raise InvalidTransaction("invalid signature")
        if tx.chain_id is not None and tx.chain_id != self.config.chain_id:
            # counted against the pool's flow accounting even though the
            # check runs above it: RPC rejection reasons share one ledger
            from .utils.metrics import record_mempool_rejection

            self.mempool.rejections["wrong_chain_id"] = \
                self.mempool.rejections.get("wrong_chain_id", 0) + 1
            record_mempool_rejection("wrong_chain_id")
            err = InvalidTransaction("wrong chain id")
            err.reason = "wrong_chain_id"
            raise err
        root = self.head_state_root()
        acct = self.store.account_state(root, sender)
        nonce = acct.nonce if acct else 0
        balance = acct.balance if acct else 0
        base_fee = self.store.head_header().base_fee_per_gas or 0
        try:
            return self.mempool.add_transaction(tx, nonce, balance, base_fee)
        except MempoolError as e:
            # carry the typed rejection reason across the exception
            # translation: the RPC layer forwards it as structured error
            # data so load generators can account rejections per reason
            # instead of folding them into a generic error rate
            err = InvalidTransaction(str(e))
            err.reason = e.reason
            raise err

    # ------------------------------------------------------------------
    def produce_block(self, timestamp: int | None = None,
                      forced_txs: list | None = None):
        """Block production: forced (privileged) txs + mempool -> payload ->
        import.  `forced_txs` are included ahead of the mempool (the L2
        deposit path)."""
        with self.lock:
            parent = self.store.head_header()
            ts = timestamp or max(int(time.time()), parent.timestamp + 1)
            header = create_payload_header(
                parent, self.config, timestamp=ts, coinbase=self.coinbase)
            base_fee = header.base_fee_per_gas or 0
            root = parent.state_root

            def get_nonce(sender):
                acct = self.store.account_state(root, sender)
                return acct.nonce if acct else 0

            from .perf.chain_path import CHAIN_PATH
            from .perf.profiler import record_stage

            t_drain = time.monotonic()
            txs = list(forced_txs or []) \
                + self.mempool.pending(base_fee, get_nonce)
            t0 = time.monotonic()
            # chain-path X-ray: the mempool drain is the first producer
            # stage span; the candidate set marks sampled lifecycles
            record_stage("payload", "drain", t0 - t_drain)
            CHAIN_PATH.txs_selected([tx.hash for tx in txs])
            result = build_payload(self.chain, parent, header, txs, [],
                                   mempool=self.mempool)
            # block records + fork choice commit as one journaled unit on
            # persistent stores (write groups nest; see write_group)
            with self.store.write_group():
                self.chain.add_block(result.block)
                self.reorg_handler.apply(result.block.hash)
            for tx in result.block.body.transactions:
                self.mempool.remove_transaction(tx.hash, reason="included")
            from .utils.metrics import record_block

            build_s = time.monotonic() - t0
            record_block(result.block, build_s)
            CHAIN_PATH.block_produced(
                result.block.header.number,
                [tx.hash for tx in result.block.body.transactions],
                build_s)
            return result.block

    def import_block(self, block) -> bool:
        """Serialized import: validates + stores + fork-chooses under the
        node lock.  Returns True if the block was new."""
        from .blockchain.blockchain import InvalidBlock

        with self.lock:
            if self.store.get_header(block.hash) is not None:
                return False
            with self.store.write_group():
                self.chain.add_block(block)  # raises InvalidBlock
                self.reorg_handler.apply(block.hash)
        return True

    def pending_txs(self, parent) -> list:
        """Mempool transactions executable on top of `parent`, filtered by
        the NEXT block's base fee (shared by the payload build and the
        prewarmer so both see the same tx set)."""
        from .blockchain.blockchain import next_base_fee
        from .primitives.genesis import Fork

        fork = self.config.fork_at(parent.number + 1, parent.timestamp + 1)
        base_fee = next_base_fee(parent) if fork >= Fork.LONDON else 0

        def get_nonce(sender):
            acct = self.store.account_state(parent.state_root, sender)
            return acct.nonce if acct else 0

        return self.mempool.pending(base_fee or 0, get_nonce)

    def start_dev_producer(self, block_time: float = 1.0,
                           prewarm: bool = True):
        from .blockchain.prewarm import prewarm_transactions

        def loop():
            while not self._stop.wait(block_time):
                try:
                    if len(self.mempool):
                        self.produce_block()
                        if prewarm:
                            # AFTER producing: the genuinely idle window
                            # before the next tick warms trie/code/backend
                            # caches for the NEXT build without delaying
                            # this one (blockchain/prewarm.py)
                            parent = self.store.head_header()
                            t_warm = time.monotonic()
                            prewarm_transactions(
                                self.chain, parent,
                                self.pending_txs(parent),
                                deadline=t_warm + block_time / 2)
                            from .perf.profiler import record_stage

                            record_stage("payload", "prewarm",
                                         time.monotonic() - t_warm)
                except Exception as e:  # noqa: BLE001 — keep producing
                    log.warning("block production failed: %s", e)

        self._producer_thread = threading.Thread(target=loop, daemon=True)
        self._producer_thread.start()

    def stop(self, timeout: float = 30.0) -> bool:
        """Returns True when all writers are stopped (safe to close the
        backend); False if the producer is still alive after the timeout.
        Idempotent: a second call (HA demotion racing the shutdown
        drain) is a no-op returning the first call's verdict."""
        self._stop.set()
        thread = self._producer_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=timeout)
            if thread.is_alive():
                log.warning("block producer did not stop within %.1fs",
                            timeout)
                return False
            self._producer_thread = None
        return True
