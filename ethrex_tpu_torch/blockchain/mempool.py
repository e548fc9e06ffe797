"""Transaction pool: a copy of `ethrex_tpu/blockchain/mempool.py`
(upstream ethrex's crates/blockchain/mempool.rs: per-account queues, tip
ordering, replacement, blob support), with its admission caps, fee floor
and replacement rules unchanged."""

from __future__ import annotations

import threading
import time

from ..perf.chain_path import CHAIN_PATH as _CHAIN_PATH
from ..primitives.transaction import TYPE_BLOB, Transaction
from ..utils.faults import inject
from ..utils.metrics import (record_mempool_admission,
                             record_mempool_eviction,
                             record_mempool_occupancy,
                             record_mempool_reinjection,
                             record_mempool_rejection,
                             record_mempool_replacement,
                             observe_time_in_pool)

MIN_REPLACEMENT_BUMP = 10  # percent

# admission-control defaults (docs/OVERLOAD.md "Mempool admission"):
# per-sender slot cap and nonce-gap limit bound what one adversarial
# key can pin in the pool; the dynamic fee floor starts rising at
# FEE_FLOOR_START utilization and reaches FEE_FLOOR_MAX_MULTIPLE x
# base_fee at 100%, so `pool_full` becomes a priced signal instead of
# an eviction scramble
MAX_SENDER_SLOTS = 64
MAX_NONCE_GAP = 64
FEE_FLOOR_START = 0.85
FEE_FLOOR_MAX_MULTIPLE = 10.0


class MempoolError(Exception):
    """Admission failure.  Subclasses carry a machine-readable ``reason``
    label so rejection counters are labelled truthfully; the message
    strings are part of the RPC error surface and stay unchanged."""

    reason = "other"


class PrivilegedTxError(MempoolError):
    reason = "privileged"


class InvalidSignatureError(MempoolError):
    reason = "invalid_signature"


class NonceTooLowError(MempoolError):
    reason = "nonce_too_low"


class InsufficientFundsError(MempoolError):
    reason = "insufficient_funds"


class BlobsMissingError(MempoolError):
    reason = "blobs_missing"


class UnderpricedError(MempoolError):
    reason = "underpriced"


class ReplacementUnderpricedError(UnderpricedError):
    """Typed replacement-by-fee rejection: same sender+nonce without the
    >=10% effective-fee bump.  Subclasses UnderpricedError and keeps its
    reason label and message, so the legacy rejection ledger and RPC
    error surface stay byte-identical while callers can catch the
    replacement case specifically."""


class NonceGapError(MempoolError):
    reason = "nonce_gap"


class SenderLimitError(MempoolError):
    reason = "sender_limit"


class FeeBelowFloorError(MempoolError):
    reason = "fee_below_floor"


MAX_BLOB_MEMPOOL_SIZE = 512   # upstream: mempool.rs:49


class Mempool:
    def __init__(self, capacity: int = 10_000,
                 blob_capacity: int = MAX_BLOB_MEMPOOL_SIZE,
                 max_sender_slots: int = MAX_SENDER_SLOTS,
                 max_nonce_gap: int = MAX_NONCE_GAP,
                 fee_floor_start: float = FEE_FLOOR_START,
                 fee_floor_max_multiple: float = FEE_FLOOR_MAX_MULTIPLE):
        self.capacity = capacity
        self.blob_capacity = blob_capacity
        self.max_sender_slots = max_sender_slots
        self.max_nonce_gap = max_nonce_gap
        self.fee_floor_start = fee_floor_start
        self.fee_floor_max_multiple = fee_floor_max_multiple
        self.by_hash: dict[bytes, Transaction] = {}
        self.by_sender: dict[bytes, dict[int, Transaction]] = {}
        self.blobs_bundles: dict[bytes, object] = {}  # tx_hash -> bundle
        # arrival order of REGULAR (non-blob) txs: the FIFO eviction
        # queue (upstream: mempool.rs txs_order +
        # remove_oldest_regular_transaction:462-475); stale entries for
        # already-removed txs are skipped at pop time
        self.txs_order: list[bytes] = []
        self.lock = threading.RLock()
        # arrival hooks (e.g. pending-tx RPC filters); invoked OUTSIDE
        # self.lock so subscribers may take their own locks freely
        self.on_add: list = []
        # flow accounting (pool-local so ethrex_health survives metric
        # registry resets): admission timestamps for the time-in-pool
        # histogram, plus admission/rejection/eviction tallies
        self.added_at: dict[bytes, float] = {}
        self.admitted = 0
        self.replacements = 0
        self.reinjections = 0
        self.rejections: dict[str, int] = {}
        self.evictions: dict[str, int] = {}

    def _reject(self, err: MempoolError) -> MempoolError:
        with self.lock:
            self.rejections[err.reason] = \
                self.rejections.get(err.reason, 0) + 1
        record_mempool_rejection(err.reason)
        return err

    def _utilization(self) -> float:
        blob = len(self.blobs_bundles)
        regular = len(self.by_hash) - blob
        return max(regular / self.capacity if self.capacity else 0.0,
                   blob / self.blob_capacity if self.blob_capacity else 0.0)

    def _publish_occupancy_locked(self) -> None:
        record_mempool_occupancy(len(self.by_hash), self._utilization())

    def utilization(self) -> float:
        """Current fill fraction (max of the regular and blob
        sub-pools); the RPC shed-level mempool feedback reads this."""
        with self.lock:
            return self._utilization()

    def _fee_floor_locked(self, base_fee: int) -> int:
        regular = len(self.by_hash) - len(self.blobs_bundles)
        util = regular / self.capacity if self.capacity else 0.0
        if util < self.fee_floor_start:
            return 0
        span = (util - self.fee_floor_start) / \
            max(1e-9, 1.0 - self.fee_floor_start)
        mult = 1.0 + (self.fee_floor_max_multiple - 1.0) * min(1.0, span)
        return int(max(base_fee, 1) * mult)

    def fee_floor(self, base_fee: int) -> int:
        """Dynamic admission fee floor for NEW regular slots: 0 while
        the regular pool sits below ``fee_floor_start`` utilization,
        then a linear ramp to ``fee_floor_max_multiple`` x base_fee at
        100% — a full pool prices admission instead of churning its
        FIFO eviction queue.  Replacements are exempt (they do not grow
        the pool); so are blob txs (the blob sub-pool has its own
        least-includable eviction rules)."""
        with self.lock:
            return self._fee_floor_locked(base_fee)

    def add_transaction(self, tx: Transaction, sender_nonce: int,
                        sender_balance: int, base_fee: int,
                        blobs_bundle=None) -> bytes:
        from ..primitives.transaction import TYPE_PRIVILEGED

        # chaos seat: a slow or crashing admission path (fired OUTSIDE
        # self.lock so an injected delay cannot serialize the pool)
        inject("mempool.add")
        if tx.tx_type == TYPE_PRIVILEGED:
            raise self._reject(
                PrivilegedTxError("privileged txs bypass the mempool"))
        sender = tx.sender()
        if sender is None:
            raise self._reject(InvalidSignatureError("invalid signature"))
        if tx.nonce < sender_nonce:
            raise self._reject(NonceTooLowError("nonce too low"))
        if tx.gas_limit * tx.max_fee() + tx.value > sender_balance:
            raise self._reject(InsufficientFundsError("insufficient funds"))
        if tx.tx_type == TYPE_BLOB and blobs_bundle is None:
            raise self._reject(
                BlobsMissingError("blob tx requires blobs bundle"))
        with self.lock:
            existing_queue = self.by_sender.get(sender)
            existing = existing_queue.get(tx.nonce) if existing_queue \
                else None
            if existing is not None:
                # replacement-by-fee: exempt from the sender cap, the
                # gap limit and the fee floor — it does not grow the
                # pool — but must clear the >=10% effective-fee bump
                bump = existing.max_fee() * (100 + MIN_REPLACEMENT_BUMP) // 100
                if tx.max_fee() < bump:
                    raise self._reject(
                        ReplacementUnderpricedError(
                            "replacement underpriced"))
                dwell = self._dwell_locked(existing.hash)
                self.by_hash.pop(existing.hash, None)
                self.blobs_bundles.pop(existing.hash, None)
                self.added_at.pop(existing.hash, None)
                self.evictions["replaced"] = \
                    self.evictions.get("replaced", 0) + 1
                record_mempool_eviction("replaced")
                if dwell is not None:
                    observe_time_in_pool(dwell, "replaced")
                _CHAIN_PATH.tx_removed(existing.hash, "replaced", dwell)
                self.replacements += 1
                record_mempool_replacement()
            else:
                # NEW-slot admission rules (docs/OVERLOAD.md): bound
                # what one key can pin, refuse unreachable nonces, and
                # price admission when the regular pool runs hot
                if tx.nonce - sender_nonce > self.max_nonce_gap:
                    raise self._reject(NonceGapError(
                        f"nonce gap {tx.nonce - sender_nonce} exceeds "
                        f"limit {self.max_nonce_gap}"))
                if existing_queue is not None and \
                        len(existing_queue) >= self.max_sender_slots:
                    raise self._reject(SenderLimitError(
                        f"sender already holds {len(existing_queue)} "
                        f"txs (cap {self.max_sender_slots})"))
                if blobs_bundle is None:
                    floor = self._fee_floor_locked(base_fee)
                    if floor and tx.max_fee() < floor:
                        raise self._reject(FeeBelowFloorError(
                            f"max fee {tx.max_fee()} below dynamic "
                            f"floor {floor}"))
            queue = self.by_sender.setdefault(sender, {})
            queue[tx.nonce] = tx
            self.by_hash[tx.hash] = tx
            self.added_at[tx.hash] = time.monotonic()
            if blobs_bundle is not None:
                self.blobs_bundles[tx.hash] = blobs_bundle
                self._evict_worst_blob()
            else:
                self.txs_order.append(tx.hash)
                self._evict_oldest_regular()
                # amortized compaction: stale entries (mined/replaced
                # txs) are skipped at pop time, but the list must stay
                # bounded on a long-running node (upstream's
                # mempool_prune_threshold seat)
                if len(self.txs_order) > 2 * self.capacity + 1024:
                    self.txs_order = [
                        h for h in self.txs_order
                        if h in self.by_hash
                        and h not in self.blobs_bundles]
            # a full blob sub-pool may pick the INCOMING tx as its own
            # least-includable eviction victim: admission succeeded
            # (pinned behavior — the hash is returned) but the pool is
            # effectively full for it, so count it truthfully
            admitted_ok = False
            if tx.hash not in self.by_hash:
                self.rejections["pool_full"] = \
                    self.rejections.get("pool_full", 0) + 1
                record_mempool_rejection("pool_full")
            else:
                self.admitted += 1
                record_mempool_admission()
                admitted_ok = True
            self._publish_occupancy_locked()
        # chain-path admission arrival (and a sampled lifecycle record)
        # fires outside the lock, like the on_add hooks
        if admitted_ok:
            _CHAIN_PATH.tx_admitted(tx.hash)
        for hook in list(self.on_add):
            hook(tx.hash)
        return tx.hash

    def reinject(self, tx: Transaction, blobs_bundle=None) -> bool:
        """Typed reorg re-injection path (docs/CHAIN_RESILIENCE.md): the
        tx was already admitted once and included on a now-orphaned
        block, so the fee floor, sender cap and nonce-gap rules do NOT
        apply — dropping it at admission would silently lose an
        accepted transaction, breaking the reorg conservation
        invariant.  Capacity still binds (FIFO eviction keeps the pool
        bounded) and the ReorgHandler's revalidation pass prunes
        entries the new canonical state invalidated.  Returns True if
        the tx entered the pool; False for duplicates, an occupied
        sender+nonce slot (the pool's entry postdates the orphan and
        wins), or a blob tx without its bundle."""
        # chaos seat: the re-injection path crashing mid-reorg (fired
        # OUTSIDE self.lock, like mempool.add)
        inject("mempool.reinject")
        sender = tx.sender()
        if sender is None:
            return False
        if tx.tx_type == TYPE_BLOB and blobs_bundle is None:
            return False
        with self.lock:
            if tx.hash in self.by_hash:
                return False
            existing_queue = self.by_sender.get(sender)
            if existing_queue is not None and \
                    existing_queue.get(tx.nonce) is not None:
                return False
            queue = self.by_sender.setdefault(sender, {})
            queue[tx.nonce] = tx
            self.by_hash[tx.hash] = tx
            self.added_at[tx.hash] = time.monotonic()
            if blobs_bundle is not None:
                self.blobs_bundles[tx.hash] = blobs_bundle
                self._evict_worst_blob()
            else:
                self.txs_order.append(tx.hash)
                self._evict_oldest_regular()
            self.reinjections += 1
            record_mempool_reinjection()
            self._publish_occupancy_locked()
        _CHAIN_PATH.tx_admitted(tx.hash)
        # re-injected txs are pending again: the newPendingTransactions
        # subscription and pending filters must see them
        for hook in list(self.on_add):
            hook(tx.hash)
        return True

    def revalidate(self, get_account) -> dict[str, int]:
        """Prune entries the new canonical state invalidated (the reorg
        aftermath): a nonce below the account's (another tx with that
        nonce landed on the winning branch) or a cost the balance no
        longer covers.  Returns {reason: count}; each prune is counted
        in the pool's eviction ledger under its typed reason."""
        with self.lock:
            snapshot = list(self.by_hash.values())
        pruned: dict[str, int] = {}
        accounts: dict[bytes, tuple[int, int]] = {}
        for tx in snapshot:
            sender = tx.sender()
            if sender is None:
                continue
            if sender not in accounts:
                acct = get_account(sender)
                accounts[sender] = (acct.nonce if acct else 0,
                                    acct.balance if acct else 0)
            nonce, balance = accounts[sender]
            reason = None
            if tx.nonce < nonce:
                reason = "nonce_below_account"
            elif tx.gas_limit * tx.max_fee() + tx.value > balance:
                reason = "insufficient_balance"
            if reason is not None:
                self.remove_transaction(tx.hash, reason=reason)
                pruned[reason] = pruned.get(reason, 0) + 1
        return pruned

    def _regular_tx_count(self) -> int:
        return len(self.by_hash) - len(self.blobs_bundles)

    def _evict_oldest_regular(self) -> None:
        """FIFO-evict regular txs past the cap; blob txs never feel
        regular-pool pressure (upstream: mempool.rs:462-475)."""
        while self._regular_tx_count() > self.capacity and self.txs_order:
            oldest = self.txs_order.pop(0)
            if oldest in self.by_hash and oldest not in self.blobs_bundles:
                dwell = self._dwell_locked(oldest)
                self._remove_locked(oldest)
                self.evictions["fifo"] = self.evictions.get("fifo", 0) + 1
                record_mempool_eviction("fifo")
                if dwell is not None:
                    observe_time_in_pool(dwell, "fifo")
                _CHAIN_PATH.tx_removed(oldest, "fifo", dwell)

    def _evict_worst_blob(self) -> None:
        """Evict the LEAST INCLUDABLE blob tx past the blob sub-pool cap:
        deepest per-sender nonce offset first (it cannot be included
        until earlier same-sender blobs clear), ties broken by lowest
        blob fee (upstream: mempool.rs:477-530)."""
        while len(self.blobs_bundles) > self.blob_capacity:
            min_nonce: dict[bytes, int] = {}
            for h in self.blobs_bundles:
                tx = self.by_hash.get(h)
                if tx is None:
                    continue
                s = tx.sender()
                if s not in min_nonce or tx.nonce < min_nonce[s]:
                    min_nonce[s] = tx.nonce
            worst = None
            worst_key = None
            for h in self.blobs_bundles:
                tx = self.by_hash.get(h)
                if tx is None:
                    continue
                offset = tx.nonce - min_nonce[tx.sender()]
                key = (offset, -(tx.max_fee_per_blob_gas or 0))
                if worst_key is None or key > worst_key:
                    worst_key = key
                    worst = h
            if worst is None:
                break
            dwell = self._dwell_locked(worst)
            self._remove_locked(worst)
            self.evictions["blob_pool_full"] = \
                self.evictions.get("blob_pool_full", 0) + 1
            record_mempool_eviction("blob_pool_full")
            if dwell is not None:
                observe_time_in_pool(dwell, "blob_pool_full")
            _CHAIN_PATH.tx_removed(worst, "blob_pool_full", dwell)

    def _dwell_locked(self, tx_hash: bytes) -> float | None:
        """Seconds since admission — read BEFORE ``_remove_locked``
        pops ``added_at``; feeds the reason-labelled time-in-pool
        histogram and the chain-path admission dwell."""
        t0 = self.added_at.get(tx_hash)
        return time.monotonic() - t0 if t0 is not None else None

    def _remove_locked(self, tx_hash: bytes):
        tx = self.by_hash.pop(tx_hash, None)
        if tx is None:
            return
        self.blobs_bundles.pop(tx_hash, None)
        self.added_at.pop(tx_hash, None)
        sender = tx.sender()
        queue = self.by_sender.get(sender)
        if queue and queue.get(tx.nonce) is tx:
            del queue[tx.nonce]
            if not queue:
                del self.by_sender[sender]

    def remove_transaction(self, tx_hash: bytes, reason: str | None = None):
        """Drop a tx.  Every reasoned removal of a present tx feeds the
        reason-labelled time-in-pool histogram (``included`` is the
        admission→inclusion dwell; evictions/prunes/reorg reasons keep
        their own series so they cannot pollute it) and departs the
        chain-path admission queue.  ``reason=None`` is a silent
        administrative removal (no histogram, counted as an untyped
        drop in the stage queue)."""
        with self.lock:
            present = tx_hash in self.by_hash
            dwell = self._dwell_locked(tx_hash) if present else None
            self._remove_locked(tx_hash)
            if present and reason is not None and reason != "included":
                self.evictions[reason] = self.evictions.get(reason, 0) + 1
                record_mempool_eviction(reason)
            if present:
                self._publish_occupancy_locked()
        if present:
            if reason is not None and dwell is not None:
                observe_time_in_pool(dwell, reason)
            _CHAIN_PATH.tx_removed(tx_hash, reason or "admin", dwell)

    def stats_json(self, top_k: int = 5) -> dict:
        """Flow-accounting summary for ethrex_health: occupancy,
        admission/rejection/eviction tallies by reason, and the top-k
        deepest per-sender queues (spam/hot-sender visibility)."""
        with self.lock:
            blob = len(self.blobs_bundles)
            depths = sorted(((len(q), s) for s, q in self.by_sender.items()),
                            reverse=True)[:max(0, top_k)]
            return {
                "size": len(self.by_hash),
                "regular": len(self.by_hash) - blob,
                "blob": blob,
                "capacity": self.capacity,
                "blobCapacity": self.blob_capacity,
                "utilization": round(self._utilization(), 6),
                "admitted": self.admitted,
                "replacements": self.replacements,
                "reinjections": self.reinjections,
                "senderSlotCap": self.max_sender_slots,
                "nonceGapLimit": self.max_nonce_gap,
                "rejections": dict(sorted(self.rejections.items())),
                "evictions": dict(sorted(self.evictions.items())),
                "topSenders": [{"sender": "0x" + s.hex(), "txs": n}
                               for n, s in depths],
            }

    def get_transaction(self, tx_hash: bytes) -> Transaction | None:
        return self.by_hash.get(tx_hash)

    def pending(self, base_fee: int, get_nonce) -> list[Transaction]:
        """Executable txs in inclusion order: highest effective tip first,
        but never breaking per-sender nonce order — a heap over each
        sender's *next* executable tx (upstream's fill_transactions
        ordering, crates/blockchain/payload.rs)."""
        import heapq

        with self.lock:
            chains: dict[bytes, list[Transaction]] = {}
            for sender, queue in self.by_sender.items():
                nonce = get_nonce(sender)
                run = []
                while nonce in queue:
                    tx = queue[nonce]
                    if tx.effective_gas_price(base_fee) is None:
                        break
                    run.append(tx)
                    nonce += 1
                if run:
                    chains[sender] = run
            heap = []
            for seq, (sender, run) in enumerate(chains.items()):
                tip = run[0].effective_gas_price(base_fee) - base_fee
                heapq.heappush(heap, (-tip, seq, sender, 0))
            out = []
            while heap:
                _, seq, sender, idx = heapq.heappop(heap)
                run = chains[sender]
                out.append(run[idx])
                if idx + 1 < len(run):
                    tip = run[idx + 1].effective_gas_price(base_fee) - base_fee
                    heapq.heappush(heap, (-tip, seq, sender, idx + 1))
            return out

    def content(self) -> dict:
        with self.lock:
            return {
                sender: dict(queue)
                for sender, queue in self.by_sender.items()
            }

    def split(self, get_nonce) -> tuple[dict, dict]:
        """The pending-vs-queued partition (upstream's mempool / geth txpool
        semantics): per sender, txs forming a contiguous nonce run from the
        account's current nonce are PENDING (executable); gapped/future
        nonces are QUEUED until the gap fills."""
        with self.lock:
            pending: dict[bytes, dict[int, Transaction]] = {}
            queued: dict[bytes, dict[int, Transaction]] = {}
            for sender, queue in self.by_sender.items():
                nonce = get_nonce(sender)
                run = {}
                while nonce in queue:
                    run[nonce] = queue[nonce]
                    nonce += 1
                rest = {n: tx for n, tx in queue.items() if n not in run}
                if run:
                    pending[sender] = run
                if rest:
                    queued[sender] = rest
            return pending, queued

    def status(self, get_nonce) -> dict:
        pending, queued = self.split(get_nonce)
        return {
            "pending": sum(len(q) for q in pending.values()),
            "queued": sum(len(q) for q in queued.values()),
        }

    def __len__(self):
        return len(self.by_hash)
