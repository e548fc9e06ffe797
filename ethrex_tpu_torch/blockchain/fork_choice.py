"""Fork choice application — a copy of `ethrex_tpu/blockchain/fork_choice.py`
(upstream ethrex's crates/blockchain/fork_choice.rs apply_fork_choice),
plus the reorg-safe
transaction lifecycle around it (docs/CHAIN_RESILIENCE.md).

`ReorgHandler.apply` is the one seam every head move goes through: it
computes the (orphaned, adopted) block sets from the branch walk,
rewrites the canonical index AND the tx-location index in one journaled
write group, then settles the mempool — orphaned-but-not-readopted txs
are re-injected through the typed `reinjected` path, newly-adopted txs
are evicted, and the surviving pool is revalidated against the new
canonical state.  The invariant enforced end to end: no transaction is
ever silently lost by a reorg.

The mempool leg runs AFTER the canonical write group commits, so a
crash between the two would lose the re-injection — the write group
therefore also journals the orphan set under `meta["reorg_pending"]`,
and `recover_pending` (run on node start and at the top of every apply)
replays the mempool leg until a later write group clears the record.
Crash-only design: the reorg transition is a journaled, restartable
unit like every other state change.
"""

from __future__ import annotations

import threading

from ..primitives.transaction import TYPE_BLOB
from ..storage.store import Store
from ..utils.faults import inject
from ..utils.metrics import (record_chain_reorg,
                             record_mempool_reorg_eviction)

REORG_JOURNAL_KEY = "reorg_pending"


class ForkChoiceError(Exception):
    pass


class InvalidForkChoiceState(ForkChoiceError):
    """safe/finalized hash is known but NOT an ancestor of the new head
    (the engine API's invalidForkChoiceState condition, error -38002)."""


class ReorgOutcome:
    """What one fork-choice application did.  `depth` counts orphaned
    formerly-canonical blocks — 0 for a plain head extension."""

    __slots__ = ("head", "adopted", "orphaned", "depth", "reinjected",
                 "evicted", "pruned", "recovered")

    def __init__(self, head, adopted, orphaned, recovered=False):
        self.head = head            # new head BlockHeader
        self.adopted = adopted      # new canonical Blocks, oldest first
        self.orphaned = orphaned    # ex-canonical Blocks, oldest first
        self.depth = len(orphaned)
        self.reinjected = 0         # txs put back in the pool
        self.evicted = 0            # pool txs dropped (adopted + prunes)
        self.pruned: dict[str, int] = {}  # revalidation prunes by reason
        self.recovered = recovered  # replayed from the pending journal


def _is_ancestor(store: Store, hdr, head) -> bool:
    """True if hdr is head or an ancestor of head (walked by parent
    hashes — the canonical index may not reflect head's branch yet)."""
    if hdr.number > head.number:
        return False
    cursor = head
    while cursor.number > hdr.number:
        cursor = store.get_header(cursor.parent_hash)
        if cursor is None:
            return False
    return cursor.hash == hdr.hash


class ReorgHandler:
    """The reorg seam: owns fork-choice application for one store and
    (when wired by the node) the mempool settlement that must follow
    every reorg.  The reference's reorg listeners serve its websocket
    layer, which the port does not have.  Store-only callers
    (CLI, benches, the L2 sequencer tip mover) construct one ad hoc via
    `apply_fork_choice` and get the canonical/txloc rewrite without the
    pool leg."""

    def __init__(self, store: Store, mempool=None, lock=None):
        self.store = store
        self.mempool = mempool
        # serialization with the node's producer/import paths; a bare
        # handler gets a private lock
        self.lock = lock if lock is not None else threading.RLock()
        # handler-local tallies so ethrex_health survives metric
        # registry resets (same idiom as Mempool flow accounting)
        self.reorgs = 0
        self.last_depth = 0
        self.deepest = 0
        self.reinjected = 0
        self.evictions: dict[str, int] = {}
        self.recoveries = 0

    # -- the seam ----------------------------------------------------------
    def apply(self, head_hash: bytes, safe_hash: bytes = b"",
              finalized_hash: bytes = b"") -> ReorgOutcome:
        """Make head_hash canonical: walk back to the first ancestor
        already on the canonical chain, rewrite the canonical + txloc
        indices as one journaled unit, then settle the mempool.  Raises
        ForkChoiceError for unknown or non-ancestor safe/finalized
        hashes."""
        store = self.store
        with self.lock:
            head = store.get_header(head_hash)
            if head is None:
                raise ForkChoiceError("unknown head block")
            fin = None
            for name, h in (("safe", safe_hash),
                            ("finalized", finalized_hash)):
                if h:
                    hdr = store.get_header(h)
                    if hdr is None:
                        raise ForkChoiceError(f"unknown {name} block")
                    if not _is_ancestor(store, hdr, head):
                        raise InvalidForkChoiceState(
                            f"{name} block 0x{h.hex()} is not an "
                            f"ancestor of the new head")
                    if name == "finalized":
                        fin = hdr

            # finish any reorg transition a crash interrupted before
            # starting a new one (idempotent; usually a no-op)
            self.recover_pending()

            # collect the branch from head back to a canonical ancestor
            branch = []
            cursor = head
            while store.canonical_hash(cursor.number) != cursor.hash:
                branch.append(cursor)
                parent = store.get_header(cursor.parent_hash)
                if parent is None:
                    raise ForkChoiceError("detached branch")
                cursor = parent
            old_head = store.head_header()
            # orphaned = formerly-canonical blocks above the common
            # ancestor: heights the branch overwrites plus any stale
            # heights above the new head (a head rollback)
            pivot = cursor.number
            orphaned = []
            for number in range(pivot + 1, old_head.number + 1):
                h = store.canonical_hash(number)
                blk = store.get_block(h) if h else None
                if blk is not None and h != head_hash \
                        and all(h != b.hash for b in branch):
                    orphaned.append(blk)
            adopted = [blk for blk in
                       (store.get_block(b.hash) for b in reversed(branch))
                       if blk is not None]
            adopted_tx = {tx.hash for blk in adopted
                          for tx in blk.body.transactions}

            # chaos seat, leg 1: crash BEFORE the canonical rewrite —
            # the old index must be fully intact
            inject("forkchoice.apply")

            # the canonical+txloc rewrite, head/safe/finalized markers
            # and the pending-reorg journal commit as ONE journaled
            # unit: a crash at any byte offset leaves either the old
            # chain or the new chain with its mempool debt recorded
            with store.write_group():
                for number in range(head.number + 1, old_head.number + 1):
                    store.delete_canonical(number)
                for header in branch:
                    store.set_canonical(header.number, header.hash)
                store.set_head(head_hash)
                if safe_hash:
                    store.meta["safe"] = safe_hash
                if finalized_hash:
                    store.meta["finalized"] = finalized_hash
                    # flatten every layer at or below the finalized
                    # height to the durable backend
                    store.finalize_node_layers(fin.number)
                # tx locations follow the canonical index in the same
                # group: adopted inclusions point at their new blocks,
                # orphaned-only inclusions are pruned — RPC can never
                # serve an orphaned inclusion
                for blk in adopted:
                    for i, tx in enumerate(blk.body.transactions):
                        store.set_tx_location(tx.hash, blk.hash, i)
                for blk in orphaned:
                    for tx in blk.body.transactions:
                        if tx.hash not in adopted_tx:
                            store.delete_tx_location(tx.hash)
                if orphaned and self.mempool is not None:
                    store.meta[REORG_JOURNAL_KEY] = b"".join(
                        b.hash for b in orphaned)

            # chaos seat, leg 2: crash AFTER the rewrite committed but
            # before the mempool settles — recovery replays it from the
            # journal (pair with after=1 to target this leg)
            inject("forkchoice.apply")

            outcome = ReorgOutcome(head, adopted, orphaned)
            if orphaned:
                self._settle(outcome)
            elif self.mempool is not None and adopted_tx:
                # plain adoption (engine newPayload -> fcU of externally
                # built blocks): drop pool copies of the adopted txs so
                # a tx is never pending and included at once — not a
                # reorg, so no reorg metrics fire
                for blk in adopted:
                    for tx in blk.body.transactions:
                        if self.mempool.get_transaction(tx.hash) is not None:
                            self.mempool.remove_transaction(
                                tx.hash, reason="included")
                            outcome.evicted += 1
            return outcome

    # -- crash recovery ----------------------------------------------------
    def recover_pending(self) -> ReorgOutcome | None:
        """Replay the mempool leg of a reorg whose canonical rewrite
        committed but whose settlement was interrupted (process crash
        or an injected fault between the two legs).  Idempotent: txs
        already back in the pool or canonically re-included are
        skipped.  Run on node start and at the top of every apply."""
        if self.mempool is None:
            return None
        with self.lock:
            raw = self.store.meta.get(REORG_JOURNAL_KEY)
            if not raw:
                return None
            hashes = [raw[i:i + 32] for i in range(0, len(raw), 32)]
            orphaned = [blk for blk in
                        (self.store.get_block(h) for h in hashes)
                        if blk is not None]
            outcome = ReorgOutcome(self.store.head_header(), [], orphaned,
                                   recovered=True)
            self.recoveries += 1
            self._settle(outcome, count_reorg=False)
            return outcome

    # -- the mempool leg ---------------------------------------------------
    def _settle(self, outcome: ReorgOutcome, count_reorg: bool = True):
        """Re-inject, evict, revalidate, clear the journal.
        Runs with self.lock held (apply) or standalone (recovery)."""
        store = self.store
        if count_reorg:
            record_chain_reorg(outcome.depth)
            self.reorgs += 1
            self.last_depth = outcome.depth
            self.deepest = max(self.deepest, outcome.depth)
        mp = self.mempool
        if mp is not None:
            head = outcome.head
            # 1. re-inject orphaned txs that did not land on the new
            #    canonical branch (canonical_tx_location is the truth:
            #    it also filters re-adoptions below the pivot and makes
            #    the recovery replay idempotent)
            for blk in outcome.orphaned:
                for tx in blk.body.transactions:
                    if store.canonical_tx_location(tx.hash) is not None:
                        continue
                    if tx.tx_type == TYPE_BLOB:
                        # the blob sidecar died with the orphaned
                        # inclusion; without it the tx cannot be
                        # re-broadcast — count the loss truthfully
                        # instead of re-injecting an unprovable tx
                        self._count_eviction("blob_unrecoverable")
                        outcome.evicted += 1
                        continue
                    if mp.reinject(tx):
                        outcome.reinjected += 1
                        self.reinjected += 1
            # 2. evict pool entries the new branch adopted
            for blk in outcome.adopted:
                for tx in blk.body.transactions:
                    if mp.get_transaction(tx.hash) is not None:
                        mp.remove_transaction(tx.hash, reason="included")
                        self._count_eviction("adopted")
                        outcome.evicted += 1
            # 3. revalidate the surviving pool against the new state
            root = head.state_root

            def get_account(address):
                return store.account_state(root, address)

            outcome.pruned = mp.revalidate(get_account)
            for reason, n in outcome.pruned.items():
                for _ in range(n):
                    self._count_eviction(reason)
                outcome.evicted += n
            # the mempool debt is paid: clear the journal (its own
            # group — it must commit strictly after the settlement ran)
            with store.write_group():
                store.meta.pop(REORG_JOURNAL_KEY, None)

    def _count_eviction(self, reason: str):
        self.evictions[reason] = self.evictions.get(reason, 0) + 1
        record_mempool_reorg_eviction(reason)

    # -- observability -----------------------------------------------------
    def stats_json(self) -> dict:
        return {
            "reorgs": self.reorgs,
            "lastDepth": self.last_depth,
            "deepestDepth": self.deepest,
            "reinjected": self.reinjected,
            "evictions": dict(sorted(self.evictions.items())),
            "recoveries": self.recoveries,
            "pendingJournal": bool(
                self.store.meta.get(REORG_JOURNAL_KEY)),
        }


def apply_fork_choice(store: Store, head_hash: bytes,
                      safe_hash: bytes = b"", finalized_hash: bytes = b""):
    """Store-only fork choice (no mempool wired): rewrite the canonical
    + txloc indices and markers.  Returns the new head header.  Node
    paths go through Node.reorg_handler so the pool settles too."""
    return ReorgHandler(store).apply(
        head_hash, safe_hash, finalized_hash).head
