"""Batched, parallel transaction sender recovery — off the execute path.

ethrex recovers a block's senders ahead of execution instead of inline in
the tx loop (`add_block_pipeline` / `add_blocks_in_batch`); this module is
that stage.  `recover_senders(txs)` recovers every uncached sender in one
batched pass and seeds each tx's `_sender` cache (including the
failed-recovery sentinel), so the executor's inline `tx.sender()` becomes
a dict-speed cache hit.

A copy of `ethrex_tpu/blockchain/sender_recovery.py` over the port's
native engine (`crypto/native_secp256k1.py`, built at first use from
`native/secp256k1.c`): the tx list is sliced across a bounded thread
pool and each worker runs one C `recover_batch` call over its slice.
The C call releases the GIL, so the slices recover genuinely in
parallel.  There is no Python path: a failed build raises
(`native.BuildError`), as it does for every host engine of the port;
`crypto.secp256k1.recover` stays the engine's oracle in the tests.

The pool has a fixed size, `min(8, cpu_count)`.  The reference's
`--sender-workers` setting comes with the CLI that passes it.

The batched wall-clock is recorded into the `evm/sig_recovery` profiler
stage: after this stage runs, the executor's inline `tx.sender()` calls
are cache hits, and the batch wall carries the real cost.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..crypto import native_secp256k1, secp256k1
from ..perf.profiler import record_stage
from ..primitives.transaction import SENDER_INVALID, TYPE_PRIVILEGED
from ..utils import metrics

_HALF_N = secp256k1.N // 2

POOL_SIZE = max(1, min(8, os.cpu_count() or 1))

_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=POOL_SIZE, thread_name_prefix="sender-recovery")
        return _pool


def _collect(txs):
    """Uncached signature work items: (tx, msg_hash, r, s, rec_id).

    Invalid-by-inspection txs (high-s, bad v) get their sentinel seeded
    here — no EC math needed for those.
    """
    items = []
    for tx in txs:
        if tx.tx_type == TYPE_PRIVILEGED or tx._sender is not None:
            continue
        if tx.s > _HALF_N:
            tx._sender = SENDER_INVALID
            continue
        rec = tx.recovery_id()
        if rec is None:
            tx._sender = SENDER_INVALID
            continue
        items.append((tx, tx.signing_hash(), tx.r, tx.s, rec))
    return items


def _recover_slice_native(items):
    from ..crypto.keccak import keccak256

    pubs = native_secp256k1.recover_batch(
        [(msg, r, s, rec) for _, msg, r, s, rec in items])
    for (tx, _, _, _, _), pub in zip(items, pubs):
        tx._sender = SENDER_INVALID if pub is None else keccak256(pub)[12:]


def recover_senders(txs, record: bool = True) -> int:
    """Recover and cache the sender of every tx in `txs`.

    Returns the number of signatures actually recovered (cache hits and
    invalid-by-inspection txs are excluded).  Safe to call concurrently
    with readers of `tx.sender()` for *other* txs; callers overlap it
    with the previous block's execute/merkleize, never with execution of
    the same txs.
    """
    items = _collect(txs)
    if not items:
        return 0
    t0 = time.perf_counter()
    # one batched C call per worker slice; slices of < 4 sigs are not
    # worth a dispatch, so small blocks collapse to fewer slices
    per = max(4, (len(items) + POOL_SIZE - 1) // POOL_SIZE)
    slices = [items[i:i + per] for i in range(0, len(items), per)]
    if len(slices) == 1:
        _recover_slice_native(slices[0])
    else:
        list(_get_pool().map(_recover_slice_native, slices))
    wall = time.perf_counter() - t0
    if record:
        record_stage("evm", "sig_recovery", wall)
        metrics.record_senders_recovered(len(items))
        metrics.observe_sender_recovery_batch(wall)
    return len(items)


class PendingRecovery:
    """Handle to an in-flight background recovery (pipeline overlap)."""

    def __init__(self, thread: threading.Thread | None):
        self._thread = thread

    def wait(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


_DONE = PendingRecovery(None)  # empty batch: wait() is a no-op


def recover_senders_async(txs) -> PendingRecovery:
    """Kick off recovery for `txs` on a background thread and return a
    handle; used by the pipelined importer to overlap block N+1's sender
    recovery with block N's execute/merkleize.  Exceptions are swallowed
    — the executor's inline recovery is the correctness backstop."""
    if not txs:
        return _DONE

    def run():
        try:
            recover_senders(txs)
        except Exception:
            pass

    t = threading.Thread(target=run, daemon=True,
                         name="sender-recovery-prefetch")
    t.start()
    return PendingRecovery(t)
