"""Speculative mempool prewarming — a copy of
`ethrex_tpu/blockchain/prewarm.py` (the seat of upstream ethrex's
crates/blockchain/prewarm.rs): during the idle gap between blocks, run
pending transactions against a THROWAWAY state layered on the head root
and discard every result.  The side effect is the point — account/storage
trie paths, contract code and persistent-backend pages are pulled into
the node/code table caches, so the real block build hits warm caches.

Differences from upstream, by architecture: upstream prewarms on rayon
workers inside the node process; here the producer loop calls
`prewarm_transactions` in its idle window (`Node.start_dev_producer`),
and the warmed state is the Store's table caches — the StateDB scratch
layer itself is dropped.

Senders are batch-recovered up front (`sender_recovery.recover_senders`)
so speculative runs reuse one recovery per tx instead of re-deriving
inline — and the caches seeded here survive into the real block build.
"""

from __future__ import annotations

import time

from ..evm.db import StateDB
from ..evm.executor import execute_tx
from ..evm.vm import BlockEnv
from . import sender_recovery


class _DeadlineAbort(Exception):
    """Raised by the deadline tracer to bail out of a long tx run."""


class _DeadlineTracer:
    """Frame-boundary deadline guard for speculative runs.

    Checks the clock on every call-frame enter/exit — cheap (no per-step
    hook, so the native dispatch loop stays active) yet bounds how long a
    call-heavy tx can overrun the idle window.  A single hot frame with
    no sub-calls still runs to completion; the producer loop's own
    deadline check between txs is the backstop for those.
    """

    __slots__ = ("deadline",)

    def __init__(self, deadline: float):
        self.deadline = deadline

    def enter(self, msg):
        if time.monotonic() >= self.deadline:
            raise _DeadlineAbort

    def exit(self, ok, gas_left, out):
        if time.monotonic() >= self.deadline:
            raise _DeadlineAbort


def prewarm_transactions(chain, parent_header, txs,
                         deadline: float | None = None,
                         max_txs: int = 256) -> int:
    """Speculatively execute up to `max_txs` transactions against the
    parent state; returns how many ran.  Never mutates canonical state
    (scratch StateDB, discarded) and never raises — a failing tx is
    skipped and warming continues with the next one.  Past `deadline`
    (checked between txs and at call-frame boundaries inside them) the
    pass stops."""
    from ..storage.store import StoreSource

    if not txs:
        return 0
    try:
        source = StoreSource(chain.store, parent_header.state_root)
    except Exception:
        return 0
    txs = txs[:max_txs]
    try:
        # one batched recovery instead of per-run inline derivation; the
        # seeded caches are reused by the real block build afterwards
        sender_recovery.recover_senders(txs)
    except Exception:
        pass  # speculation only; inline recovery remains the backstop
    state = StateDB(source)
    env = BlockEnv(
        number=parent_header.number + 1,
        coinbase=parent_header.coinbase,
        timestamp=parent_header.timestamp + 1,
        gas_limit=parent_header.gas_limit,
        base_fee=parent_header.base_fee_per_gas or 0,
        excess_blob_gas=parent_header.excess_blob_gas or 0,
        prev_randao=parent_header.prev_randao or b"\x00" * 32,
    )
    tracer = _DeadlineTracer(deadline) if deadline is not None else None
    ran = 0
    for tx in txs:
        if deadline is not None and time.monotonic() >= deadline:
            break
        try:
            execute_tx(tx, state, env, chain.config, tracer=tracer)
            ran += 1
        except _DeadlineAbort:
            break
        except Exception:
            # speculation only: any failure (InvalidTransaction or a bug
            # surfaced by a malformed tx) just skips this tx; later txs
            # still warm their lanes
            continue
    return ran
