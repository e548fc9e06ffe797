"""Deterministic fault-injection harness for the prover pipeline: a copy
of `ethrex_tpu/utils/faults.py`.  The port wires the prover's sites
(proto.send, proto.recv, backend.prove, backend.phase, device.lost) where
the reference does; the node-side sites below come with the modules that
fire them.

A process-wide `FaultPlan` (seeded) carries rules bound to named
injection points; production code calls `inject(site, payload)` at those
points, which is a no-op until a plan is installed.  Same seed + same
call sequence -> same fault schedule, so every failure mode in
`tests/test_prover_chaos.py` replays deterministically.

Injection points wired into the pipeline (see docs/PROVER_RESILIENCE.md
and docs/L1_SETTLEMENT_RESILIENCE.md):

    proto.send              protocol.send_msg, after framing
    proto.recv              protocol.recv_msg / recv_msg_file, after read
    backend.prove           ProverClient around backend.prove
    backend.phase           the stark prover around EVERY device phase
                            (execute / commit / quotient / open / fri /
                            binding legs).  error+delay fire on entry
                            (a crashing or slow kernel — an exception
                            that classifies as oom/device_lost walks
                            the degradation ladder, see
                            prover/runtime_errors); corrupt mangles
                            the phase's host-visible artifacts (a
                            non-finite / out-of-field value ->
                            nan_poison quarantine); drop fires at the
                            phase BOUNDARY, after the checkpoint
                            store — a preemption between phases, the
                            kill-at-every-boundary drill's kill point
    device.lost             fired on entry to every device phase,
                            dedicated to device/slice-loss simulation:
                            an error rule here (the raised message
                            names the site) classifies as device_lost
                            and the failed phase retries down the
                            degradation ladder
    coordinator.store_proof ProofCoordinator before rollup.store_proof
    l1.commit               sequencer around L1Client.commit_batch; fires
                            on BOTH legs — before the call (request lost)
                            and after it returns (tx mined, receipt lost;
                            pair with after=1 to target this leg)
    l1.verify               sequencer around L1Client.verify_batches,
                            same two-leg convention
    l1.get_deposits         sequencer before L1Client.get_deposits
    store.open              PersistentBackend.__init__ before kv_open
    store.put               every durable KV write (direct put/delete and
                            each op applied from a committed batch journal)
    store.flush             two legs per batch commit: the journal bytes
                            (corrupt/torn mangle them = crash mid-journal)
                            and post-journal pre-apply (error/drop = crash
                            after the journal is durable); also fired by
                            backend.flush (see docs/STORAGE_RESILIENCE.md)
    rpc.handle              RpcServer.handle after admission control,
                            before the method body: delay = a slow
                            handler (overload pressure), error/drop = a
                            crashing handler (docs/OVERLOAD.md)
    mempool.add             Mempool.add_transaction at entry: delay = a
                            slow admission path, error/drop = admission
                            crash mid-submit
    coordinator.schedule    ProofCoordinator.assign at entry: delay = a
                            slow scheduling decision, error/drop =
                            scheduler crash (the connection drops, the
                            prover backs off and retries; no lease is
                            granted)
    aggregate.prove         ProofAggregator around the recursion proof;
                            fires on BOTH legs — before the aggregate
                            build (work lost) and after it returns
                            (proof built, settlement leg lost; pair with
                            after=1 to target this leg)
    submit.duplicate        ProofCoordinator on a PROOF_SUBMIT for a
                            batch that already has a stored proof (the
                            losing leg of a hedged assignment): delay = a
                            slow duplicate ack, error/drop = crash while
                            no-op-acking the loser
    net.send                RlpxPeer.send_msg before framing: drop = the
                            frame never leaves, corrupt = wire bytes
                            mangled (the far side fails MAC/decode and
                            the request times out), delay = a congested
                            uplink (docs/P2P_RESILIENCE.md)
    net.recv                RlpxPeer.recv_msg after decode on the reader
                            thread: drop kills the session exactly like
                            a peer disconnect mid-read; corrupt hands
                            the handler a mangled message
    peer.request            RlpxPeer.request at entry (drop/delay/error
                            legs): a request that dies before any bytes
                            move — exercises the retry/backoff path
                            without touching the shared session
    snap.serve              the snap/1 serving legs (account-range /
                            storage-range / byte-codes / trie-nodes
                            responses) before send: corrupt = a
                            byzantine snap server (tampered proofs),
                            drop = the response is lost
    l1.lease                LeadershipManager around every lease
                            acquire/renew CAS; fires on BOTH legs —
                            before the call (request lost) and after it
                            returns (lease held on L1, response lost:
                            the candidate must survive its own orphaned
                            term expiring; pair with after=1 to target
                            this leg).  docs/SEQUENCER_HA.md
    seq.fence               every sequencer-side fence checkpoint
                            (LeadershipManager.check / Sequencer._fence,
                            at the top of commit_next_batch, send_proofs
                            and update_state): error = deposition
                            surfacing exactly at the checkpoint
    forkchoice.apply        ReorgHandler.apply around the canonical
                            rewrite; fires on BOTH legs — before the
                            write group (crash with the old canonical
                            index fully intact) and after it commits
                            (index rewritten, mempool re-injection not
                            yet run: the journaled reorg_pending record
                            replays it on recovery; pair with after=1
                            to target this leg).  docs/CHAIN_RESILIENCE.md
    mempool.reinject        Mempool.reinject at entry: the reorg
                            re-injection path crashing mid-reorg (the
                            pending-reorg journal makes the retry
                            idempotent — see docs/CHAIN_RESILIENCE.md)

Fault kinds:

    drop     raise InjectedFault (a ConnectionError): dropped connection
    delay    time.sleep(seconds): a slow peer / slow TPU proof
    corrupt  mutate the payload in place of the real one
    torn     truncate a bytes payload mid-record: a torn disk write
    error    raise an arbitrary exception: internal crash
"""

from __future__ import annotations

import contextlib
import random
import threading
import time

SITES = frozenset({
    "proto.send",
    "proto.recv",
    "backend.prove",
    "backend.phase",
    "device.lost",
    "coordinator.store_proof",
    "l1.commit",
    "l1.verify",
    "l1.get_deposits",
    "store.open",
    "store.put",
    "store.flush",
    "rpc.handle",
    "mempool.add",
    "coordinator.schedule",
    "aggregate.prove",
    "submit.duplicate",
    "net.send",
    "net.recv",
    "peer.request",
    "snap.serve",
    "l1.lease",
    "seq.fence",
    "forkchoice.apply",
    "mempool.reinject",
})

KINDS = frozenset({"drop", "delay", "corrupt", "torn", "error"})


class InjectedFault(ConnectionError):
    """Raised by drop rules; a ConnectionError so every handler that
    survives real network failures survives injected ones the same way."""


class FaultRule:
    __slots__ = ("site", "kind", "p", "times", "seconds", "exc", "mutate",
                 "after", "fired", "seen")

    def __init__(self, site: str, kind: str, p: float = 1.0,
                 times: int | None = None, seconds: float = 0.0,
                 exc: BaseException | None = None, mutate=None,
                 after: int = 0):
        if site not in SITES:
            raise ValueError(f"unknown injection site {site!r}")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.site = site
        self.kind = kind
        self.p = p
        self.times = times      # fire budget; None = unlimited
        self.seconds = seconds  # delay kind
        self.exc = exc          # error kind
        self.mutate = mutate    # corrupt kind: payload -> payload
        self.after = after      # skip the first N matching occasions
        self.fired = 0
        self.seen = 0


def _default_corrupt(payload):
    """Deterministic default mutation: flip wire bytes / clobber a proof's
    backend tag — guaranteed to fail frame decoding or submit validation."""
    if isinstance(payload, (bytes, bytearray)):
        buf = bytearray(payload)
        if buf:
            buf[len(buf) // 2] ^= 0xFF
        return bytes(buf)
    if isinstance(payload, dict):
        out = dict(payload)
        if "backend" in out:
            out["backend"] = "__corrupt__"
        out["__corrupt__"] = True
        return out
    return payload


class FaultPlan:
    """A seeded schedule of fault rules.  Chainable builders:

        FaultPlan(seed=7).error("backend.prove", times=1)
        FaultPlan(3).drop("proto.send", times=3).delay("proto.recv", 0.2)
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: list[FaultRule] = []
        self.lock = threading.Lock()
        self.log: list[tuple[str, str]] = []  # (site, kind) fire history

    # -- builders ----------------------------------------------------------
    def add(self, rule: FaultRule) -> "FaultPlan":
        self.rules.append(rule)
        return self

    def drop(self, site: str, p: float = 1.0,
             times: int | None = None, after: int = 0) -> "FaultPlan":
        return self.add(FaultRule(site, "drop", p=p, times=times,
                                  after=after))

    def delay(self, site: str, seconds: float, p: float = 1.0,
              times: int | None = None, after: int = 0) -> "FaultPlan":
        return self.add(FaultRule(site, "delay", p=p, times=times,
                                  seconds=seconds, after=after))

    def corrupt(self, site: str, p: float = 1.0, times: int | None = None,
                mutate=None, after: int = 0) -> "FaultPlan":
        return self.add(FaultRule(site, "corrupt", p=p, times=times,
                                  mutate=mutate, after=after))

    def torn(self, site: str, p: float = 1.0, times: int | None = None,
             after: int = 0) -> "FaultPlan":
        return self.add(FaultRule(site, "torn", p=p, times=times,
                                  after=after))

    def error(self, site: str, exc: BaseException | None = None,
              p: float = 1.0, times: int | None = None,
              after: int = 0) -> "FaultPlan":
        return self.add(FaultRule(site, "error", p=p, times=times, exc=exc,
                                  after=after))

    # -- firing ------------------------------------------------------------
    def fire(self, site: str, payload=None, kinds=None):
        matched: list[FaultRule] = []
        with self.lock:
            for rule in self.rules:
                if rule.site != site:
                    continue
                if kinds is not None and rule.kind not in kinds:
                    continue
                if rule.kind in ("corrupt", "torn") and payload is None:
                    continue  # nothing to mangle at this call point
                if rule.times is not None and rule.fired >= rule.times:
                    continue  # budget exhausted
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue  # occasion deliberately skipped (after=N)
                if rule.p < 1.0 and self.rng.random() >= rule.p:
                    continue
                rule.fired += 1
                self.log.append((site, rule.kind))
                matched.append(rule)
        # act outside the lock: a delay rule must not serialize the
        # coordinator's handler threads behind a sleeping prover
        for rule in matched:
            if rule.kind == "delay":
                time.sleep(rule.seconds)
            elif rule.kind == "corrupt":
                payload = (rule.mutate or _default_corrupt)(payload)
            elif rule.kind == "torn":
                if isinstance(payload, (bytes, bytearray)):
                    payload = bytes(payload)[:max(1, len(payload) // 2)]
            elif rule.kind == "error":
                raise rule.exc if rule.exc is not None else InjectedFault(
                    f"injected error at {site}")
            else:  # drop
                raise InjectedFault(f"injected connection drop at {site}")
        return payload


# -- process-wide plumbing (no-op default) ---------------------------------
_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> FaultPlan | None:
    return _ACTIVE


def inject(site: str, payload=None, kinds=None):
    """The production hook: returns the (possibly mutated) payload; may
    sleep or raise per the active plan.  Free when no plan is installed."""
    plan = _ACTIVE
    if plan is None:
        return payload
    return plan.fire(site, payload, kinds=kinds)


@contextlib.contextmanager
def injected(plan: FaultPlan):
    install(plan)
    try:
        yield plan
    finally:
        clear()
