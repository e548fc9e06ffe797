"""Prover pull-client: poll coordinator endpoints, prove, submit — the port
of `ethrex_tpu/prover/client.py` (parity with upstream ethrex's Prover
actor, crates/prover/src/prover.rs:66-242 — request -> prove -> submit,
version-gated, self-rescheduling), hardened for real fleets:

  * per-endpoint exponential backoff with jitter — a flapping coordinator
    is retried gently instead of hammered every poll;
  * a circuit breaker per endpoint — after `breaker_threshold`
    consecutive failures the endpoint is skipped entirely until a
    half-open probe after `breaker_cooldown` seconds succeeds;
  * a background heartbeat thread while `backend.prove` runs — a long
    proof extends its coordinator lease instead of being reassigned;
  * submit over a fresh connection — the socket that carried the input
    request can die during a multi-minute proof without losing the
    finished proof;
  * background pre-warm before the first InputRequest — the backend
    builds its kernel library and the wrap's keys (`GpuBackend.prewarm`)
    while the client starts polling, and every InputRequest carries an
    advisory `warm` flag so the coordinator's fleet scheduler can route
    the first post-restart batches to already-warm provers;
  * a lost device ends the client — a `device_lost` failure (an illegal
    address, a device-side assert: prover/runtime_errors) poisons the
    process's CUDA context, so the client stops polling and re-raises;
    the process is restarted by its supervisor and resumes the batch
    from its phase checkpoints.

The heartbeat and pre-warm threads touch no CUDA tensor; prove and submit
run on the polling thread.  The counterpart is the reference's
`ProofCoordinator`, unmodified.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import secrets
import socket
import threading
import time

from ..guest.execution import ProgramInput
from ..utils import faults, tracing
from . import checkpoint as ckpt_mod
from . import protocol
from . import runtime_errors as rt_mod
from .backend import ProverBackend, get_backend

log = logging.getLogger("ethrex_tpu_torch.prover.client")


@dataclasses.dataclass
class EndpointState:
    """Per-endpoint breaker/backoff state (exposed for health checks)."""

    failures: int = 0           # consecutive
    next_attempt: float = 0.0   # monotonic backoff gate
    breaker: str = "closed"     # closed | open | half-open
    open_until: float = 0.0
    transitions: int = 0


class _HeartbeatThread(threading.Thread):
    """Best-effort lease keep-alive over short-lived connections while the
    backend proves; failures are ignored — lease expiry is the backstop."""

    def __init__(self, host: str, port: int, batch_id: int,
                 prover_type: str, interval: float,
                 lease_token: str | None = None,
                 trace_id: str | None = None,
                 prover_id: str | None = None,
                 ctx: "ckpt_mod.BatchContext | None" = None):
        super().__init__(daemon=True)
        self.host, self.port = host, port
        self.batch_id = batch_id
        self.prover_type = prover_type
        self.interval = interval
        self.lease_token = lease_token
        self.prover_id = prover_id
        # the batch context stamps each beat with the in-flight phase
        # (the coordinator re-anchors its hedging deadline on every
        # phase transition)
        self.ctx = ctx
        # when set, each beat piggybacks the spans completed so far for
        # this trace (stage spans finish while the proof runs), so a
        # prover that crashes mid-prove still leaves its partial subtree
        # at the coordinator; the payload is cumulative and the
        # coordinator deduplicates by span ID
        self.trace_id = trace_id
        self.acked = 0
        self._stop = threading.Event()

    def run(self):
        while not self._stop.wait(self.interval):
            try:
                msg = {
                    "type": protocol.HEARTBEAT,
                    "batch_id": self.batch_id,
                    "prover_type": self.prover_type,
                    "lease_token": self.lease_token,
                    "prover_id": self.prover_id,
                }
                if self.ctx is not None:
                    msg.update(self.ctx.snapshot())
                if self.trace_id:
                    spans = tracing.export_wire(self.trace_id)
                    if spans is not None:
                        msg["spans"] = spans
                with socket.create_connection(
                        (self.host, self.port), timeout=5) as sock:
                    protocol.send_msg(sock, msg)
                    ack = protocol.recv_msg(sock)
                if ack.get("type") == protocol.HEARTBEAT_ACK \
                        and ack.get("ok"):
                    self.acked += 1
            except (ConnectionError, OSError, ValueError):
                pass

    def stop(self):
        self._stop.set()


class ProverClient:
    def __init__(self, backend: ProverBackend | str,
                 endpoints: list[tuple[str, int]],
                 commit_hash: str = protocol.PROTOCOL_VERSION,
                 poll_interval: float = 1.0,
                 heartbeat_interval: float = 30.0,
                 backoff_base: float = 0.5,
                 backoff_max: float = 30.0,
                 breaker_threshold: int = 5,
                 breaker_cooldown: float = 10.0,
                 rng_seed: int | None = None,
                 prover_id: str | None = None,
                 prewarm: bool = True):
        self.backend = (get_backend(backend) if isinstance(backend, str)
                        else backend)
        # advisory fleet identity: lets the coordinator's scheduler
        # attribute throughput to this prover across polls (the lease
        # token, not this, remains the authority over lease state)
        self.prover_id = prover_id if prover_id is not None else \
            f"{self.backend.prover_type}-{secrets.token_hex(4)}"
        self.endpoints = endpoints
        self.commit_hash = commit_hash
        self.poll_interval = poll_interval
        self.heartbeat_interval = heartbeat_interval
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self._rng = random.Random(rng_seed)
        self._stop = threading.Event()
        self.proved: list[int] = []   # batch ids proven (observability)
        self.submit_rejections = 0    # application-level rejects (not
        #                               transport; never trips the breaker)
        self.poisoned: list[int] = []  # batches aborted as nan_poison
        # the device_lost failure that ended this client (its CUDA
        # context is unusable; the process must restart), or None
        self.fatal: Exception | None = None
        self.endpoint_states: dict[tuple[str, int], EndpointState] = {
            ep: EndpointState() for ep in endpoints}
        # pre-warm: build the backend's kernels and keys in the
        # background, so the first assignment can run at steady-state
        # wall; `warm` rides every InputRequest (advisory, like
        # prover_id) so the fleet scheduler can prefer warm provers for
        # the first batches after a restart
        self.hydrated_groups = 0
        self._prewarm_done = threading.Event()
        if prewarm:
            threading.Thread(target=self._prewarm_worker,
                             daemon=True).start()
        else:
            self._prewarm_done.set()

    def _prewarm_worker(self):
        try:
            hook = getattr(self.backend, "prewarm", None)
            if callable(hook):
                self.hydrated_groups = int(hook() or 0)
        except Exception:  # noqa: BLE001 — a failed prewarm is just cold
            log.exception("prover prewarm failed; starting cold")
        finally:
            self._prewarm_done.set()
            if self.hydrated_groups:
                log.info("prover %s prewarmed: %d artifact(s) built",
                         self.prover_id, self.hydrated_groups)

    @property
    def warm(self) -> bool:
        """Whether this prover's next proof should run at steady-state
        wall: the prewarm pass finished AND it either built its kernels
        or has already proven in this process."""
        return self._prewarm_done.is_set() and (
            self.hydrated_groups > 0 or bool(self.proved))

    # ------------------------------------------------------------------
    # breaker / backoff
    # ------------------------------------------------------------------
    def _should_attempt(self, st: EndpointState, now: float) -> bool:
        if st.breaker == "open":
            if now < st.open_until:
                return False
            st.breaker = "half-open"   # one probe allowed
            st.transitions += 1
            return True
        return now >= st.next_attempt

    def _record_success(self, ep, st: EndpointState):
        if st.breaker != "closed":
            st.breaker = "closed"
            st.transitions += 1
            log.info("endpoint %s:%d recovered, breaker closed", *ep)
            self._publish_breaker(transition=True)
        st.failures = 0
        st.next_attempt = 0.0

    def _record_failure(self, ep, st: EndpointState, now: float,
                        err: Exception):
        from ..utils.metrics import record_poll_error

        record_poll_error()
        st.failures += 1
        log.warning("endpoint %s:%d poll failed (%d consecutive): %s",
                    ep[0], ep[1], st.failures,
                    f"{type(err).__name__}: {err}")
        if st.breaker == "half-open" or \
                st.failures >= self.breaker_threshold:
            st.breaker = "open"
            st.open_until = now + self.breaker_cooldown
            st.transitions += 1
            log.warning("endpoint %s:%d breaker open for %.1fs",
                        ep[0], ep[1], self.breaker_cooldown)
            self._publish_breaker(transition=True)
        else:
            # exponential backoff with jitter in [0.5x, 1x)
            delay = min(self.backoff_base * (2 ** (st.failures - 1)),
                        self.backoff_max)
            st.next_attempt = now + delay * (0.5 + self._rng.random() / 2)

    def _publish_breaker(self, transition: bool = False):
        from ..utils.metrics import record_breaker

        record_breaker(sum(1 for s in self.endpoint_states.values()
                           if s.breaker == "open"), transition=transition)

    # ------------------------------------------------------------------
    def poll_once(self) -> int:
        """One pass over all endpoints; returns number of batches proven.
        Endpoint failures are absorbed into breaker/backoff state — the
        prover never dies because a coordinator does.  A lost device is
        not an endpoint failure: it stops the client and is raised."""
        proven = 0
        for ep in self.endpoints:
            st = self.endpoint_states.setdefault(ep, EndpointState())
            now = time.monotonic()
            if not self._should_attempt(st, now):
                continue
            try:
                proven += self._poll_endpoint(*ep)
            except Exception as e:  # noqa: BLE001 — keep polling others
                if rt_mod.classify(e) == "device_lost":
                    # every later CUDA call of this process fails too: no
                    # retry here can help; the restarted process resumes
                    # the batch from its phase checkpoints
                    self.fatal = e
                    self._stop.set()
                    log.error("device lost while proving (%s); the prover "
                              "stops, restart its process", e)
                    raise
                self._record_failure(ep, st, time.monotonic(), e)
            else:
                self._record_success(ep, st)
        return proven

    def _poll_endpoint(self, host: str, port: int) -> int:
        # connection 1: request work (closed before the proof starts)
        with socket.create_connection((host, port), timeout=30) as sock:
            protocol.send_msg(sock, {
                "type": protocol.INPUT_REQUEST,
                "commit_hash": self.commit_hash,
                "prover_type": self.backend.prover_type,
                "prover_id": self.prover_id,
                "warm": self.warm,
            })
            resp = protocol.recv_msg(sock)
        rtype = resp.get("type")
        if rtype == protocol.VERSION_MISMATCH:
            raise ValueError(
                f"prover version mismatch: need {resp.get('expected')}")
        if rtype != protocol.INPUT_RESPONSE:
            return 0
        batch_id = resp["batch_id"]
        lease_token = resp.get("lease_token")
        # continue the trace the coordinator opened at assignment, so the
        # whole batch lifecycle shares one trace ID across the TCP seam
        trace_id = resp.get("trace_id")
        parent_span = resp.get("span_id")
        program_input = ProgramInput.from_json(resp["input"])
        # the batch context scopes this attempt's phase checkpoints (a
        # restart with a fresh lease resumes from the last completed
        # phase) and carries the advisory state heartbeats report
        with ckpt_mod.batch_context(batch_id,
                                    lease_token=lease_token) as ctx:
            # heartbeats keep the coordinator lease alive through a
            # long proof
            hb = None
            if self.heartbeat_interval and self.heartbeat_interval > 0:
                hb = _HeartbeatThread(host, port, batch_id,
                                      self.backend.prover_type,
                                      self.heartbeat_interval,
                                      lease_token=lease_token,
                                      trace_id=trace_id,
                                      prover_id=self.prover_id,
                                      ctx=ctx)
                hb.start()
            with tracing.trace_context(trace_id, parent_span) as tid:
                try:
                    with tracing.span("prover.prove", batch=batch_id,
                                      backend=self.backend.prover_type):
                        faults.inject("backend.prove")
                        proof = self.backend.prove(program_input,
                                                   resp["format"])
                        proof = faults.inject("backend.prove", proof,
                                              kinds=("corrupt",))
                except rt_mod.NanPoisonError as poison:
                    # poisoned batch: retrying cannot help — tell the
                    # coordinator exactly which phase went non-finite so
                    # it quarantines on the FIRST attempt, and spend
                    # zero retries here
                    if hb is not None:
                        hb.stop()
                    self.poisoned.append(batch_id)
                    log.error("batch %d poisoned in phase %s; reporting "
                              "for quarantine", batch_id, poison.phase)
                    self._report_poison(host, port, batch_id,
                                        lease_token, poison)
                    return 0
                finally:
                    if hb is not None:
                        hb.stop()
                # connection 2: submit over a fresh socket — the
                # input-request connection may long since have died
                # under the proof
                with tracing.span("prover.submit", batch=batch_id) as sub:
                    # ship the completed span subtree (prove + stage
                    # spans) with the proof; the coordinator merges it
                    # into its ring so the batch renders as one
                    # cross-process trace
                    with socket.create_connection((host, port),
                                                  timeout=30) as sock:
                        protocol.send_msg(sock, {
                            "type": protocol.PROOF_SUBMIT,
                            "batch_id": batch_id,
                            "prover_type": self.backend.prover_type,
                            "proof": proof,
                            "lease_token": lease_token,
                            "prover_id": self.prover_id,
                            "trace_id": trace_id,
                            "span_id": sub.span_id if sub else None,
                            "spans": tracing.export_wire(tid),
                        })
                        ack = protocol.recv_msg(sock)
        if ack.get("type") == protocol.SUBMIT_ACK:
            # the proof is accepted: its recovery state has no further
            # value, drop the batch's checkpoints
            ckpt_mod.complete(batch_id)
            self.proved.append(batch_id)
            return 1
        # application-level rejection (invalid proof, stale token): the
        # coordinator answered fine, so the endpoint is healthy — do NOT
        # feed this into the breaker/backoff failure count; a prover with
        # a corrupt backend must not open its own breaker against a
        # perfectly good coordinator
        from ..utils.metrics import record_submit_rejected

        record_submit_rejected()
        self.submit_rejections += 1
        log.warning("submit rejected for batch %d by %s:%d: %s",
                    batch_id, host, port,
                    ack.get("message", ack.get("type")))
        return 0

    def _report_poison(self, host: str, port: int, batch_id: int,
                       lease_token: str | None,
                       poison: "rt_mod.NanPoisonError") -> None:
        """Best-effort poison report: a HEARTBEAT carrying the offending
        phase; the coordinator quarantines the batch immediately instead
        of burning its failure budget on doomed retries."""
        try:
            with socket.create_connection((host, port), timeout=5) as sock:
                protocol.send_msg(sock, {
                    "type": protocol.HEARTBEAT,
                    "batch_id": batch_id,
                    "prover_type": self.backend.prover_type,
                    "lease_token": lease_token,
                    "prover_id": self.prover_id,
                    "poison": {"phase": str(poison.phase),
                               "detail": str(poison.detail)},
                })
                protocol.recv_msg(sock)
        except (ConnectionError, OSError, ValueError):
            pass  # lease expiry is the backstop, as for normal beats

    # ------------------------------------------------------------------
    def run_forever(self):
        from ..utils.metrics import record_poll_error

        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — prover must keep polling
                record_poll_error()     # (a lost device set _stop)
                log.exception("prover poll pass failed")

    def start(self) -> "ProverClient":
        threading.Thread(target=self.run_forever, daemon=True).start()
        return self

    def stop(self):
        self._stop.set()


def start_prover(backend_name: str, endpoints: list[tuple[str, int]],
                 **kwargs) -> ProverClient:
    """Entry point (upstream ethrex: start_prover, prover.rs:242):
    `start_prover("tpu", [(host, port)])` polls with `GpuBackend` on the
    card."""
    return ProverClient(backend_name, endpoints, **kwargs).start()
