"""Chain-path X-ray: explicit measured stages over the transaction
pipeline — a copy of `ethrex_tpu/perf/chain_path.py` (docs/OBSERVABILITY.md
"Chain-path telemetry").

This module instruments ingest→admit→select→execute→include→batch→
prove→settle the SEDA way (Welsh et al.): every pipeline stage gets an
explicit queue with measured arrival/service rates, so overload shows
up as a number on one stage instead of a mystery p99.

Three layers:

- ``StageQueue``: a never-raise per-stage queue instrument — depth
  gauge, arrival/departure/drop counters, dwell histogram, windowed
  arrival/service rates, utilization rho = arrival/service, and a
  Little's-law cross-check (L = lambda * W) that flags when the
  observed depth disagrees with what the measured rates predict
  (instrumentation bug or non-stationary load).
- ``ChainPath``: the process-global wiring.  Three queues — "admission"
  (mempool add -> removal), "producer" (block build service), and
  "batching" (block sealed -> batch committed) — plus a sampled per-tx
  lifecycle ring (admitted/selected/included/batched/proved/settled
  timestamps, joined to the batch trace by trace ID) and a live
  ``block_inclusion_tps`` gauge over a sliding window.
- ``explain_chain_path()``: the ``explain_scaling`` pattern applied
  to the pipeline — a pure function over the queue stats that
  names the dominant bottleneck stage with a human-readable verdict.

Everything here is telemetry on hot paths: every public entry point is
exception-guarded and must never raise into admission or block
production.  Failures count into ``CHAIN_PATH.errors`` and degrade to
missing numbers.

Sizes: the lifecycle sampling stride (``DEFAULT_SAMPLE``, every 16th
admitted transaction), the lifecycle ring (``DEFAULT_RING``) and the
sliding window in seconds for rates, utilization and the inclusion-tps
gauge (``DEFAULT_WINDOW``) are constants, which a caller may override
through ``configure``.  The reference's environment settings for them
come with the telemetry readers (RPC, exporter) that the port does not
have yet.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time

from ..utils.metrics import METRICS, _observe_safe

log = logging.getLogger(__name__)

# lifecycle events in pipeline order; each hop histogram is the dwell
# between two adjacent events that both fired for a sampled tx
LIFECYCLE_EVENTS = ("admitted", "selected", "included",
                    "batched", "proved", "settled")

QUEUE_STAGES = ("admission", "producer", "batching")

DEFAULT_SAMPLE = 16
DEFAULT_RING = 512
DEFAULT_WINDOW = 30.0

# an idle/stalled service rate would make backlog-drain estimates
# infinite; clamp so alert thresholds stay comparable
MAX_BACKLOG_SECONDS = 1e6


# ---------------------------------------------------------------------------
# metric helpers (help-text lint: tests/test_tooling.py)
# ---------------------------------------------------------------------------


def record_stage_depth(stage: str, depth: float):
    try:
        METRICS.set_labeled(
            "chain_path_stage_depth", {"stage": stage}, float(depth),
            "Current queue depth of a chain-path pipeline stage "
            "(admission = txs resident in the mempool, batching = "
            "blocks sealed but not yet committed to a batch)")
    except Exception:
        pass


def record_stage_event(stage: str, event: str, n: float = 1.0):
    try:
        METRICS.inc_labeled(
            "chain_path_stage_events_total",
            {"stage": stage, "event": event}, float(n),
            "Arrival/departure/drop events per chain-path stage queue "
            "(drops are departures that left the pipeline: evictions, "
            "prunes, reorg re-injections)")
    except Exception:
        pass


def observe_stage_dwell(stage: str, seconds: float):
    _observe_safe("chain_path_stage_dwell_seconds", seconds,
                  {"stage": stage},
                  "Time a unit of work spent inside one chain-path "
                  "stage queue, from arrival to departure")


def observe_lifecycle_hop(hop: str, seconds: float):
    _observe_safe("chain_path_hop_seconds", seconds, {"hop": hop},
                  "Dwell between adjacent lifecycle events of a sampled "
                  "transaction (e.g. admitted_to_selected); the per-hop "
                  "decomposition of end-to-end inclusion latency")


def record_inclusion_tps(tps: float):
    try:
        METRICS.set(
            "block_inclusion_tps", float(tps),
            "Transactions included in sealed blocks per second over the "
            "chain-path sliding window — the live gauge behind the "
            "bench --measure-inclusion history gate")
    except Exception:
        pass


# ---------------------------------------------------------------------------
# StageQueue
# ---------------------------------------------------------------------------


class StageQueue:
    """One explicitly measured pipeline stage (SEDA style).

    Mutators (``arrive``/``depart``) are thread-safe and never raise;
    ``stats()`` returns a JSON-able dict with windowed arrival/service
    rates, utilization rho and a Little's-law cross-check.  The depth
    integral is maintained on every mutation so the *time-averaged*
    depth (Little's observed L) is exact, not sampled.
    """

    def __init__(self, name: str, window: float | None = None,
                 clock=time.monotonic):
        self.name = name
        self.window = float(window if window is not None
                            else DEFAULT_WINDOW)
        self._clock = clock
        self.lock = threading.Lock()
        self.depth = 0
        self.arrivals = 0
        self.departures = 0
        self.drops = 0
        self.errors = 0
        self._dwell_sum = 0.0
        self._dwell_count = 0
        # windowed event logs: (ts, n) arrivals; (ts, n, dwell) services
        self._arrived: collections.deque = collections.deque()
        self._served: collections.deque = collections.deque()
        now = self._clock()
        self._born = now
        self._last_change = now
        self._depth_area = 0.0  # integral of depth dt since _born

    # -- internals (caller holds self.lock) -----------------------------
    def _advance(self, now: float) -> None:
        if now > self._last_change:
            self._depth_area += self.depth * (now - self._last_change)
            self._last_change = now
        horizon = now - self.window
        while self._arrived and self._arrived[0][0] < horizon:
            self._arrived.popleft()
        while self._served and self._served[0][0] < horizon:
            self._served.popleft()

    # -- mutators --------------------------------------------------------
    def arrive(self, n: int = 1) -> None:
        try:
            n = int(n)
            if n <= 0:
                return
            with self.lock:
                now = self._clock()
                self._advance(now)
                self.depth += n
                self.arrivals += n
                self._arrived.append((now, n))
                depth = self.depth
            record_stage_depth(self.name, depth)
            record_stage_event(self.name, "arrival", n)
        except Exception:
            self.errors += 1

    def depart(self, dwell: float | None = None, n: int = 1,
               dropped: bool = False) -> None:
        try:
            n = int(n)
            if n <= 0:
                return
            with self.lock:
                now = self._clock()
                self._advance(now)
                self.depth = max(0, self.depth - n)
                if dropped:
                    self.drops += n
                else:
                    self.departures += n
                d = None
                if dwell is not None:
                    d = max(0.0, float(dwell))
                    self._dwell_sum += d * n
                    self._dwell_count += n
                self._served.append((now, n, d))
                depth = self.depth
            record_stage_depth(self.name, depth)
            record_stage_event(self.name, "drop" if dropped
                               else "departure", n)
            if d is not None:
                observe_stage_dwell(self.name, d)
        except Exception:
            self.errors += 1

    # -- readers ---------------------------------------------------------
    def stats(self) -> dict:
        try:
            with self.lock:
                now = self._clock()
                self._advance(now)
                span = min(self.window, max(now - self._born, 1e-9))
                arr = sum(n for _, n in self._arrived)
                srv = sum(n for _, n, _ in self._served)
                dwells = [(n, d) for _, n, d in self._served
                          if d is not None]
                arrival_rate = arr / span
                service_rate = srv / span
                w_n = sum(n for n, _ in dwells)
                mean_dwell = (sum(n * d for n, d in dwells) / w_n
                              if w_n else None)
                rho = None
                if service_rate > 0:
                    rho = arrival_rate / service_rate
                elif arrival_rate > 0:
                    rho = float("inf")
                # Little's law: L = lambda * W.  Compare the predicted
                # depth with the observed time-averaged depth; a ratio
                # far from 1 under stationary load means the
                # instrumentation (or the stationarity assumption) is
                # lying.
                elapsed = max(now - self._born, 1e-9)
                observed_l = self._depth_area / elapsed
                predicted_l = (arrival_rate * mean_dwell
                               if mean_dwell is not None else None)
                ratio = None
                if predicted_l is not None and observed_l > 1e-9:
                    ratio = predicted_l / observed_l
                return {
                    "depth": self.depth,
                    "arrivals": self.arrivals,
                    "departures": self.departures,
                    "drops": self.drops,
                    "errors": self.errors,
                    "windowSeconds": round(span, 3),
                    "arrivalRate": round(arrival_rate, 4),
                    "serviceRate": round(service_rate, 4),
                    "utilization": (round(rho, 4)
                                    if rho not in (None, float("inf"))
                                    else rho),
                    "meanDwellSeconds": (round(mean_dwell, 6)
                                         if mean_dwell is not None
                                         else None),
                    "busySeconds": round(
                        sum(n * d for n, d in dwells), 6),
                    "littleLaw": {
                        "observedDepth": round(observed_l, 4),
                        "predictedDepth": (round(predicted_l, 4)
                                           if predicted_l is not None
                                           else None),
                        "ratio": (round(ratio, 4)
                                  if ratio is not None else None),
                    },
                }
        except Exception:
            self.errors += 1
            return {"depth": self.depth, "error": "stats failed"}


# ---------------------------------------------------------------------------
# per-tx lifecycle ring
# ---------------------------------------------------------------------------


class ChainPath:
    """Process-global chain-path instrument (singleton ``CHAIN_PATH``).

    Wiring points (each a never-raise call):

    - ``tx_admitted``      mempool.add_transaction success
    - ``tx_removed``       mempool.remove_transaction (any reason)
    - ``txs_selected``     Node.produce_block candidate set
    - ``block_produced``   Node.produce_block after the block is sealed
    - ``blocks_batched``   Sequencer.commit_next_batch success
    - ``batch_proved``     ProofCoordinator proof accepted
    - ``batches_settled``  record_verified_batch call sites
    """

    def __init__(self, sample: int | None = None,
                 ring: int | None = None,
                 window: float | None = None,
                 clock=time.monotonic):
        self._clock = clock
        self.configure(sample=sample, ring=ring, window=window)

    def configure(self, sample: int | None = None,
                  ring: int | None = None,
                  window: float | None = None) -> None:
        """(Re)initialize — tests use this to force sample=1 and small
        rings; otherwise the module's constant sizes apply."""
        self.sample = int(sample if sample is not None else DEFAULT_SAMPLE)
        self.ring = max(1, int(ring if ring is not None else DEFAULT_RING))
        self.window = float(window if window is not None
                            else DEFAULT_WINDOW)
        self.lock = threading.Lock()
        self.queues = {name: StageQueue(name, window=self.window,
                                        clock=self._clock)
                       for name in QUEUE_STAGES}
        self.errors = 0
        self._seen = 0          # admissions observed (sampling stride)
        self._sampled = 0       # lifecycle records created
        self._records: collections.OrderedDict = collections.OrderedDict()
        self._by_block: dict[int, list[str]] = {}
        self._block_sealed_at: collections.OrderedDict = \
            collections.OrderedDict()
        self._by_batch: dict[int, list[str]] = {}
        self._included_events: collections.deque = collections.deque()
        self.blocks_produced = 0
        self.txs_included = 0
        self.last_block_at: float | None = None

    def reset(self) -> None:
        self.configure()

    # -- internals (caller holds self.lock) -----------------------------
    def _evict(self) -> None:
        while len(self._records) > self.ring:
            h, rec = self._records.popitem(last=False)
            blk = rec.get("block")
            if blk in self._by_block:
                self._by_block[blk] = [x for x in self._by_block[blk]
                                       if x != h]
                if not self._by_block[blk]:
                    del self._by_block[blk]
            bat = rec.get("batch")
            if bat in self._by_batch:
                self._by_batch[bat] = [x for x in self._by_batch[bat]
                                       if x != h]
                if not self._by_batch[bat]:
                    del self._by_batch[bat]

    def _mark(self, rec: dict, event: str, now: float) -> None:
        ts = rec["ts"]
        if event in ts:
            return
        ts[event] = now
        idx = LIFECYCLE_EVENTS.index(event)
        for prev in reversed(LIFECYCLE_EVENTS[:idx]):
            if prev in ts:
                observe_lifecycle_hop(f"{prev}_to_{event}",
                                      max(0.0, now - ts[prev]))
                break

    def _prune_included(self, now: float) -> None:
        horizon = now - self.window
        while self._included_events and \
                self._included_events[0][0] < horizon:
            self._included_events.popleft()

    # -- wiring hooks ----------------------------------------------------
    def tx_admitted(self, tx_hash) -> None:
        try:
            self.queues["admission"].arrive()
            if self.sample <= 0:
                return
            with self.lock:
                self._seen += 1
                if (self._seen - 1) % self.sample:
                    return
                now = self._clock()
                h = getattr(tx_hash, "hex", lambda: str(tx_hash))()
                self._records[h] = {"tx": h, "ts": {"admitted": now},
                                    "block": None, "batch": None,
                                    "traceId": None}
                self._sampled += 1
                self._evict()
        except Exception:
            self.errors += 1

    def tx_removed(self, tx_hash, reason: str,
                   dwell: float | None = None) -> None:
        """Mempool removal = admission-stage departure.  Only
        ``included`` leaves through the pipeline; every other reason
        (evicted/pruned/reorg/...) is a drop."""
        try:
            self.queues["admission"].depart(
                dwell=dwell, dropped=(reason != "included"))
        except Exception:
            self.errors += 1

    def txs_selected(self, tx_hashes) -> None:
        try:
            with self.lock:
                now = self._clock()
                for th in tx_hashes:
                    h = getattr(th, "hex", lambda t=th: str(t))()
                    rec = self._records.get(h)
                    if rec is not None:
                        self._mark(rec, "selected", now)
        except Exception:
            self.errors += 1

    def block_produced(self, block_number: int, tx_hashes,
                       build_seconds: float) -> None:
        try:
            q = self.queues["producer"]
            q.arrive()
            q.depart(dwell=build_seconds)
            self.queues["batching"].arrive()
            hashes = [getattr(th, "hex", lambda t=th: str(t))()
                      for th in tx_hashes]
            with self.lock:
                now = self._clock()
                self.blocks_produced += 1
                self.txs_included += len(hashes)
                self.last_block_at = now
                self._block_sealed_at[int(block_number)] = now
                while len(self._block_sealed_at) > 4096:
                    self._block_sealed_at.popitem(last=False)
                self._included_events.append((now, len(hashes)))
                self._prune_included(now)
                marked = []
                for h in hashes:
                    rec = self._records.get(h)
                    if rec is not None:
                        self._mark(rec, "included", now)
                        rec["block"] = int(block_number)
                        marked.append(h)
                if marked:
                    self._by_block[int(block_number)] = marked
                tps = self._inclusion_tps_locked(now)
            record_inclusion_tps(tps)
        except Exception:
            self.errors += 1

    def blocks_batched(self, batch_number: int, first_block: int,
                       last_block: int,
                       trace_id: str | None = None) -> None:
        try:
            with self.lock:
                now = self._clock()
                marked = []
                n_blocks = 0
                dwells = []
                for blk in range(int(first_block), int(last_block) + 1):
                    sealed = self._block_sealed_at.pop(blk, None)
                    if sealed is not None:
                        n_blocks += 1
                        dwells.append(max(0.0, now - sealed))
                    for h in self._by_block.get(blk, ()):
                        rec = self._records.get(h)
                        if rec is None:
                            continue
                        self._mark(rec, "batched", now)
                        rec["batch"] = int(batch_number)
                        rec["traceId"] = trace_id or rec["traceId"]
                        marked.append(h)
                if marked:
                    self._by_batch[int(batch_number)] = marked
            q = self.queues["batching"]
            for d in dwells:
                q.depart(dwell=d)
            # blocks sealed before this instrument booted (or >4096
            # ago) still leave the queue, just without a dwell
            extra = (int(last_block) - int(first_block) + 1) - n_blocks
            if extra > 0 and q.depth > 0:
                q.depart(n=min(extra, q.depth))
        except Exception:
            self.errors += 1

    def batch_proved(self, batch_number: int) -> None:
        try:
            with self.lock:
                now = self._clock()
                for h in self._by_batch.get(int(batch_number), ()):
                    rec = self._records.get(h)
                    if rec is not None:
                        self._mark(rec, "proved", now)
        except Exception:
            self.errors += 1

    def batches_settled(self, first_batch: int,
                        last_batch: int | None = None) -> None:
        try:
            last = int(last_batch if last_batch is not None
                       else first_batch)
            with self.lock:
                now = self._clock()
                for b in range(int(first_batch), last + 1):
                    for h in self._by_batch.get(b, ()):
                        rec = self._records.get(h)
                        if rec is not None:
                            self._mark(rec, "settled", now)
        except Exception:
            self.errors += 1

    # -- readers ---------------------------------------------------------
    def _inclusion_tps_locked(self, now: float) -> float:
        self._prune_included(now)
        if not self._included_events:
            return 0.0
        span = min(self.window, max(now - self._included_events[0][0],
                                    1e-9))
        # a single block gives a degenerate span; floor at 1s so the
        # gauge reads "txs in the last second" rather than infinity
        span = max(span, 1.0)
        return sum(n for _, n in self._included_events) / span

    def inclusion_tps(self) -> float:
        try:
            with self.lock:
                return self._inclusion_tps_locked(self._clock())
        except Exception:
            self.errors += 1
            return 0.0

    def backlog_seconds(self) -> float | None:
        """Estimated seconds to drain the admission backlog at the
        current inclusion (service) rate.  None when the backlog is
        empty or this node has never produced a block (L1-only follower
        — the signal must stay armed-but-silent there)."""
        try:
            st = self.queues["admission"].stats()
            depth = st.get("depth") or 0
            if depth <= 0:
                return None
            if self.blocks_produced <= 0:
                return None
            rate = st.get("serviceRate") or 0.0
            if rate <= 0:
                return float(MAX_BACKLOG_SECONDS)
            return min(float(MAX_BACKLOG_SECONDS), depth / rate)
        except Exception:
            self.errors += 1
            return None

    def producer_stall_seconds(self) -> float | None:
        """Seconds since the last sealed block while admitted work is
        waiting.  None while the mempool is empty or before the first
        block (idle is not a stall)."""
        try:
            if self.last_block_at is None:
                return None
            if (self.queues["admission"].depth or 0) <= 0:
                return None
            return max(0.0, self._clock() - self.last_block_at)
        except Exception:
            self.errors += 1
            return None

    def lifecycles_json(self, limit: int = 16) -> list[dict]:
        try:
            with self.lock:
                recs = list(self._records.values())[-int(limit):]
            out = []
            for rec in recs:
                ts = rec["ts"]
                hops = {}
                prev = None
                for ev in LIFECYCLE_EVENTS:
                    if ev not in ts:
                        continue
                    if prev is not None:
                        hops[f"{prev}_to_{ev}"] = round(
                            ts[ev] - ts[prev], 6)
                    prev = ev
                out.append({
                    "tx": rec["tx"],
                    "block": rec["block"],
                    "batch": rec["batch"],
                    "traceId": rec["traceId"],
                    "events": {ev: round(t, 6)
                               for ev, t in ts.items()},
                    "hops": hops,
                })
            return out
        except Exception:
            self.errors += 1
            return []

    def to_json(self) -> dict:
        try:
            with self.lock:
                sampled = self._sampled
                seen = self._seen
            return _jsonable({
                "enabled": True,
                "stages": {n: q.stats()
                           for n, q in self.queues.items()},
                "inclusionTps": round(self.inclusion_tps(), 4),
                "blocksProduced": self.blocks_produced,
                "txsIncluded": self.txs_included,
                "lifecycle": {
                    "sampleEvery": self.sample,
                    "ringCapacity": self.ring,
                    "seen": seen,
                    "sampled": sampled,
                    "records": self.lifecycles_json(),
                },
                "explain": explain_chain_path(self),
                "errors": self.errors,
            })
        except Exception as exc:
            self.errors += 1
            return {"enabled": False,
                    "error": f"{type(exc).__name__}: {exc}"}

    def health_json(self) -> dict:
        """Compact ethrex_health section.  On an L1-only node (never
        produced a block) this degrades to zeros with bottleneck null —
        present, truthful, never an error."""
        try:
            exp = explain_chain_path(self)
            return _jsonable({
                "bottleneck": exp.get("bottleneck"),
                "inclusionTps": round(self.inclusion_tps(), 4),
                "backlogSeconds": self.backlog_seconds(),
                "producerStallSeconds": self.producer_stall_seconds(),
                "blocksProduced": self.blocks_produced,
                "stages": {
                    n: {"depth": q.stats().get("depth"),
                        "utilization": q.stats().get("utilization")}
                    for n, q in self.queues.items()},
            })
        except Exception as exc:
            return {"error": f"{type(exc).__name__}: {exc}"}


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------


def _jsonable(obj):
    """Replace non-finite floats with the string "inf" so stage stats
    survive strict JSON parsers on the RPC/health surfaces (Python's
    json.dumps would happily emit bare ``Infinity``)."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return "inf"
    return obj


def explain_chain_path(path: ChainPath | None = None) -> dict:
    """Name the dominant chain-path bottleneck from the queue stats —
    the ``explain_scaling`` pattern applied to the tx pipeline.

    Pure over ``StageQueue.stats()`` output; returns a stub verdict
    (bottleneck null) when no stage shows pressure, so the RPC degrades
    gracefully on idle or L1-only nodes."""
    p = path if path is not None else CHAIN_PATH
    try:
        stages = {n: q.stats() for n, q in p.queues.items()}
        bits: list[str] = []
        pressures: dict[str, float] = {}

        adm = stages.get("admission", {})
        rho = adm.get("utilization")
        adm_p = 0.0
        if adm.get("depth"):
            if rho == float("inf"):
                adm_p = float(adm["depth"])
                bits.append(
                    "admission: %d txs queued with no inclusion in the "
                    "window — txs arrive but nothing drains them"
                    % adm["depth"])
            elif rho is not None and rho > 1.0:
                adm_p = float(rho)
                bits.append(
                    "admission: arrivals %.1f/s vs inclusion %.1f/s "
                    "(rho %.2f), backlog %d txs"
                    % (adm.get("arrivalRate") or 0.0,
                       adm.get("serviceRate") or 0.0, rho,
                       adm["depth"]))
        pressures["admission"] = adm_p

        prod = stages.get("producer", {})
        busy = (prod.get("busySeconds") or 0.0) / max(
            prod.get("windowSeconds") or 1.0, 1e-9)
        prod_p = busy if busy > 0.8 else 0.0
        if prod_p:
            bits.append(
                "producer: block building consumed %.0f%% of the "
                "window (%.3fs mean build) — the producer itself is "
                "the wall" % (busy * 100.0,
                              prod.get("meanDwellSeconds") or 0.0))
        stall = p.producer_stall_seconds()
        if stall is not None and stall > 2.0 * max(
                prod.get("meanDwellSeconds") or 0.0, 1.0):
            prod_p = max(prod_p, 1.0 + stall)
            bits.append(
                "producer: no block for %.1fs while %d txs wait — "
                "producer stalled" % (stall, adm.get("depth") or 0))
        pressures["producer"] = round(prod_p, 4)

        bat = stages.get("batching", {})
        brho = bat.get("utilization")
        bat_p = 0.0
        # only score batching once a batch has actually been committed:
        # on an L1-only node sealed blocks arrive here but nothing ever
        # drains them, and that is normal, not a bottleneck
        if bat.get("depth") and bat.get("departures"):
            if brho == float("inf"):
                bat_p = float(bat["depth"])
                bits.append(
                    "batching: %d sealed blocks await commitment with "
                    "no batch committed in the window" % bat["depth"])
            elif brho is not None and brho > 1.0:
                bat_p = float(brho)
                bits.append(
                    "batching: blocks sealed at %.2f/s vs committed "
                    "%.2f/s (rho %.2f)"
                    % (bat.get("arrivalRate") or 0.0,
                       bat.get("serviceRate") or 0.0, brho))
        pressures["batching"] = bat_p

        bottleneck = None
        if any(v > 0 for v in pressures.values()):
            bottleneck = max(pressures, key=lambda k: pressures[k])
        if bottleneck is None:
            bits.append("no stage under pressure — the chain path is "
                        "keeping up with offered load")
        return {
            "bottleneck": bottleneck,
            "verdict": "; ".join(bits),
            "pressures": {k: (v if v != float("inf") else "inf")
                          for k, v in pressures.items()},
            "inclusionTps": round(p.inclusion_tps(), 4),
            "stages": _jsonable(stages),
        }
    except Exception as exc:
        return {"bottleneck": None,
                "error": f"{type(exc).__name__}: {exc}"}


CHAIN_PATH = ChainPath()
