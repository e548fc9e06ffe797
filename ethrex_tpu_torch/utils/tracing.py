"""Hierarchical in-process tracing and structured logging (stdlib only): a
copy of `ethrex_tpu/utils/tracing.py`.

Mirrors the shape of the reference stack's tracing setup (ethrex wires
`tracing_subscriber` + OTLP spans around the sequencer and prover): a
span is a named, timed region with attributes; spans nest via a
thread-local context stack; completed spans are folded into a bounded
ring buffer of traces keyed by trace ID.

Cross-process propagation is cooperative: the proof coordinator stamps
``trace_id``/``span_id`` into ``InputResponse``, the prover client
re-enters that context with :class:`trace_context`, and ``ProofSubmit``
echoes the IDs back, so one batch's life (assign -> prove -> submit ->
verify -> settle) is a single trace even across the TCP seam.

Everything here is best-effort by contract: tracing must NEVER raise
into the traced path.  Span entry/exit and recording are wrapped so a
tracing bug degrades to missing telemetry, not a failed prove.
"""

from __future__ import annotations

import collections
import json
import logging
import secrets
import sys
import threading
import time

# Completed traces kept in memory (oldest evicted first).
TRACE_CAPACITY = 256
# Spans kept per trace (runaway-loop protection).
SPANS_PER_TRACE = 512

# -- span-shipping wire format (docs/OBSERVABILITY.md "Distributed
# tracing").  A prover attaches ``export_wire(trace_id)`` to ProofSubmit
# (and piggybacks it on Heartbeat mid-proof); the coordinator merges it
# with ``TRACER.ingest``.  The field is advisory like ``prover_id``:
# old peers ignore it, new coordinators accept only this version tag.
WIRE_VERSION = 1
# Spans shipped per payload; over the cap the LONGEST spans win, because
# they are the ones critical-path analysis needs.
WIRE_MAX_SPANS = 256
# Serialized payload budget; halve the span list until it fits.
WIRE_MAX_BYTES = 256 * 1024
# Spans one source may contribute to one merged trace, so a chatty or
# hedged prover cannot evict the rest of the tree.
INGEST_SPANS_PER_SOURCE = 256


def new_trace_id() -> str:
    return secrets.token_hex(8)


def new_span_id() -> str:
    return secrets.token_hex(4)


class Span:
    """A single timed region.  Fields are finalized on context exit."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "seconds", "attrs", "status", "error", "_t0")

    def __init__(self, trace_id, span_id, parent_id, name, attrs):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.seconds = 0.0
        self.status = "ok"
        self.error = None

    def set_attr(self, key, value):
        try:
            self.attrs[key] = value
        except Exception:
            pass

    def to_json(self) -> dict:
        out = {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "start": self.start,
            "seconds": self.seconds,
            "status": self.status,
        }
        if self.attrs:
            out["attrs"] = {k: _jsonable(v) for k, v in self.attrs.items()}
        if self.error:
            out["error"] = self.error
        return out


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


_ctx = threading.local()


def _stack() -> list:
    st = getattr(_ctx, "stack", None)
    if st is None:
        st = []
        _ctx.stack = st
    return st


def current() -> "tuple[str, str | None] | None":
    """(trace_id, span_id) for the innermost active context, or None."""
    try:
        st = _stack()
        return st[-1] if st else None
    except Exception:
        return None


def current_trace_id() -> "str | None":
    cur = current()
    return cur[0] if cur else None


class Tracer:
    """Bounded ring buffer of completed traces, keyed by trace ID."""

    def __init__(self, capacity: int = TRACE_CAPACITY):
        self.lock = threading.Lock()
        self.capacity = capacity
        self._traces: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.dropped = 0
        # spans merged from / dropped by remote payloads (``ingest``)
        self.ingested = 0
        self.ingest_dropped = 0

    def record(self, span: Span) -> None:
        with self.lock:
            rec = self._traces.get(span.trace_id)
            if rec is None:
                rec = {"traceId": span.trace_id, "spans": []}
                self._traces[span.trace_id] = rec
                while len(self._traces) > self.capacity:
                    self._traces.popitem(last=False)
                    self.dropped += 1
            else:
                # A late span keeps its trace warm in the ring.
                self._traces.move_to_end(span.trace_id)
            rec["spans"].append(span.to_json())
            if len(rec["spans"]) > SPANS_PER_TRACE:
                del rec["spans"][:len(rec["spans"]) - SPANS_PER_TRACE]

    def ingest(self, payload, source: "str | None" = None) -> int:
        """Merge a shipped span payload (``export_wire``) into the ring.

        Spans land under their ORIGINAL trace and parent IDs, so the
        remote subtree reattaches to the local assign/verify spans and
        one batch renders as one cross-process tree.  The contract is
        the usual tracing one plus wire paranoia: never raises, accepts
        only ``WIRE_VERSION`` payloads, drops malformed spans,
        deduplicates by span ID within a trace (heartbeat payloads are
        cumulative, so re-shipping is idempotent), and caps each source
        at ``INGEST_SPANS_PER_SOURCE`` spans per trace.  Returns the
        number of spans actually added.
        """
        added = dropped = 0
        try:
            if not isinstance(payload, dict) \
                    or payload.get("v") != WIRE_VERSION:
                return 0
            spans = payload.get("spans")
            if not isinstance(spans, list):
                return 0
            src = source if isinstance(source, str) and source else "remote"
            with self.lock:
                # per-call cache: trace id -> (rec, seen span ids,
                # per-source counts) — payload spans overwhelmingly
                # share one trace, so resolve/ring-touch it once
                cache: "dict[str, tuple]" = {}
                # the loop body is hand-flattened (bound s.get, type()
                # over isinstance, branch-only-when-clamping): ingestion
                # sits on the coordinator's socket-serving path and the
                # whole ship+merge cycle carries a <2% tail budget
                per_src_cap = INGEST_SPANS_PER_SOURCE
                per_trace_cap = SPANS_PER_TRACE
                for s in spans:
                    if type(s) is not dict:
                        dropped += 1
                        continue
                    sget = s.get
                    tid = sget("traceId")
                    sid = sget("spanId")
                    start = sget("start")
                    secs = sget("seconds")
                    if not (type(tid) is str and type(sid) is str
                            and isinstance(start, (int, float))
                            and isinstance(secs, (int, float))):
                        dropped += 1
                        continue
                    hit = cache.get(tid)
                    if hit is None:
                        rec = self._traces.get(tid)
                        if rec is None:
                            rec = {"traceId": tid, "spans": []}
                            self._traces[tid] = rec
                            while len(self._traces) > self.capacity:
                                self._traces.popitem(last=False)
                                self.dropped += 1
                        else:
                            self._traces.move_to_end(tid)
                        hit = (rec["spans"],
                               {x.get("spanId") for x in rec["spans"]},
                               rec.setdefault("sources", {}))
                        cache[tid] = hit
                    out, ids, per_src = hit
                    if sid in ids:
                        continue  # duplicate (heartbeat then submit)
                    if per_src.get(src, 0) >= per_src_cap \
                            or len(out) >= per_trace_cap:
                        dropped += 1
                        continue
                    name = sget("name") or "remote"
                    if type(name) is not str:
                        name = str(name)
                    status = sget("status") or "ok"
                    if type(status) is not str:
                        status = str(status)
                    parent = sget("parentId")
                    clean = {
                        "traceId": tid,
                        "spanId": sid,
                        "parentId": parent if type(parent) is str else None,
                        "name": name if len(name) <= 120 else name[:120],
                        "start": float(start),
                        "seconds": float(secs) if secs >= 0 else 0.0,
                        "status": status if len(status) <= 16
                        else status[:16],
                        # which process shipped it; drives the Perfetto
                        # pid mapping and hedged-subtree rendering
                        "source": src,
                    }
                    attrs = sget("attrs")
                    if type(attrs) is dict and attrs:
                        if len(attrs) > 32:
                            attrs = dict(list(attrs.items())[:32])
                        clean["attrs"] = {
                            (k if type(k) is str else str(k)): (
                                v if v is None
                                or type(v) in (str, int, float, bool)
                                else str(v))
                            for k, v in attrs.items()}
                    err = sget("error")
                    if err:
                        clean["error"] = str(err)[:500]
                    out.append(clean)
                    ids.add(sid)
                    per_src[src] = per_src.get(src, 0) + 1
                    added += 1
                self.ingested += added
                self.ingest_dropped += dropped
        except Exception:
            pass
        if added or dropped:
            try:
                from . import metrics
                metrics.record_trace_ingest(added, dropped)
            except Exception:
                pass
        return added

    def __len__(self) -> int:
        with self.lock:
            return len(self._traces)

    def get_trace(self, trace_id: str) -> "dict | None":
        with self.lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                return None
            return {"traceId": rec["traceId"], "spans": list(rec["spans"])}

    def _summaries(self) -> list:
        with self.lock:
            recs = [(tid, list(rec["spans"]))
                    for tid, rec in self._traces.items()]
        out = []
        for tid, spans in recs:
            spans = [s for s in spans if isinstance(s, dict)]
            if not spans:
                continue
            start = min(s.get("start") or 0.0 for s in spans)
            root = next((s for s in spans if not s.get("parentId")), None)
            if root is not None:
                end = max((s.get("start") or 0.0) + (s.get("seconds") or 0.0)
                          for s in spans)
                seconds = max(0.0, end - start)
            else:
                # Rootless trace: late or shipped spans kept it warm in
                # the ring without a root, so the wall extent is
                # unknowable.  The longest single span stands in for the
                # duration — a partial trace must not skew the slowest
                # sort with a fabricated extent (or raise on render).
                seconds = max(s.get("seconds") or 0.0 for s in spans)
            entry = {
                "traceId": tid,
                "name": (root if root is not None else
                         min(spans, key=lambda s: s.get("start") or 0.0)
                         ).get("name") or "?",
                "start": start,
                "seconds": seconds,
                "spanCount": len(spans),
                "spans": spans,
            }
            if root is None:
                entry["partial"] = True
            out.append(entry)
        return out

    def recent(self, limit: int = 20) -> list:
        """Most recently touched traces, newest first."""
        return list(reversed(self._summaries()))[:max(0, limit)]

    def slowest(self, limit: int = 20) -> list:
        """Traces ordered by wall-clock extent, slowest first."""
        out = self._summaries()
        out.sort(key=lambda t: t["seconds"], reverse=True)
        return out[:max(0, limit)]

    def stage_breakdown(self, trace_id: str) -> "dict[str, float]":
        """Sum span durations by their ``stage`` attribute for one trace."""
        rec = self.get_trace(trace_id)
        stages: "dict[str, float]" = {}
        if rec is None:
            return stages
        for s in rec["spans"]:
            stage = (s.get("attrs") or {}).get("stage")
            if stage:
                stages[stage] = stages.get(stage, 0.0) + s["seconds"]
        return stages

    def clear(self) -> None:
        with self.lock:
            self._traces.clear()
            self.dropped = 0
            self.ingested = 0
            self.ingest_dropped = 0


TRACER = Tracer()

# Stage observers: callables (span_name, stage, seconds) invoked on every
# stage-span exit, after the prover_stage_seconds observation.  The perf
# profiler (perf/profiler.py) registers here to fold stage spans into its
# attribution tree.  Observers run under the same
# never-raise guard as the rest of span exit.
STAGE_OBSERVERS: list = []


class span:
    """Context manager opening a span under the current thread context.

    With no enclosing context a new trace is started.  ``stage=`` also
    feeds the ``prover_stage_seconds`` histogram on exit.  Never raises:
    on internal failure ``__enter__`` yields None and the body still runs.
    """

    __slots__ = ("_name", "_stage", "_attrs", "_span", "_pushed")

    def __init__(self, name: str, stage: "str | None" = None, **attrs):
        self._name = name
        self._stage = stage
        self._attrs = attrs
        self._span = None
        self._pushed = False

    def __enter__(self):
        try:
            attrs = dict(self._attrs)
            if self._stage:
                attrs["stage"] = self._stage
            st = _stack()
            if st:
                trace_id, parent_id = st[-1]
            else:
                trace_id, parent_id = new_trace_id(), None
            sp = Span(trace_id, new_span_id(), parent_id, self._name, attrs)
            st.append((trace_id, sp.span_id))
            self._pushed = True
            self._span = sp
        except Exception:
            self._span = None
        return self._span

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._pushed:
                st = _stack()
                if st:
                    st.pop()
            sp = self._span
            if sp is not None:
                sp.seconds = time.perf_counter() - sp._t0
                if exc is not None:
                    sp.status = "error"
                    sp.error = f"{exc_type.__name__}: {exc}"
                TRACER.record(sp)
                if self._stage:
                    from . import metrics
                    metrics.observe_prover_stage(self._stage, sp.seconds)
                    for obs in STAGE_OBSERVERS:
                        try:
                            obs(self._name, self._stage, sp.seconds)
                        except Exception:
                            pass
        except Exception:
            pass
        return False


class trace_context:
    """Re-enter a trace received over the wire on this thread.

    Spans opened inside become children of ``parent_span_id`` (or roots
    of the trace when no parent is known).  A falsy ``trace_id`` starts
    a fresh trace so callers need not special-case old peers that do
    not send one.  Never raises.
    """

    __slots__ = ("_trace_id", "_parent_id", "_pushed")

    def __init__(self, trace_id: "str | None",
                 parent_span_id: "str | None" = None):
        self._trace_id = trace_id
        self._parent_id = parent_span_id
        self._pushed = False

    def __enter__(self):
        try:
            tid = self._trace_id
            if not isinstance(tid, str) or not tid:
                tid = new_trace_id()
            pid = self._parent_id if isinstance(self._parent_id, str) else None
            _stack().append((tid, pid))
            self._pushed = True
            self._trace_id = tid
        except Exception:
            pass
        return self._trace_id

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._pushed:
                st = _stack()
                if st:
                    st.pop()
        except Exception:
            pass
        return False


# ---------------------------------------------------------------------------
# Span shipping, critical-path analysis, Perfetto export
# (docs/OBSERVABILITY.md "Distributed tracing")


def export_wire(trace_id, max_spans: int = WIRE_MAX_SPANS,
                max_bytes: int = WIRE_MAX_BYTES,
                tracer: "Tracer | None" = None) -> "dict | None":
    """One trace's completed spans as a bounded wire payload.

    Returns ``{"v": WIRE_VERSION, "spans": [...], "truncated": bool}``
    sorted by span start, or None when the trace is unknown or empty.
    Over ``max_spans`` the longest spans are kept (they are what
    critical-path analysis needs); over ``max_bytes`` the list is halved
    until the serialized payload fits.  Never raises.
    """
    try:
        t = tracer if tracer is not None else TRACER
        if not isinstance(trace_id, str) or not trace_id:
            return None
        rec = t.get_trace(trace_id)
        if rec is None:
            return None
        spans = [s for s in rec["spans"] if isinstance(s, dict)]
        if not spans:
            return None
        truncated = False
        if len(spans) > max_spans:
            spans.sort(key=lambda s: s.get("seconds") or 0.0, reverse=True)
            spans = spans[:max(1, max_spans)]
            truncated = True
        # serialization is the expensive part of shipping (~100us for a
        # 64-span trace) — skip it when a pessimistic size estimate (x6
        # covers worst-case JSON string escaping) is still under budget
        if _approx_wire_bytes(spans) * 6 > max_bytes:
            while len(spans) > 1 and len(json.dumps(
                    {"v": WIRE_VERSION, "spans": spans},
                    default=str)) > max_bytes:
                spans.sort(key=lambda s: s.get("seconds") or 0.0,
                           reverse=True)
                spans = spans[:max(1, len(spans) // 2)]
                truncated = True
        spans.sort(key=lambda s: s.get("start") or 0.0)
        return {"v": WIRE_VERSION, "spans": spans, "truncated": truncated}
    except Exception:
        return None


def _approx_wire_bytes(spans) -> int:
    """Cheap lower bound on the serialized payload size (fixed keys +
    ids + numbers ~= 150 bytes/span, plus the variable strings)."""
    total = 32
    for s in spans:
        n = 150 + len(str(s.get("name") or ""))
        err = s.get("error")
        if err:
            n += len(str(err))
        attrs = s.get("attrs")
        if isinstance(attrs, dict):
            for k, v in attrs.items():
                n += len(str(k)) + len(str(v)) + 8
        total += n
    return total


def _component(s: dict) -> str:
    """Critical-path component of one span.

    The taxonomy the walker attributes wall time to: stage spans become
    ``compile`` / ``prove/<stage>``, transport and lifecycle spans map
    by name, anything unrecognized is ``other`` (uncovered top-level
    time is ``queue-wait``, added by the walker itself).
    """
    attrs = s.get("attrs")
    stage = attrs.get("stage") if isinstance(attrs, dict) else None
    if stage:
        stage = str(stage)
        return "compile" if "compile" in stage else f"prove/{stage}"
    name = str(s.get("name") or "")
    if name == "prover.assign":
        return "assign"
    if name in ("prover.submit", "prover.store_proof"):
        return "transport"
    if name in ("proof.verify", "proof.audit") or name.startswith("aggregate"):
        return "verify"
    if name == "proof.settle":
        return "settle"
    if name.startswith("prover.") or name.startswith("bench."):
        return "prove"
    return "other"


def critical_path(trace: "dict | None") -> dict:
    """Blocking chain + per-component attribution of one merged trace.

    Pure and defensive: walks the plain-dict trace shape
    (``Tracer.get_trace`` output), never raises on partial or malformed
    spans, and attributes every second of the trace's wall
    [earliest start, latest end] to exactly ONE component, so the
    components sum to ``wallSeconds`` by construction — including for a
    hedged batch whose two prover subtrees overlap in time.

    The sweep cuts the wall at every span boundary; each segment is
    attributed to the DEEPEST span covering it (ties to the latest
    starter), i.e. the most specific thing actually running then.  A
    child may outlive its parent — the shipped ``prover.prove`` span
    runs long after its milliseconds-long ``prover.assign`` parent
    closed — and still claims its segments.  Segments nothing covers
    are ``queue-wait``.
    """
    tid = trace.get("traceId") if isinstance(trace, dict) else None
    raw = trace.get("spans") if isinstance(trace, dict) else None
    spans = [s for s in (raw or [])
             if isinstance(s, dict)
             and isinstance(s.get("start"), (int, float))
             and isinstance(s.get("seconds"), (int, float))]
    out = {"traceId": tid, "start": None, "wallSeconds": 0.0,
           "spanCount": len(spans), "components": {}, "chain": [],
           "sources": [], "partial": False}
    if not spans:
        return out

    def _end(s):
        return s["start"] + max(0.0, s["seconds"])

    ids: "dict[str, dict]" = {}
    for s in spans:
        sid = s.get("spanId")
        if isinstance(sid, str) and sid not in ids:
            ids[sid] = s

    def _depth(s):
        # orphans whose parent never reached the ring count as roots
        d = 0
        seen: set = set()
        cur = s
        while d < 64:
            sid = cur.get("spanId")
            if isinstance(sid, str):
                if sid in seen:
                    break  # cycle in wire data
                seen.add(sid)
            pid = cur.get("parentId")
            parent = ids.get(pid) if isinstance(pid, str) else None
            if parent is None or parent is cur:
                break
            d += 1
            cur = parent
        return d

    ranked = [((_depth(s), s["start"]), s) for s in spans]
    wall_lo = min(s["start"] for s in spans)
    wall_hi = max(_end(s) for s in spans)
    cuts = sorted({s["start"] for s in spans} | {_end(s) for s in spans})
    comps: "dict[str, float]" = {}
    chain: list = []
    for a, b in zip(cuts, cuts[1:]):
        if b - a <= 1e-9:
            continue
        mid = (a + b) / 2.0
        best = None
        for rank, s in ranked:
            if s["start"] <= mid < _end(s) \
                    and (best is None or rank > best[0]):
                best = (rank, s)
        if best is None:
            # nothing ran at all: scheduler / queue time, not on any span
            comps["queue-wait"] = comps.get("queue-wait", 0.0) + (b - a)
            continue
        sp = best[1]
        comp = _component(sp)
        comps[comp] = comps.get(comp, 0.0) + (b - a)
        last = chain[-1] if chain else None
        if last is not None and last["spanId"] == sp.get("spanId") \
                and abs(last["end"] - a) <= 1e-9:
            last["end"] = b  # same blocker continues across the cut
        else:
            chain.append({"spanId": sp.get("spanId"),
                          "name": sp.get("name"),
                          "component": comp,
                          "source": sp.get("source"),
                          "start": a, "end": b})
    out.update({
        "start": wall_lo,
        "wallSeconds": wall_hi - wall_lo,
        "components": dict(sorted(comps.items(),
                                  key=lambda kv: kv[1], reverse=True)),
        "chain": chain[:128],
        "sources": sorted({str(s.get("source") or "local") for s in spans}),
        "partial": not any(not s.get("parentId") for s in spans),
    })
    return out


def to_trace_events(trace: "dict | None") -> dict:
    """One merged trace as Chrome trace-event JSON (Perfetto-loadable).

    pid 1 is the local process (coordinator/sequencer spans); each
    remote span ``source`` gets its own pid with process_name metadata,
    so a hedged batch renders as two prover tracks.  Spans carrying a
    ``deviceLane`` attr (the parallel prover's mesh-slice jobs,
    prover/tpu_backend.py) render on a per-lane thread track
    ("device-lane N (k dev)") instead of tid 1, so slice concurrency
    and the idle bubbles between jobs are visible in Perfetto.
    Parent->child links that cross a pid — the submit seam — are
    emitted as flow events ("s"/"f") so the viewer draws the arrow
    across processes.  Never raises; malformed spans are skipped.
    """
    tid = trace.get("traceId") if isinstance(trace, dict) else None
    raw = trace.get("spans") if isinstance(trace, dict) else None
    spans = [s for s in (raw or [])
             if isinstance(s, dict)
             and isinstance(s.get("start"), (int, float))
             and isinstance(s.get("seconds"), (int, float))]
    events: list = []
    try:
        sources = sorted({s["source"] for s in spans
                          if isinstance(s.get("source"), str)})
        pids = {None: 1}
        for i, src in enumerate(sources):
            pids[src] = 2 + i
        for src, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            name = "local" if src is None else f"prover:{src}"
            events.append({"ph": "M", "pid": pid, "tid": 1, "ts": 0,
                           "name": "process_name", "args": {"name": name}})
            events.append({"ph": "M", "pid": pid, "tid": 1, "ts": 0,
                           "name": "thread_name", "args": {"name": "spans"}})

        def _pid(s):
            return pids.get(s.get("source")
                            if isinstance(s.get("source"), str) else None, 1)

        def _lane(s):
            attrs = s.get("attrs")
            lane = attrs.get("deviceLane") if isinstance(attrs, dict) \
                else None
            if isinstance(lane, (int, float)) and not isinstance(lane, bool) \
                    and 0 <= int(lane) < 4096:
                return int(lane)
            return None

        lane_meta = set()
        for s in spans:
            lane = _lane(s)
            if lane is None:
                continue
            key = (_pid(s), lane)
            if key in lane_meta:
                continue
            lane_meta.add(key)
            attrs = s.get("attrs") or {}
            ndev = attrs.get("laneDevices")
            label = f"device-lane {lane}"
            if isinstance(ndev, (int, float)) and ndev:
                label += f" ({int(ndev)} dev)"
            events.append({"ph": "M", "pid": key[0], "tid": 2 + lane,
                           "ts": 0, "name": "thread_name",
                           "args": {"name": label}})

        ids: "dict[str, dict]" = {}
        for s in spans:
            sid = s.get("spanId")
            if isinstance(sid, str) and sid not in ids:
                ids[sid] = s
        for s in spans:
            args = {"spanId": s.get("spanId"), "parentId": s.get("parentId"),
                    "status": s.get("status")}
            attrs = s.get("attrs")
            if isinstance(attrs, dict):
                args.update({str(k): _jsonable(v) for k, v in attrs.items()})
            lane = _lane(s)
            events.append({
                "ph": "X", "cat": "span",
                "name": str(s.get("name") or "?"),
                "pid": _pid(s), "tid": 1 if lane is None else 2 + lane,
                "ts": round(s["start"] * 1e6, 3),
                "dur": max(1.0, round(max(0.0, s["seconds"]) * 1e6, 3)),
                "args": args,
            })
        flow = 0
        for s in spans:
            parent = ids.get(s.get("parentId"))
            if parent is None or _pid(parent) == _pid(s):
                continue
            flow += 1
            events.append({"ph": "s", "cat": "flow", "name": "submit-seam",
                           "id": flow, "pid": _pid(parent), "tid": 1,
                           "ts": round(parent["start"] * 1e6, 3)})
            events.append({"ph": "f", "bp": "e", "cat": "flow",
                           "name": "submit-seam",
                           "id": flow, "pid": _pid(s), "tid": 1,
                           "ts": round(s["start"] * 1e6, 3)})
    except Exception:
        pass
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"traceId": tid}}


# ---------------------------------------------------------------------------
# Structured logging


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line; carries trace context when present."""

    def format(self, record):
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        cur = current()
        if cur:
            out["traceId"] = cur[0]
            if cur[1]:
                out["spanId"] = cur[1]
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup_logging(level: str = "info", json_mode: bool = False,
                  stream=None) -> logging.Logger:
    """Configure the ``ethrex_tpu_torch`` logger namespace.

    Idempotent: replaces any handler installed by a prior call.  Library
    modules log via ``logging.getLogger("ethrex_tpu_torch.<mod>")`` and route
    through here; nothing is written until this is called (or the root
    logger is otherwise configured), which keeps library imports silent.
    """
    root = logging.getLogger("ethrex_tpu_torch")
    handler = logging.StreamHandler(stream if stream is not None
                                    else sys.stderr)
    if json_mode:
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s"))
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    # propagation stays on: the root logger has no handlers in normal
    # CLI runs (no duplicate output), and pytest's caplog attaches there
    return root
