"""Prometheus metrics (parity target: upstream ethrex's ethrex-metrics
crate, crates/blockchain/metrics — text exposition format, stdlib only):
the part of `ethrex_tpu/utils/metrics.py` that the prover process
reaches.  The registry (`Metrics`, `METRICS`) is copied whole; of the
recorders only those that the proof client, the phase checkpoints, the
runtime-error guard, the backend and the tracer call.  The node's
recorders and the HTTP exporter (`MetricsServer`) are not copied."""

from __future__ import annotations

import threading
import time

# Fixed exponential buckets: 1ms * 2^i, spanning ~1ms .. ~524s.  One
# shared ladder keeps every latency histogram comparable and the
# exposition size bounded.
DEFAULT_BUCKETS = tuple(0.001 * 2 ** i for i in range(20))

# Label sets one family may hold (mirrors the profiler's MAX_KEYS):
# adversarial reject reasons or per-air labels cannot grow the
# exposition unboundedly; overflow series are dropped and counted in
# metrics_dropped_label_sets_total.
MAX_LABEL_SETS = 512


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: tuple) -> str:
    return ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)


def _fmt_le(le) -> str:
    """Canonical shortest-float bucket boundary: coerce to float first so
    numpy scalars / ints / Decimals all render identically ("0.004",
    "5.0"), keeping le labels stable and joinable across scrapes."""
    return repr(float(le))


class _Histogram:
    """One named histogram family: per-labelset bucket counts + sum."""

    __slots__ = ("buckets", "series", "exemplars")

    def __init__(self, buckets):
        self.buckets = tuple(sorted(buckets))
        # labels tuple -> [bucket counts..., +Inf count, sum]
        self.series: dict[tuple, list] = {}
        # (labels tuple, bucket index) -> (trace_id, value): the most
        # recent exemplar observed into that bucket, rendered in
        # OpenMetrics exemplar syntax so a tail bucket links straight to
        # a loadable trace (docs/OBSERVABILITY.md "Distributed tracing")
        self.exemplars: dict[tuple, tuple] = {}

    def observe(self, value: float, labels: tuple, exemplar=None):
        row = self.series.get(labels)
        if row is None:
            row = [0] * (len(self.buckets) + 1) + [0.0]
            self.series[labels] = row
        landed = len(self.buckets)       # +Inf unless a bucket matches
        for i, le in enumerate(self.buckets):
            if value <= le:
                row[i] += 1
                landed = min(landed, i)
        row[len(self.buckets)] += 1      # +Inf == total count
        row[-1] += value                 # running sum
        if exemplar:
            self.exemplars[(labels, landed)] = (str(exemplar), float(value))


class Metrics:
    """Process-wide metric registry (counters + gauges + histograms)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        # labelled counter families: name -> {sorted labels tuple: value}
        self.lcounters: dict[str, dict[tuple, float]] = {}
        # labelled gauge families: name -> {sorted labels tuple: value}
        self.lgauges: dict[str, dict[tuple, float]] = {}
        self.histograms: dict[str, _Histogram] = {}
        self.help: dict[str, str] = {}
        self.started = time.time()

    def inc(self, name: str, value: float = 1.0, help_text: str = ""):
        with self.lock:
            self.counters[name] = self.counters.get(name, 0.0) + value
            if help_text:
                self.help[name] = help_text

    def set(self, name: str, value: float, help_text: str = ""):
        with self.lock:
            self.gauges[name] = value
            if help_text:
                self.help[name] = help_text

    def _clamped(self, fam: dict, key: tuple) -> bool:
        """Caller holds the lock.  True when a NEW label set would push
        one family past MAX_LABEL_SETS: the series is dropped (existing
        series keep updating) and the drop is counted."""
        if key in fam or len(fam) < MAX_LABEL_SETS:
            return False
        self.counters["metrics_dropped_label_sets_total"] = \
            self.counters.get("metrics_dropped_label_sets_total", 0.0) + 1
        self.help.setdefault(
            "metrics_dropped_label_sets_total",
            "Series dropped by the per-family label-set clamp "
            "(MAX_LABEL_SETS) — cardinality protection against "
            "unbounded label values")
        return True

    def inc_labeled(self, name: str, labels: dict, value: float = 1.0,
                    help_text: str = ""):
        """Increment one series of a labelled counter family (e.g.
        per-reason mempool rejections)."""
        key = tuple(sorted((labels or {}).items()))
        with self.lock:
            fam = self.lcounters.setdefault(name, {})
            if self._clamped(fam, key):
                return
            fam[key] = fam.get(key, 0.0) + float(value)
            if help_text:
                self.help[name] = help_text

    def set_labeled(self, name: str, labels: dict, value: float,
                    help_text: str = ""):
        """Set one series of a labelled gauge family (e.g. per-kernel
        roofline gauges, prover_kernel_flops{air,stage})."""
        key = tuple(sorted((labels or {}).items()))
        with self.lock:
            fam = self.lgauges.setdefault(name, {})
            if self._clamped(fam, key):
                return
            fam[key] = float(value)
            if help_text:
                self.help[name] = help_text

    def observe(self, name: str, value: float,
                labels: dict | None = None, help_text: str = "",
                buckets=DEFAULT_BUCKETS, exemplar: str | None = None):
        """Record one observation into a labelled histogram.

        ``exemplar`` optionally attaches a trace ID to the bucket this
        value lands in, surfaced in OpenMetrics exemplar syntax by
        ``render`` so tail buckets link to a loadable trace."""
        key = tuple(sorted((labels or {}).items()))
        with self.lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = _Histogram(buckets)
            if self._clamped(hist.series, key):
                return
            hist.observe(float(value), key, exemplar=exemplar)
            if help_text:
                self.help[name] = help_text

    def snapshot(self) -> dict:
        """Point-in-time plain-data copy of the registry (JSON-safe).

        The time-series engine samples this periodically; histogram rows
        keep the cumulative-per-bucket layout so window deltas can be
        taken bucket-by-bucket."""
        with self.lock:
            hists = {}
            for name, hist in self.histograms.items():
                nb = len(hist.buckets)
                hists[name] = {
                    "buckets": [float(b) for b in hist.buckets],
                    "series": [
                        {"labels": dict(labels),
                         "counts": [int(c) for c in row[:nb + 1]],
                         "sum": float(row[-1])}
                        for labels, row in hist.series.items()],
                }
            return {"ts": time.time(),
                    "counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "labeled_counters": {
                        name: [{"labels": dict(labels), "value": value}
                               for labels, value in fam.items()]
                        for name, fam in self.lcounters.items()},
                    "labeled_gauges": {
                        name: [{"labels": dict(labels), "value": value}
                               for labels, value in fam.items()]
                        for name, fam in self.lgauges.items()},
                    "histograms": hists}

    def reset(self):
        """Drop every series and restart the uptime clock (test isolation
        and simulated process restarts)."""
        with self.lock:
            self.counters.clear()
            self.gauges.clear()
            self.lcounters.clear()
            self.lgauges.clear()
            self.histograms.clear()
            self.help.clear()
            self.started = time.time()

    def _render_histograms(self, lines: list):
        for name, hist in sorted(self.histograms.items()):
            if name in self.help:
                lines.append(f"# HELP {name} {self.help[name]}")
            lines.append(f"# TYPE {name} histogram")
            nb = len(hist.buckets)
            for labels, row in sorted(hist.series.items()):
                base = _fmt_labels(labels)
                sep = "," if base else ""

                def _ex(i, labels=labels):
                    # OpenMetrics exemplar: `... 5 # {trace_id="x"} 0.23`
                    # (no timestamp — keeps goldens and diffs stable)
                    ex = hist.exemplars.get((labels, i))
                    if not ex:
                        return ""
                    return (f' # {{trace_id="{_escape_label(ex[0])}"}}'
                            f" {ex[1]}")

                for i, le in enumerate(hist.buckets):
                    lines.append(
                        f'{name}_bucket{{{base}{sep}le="{_fmt_le(le)}"}} '
                        f"{row[i]}{_ex(i)}")
                lines.append(
                    f'{name}_bucket{{{base}{sep}le="+Inf"}} '
                    f"{row[nb]}{_ex(nb)}")
                brace = f"{{{base}}}" if base else ""
                lines.append(f"{name}_sum{brace} {row[-1]}")
                lines.append(f"{name}_count{brace} {row[nb]}")

    def render(self) -> str:
        with self.lock:
            lines = []
            for name, value in sorted(self.counters.items()):
                if name in self.help:
                    lines.append(f"# HELP {name} {self.help[name]}")
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {value}")
            for name, fam in sorted(self.lcounters.items()):
                if name in self.help:
                    lines.append(f"# HELP {name} {self.help[name]}")
                lines.append(f"# TYPE {name} counter")
                for labels, value in sorted(fam.items()):
                    lines.append(f"{name}{{{_fmt_labels(labels)}}} {value}")
            for name, value in sorted(self.gauges.items()):
                if name in self.help:
                    lines.append(f"# HELP {name} {self.help[name]}")
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {value}")
            for name, fam in sorted(self.lgauges.items()):
                if name in self.help:
                    lines.append(f"# HELP {name} {self.help[name]}")
                lines.append(f"# TYPE {name} gauge")
                for labels, value in sorted(fam.items()):
                    lines.append(f"{name}{{{_fmt_labels(labels)}}} {value}")
            self._render_histograms(lines)
            lines.append("# TYPE process_uptime_seconds gauge")
            lines.append(
                f"process_uptime_seconds {time.time() - self.started}")
            return "\n".join(lines) + "\n"


METRICS = Metrics()  # global registry, like the reference's statics


def record_poll_error():
    METRICS.inc("prover_poll_errors_total", 1,
                "Prover client poll passes that failed on an endpoint")


def record_breaker(open_count: int, transition: bool = False):
    METRICS.set("prover_breaker_open", open_count,
                "Coordinator endpoints currently skipped by an open "
                "circuit breaker")
    if transition:
        METRICS.inc("prover_breaker_transitions_total", 1,
                    "Circuit breaker state transitions "
                    "(closed/open/half-open)")


def record_submit_rejected():
    METRICS.inc("prover_submit_rejections_total", 1,
                "Proof submits the coordinator rejected at the "
                "application level (endpoint healthy; not a breaker "
                "failure)")


def record_phase_resume(phase: str):
    METRICS.inc("prover_phase_resumes_total", 1,
                "Completed prove phases skipped on restart: loaded from "
                "an on-disk phase checkpoint instead of re-proven")
    METRICS.inc_labeled("prover_phase_resumes_by_phase", {"phase": phase},
                        1, help_text="Checkpoint-resumed prove phases by "
                        "phase name (which phase a restarted prover "
                        "picked up from)")


def record_nan_poison(phase: str):
    METRICS.inc("prover_nan_poison_total", 1,
                "Prove phases whose outputs were non-finite or out of "
                "field: the batch is quarantined immediately, never "
                "retried")


def _observe_safe(name, value, labels, help_text, exemplar=None):
    # Telemetry sits inside hot/traced paths; it must never raise there.
    try:
        METRICS.observe(name, value, labels, help_text, exemplar=exemplar)
    except Exception:
        pass


def record_trace_ingest(added: int, dropped: int = 0):
    if added:
        METRICS.inc("trace_spans_ingested_total", added,
                    "Remote spans merged into the local trace ring "
                    "(span shipping over ProofSubmit/Heartbeat)")
    if dropped:
        METRICS.inc("trace_spans_ingest_dropped_total", dropped,
                    "Shipped spans dropped at ingestion: malformed, "
                    "over the per-source cap, or over the per-trace "
                    "span budget")


def observe_prover_stage(stage: str, seconds: float):
    _observe_safe("prover_stage_seconds", seconds, {"stage": stage},
                  "Per-stage prover latency (torch.cuda.synchronize-bounded "
                  "on the card)")


def record_proof_wall(seconds: float):
    """Derive the proofs_per_hour throughput gauge from one end-to-end
    backend prove wall-clock."""
    if seconds > 0:
        METRICS.set("proofs_per_hour", 3600.0 / seconds,
                    "Extrapolated proofs per hour from the last "
                    "end-to-end backend prove wall-clock")
