"""Continuous stage-attribution profiler: the stage accumulator of
`ethrex_tpu/perf/profiler.py`.

One process-wide accumulator keyed (component, stage): every timed leg
of the prover and the block import path lands here, either directly
(``record_stage`` from the import and payload hot paths) or through the
tracing observer installed below (the prover's stage spans flow in with
no change to the prover).

Components:

- ``stark``    — the DEEP-FRI phase stages (trace_lde, merkle_commit,
                 quotient, openings, fri_fold, query)
- ``prover``   — the backend's coarse pipeline stages (execute,
                 state_proof, vm_circuits, binding, aggregate,
                 groth16_wrap)
- ``l1_import``— execute / merkleize / store_write legs of add_block
                 and the pipelined importer
- ``evm``      — the batched sender recovery (sig_recovery)
- ``payload``  — the block producer's drain / select / execute /
                 merkleize / seal / prewarm

Contract: ``record`` is a dict update under one lock (~1us) and NEVER
raises; with nothing recording the profiler costs nothing.  The
reference's opt-in trace capture (``configure`` / ``capture``) is not
copied.
"""

from __future__ import annotations

import threading
import time

# bound on distinct (component, stage) keys — runaway-cardinality guard
MAX_KEYS = 512

# tracing-span stage -> component for the observer (spans carry a stage
# attr but no component; the split mirrors where each span lives)
_STARK_STAGES = frozenset(
    ("trace_lde", "merkle_commit", "quotient", "openings", "fri_fold",
     "query"))
_BACKEND_STAGES = frozenset(
    ("execute", "state_proof", "vm_circuits", "binding", "aggregate",
     "groth16_wrap"))


class StageProfiler:
    """Thread-safe (component, stage) -> count/total/max/last wall-clock
    accumulator."""

    def __init__(self):
        self._lock = threading.Lock()
        # (component, stage) -> [count, total, max, last, last_ts]
        self._cells: dict[tuple[str, str], list] = {}
        self.dropped = 0

    def record(self, component: str, stage: str, seconds: float) -> None:
        try:
            key = (str(component), str(stage))
            sec = float(seconds)
            now = time.time()
            with self._lock:
                cell = self._cells.get(key)
                if cell is None:
                    if len(self._cells) >= MAX_KEYS:
                        self.dropped += 1
                        return
                    self._cells[key] = [1, sec, sec, sec, now]
                    return
                cell[0] += 1
                cell[1] += sec
                if sec > cell[2]:
                    cell[2] = sec
                cell[3] = sec
                cell[4] = now
        except Exception:
            pass

    def stage_totals(self, component: str) -> dict[str, float]:
        """{stage: total seconds} for one component (bench attribution
        takes before/after deltas of this)."""
        with self._lock:
            return {stage: cell[1]
                    for (comp, stage), cell in self._cells.items()
                    if comp == component}

    def tree(self) -> dict:
        """The attribution tree: component -> stages with count / total /
        mean / max / last / share-of-component."""
        with self._lock:
            cells = {k: list(v) for k, v in self._cells.items()}
            dropped = self.dropped
        out: dict = {}
        for (comp, stage), (count, total, mx, last, last_ts) in \
                sorted(cells.items()):
            node = out.setdefault(
                comp, {"totalSeconds": 0.0, "stages": {}})
            node["totalSeconds"] += total
            node["stages"][stage] = {
                "count": count,
                "totalSeconds": round(total, 6),
                "meanSeconds": round(total / count, 6) if count else 0.0,
                "maxSeconds": round(mx, 6),
                "lastSeconds": round(last, 6),
                "lastTs": last_ts,
            }
        for node in out.values():
            tot = node["totalSeconds"]
            node["totalSeconds"] = round(tot, 6)
            for st in node["stages"].values():
                st["share"] = round(st["totalSeconds"] / tot, 4) \
                    if tot > 0 else 0.0
        return {"components": out, "droppedKeys": dropped}

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
            self.dropped = 0


PROFILER = StageProfiler()


def record_stage(component: str, stage: str, seconds: float) -> None:
    """Module-level hook used by the import/EVM/trie hot paths.  Never
    raises (hot-path contract)."""
    PROFILER.record(component, stage, seconds)


def _span_observer(name, stage, seconds):
    """Fold tracing stage spans into the attribution tree.  Stage names
    unknown to the static maps land under component 'other' so a new
    span is visible the day it ships."""
    if stage in _STARK_STAGES:
        PROFILER.record("stark", stage, seconds)
    elif stage in _BACKEND_STAGES or stage.startswith("vm_circuits/"):
        # per-slice vm_circuits/<air> spans (parallel mesh proving)
        # attribute to the prover component alongside the aggregate
        PROFILER.record("prover", stage, seconds)
    else:
        PROFILER.record("other", stage, seconds)


def _install() -> None:
    from ..utils import tracing

    if _span_observer not in tracing.STAGE_OBSERVERS:
        tracing.STAGE_OBSERVERS.append(_span_observer)


try:
    _install()
except Exception:
    pass
