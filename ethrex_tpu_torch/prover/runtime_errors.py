"""Runtime-error taxonomy, phase guard and memory gate of the prover on one
CUDA card: the port of `ethrex_tpu/prover/runtime_errors.py`.

A crash inside `GpuBackend.prove` is classified by what the runtime
threw, and each class is routed differently:

    oom          `torch.cuda.OutOfMemoryError`, "CUDA out of memory", a
                 launch that reports cudaErrorMemoryAllocation, a host
                 MemoryError, or the memory gate's refusal below.
    device_lost  an error that poisons the process's CUDA context: an
                 illegal memory access, an unspecified launch failure, a
                 device-side assert, an uncorrectable ECC error (or a
                 launch that reports one of their codes), a kernel that
                 fails to build, or the injected `device.lost` fault.
                 Every later CUDA call of the process fails as well, so
                 no retry in this process can help: the phase raises out
                 of `prove`, the proof client stops, and the restarted
                 process resumes from the phase checkpoints
                 (prover/checkpoint), which bound the loss to the phase
                 in flight.
    nan_poison   a phase produced out-of-field or non-finite outputs: the
                 batch is poisoned, not the runtime; quarantined on the
                 first report, zero retries.
    unknown      everything else propagates unchanged.

One card, one rung.  The reference walks a degradation ladder (half the
mesh, one device, then the CPU); on one card there is no smaller layout
below the card, and no rung is the CPU.  So a transient class (`oom`,
`device_lost`) is raised as TransientPhaseError, never retried on the
same context and never carried on elsewhere.  `memory_gate` refuses a
STARK whose estimated working set does not fit the card's free memory
before any of its kernels launch, instead of letting it OOM mid-proof.
"""

from __future__ import annotations

import re
import threading

from ..ops import babybear as bb
from ..utils import faults

_LOCK = threading.Lock()
STATS = {"nan_poisons": 0, "phase_resumes": 0, "transient_failures": 0,
         "memory_gate_refusals": 0}

_OOM_MARKERS = ("out of memory", "out_of_memory", "failed to allocate",
                "allocation failure", "resource_exhausted")
_DEVICE_LOST_MARKERS = ("device.lost", "device lost", "device_lost",
                        "illegal memory access", "illegal address",
                        "unspecified launch failure", "launch failure",
                        "device-side assert", "uncorrectable ecc",
                        "ecc error", "misaligned address",
                        "illegal instruction", "nvcc failed",
                        "nvcc link failed", "nvcc not found")
# cudaError_t codes a kernel wrapper reports ("CUDA kernel <entry> failed
# with error <code>", kernels.check): cudaErrorMemoryAllocation, and the
# sticky errors that leave the context unusable
_OOM_CODES = {2}
_DEVICE_LOST_CODES = {214, 700, 702, 709, 710, 714, 715, 716, 717, 718,
                      719}
_CODE_RE = re.compile(r"failed with error (\d+)")
# the share of the device's free memory a STARK's estimated working set
# may fill (the reference's default headroom)
GATE_HEADROOM = 0.8


class NanPoisonError(RuntimeError):
    """A phase emitted non-finite / out-of-field values: the batch is
    poisoned, not the runtime.  Carries the offending phase so the
    quarantine reason names it."""

    def __init__(self, phase: str, detail: str = ""):
        self.phase = phase
        self.detail = detail
        super().__init__(
            f"non-finite/out-of-field output in phase {phase!r}"
            + (f": {detail}" if detail else ""))


class TransientPhaseError(RuntimeError):
    """A phase failed with a transient class (`oom` / `device_lost`).  On
    one card it is raised out of the prove: an `oom` the gate let
    through does not fit this card, a `device_lost` leaves the process's
    CUDA context unusable."""

    def __init__(self, kind: str, phase: str, cause: BaseException):
        self.kind = kind
        self.phase = phase
        self.cause = cause
        super().__init__(f"{kind} in phase {phase!r}: {cause}")


def classify(exc: BaseException) -> str:
    """Map an exception from a device phase onto the taxonomy."""
    import torch

    if isinstance(exc, NanPoisonError):
        return "nan_poison"
    if isinstance(exc, TransientPhaseError):
        return exc.kind
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        return "oom"
    msg = str(exc).lower()
    code = _CODE_RE.search(msg)
    if code is not None:
        if int(code.group(1)) in _OOM_CODES:
            return "oom"
        if int(code.group(1)) in _DEVICE_LOST_CODES:
            return "device_lost"
    for marker in _OOM_MARKERS:
        if marker in msg:
            return "oom"
    for marker in _DEVICE_LOST_MARKERS:
        if marker in msg:
            return "device_lost"
    return "unknown"


def _walk_values(value):
    """Yield every scalar or array reachable in a phase-artifact
    structure."""
    import numpy as np
    import torch

    if isinstance(value, dict):
        for v in value.values():
            yield from _walk_values(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _walk_values(v)
    elif isinstance(value, torch.Tensor):
        yield value.detach().cpu().numpy()
    elif isinstance(value, np.ndarray):
        yield value
    elif isinstance(value, (int, float, np.integer, np.floating)):
        yield value


def check_phase_outputs(phase: str, arts) -> None:
    """Validate the host-visible artifacts of a completed phase: every
    field element in [0, P), every float finite.  An int32 field tensor
    cannot hold a NaN, so the range check is the one that bites.  A
    violation is a poisoned batch, raised as NanPoisonError."""
    import numpy as np

    if isinstance(arts, dict) and arts.get("__corrupt__"):
        _note_nan_poison(phase)
        raise NanPoisonError(phase, "corrupted artifact envelope")
    for v in _walk_values(arts):
        if isinstance(v, np.ndarray):
            if np.issubdtype(v.dtype, np.floating):
                if not np.all(np.isfinite(v)):
                    _note_nan_poison(phase)
                    raise NanPoisonError(phase, "non-finite array value")
            elif np.issubdtype(v.dtype, np.integer) and v.size:
                if int(v.min()) < 0 or int(v.max()) >= bb.P:
                    _note_nan_poison(phase)
                    raise NanPoisonError(phase, "out-of-field array value")
        elif isinstance(v, (float, np.floating)):
            if v != v or v in (float("inf"), float("-inf")):
                _note_nan_poison(phase)
                raise NanPoisonError(phase, "non-finite value")
        elif not 0 <= int(v) < bb.P:
            _note_nan_poison(phase)
            raise NanPoisonError(phase, "out-of-field value")


def guard_phase(phase: str, air_name: str, fn):
    """Run one device phase under the fault legs and the taxonomy.

    Fires the `backend.phase` error/delay legs and the `device.lost`
    site on entry, then classifies anything `fn` raises: the transient
    classes come out as TransientPhaseError (raised, not retried: on
    one card there is no other rung, and a poisoned context fails every
    retry), poison and unknown classes propagate as they are.  Stamps
    the in-flight phase on the active batch context so heartbeats
    report it."""
    from . import checkpoint

    ctx = checkpoint.current_context()
    if ctx is not None:
        job = checkpoint.current_job()
        ctx.set_phase(f"{job}.{phase}" if job else phase)
    try:
        faults.inject("backend.phase", {"phase": phase, "air": air_name},
                      kinds=("error", "delay"))
        faults.inject("device.lost")
        return fn()
    except (NanPoisonError, TransientPhaseError):
        raise
    except Exception as exc:
        kind = classify(exc)
        if kind in ("oom", "device_lost"):
            with _LOCK:
                STATS["transient_failures"] += 1
            raise TransientPhaseError(kind, phase, exc) from exc
        raise


def screen_outputs(phase: str, arts):
    """The nan/corrupt leg: offer the phase's host artifacts to the
    `backend.phase` corrupt rules, then range-check what (possibly
    mangled) came back.  Returns the artifacts for downstream use."""
    arts = faults.inject("backend.phase", arts, kinds=("corrupt", "torn"))
    check_phase_outputs(phase, arts)
    return arts


def note_resume(phase: str) -> None:
    """One completed phase skipped on restart (loaded from checkpoint)."""
    with _LOCK:
        STATS["phase_resumes"] += 1
    from ..utils.metrics import record_phase_resume

    record_phase_resume(phase)
    from . import checkpoint

    ctx = checkpoint.current_context()
    if ctx is not None:
        with ctx.lock:
            ctx.resumes += 1


def _note_nan_poison(phase: str) -> None:
    with _LOCK:
        STATS["nan_poisons"] += 1
    from ..utils.metrics import record_nan_poison

    record_nan_poison(phase)


# -- pre-prove memory gate --------------------------------------------------

def stark_bytes(n: int, width: int, log_blowup: int, num_periodic: int = 0,
                num_boundaries: int = 0) -> int:
    """Device bytes a STARK of trace (n, width) holds at once in
    `stark/prover.py` at blowup 2^log_blowup (N = n 2^log_blowup LDE
    points, int32 words): the trace's columns (w n) and its LDE (w N);
    the tables (periodic columns, the divisor inverses of every coset
    class, the last row and each boundary, the domain points and x -
    g^(n-1): (P + B + 3 + nb) N); both Merkle trees (2 x 8 x 2N); the
    quotient's LDE (4 B N) and its three (N, 4) temporaries; the DEEP
    step's two column sums (8 N).  It reads the shape alone: no kernel
    runs to make it."""
    B = 1 << log_blowup
    N = n << log_blowup
    words = (width * n + width * N
             + (num_periodic + B + 3 + num_boundaries) * N
             + 2 * 8 * 2 * N + 4 * B * N + 3 * 4 * N + 8 * N)
    return 4 * words


def _available_bytes(device):
    """Free memory of `device` for the prover: the driver's free bytes
    plus what PyTorch's caching allocator holds but does not use; None
    off the card (the CPU reports no limit)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev)
               - torch.cuda.memory_allocated(dev))


def memory_gate(air_name: str, device, est_bytes: int, avail_fn=None):
    """Refuse a STARK BEFORE an OOM: if its estimated working set exceeds
    GATE_HEADROOM of the free memory of `device`, raise
    TransientPhaseError("oom", "memory_gate", ...) before any of its
    kernels launch.  One card has no smaller rung to move to, and the
    CPU is no rung.  Passes when the device reports no limit."""
    avail = (avail_fn or _available_bytes)(device)
    if avail is None or est_bytes <= GATE_HEADROOM * avail:
        return
    with _LOCK:
        STATS["memory_gate_refusals"] += 1
    raise TransientPhaseError("oom", "memory_gate", MemoryError(
        f"{air_name}: estimated {est_bytes} bytes > {GATE_HEADROOM} x "
        f"{avail} free bytes on {device}"))


def reset_stats() -> None:
    """Test hook: zero the module counters."""
    with _LOCK:
        for key in STATS:
            STATS[key] = 0
