"""Phase-level proof checkpoints: crash-only proving for `GpuBackend`, the
port of `ethrex_tpu/prover/checkpoint.py`.

A prove is a sequence of device phases (execute -> per-AIR
commit/quotient/open/fri -> binding/aggregate) stitched together by a
host Fiat-Shamir transcript.  Each completed phase persists ONE
content-addressed envelope here — the phase's host-visible artifacts,
numpy copies of the device tensors the later phases consume, and a
snapshot of the transcript sponge — so a restarted `ProverClient`
holding a *fresh lease for the same batch* replays the transcript from
the last completed phase instead of re-proving from scratch.  Bounded
loss is <= 1 phase (the one in flight when the process died, or when a
poisoned CUDA context ended it) and the resumed proof is byte-identical:
all arithmetic is exact and the sponge snapshot pins every later
challenge.

Key schema: an entry's filename is the SHA-256 over the JSON-canonical
key parts — batch id, job name, AIR cache key, trace shape, STARK
params, phase — joined with the environment half (`fingerprint()`: the
torch and CUDA versions and a sha256 over the package's `.py` and
`csrc/` sources).  The lease token is recorded as envelope metadata,
NOT key material: a restarted client always holds a fresh token for the
same batch.

Records are written atomically (tempfile + os.replace) and framed as
MAGIC | crc32 | length | pickle-blob; a torn, truncated or garbage
blob fails the frame check and is discarded for a clean fresh prove
(`proof_ckpt_discards_total`) — the loader never raises.

A full-width batch writes large envelopes: the commit phase alone holds
the trace's LDE (width x n x blowup int32 words) and its Merkle tree.

Env knobs (as the reference's):
  ETHREX_PROOF_CKPT_DIR  checkpoint directory (default
                         <tmp>/ethrex_tpu_torch_proof_ckpt_<fingerprint>,
                         never the reference's directory)
  ETHREX_PROOF_CKPT_OFF  "1" disables checkpoint stores and loads
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import tempfile
import threading
import time
import zlib

_SCHEMA = 1
_MAGIC = b"ETPC"
_SUFFIX = ".ckpt"

_LOCK = threading.Lock()
_CONFIGURED_DIR: str | None = None
STATS = {"stores": 0, "loads": 0, "discards": 0}

# The per-thread prove context: ProverClient activates one around
# backend.prove, on the thread that proves (threading.local does not
# cross threads, same re-entry discipline as tracing.trace_context).
_TLS = threading.local()


class BatchContext:
    """Mutable per-batch prove state shared between the prove thread and
    the heartbeat thread: identity (batch id + the lease token that
    granted this attempt) and the in-flight phase for heartbeat stamping
    (the heartbeat thread reads it, never a CUDA tensor)."""

    def __init__(self, batch_id, lease_token=None):
        self.batch_id = batch_id
        self.lease_token = lease_token
        self.lock = threading.Lock()
        self.phase: str | None = None
        self.phase_started: float | None = None
        self.resumes = 0

    def set_phase(self, phase: str | None) -> None:
        with self.lock:
            if phase != self.phase:
                self.phase = phase
                self.phase_started = time.time()

    def snapshot(self) -> dict:
        """Heartbeat-safe copy of the advisory fields."""
        with self.lock:
            return {"phase": self.phase,
                    "phase_started": self.phase_started}


def current_context() -> BatchContext | None:
    return getattr(_TLS, "ctx", None)


def current_job() -> str | None:
    return getattr(_TLS, "job", None)


@contextlib.contextmanager
def batch_context(batch_id, lease_token=None):
    """Open (or reopen, after a restart) the checkpointed prove of one
    batch on this thread.  The yielded context carries the advisory
    state the heartbeat thread reports (the in-flight phase)."""
    prev = getattr(_TLS, "ctx", None)
    ctx = _TLS.ctx = BatchContext(batch_id, lease_token=lease_token)
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


@contextlib.contextmanager
def job_scope(job: str):
    """Name the prove job (state_proof / vm_circuits/TransferAir /
    binding / ...) for every checkpoint written under it."""
    prev = getattr(_TLS, "job", None)
    _TLS.job = job
    try:
        yield
    finally:
        _TLS.job = prev


# -- store layout -----------------------------------------------------------

def set_checkpoint_dir(path: str | None) -> None:
    """Explicit directory override (tests); beats the env knob."""
    global _CONFIGURED_DIR
    with _LOCK:
        _CONFIGURED_DIR = path


def checkpoint_dir() -> str:
    with _LOCK:
        configured = _CONFIGURED_DIR
    if configured:
        return configured
    env = os.environ.get("ETHREX_PROOF_CKPT_DIR")
    if env:
        return env
    return os.path.join(tempfile.gettempdir(),
                        f"ethrex_tpu_torch_proof_ckpt_{fingerprint()}")


_FINGERPRINT: str | None = None


def _env_parts() -> dict:
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda}


def fingerprint() -> str:
    """The environment half of every key: the torch and CUDA versions and
    a sha256 over the package's `.py` and `csrc/` sources (a change to
    what the prover computes invalidates every envelope).  Computed once
    a process."""
    global _FINGERPRINT
    with _LOCK:
        if _FINGERPRINT is not None:
            return _FINGERPRINT
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256(json.dumps(_env_parts(), sort_keys=True).encode())
    for root, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        rel = os.path.relpath(root, pkg)
        for name in sorted(files):
            if name.endswith(".py") or rel.split(os.sep)[0] == "csrc":
                h.update(os.path.join(rel, name).encode())
                with open(os.path.join(root, name), "rb") as f:
                    h.update(hashlib.sha256(f.read()).digest())
    fp = h.hexdigest()[:16]
    with _LOCK:
        _FINGERPRINT = fp
    return fp


def enabled() -> bool:
    return os.environ.get("ETHREX_PROOF_CKPT_OFF") != "1"


def record_ckpt_store() -> None:
    from ..utils.metrics import METRICS

    METRICS.inc("proof_ckpt_stores_total", 1,
                "Proof phase checkpoints persisted: completed prove "
                "phases a restarted prover can resume from")


def record_ckpt_load() -> None:
    from ..utils.metrics import METRICS

    METRICS.inc("proof_ckpt_loads_total", 1,
                "Proof phase checkpoints loaded on resume: phases "
                "skipped instead of re-proven after a restart")


def record_ckpt_discard() -> None:
    from ..utils.metrics import METRICS

    METRICS.inc("proof_ckpt_discards_total", 1,
                "Proof phase checkpoints discarded as torn, truncated "
                "or garbage: the prove falls back to a fresh run")


def _batch_dir(batch_id) -> str:
    tag = hashlib.sha256(repr(batch_id).encode()).hexdigest()[:16]
    return os.path.join(checkpoint_dir(), f"batch_{tag}")


def _entry_path(batch_id, parts: dict) -> str:
    key = {"schema": _SCHEMA, "parts": parts,
           "env": {"code": fingerprint(), **_env_parts()}}
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"),
                      default=str)
    digest = hashlib.sha256(blob.encode()).hexdigest()
    return os.path.join(_batch_dir(batch_id), digest + _SUFFIX)


def store(batch_id, parts: dict, payload, meta: dict | None = None) -> bool:
    """Persist one phase envelope; atomic and never raises.  Returns
    True when the record landed."""
    if not enabled():
        return False
    try:
        blob = pickle.dumps({"schema": _SCHEMA, "parts": parts,
                             "meta": dict(meta or {}), "payload": payload},
                            protocol=pickle.HIGHEST_PROTOCOL)
        frame = (_MAGIC + zlib.crc32(blob).to_bytes(4, "big")
                 + len(blob).to_bytes(8, "big") + blob)
        path = _entry_path(batch_id, parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(frame)
            os.replace(tmp, path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        with _LOCK:
            STATS["stores"] += 1
        record_ckpt_store()
        return True
    except Exception:
        return False


def load(batch_id, parts: dict):
    """Load one phase envelope's payload, or None.  A torn/garbage blob
    is unlinked and counted (`proof_ckpt_discards_total`) — the caller
    simply re-proves the phase; this never raises."""
    if not enabled():
        return None
    path = _entry_path(batch_id, parts)
    try:
        with open(path, "rb") as f:
            frame = f.read()
    except OSError:
        return None
    try:
        if frame[:4] != _MAGIC or len(frame) < 16:
            raise ValueError("bad magic")
        crc = int.from_bytes(frame[4:8], "big")
        length = int.from_bytes(frame[8:16], "big")
        blob = frame[16:]
        if len(blob) != length or zlib.crc32(blob) != crc:
            raise ValueError("torn record")
        rec = pickle.loads(blob)
        if rec.get("schema") != _SCHEMA or rec.get("parts") != parts:
            raise ValueError("key mismatch")
        with _LOCK:
            STATS["loads"] += 1
        record_ckpt_load()
        return rec["payload"]
    except Exception:
        with contextlib.suppress(OSError):
            os.unlink(path)
        with _LOCK:
            STATS["discards"] += 1
        record_ckpt_discard()
        return None


def complete(batch_id) -> None:
    """Drop every checkpoint of a settled batch (proof accepted): the
    envelope is recovery state, not an artifact."""
    bdir = _batch_dir(batch_id)
    try:
        names = os.listdir(bdir)
    except OSError:
        return
    for name in names:
        with contextlib.suppress(OSError):
            os.unlink(os.path.join(bdir, name))
    with contextlib.suppress(OSError):
        os.rmdir(bdir)


def runtime_stats() -> dict:
    """Live view for ethrex_health (l2.prover.runtime.checkpoints)."""
    with _LOCK:
        out = dict(STATS)
    out["enabled"] = enabled()
    try:
        out["batches"] = sum(
            1 for n in os.listdir(checkpoint_dir())
            if n.startswith("batch_"))
    except OSError:
        out["batches"] = 0
    return out


class PhaseStore:
    """Checkpoint handle for one job's phase sequence: fixes the
    identity parts (batch, job, air, shape, params) so the prover only
    names the phase.  `meta` (the lease token) is recorded on every
    envelope for forensics but never addresses it."""

    def __init__(self, ctx: BatchContext, job: str, air_key, log_n: int,
                 params_key):
        self.ctx = ctx
        self.batch_id = ctx.batch_id
        self.base = {"kind": "proof_ckpt", "job": job,
                     "air": repr(air_key), "log_n": int(log_n),
                     "params": repr(params_key)}
        self.meta = {"lease_token": ctx.lease_token}

    def _parts(self, phase: str) -> dict:
        parts = dict(self.base)
        parts["phase"] = phase
        return parts

    def load(self, phase: str):
        return load(self.batch_id, self._parts(phase))

    def store(self, phase: str, payload):
        return store(self.batch_id, self._parts(phase), payload,
                     meta=self.meta)


def phase_store(air_key, log_n: int, params_key) -> PhaseStore | None:
    """The stark prover's entry point: a PhaseStore bound to the active
    batch context and job scope, or None when checkpointing is off or
    the prove runs outside a batch (the smoke's paths, direct API use),
    which then takes its path unchanged."""
    if not enabled():
        return None
    ctx = current_context()
    if ctx is None:
        return None
    job = current_job() or "-"
    return PhaseStore(ctx, job, air_key, log_n, params_key)
