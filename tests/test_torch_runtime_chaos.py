"""The port's runtime-error taxonomy, phase guard, memory gate and phase
checkpoints on the CPU, after tests/test_runtime_chaos.py.

The taxonomy is read on torch's exception types and on CUDA's messages
(an out-of-memory, an illegal address, a launch failure, a device-side
assert, an uncorrectable ECC error, a kernel that fails to build, a
launch's error code).  `guard_phase` wraps the transient classes and
never retries a phase.  `memory_gate` is fed `avail_fn` and refuses a
STARK before any of its work runs.  The checkpoint envelope round-trips,
torn and garbage envelopes fall back to a fresh prove, `phase_store`
needs a batch context, and a prove killed at every phase boundary of a
small StateUpdateAir (depth 2, 3 writes: trace 2^10 x 115) resumes to a
byte-identical proof.  The checkpoint directory and fingerprint are the
port's own, never the reference's.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from ethrex_tpu.prover import checkpoint as jckpt
from ethrex_tpu_torch.models import state_update_air as sua
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.prover import checkpoint as ckpt
from ethrex_tpu_torch.prover import runtime_errors as rt
from ethrex_tpu_torch.stark import prover, state_tree
from ethrex_tpu_torch.stark.prover import StarkParams
from ethrex_tpu_torch.utils import faults
from ethrex_tpu_torch.utils.faults import FaultPlan, InjectedFault

PARAMS = StarkParams(log_blowup=3, num_queries=12, log_final_size=4)
PHASES = ("commit", "quotient", "open", "fri")
DEPTH, SEG = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the plain versions' torch ops: one thread a test worker, so that
    # parallel workers do not oversubscribe the cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _runtime_isolation(tmp_path):
    """Every test gets its own checkpoint dir and zeroed counters; no
    fault plan or context leaks out."""
    ckpt.set_checkpoint_dir(str(tmp_path / "ckpt"))
    rt.reset_stats()
    with ckpt._LOCK:
        for key in ckpt.STATS:
            ckpt.STATS[key] = 0
    yield
    faults.clear()
    ckpt.set_checkpoint_dir(None)
    rt.reset_stats()


@pytest.fixture(scope="module")
def material():
    """A small StateUpdateAir: 4 keys, 3 writes, depth 2 (n = 2^10)."""
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
             for _ in range(11)]
    entries = dict(zip(words[:4], words[4:8]))
    tree = state_tree.TouchedStateTree(entries, DEPTH)
    r_pre = tree.root
    keys = list(entries)
    records = [tree.update(keys[k], words[8 + i])
               for i, k in enumerate((0, 2, 0))]
    air = sua.StateUpdateAir(DEPTH, seg_periods=SEG)
    trace = sua.generate_state_update_trace(records, r_pre, DEPTH, SEG)
    pub = sua.state_update_public_inputs(records, r_pre, tree.root, SEG)
    assert trace.shape == (1 << 10, 115)
    baseline = prover.prove(air, trace, pub, PARAMS, device="cpu")
    return air, trace, pub, baseline


def _dump(proof) -> str:
    return json.dumps(proof, sort_keys=True)


def _prove(material):
    air, trace, pub, _ = material
    return prover.prove(air, trace, pub, PARAMS, device="cpu")


# ===========================================================================
# taxonomy units
# ===========================================================================

@pytest.mark.parametrize("exc,kind", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "7.70 GiB"), "oom"),
    (RuntimeError("CUDA error: out of memory"), "oom"),
    (MemoryError(), "oom"),
    (RuntimeError("CUDA kernel ntt_pass failed with error 2"), "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "device_lost"),
    (RuntimeError("CUDA error: unspecified launch failure"), "device_lost"),
    (RuntimeError("CUDA error: device-side assert triggered"),
     "device_lost"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     "device_lost"),
    (RuntimeError("nvcc failed:\nntt.cu: error"), "device_lost"),
    (RuntimeError("CUDA kernel p2_hash_leaves failed with error 700"),
     "device_lost"),
    (RuntimeError("CUDA kernel deep_compose failed with error 1"),
     "unknown"),
    (InjectedFault("injected error at device.lost"), "device_lost"),
    (rt.NanPoisonError("commit", "x"), "nan_poison"),
    (rt.TransientPhaseError("oom", "open", MemoryError()), "oom"),
    (ValueError("anything else"), "unknown"),
])
def test_classify_taxonomy(exc, kind):
    assert rt.classify(exc) == kind


def test_check_phase_outputs_names_the_phase():
    rt.check_phase_outputs("commit", {
        "rows": np.array([1, 2], np.uint32), "wall": 0.25, "n": 7,
        "lde": torch.tensor([0, bb.P - 1], dtype=torch.int32)})
    with pytest.raises(rt.NanPoisonError) as ei:
        rt.check_phase_outputs("open", {"vals": np.array([1.0, np.nan])})
    assert ei.value.phase == "open"
    # an int32 field tensor holds no NaN: the range check bites
    with pytest.raises(rt.NanPoisonError):
        rt.check_phase_outputs("fri", torch.tensor([-5], dtype=torch.int32))
    with pytest.raises(rt.NanPoisonError):
        rt.check_phase_outputs("fri", np.array([bb.P + 3], np.uint64))
    with pytest.raises(rt.NanPoisonError):
        rt.check_phase_outputs("quotient",
                               torch.tensor([float("inf")]))
    with pytest.raises(rt.NanPoisonError):
        rt.check_phase_outputs("commit", {"__corrupt__": True})
    assert rt.STATS["nan_poisons"] == 5


def test_guard_phase_classifies_and_never_retries():
    calls = []

    def phase():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with pytest.raises(rt.TransientPhaseError) as ei:
        rt.guard_phase("quotient", "air", phase)
    assert (ei.value.kind, ei.value.phase) == ("device_lost", "quotient")
    assert calls == [1]     # a poisoned context is never retried
    with faults.injected(FaultPlan(seed=1).error(
            "backend.phase", exc=torch.cuda.OutOfMemoryError("CUDA out of "
                                                             "memory"),
            times=1)):
        with pytest.raises(rt.TransientPhaseError) as ei:
            rt.guard_phase("commit", "air", lambda: 1)
    assert ei.value.kind == "oom"
    with faults.injected(FaultPlan(seed=2).error("device.lost", times=1)):
        with pytest.raises(rt.TransientPhaseError) as ei:
            rt.guard_phase("open", "air", lambda: 1)
    assert ei.value.kind == "device_lost"

    def boom():
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        rt.guard_phase("open", "air", boom)
    assert rt.guard_phase("fri", "air", lambda: 41 + 1) == 42
    assert rt.STATS["transient_failures"] == 3


def test_memory_gate_refuses_before_oom():
    # the executed BASELINE-3 state STARK (2^21 x 115, LDE 2^24): more
    # than twice its LDE (7.7 GB), less than the whole path's peak
    est = rt.stark_bytes(1 << 21, 115, 3, 0, 24)
    assert 2 * 115 * (1 << 24) * 4 < est < 33.34 * 2**30
    rt.memory_gate("air", "cuda", est_bytes=100, avail_fn=lambda d: 10_000)
    with pytest.raises(rt.TransientPhaseError) as ei:
        rt.memory_gate("air", "cuda", est_bytes=100, avail_fn=lambda d: 10)
    assert rt.classify(ei.value) == "oom"
    assert rt.STATS["memory_gate_refusals"] == 1
    # unknown availability (the CPU): never refuse on a guess
    rt.memory_gate("air", "cpu", est_bytes=100, avail_fn=lambda d: None)
    assert rt.STATS["memory_gate_refusals"] == 1


def test_prove_refused_by_the_gate_runs_nothing(material, monkeypatch):
    air, trace, pub, _ = material

    def no_work(*a, **k):
        raise AssertionError("the refused STARK reached its tables")

    monkeypatch.setattr(prover, "_tables", no_work)
    monkeypatch.setattr(rt, "_available_bytes", lambda device: 1 << 20)
    with pytest.raises(rt.TransientPhaseError) as ei:
        prover.prove(air, trace, pub, PARAMS, device="cpu")
    assert rt.classify(ei.value) == "oom"


# ===========================================================================
# checkpoint envelope units
# ===========================================================================

def test_checkpoint_roundtrip_torn_and_garbage(monkeypatch):
    parts = {"kind": "proof_ckpt", "job": "j", "phase": "commit"}
    payload = {"rows": np.arange(4, dtype=np.uint32), "ch": {"pos": 3}}
    assert ckpt.store(7, parts, payload, meta={"lease_token": "tok"})
    got = ckpt.load(7, parts)
    assert np.array_equal(got["rows"], payload["rows"])
    assert ckpt.STATS["stores"] == 1 and ckpt.STATS["loads"] == 1
    assert ckpt.load(7, {**parts, "phase": "open"}) is None
    assert ckpt.STATS["discards"] == 0

    path = ckpt._entry_path(7, parts)
    with open(path, "r+b") as f:        # torn write
        f.truncate(9)
    assert ckpt.load(7, parts) is None
    assert ckpt.STATS["discards"] == 1 and not os.path.exists(path)
    assert ckpt.store(7, parts, payload)
    with open(path, "wb") as f:         # garbage bytes
        f.write(b"\x00garbage" * 64)
    assert ckpt.load(7, parts) is None
    assert ckpt.STATS["discards"] == 2 and not os.path.exists(path)
    assert ckpt.store(7, parts, payload)
    ckpt.complete(7)
    assert ckpt.load(7, parts) is None
    assert not os.path.exists(ckpt._batch_dir(7))
    monkeypatch.setenv("ETHREX_PROOF_CKPT_OFF", "1")
    assert ckpt.store(7, parts, payload) is False
    assert ckpt.load(7, parts) is None
    assert ckpt.enabled() is False


def test_phase_store_requires_batch_context():
    assert ckpt.phase_store(("air", 1), 5, (3, 12)) is None
    with ckpt.batch_context(11, lease_token="tok"):
        store = ckpt.phase_store(("air", 1), 5, (3, 12))
        assert store is not None
        assert store.store("commit", {"x": 1})
        assert store.load("commit") == {"x": 1}
        # the lease token is metadata, not key material
        store.meta["lease_token"] = "fresh-token"
        assert store.load("commit") == {"x": 1}
    ckpt.complete(11)


def test_checkpoints_are_the_ports_own():
    ckpt.set_checkpoint_dir(None)
    jckpt.set_checkpoint_dir(None)
    ours, ref = ckpt.checkpoint_dir(), jckpt.checkpoint_dir()
    assert os.path.basename(ours) == \
        f"ethrex_tpu_torch_proof_ckpt_{ckpt.fingerprint()}"
    assert ours != ref
    assert not ours.startswith(ref) and not ref.startswith(ours)
    parts = {"kind": "proof_ckpt", "job": "j", "phase": "commit"}
    assert os.path.basename(ckpt._entry_path(3, parts)) != \
        os.path.basename(jckpt._entry_path(3, parts))
    assert len(ckpt.fingerprint()) == 16


# ===========================================================================
# prove-level drills
# ===========================================================================

def test_kill_at_every_phase_boundary_resumes_byte_identical(material):
    baseline = material[3]
    with ckpt.batch_context(901, lease_token="t0"):
        p1 = _prove(material)
    assert _dump(p1) == _dump(baseline)
    assert ckpt.STATS["stores"] == len(PHASES) + 1      # + final proof

    cycles, proof = 0, None
    with ckpt.batch_context(902, lease_token="t1"):
        while proof is None:
            cycles += 1
            assert cycles <= len(PHASES) + 2, "crash loop diverged"
            faults.install(
                FaultPlan(seed=cycles).drop("backend.phase", times=1))
            try:
                proof = _prove(material)
            except InjectedFault:
                pass        # the simulated kill at a phase boundary
            finally:
                faults.clear()
    assert cycles == len(PHASES) + 1
    assert _dump(proof) == _dump(baseline)
    # cycle k replays its k - 1 finished phases
    assert rt.STATS["phase_resumes"] == sum(range(len(PHASES) + 1))

    # a restarted prover that already finished loads the stored proof
    before = rt.STATS["phase_resumes"]
    with ckpt.batch_context(902, lease_token="t2-after-restart"):
        p2 = _prove(material)
    assert _dump(p2) == _dump(baseline)
    assert rt.STATS["phase_resumes"] == before + 1
    ckpt.complete(901)
    ckpt.complete(902)


def test_device_lost_mid_prove_raises_and_resumes(material):
    """A lost device is raised out of the prove (no retry on the same
    context); the next process resumes from the finished phases."""
    with ckpt.batch_context(904, lease_token="t"):
        faults.install(FaultPlan(seed=3).error("device.lost", times=1,
                                               after=2))
        try:
            with pytest.raises(rt.TransientPhaseError) as ei:
                _prove(material)
        finally:
            faults.clear()
        assert (ei.value.kind, ei.value.phase) == ("device_lost", "open")
        proof = _prove(material)
    assert _dump(proof) == _dump(material[3])
    assert rt.STATS["phase_resumes"] == 2       # commit, quotient
    ckpt.complete(904)


def test_torn_checkpoints_fall_back_to_fresh_prove(material):
    with ckpt.batch_context(903, lease_token="t"):
        p0 = _prove(material)
    bdir = ckpt._batch_dir(903)
    names = sorted(os.listdir(bdir))
    assert len(names) == len(PHASES) + 1
    for i, name in enumerate(names):
        path = os.path.join(bdir, name)
        if i % 2:
            with open(path, "r+b") as f:       # torn mid-frame
                f.truncate(max(1, os.path.getsize(path) // 2))
        else:
            with open(path, "wb") as f:        # arbitrary garbage
                f.write(b"\xde\xad" * 37)
    with ckpt.batch_context(903, lease_token="t"):
        p1 = _prove(material)
    assert _dump(p1) == _dump(p0)
    assert ckpt.STATS["discards"] >= 2
    assert rt.STATS["phase_resumes"] == 0
    ckpt.complete(903)
