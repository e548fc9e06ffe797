"""The port's proof client against the JAX package's unmodified proof
coordinator, over TCP on the CPU, after tests/test_l2_pipeline.py and
tests/test_prover_chaos.py.

A real node, sequencer and live coordinator of the JAX package commit
one batch (one ETH transfer) for the "tpu" prover type; the port's
`ProverClient(GpuBackend(device="cpu"), ...)` pulls it, proves it in the
coordinator's format and submits it, and the coordinator stores it after
its own submit gate (`verify_submission`, a structural check: no JAX
verification runs).  Under the port's fault plans (the prover's sites
live in the port's `utils/faults`): a heartbeat keeps a slow prove's
lease, a rejected submit does not trip the breaker, and a flapping
endpoint opens the breaker, which then recovers.  For the same message
the two packages' `send_msg` put the same bytes on a socket.  A lost
device stops the client.  Settlement through `send_proofs` is in the
slow tests/test_torch_settlement.py.
"""

from __future__ import annotations

import json
import socket
import threading
import time

import pytest
import torch

from ethrex_tpu.prover import protocol as jprotocol
from ethrex_tpu_torch.prover import checkpoint as ckpt
from ethrex_tpu_torch.prover import protocol
from ethrex_tpu_torch.prover import runtime_errors as rt
from ethrex_tpu_torch.prover.backend import ExecBackend, get_backend
from ethrex_tpu_torch.prover.client import ProverClient
from ethrex_tpu_torch.prover.gpu_backend import GpuBackend
from ethrex_tpu_torch.utils import faults
from ethrex_tpu_torch.utils.faults import FaultPlan
from ethrex_tpu_torch.utils.metrics import METRICS
from tests import test_prover_chaos
from tests.test_prover_chaos import _endpoints

TPU = protocol.PROVER_TPU


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mini_l2(prover_types, **cfg_kw):
    """tests/test_prover_chaos.py `_mini_l2` with its blocks at a fixed
    timestamp, so every mini L2 commits the same batch and the scenarios
    below prove it once (`OnceGpuBackend`)."""
    from ethrex_tpu.node import Node

    produce = Node.produce_block

    def at_fixed_time(self, timestamp=None, **kw):
        return produce(self, timestamp=timestamp or 12, **kw)

    Node.produce_block = at_fixed_time
    try:
        return test_prover_chaos._mini_l2(prover_types, **cfg_kw)
    finally:
        Node.produce_block = produce


class OnceGpuBackend(GpuBackend):
    """`GpuBackend(device="cpu")` that proves each distinct input once
    and hands the same proof back after: the file proves its one batch
    once (about 10 s on the CPU)."""

    proofs: dict = {}

    def __init__(self):
        super().__init__(device="cpu")

    def prove(self, program_input, proof_format):
        key = (json.dumps(program_input.to_json(), sort_keys=True),
               proof_format)
        if key not in self.proofs:
            self.proofs[key] = super().prove(program_input, proof_format)
        return self.proofs[key]


@pytest.fixture(autouse=True)
def _isolation(tmp_path):
    ckpt.set_checkpoint_dir(str(tmp_path / "ckpt"))
    yield
    faults.clear()
    ckpt.set_checkpoint_dir(None)


@pytest.fixture
def l2():
    node, l1, seq = _mini_l2((TPU,))
    yield seq
    seq.stop()


def test_protocol_names_equal_the_reference():
    for name in ("INPUT_REQUEST", "INPUT_RESPONSE", "VERSION_MISMATCH",
                 "TYPE_NOT_NEEDED", "PROOF_SUBMIT", "SUBMIT_ACK", "ERROR",
                 "HEARTBEAT", "HEARTBEAT_ACK", "FORMAT_STARK",
                 "FORMAT_COMPRESSED", "FORMAT_GROTH16", "PROVER_EXEC",
                 "PROVER_TPU", "PROTOCOL_VERSION"):
        assert getattr(protocol, name) == getattr(jprotocol, name)
    assert isinstance(get_backend("exec"), ExecBackend)
    with pytest.raises(ValueError):
        get_backend("sp1")


@pytest.mark.parametrize("msg", [
    {"type": protocol.INPUT_REQUEST, "commit_hash":
     protocol.PROTOCOL_VERSION, "prover_type": TPU, "prover_id": "tpu-1",
     "warm": False},
    {"type": protocol.HEARTBEAT, "batch_id": 3, "prover_type": TPU,
     "lease_token": "tok", "prover_id": None, "phase": "state.commit",
     "phase_started": 1760000000.25},
    {"type": protocol.PROOF_SUBMIT, "batch_id": 3, "prover_type": TPU,
     "proof": {"backend": TPU, "output": "0x00ff", "state_proof": {
         "pub_inputs": [1, 2013265920], "fri": {"roots": [[7] * 8]}},
         "write_log": [[["a", "aa" * 20, "", "c0", False]]]},
     "lease_token": "tok", "prover_id": "p", "trace_id": None,
     "span_id": None, "spans": None},
])
def test_send_msg_puts_the_reference_bytes_on_a_socket(msg):
    frames = []
    for send in (protocol.send_msg, jprotocol.send_msg):
        a, b = socket.socketpair()
        with a, b:
            send(a, msg)
            a.shutdown(socket.SHUT_WR)
            data = b""
            while chunk := b.recv(65536):
                data += chunk
        frames.append(data)
    assert frames[0] == frames[1]
    a, b = socket.socketpair()
    with a, b:
        jprotocol.send_msg(a, msg)
        assert protocol.recv_msg(b) == msg
    with pytest.raises(protocol.ProtocolError):
        protocol._decode_frame(b"[1, 2]\n")


@pytest.fixture(scope="module")
def accepted(tmp_path_factory):
    """One round: the port's client proves the mini L2's batch 1 (the
    real prove, on the CPU) and the coordinator accepts it."""
    ckpt.set_checkpoint_dir(str(tmp_path_factory.mktemp("ckpt")))
    node, l1, seq = _mini_l2((TPU,))
    try:
        client = ProverClient(OnceGpuBackend(), _endpoints(seq),
                              heartbeat_interval=0, rng_seed=1,
                              prewarm=False)
        proven = client.poll_once()
        co = seq.coordinator
        return dict(proven=proven, client=client,
                    proof=seq.rollup.get_proof(1, TPU),
                    proof_format=co.proof_format,
                    rejected=co.rejected_submits_total,
                    ckpt_batches=ckpt.runtime_stats()["batches"])
    finally:
        seq.stop()
        ckpt.set_checkpoint_dir(None)


def test_port_client_proof_accepted_by_the_reference_coordinator(
        accepted):
    proof = accepted["proof"]
    assert accepted["proven"] == 1
    assert proof is not None and proof["backend"] == TPU
    assert proof["format"] == accepted["proof_format"]
    assert proof["vm"]["mode"] == "transfer"
    assert accepted["client"].proved == [1]
    assert accepted["client"].submit_rejections == 0
    assert accepted["rejected"] == 0
    # the accepted batch's checkpoints were dropped
    assert accepted["ckpt_batches"] == 0


def test_heartbeat_keeps_slow_proof_alive(accepted):
    # the injected delay outlasts the 0.4 s lease three times over; only
    # heartbeats keep it
    node, l1, seq = _mini_l2((TPU,), prover_lease_timeout=0.4)
    co = seq.coordinator
    key = (1, TPU)
    try:
        faults.install(FaultPlan(seed=3).delay("backend.prove", 1.2,
                                               times=1))
        client = ProverClient(OnceGpuBackend(), _endpoints(seq),
                              heartbeat_interval=0.1, rng_seed=0,
                              prewarm=False)
        results = []
        t = threading.Thread(
            target=lambda: results.append(client.poll_once()))
        t.start()
        deadline = time.time() + 3
        while key not in co.assignments and time.time() < deadline:
            time.sleep(0.01)
        assert key in co.assignments
        d0 = co.assignments[key]
        time.sleep(0.6)                          # well past the raw lease
        with co.lock:
            still_held = key in co.assignments
            extended = still_held and co.assignments[key] > d0
        assert still_held and extended, "heartbeats did not extend lease"
        assert co.next_batch_to_assign(TPU) is None
        t.join(timeout=8)
        assert results == [1]
        assert seq.rollup.get_proof(1, TPU) is not None
        assert co.heartbeats_total >= 2
        assert co.reassignments_total == 0
    finally:
        seq.stop()


def test_rejected_submit_does_not_trip_breaker(l2, accepted):
    ep = _endpoints(l2)[0]
    faults.install(FaultPlan(seed=9).corrupt("backend.prove", times=2))
    client = ProverClient(OnceGpuBackend(), [ep], heartbeat_interval=0,
                          backoff_base=0.01, breaker_threshold=2,
                          rng_seed=3, prewarm=False)
    st = client.endpoint_states[ep]
    before = METRICS.counters.get("prover_submit_rejections_total", 0)
    assert client.poll_once() == 0
    assert client.poll_once() == 0
    assert st.breaker == "closed" and st.failures == 0
    assert client.submit_rejections == 2
    assert METRICS.counters["prover_submit_rejections_total"] == before + 2
    assert l2.coordinator.rejected_submits_total == 2
    assert client.poll_once() == 1
    assert l2.rollup.get_proof(1, TPU) is not None


def test_flapping_endpoint_breaker_opens_and_recovers(l2, accepted):
    ep = _endpoints(l2)[0]
    faults.install(FaultPlan(seed=5).drop("proto.send", times=3))
    client = ProverClient(OnceGpuBackend(), [ep], heartbeat_interval=0,
                          backoff_base=0.01, breaker_threshold=3,
                          breaker_cooldown=0.3, rng_seed=4, prewarm=False)
    st = client.endpoint_states[ep]
    for _ in range(3):
        time.sleep(0.03)                         # clear the backoff gate
        assert client.poll_once() == 0
    assert st.breaker == "open" and st.failures == 3
    assert client.poll_once() == 0               # open: not attempted
    assert st.failures == 3
    time.sleep(0.35)                             # cooldown elapses
    assert client.poll_once() == 1               # half-open probe
    assert st.breaker == "closed" and st.failures == 0
    assert l2.rollup.get_proof(1, TPU) is not None
    rendered = METRICS.render()
    assert "prover_breaker_transitions_total" in rendered
    assert "prover_poll_errors_total" in rendered


def test_lost_device_stops_the_client(l2):
    class LostDevice(OnceGpuBackend):
        def prove(self, program_input, proof_format):
            raise rt.TransientPhaseError("device_lost", "commit", RuntimeError(
                "CUDA error: an illegal memory access was encountered"))

    ep = _endpoints(l2)[0]
    client = ProverClient(LostDevice(), [ep], heartbeat_interval=0,
                          rng_seed=5, prewarm=False)
    with pytest.raises(rt.TransientPhaseError):
        client.poll_once()
    assert rt.classify(client.fatal) == "device_lost"
    assert client._stop.is_set()
    # not an endpoint failure: the breaker never saw it
    assert client.endpoint_states[ep].failures == 0
