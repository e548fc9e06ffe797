"""`GpuBackend` end to end on the CPU, VM mode: a block of two ETH
transfers and two token-template calls (tests/test_torch_host_batches.py
`mixed_batch`) goes through the wire form into the port, which executes
it, builds its VM batch and access records and proves it in the `stark`
format with the kernels' plain versions.  The JAX package's unmodified
`TpuBackend` accepts the proof, with and without the ProgramInput, and
rejects it with one output byte flipped.  `GpuBackend()` raises on a
machine without CUDA.  The slow-marked test holds the whole proof dict
JSON-equal to `TpuBackend().prove`'s (the JAX prover compiles for
minutes)."""

from __future__ import annotations

import json

import pytest
import torch

from ethrex_tpu.prover import tpu_backend as jtb
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.guest.execution import ProgramInput
from ethrex_tpu_torch.prover.gpu_backend import GpuBackend
from tests.test_torch_host_batches import mixed_batch

KEYS = {"backend", "format", "output", "write_log", "depth", "seg_periods",
        "state_proof", "proof", "vm", "vm_proof", "tok_proof"}


@pytest.fixture(scope="module")
def proved():
    jpi = mixed_batch()
    pi = ProgramInput.from_json(jpi.to_json())
    stats: dict = {}
    proof = GpuBackend(device="cpu").prove(pi, "stark", stats=stats)
    return jpi, proof, stats


def test_vm_mode_proof_is_accepted_by_the_reference(proved):
    jpi, proof, stats = proved
    assert set(proof) == KEYS
    assert proof["backend"] == "tpu" and proof["format"] == "stark"
    assert stats["mode"] == proof["vm"]["mode"] == "token"
    assert fixtures.proof_summary(proof)["segments"] == {
        "transfer": 8, "token": 2, "generic": 0}
    backend = jtb.TpuBackend()
    assert backend.verify(proof)
    assert backend.verify_with_input(proof, jpi)
    assert backend.check_coverage(proof, jtb.expected_vm_mode(jpi))


def test_vm_mode_proof_with_a_flipped_output_byte_is_rejected(proved):
    jpi, proof, _ = proved
    bad = dict(proof)
    out = bytearray.fromhex(proof["output"][2:])
    out[0] ^= 1
    bad["output"] = "0x" + out.hex()
    backend = jtb.TpuBackend()
    assert not backend.verify(bad)
    assert not backend.verify_with_input(bad, jpi)


def test_gpu_backend_needs_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            GpuBackend(device)
    assert GpuBackend("cpu").device.type == "cpu"


def test_unknown_format_is_refused():
    with pytest.raises(ValueError, match="format"):
        GpuBackend("cpu").prove(None, "snark")


@pytest.mark.slow
def test_vm_mode_proof_equals_the_reference_backend(proved):
    jpi, proof, _ = proved
    want = jtb.TpuBackend().prove(jpi, "stark")
    assert json.dumps(proof, sort_keys=True) == json.dumps(want,
                                                           sort_keys=True)
