"""`GpuBackend` end to end on the CPU, claimed-log mode: the reference
tests' contract-recipient batch (a value transfer to a contract, outside
the VM circuits; tests/test_torch_host_batches.py
`contract_recipient_batch`) makes `build_vm_batch` raise
`NotTransferBatch` in the port as in the JAX package, so the port proves
only the state and binding STARKs over the executor's write log.  The
unmodified `TpuBackend` accepts the `stark` proof with and without the
ProgramInput and rejects it with one output byte flipped; the
slow-marked test holds it JSON-equal to `TpuBackend().prove`'s."""

from __future__ import annotations

import json

import pytest

from ethrex_tpu.prover import tpu_backend as jtb
from ethrex_tpu_torch.guest.execution import ProgramInput
from ethrex_tpu_torch.prover.gpu_backend import GpuBackend
from tests.test_torch_host_batches import contract_recipient_batch


@pytest.fixture(scope="module")
def proved():
    jpi = contract_recipient_batch()
    pi = ProgramInput.from_json(jpi.to_json())
    stats: dict = {}
    proof = GpuBackend(device="cpu").prove(pi, "stark", stats=stats)
    return jpi, proof, stats


def test_claimed_log_proof_is_accepted_by_the_reference(proved):
    jpi, proof, stats = proved
    assert stats["mode"] == "claimed"
    assert set(proof) == {"backend", "format", "output", "write_log",
                          "depth", "seg_periods", "state_proof", "proof"}
    backend = jtb.TpuBackend()
    assert backend.verify(proof)
    assert backend.verify_with_input(proof, jpi)
    assert jtb.expected_vm_mode(jpi) == "claimed"
    assert backend.check_coverage(proof, "claimed")


def test_claimed_log_proof_with_a_flipped_output_byte_is_rejected(proved):
    jpi, proof, _ = proved
    bad = dict(proof)
    out = bytearray.fromhex(proof["output"][2:])
    out[-1] ^= 1
    bad["output"] = "0x" + out.hex()
    backend = jtb.TpuBackend()
    assert not backend.verify(bad)
    assert not backend.verify_with_input(bad, jpi)


@pytest.mark.slow
def test_claimed_log_proof_equals_the_reference_backend(proved):
    jpi, proof, _ = proved
    want = jtb.TpuBackend().prove(jpi, "stark")
    assert json.dumps(proof, sort_keys=True) == json.dumps(want,
                                                           sort_keys=True)
