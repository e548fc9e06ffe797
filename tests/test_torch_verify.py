"""The port's batch-proof verifier against the JAX package's, on the CPU.

The port proves the mixed batch (one block of two ETH transfers and two
token-template calls, tests/test_torch_host_batches.py `mixed_batch`) in
the `stark` format with `GpuBackend(device="cpu")`.  The port's
`GpuBackend(device="cpu")` and the reference's unmodified `TpuBackend()`
must return the same booleans from `verify`, `verify_with_input`,
`verify_submission` and `check_coverage` on that proof and on tampered
copies: a flipped output byte, a changed write-log entry, a wrong depth,
a wrong backend tag, the `vm` metadata removed (the downgrade) and a
`bc_proofs` count that matches no generic call.  `stark_components`
returns the same publics in both, and `expected_vm_mode` the same mode on
the mixed and BASELINE-3 fixtures.  No card is needed: verification is
host work.  The two copies that pass the whole STARK audit (the honest
proof and the unused `bc_proofs` entry) are compared with the reference
under `-m slow`; the port's full audit of the honest proof runs here.
"""

from __future__ import annotations

import copy

import pytest
import torch

from ethrex_tpu.prover import tpu_backend as jtb
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.guest.execution import ProgramInput
from ethrex_tpu_torch.prover import gpu_backend
from ethrex_tpu_torch.prover.gpu_backend import GpuBackend
from tests.test_torch_host_batches import mixed_batch


@pytest.fixture(scope="module")
def proved():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jpi = mixed_batch()
        pi = ProgramInput.from_json(jpi.to_json())
        yield jpi, GpuBackend(device="cpu").prove(pi, "stark")
    finally:
        torch.set_num_threads(prev)


def _flip_output(proof):
    out = bytearray.fromhex(proof["output"][2:])
    out[0] ^= 1
    proof["output"] = "0x" + out.hex()


def _change_log_entry(proof):
    row = proof["write_log"][0][0]
    assert row[0] == "a"
    new = bytearray.fromhex(row[3])
    new[-1] ^= 1
    row[3] = new.hex()


def _wrong_depth(proof):
    proof["depth"] = int(proof["depth"]) + 1


def _wrong_backend(proof):
    proof["backend"] = "exec"


def _downgrade(proof):
    del proof["vm"]


def _bc_count(proof):
    proof["bc_proofs"] = [proof["state_proof"]]


TAMPERS = {"honest": lambda p: None, "output_byte": _flip_output,
           "write_log_entry": _change_log_entry, "depth": _wrong_depth,
           "backend_tag": _wrong_backend, "vm_removed": _downgrade,
           "bc_proofs_count": _bc_count}


# the two copies that pass the STARK audit cost a full verification in
# each package (the reference's first takes about 40 s on the CPU): past
# the per-file budget, so they run with -m slow
SLOW = {"honest", "bc_proofs_count"}


@pytest.mark.parametrize("tamper", [
    pytest.param(t, marks=pytest.mark.slow) if t in SLOW else t
    for t in TAMPERS])
def test_verdicts_equal_the_reference(proved, tamper):
    jpi, proof = proved
    bad = copy.deepcopy(proof)
    TAMPERS[tamper](bad)
    ours, ref = GpuBackend(device="cpu"), jtb.TpuBackend()
    mode = jtb.expected_vm_mode(jpi)
    got = (ours.verify(bad), ours.verify_with_input(bad, jpi),
           ours.verify_submission(bad), ours.check_coverage(bad, mode))
    want = (ref.verify(bad), ref.verify_with_input(bad, jpi),
            ref.verify_submission(bad), ref.check_coverage(bad, mode))
    assert got == want
    if tamper == "honest":
        assert got == (True, True, True, True)
    elif tamper != "bc_proofs_count":
        # every tamper but an unused bc_proofs entry fails the audit
        assert not got[1]


def test_honest_proof_passes_the_full_audit(proved):
    jpi, proof = proved
    ours = GpuBackend(device="cpu")
    assert ours.verify_with_input(proof, jpi)
    assert ours.verify_submission(proof)
    assert ours.check_coverage(proof, gpu_backend.expected_vm_mode(jpi))
    assert not ours.check_coverage(proof, "transfer")


def test_stark_components_equal_the_reference(proved):
    _, proof = proved
    airs, proofs = GpuBackend(device="cpu").stark_components(proof)
    jairs, jproofs = jtb.TpuBackend().stark_components(proof)
    assert [type(a).__name__ for a in airs] == \
        [type(a).__name__ for a in jairs]
    # the keys past the class: the AIR's shape parameters
    assert [a.cache_key()[1:] for a in airs] == \
        [a.cache_key()[1:] for a in jairs]
    assert [p["pub_inputs"] for p in proofs] == \
        [p["pub_inputs"] for p in jproofs]
    with pytest.raises(ValueError, match="aggregated"):
        GpuBackend(device="cpu").stark_components(
            {**proof, "aggregate": {}})


@pytest.mark.parametrize("name", ["mixed", "baseline3"])
def test_expected_vm_mode_equals_the_reference(name):
    from ethrex_tpu.guest.execution import ProgramInput as JProgramInput

    doc = fixtures.program_input_json(name)
    mode = gpu_backend.expected_vm_mode(ProgramInput.from_json(doc))
    assert mode == jtb.expected_vm_mode(JProgramInput.from_json(doc))
    assert mode == "token"
