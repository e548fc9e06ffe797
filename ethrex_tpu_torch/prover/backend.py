"""The prover-backend interface: `ProverBackend` and `ExecBackend` of
`ethrex_tpu/prover/backend.py`, on the prover's side (prover_type /
execute / prove / verify).  A backend object is what the proof client
drives: it asks for `prover_type`, calls `prewarm` once and `prove` for
every assigned batch.  The sequencer's side (`check_coverage`,
`to_proof_bytes`, `verify_submission`) comes with the port's batch-proof
verifier."""

from __future__ import annotations

from ..guest.execution import ProgramInput, ProgramOutput, execution_program
from . import protocol


class ProverBackend:
    prover_type: str = ""

    def execute(self, program_input: ProgramInput) -> ProgramOutput:
        """Run the guest program natively (no proof)."""
        return execution_program(program_input)

    def prewarm(self) -> int:
        """Restore compiled artifacts before the first assignment; returns
        how many came back.  Backends with nothing cached restore 0."""
        return 0

    def prove(self, program_input: ProgramInput, proof_format: str) -> dict:
        raise NotImplementedError

    def verify(self, proof: dict) -> bool:
        raise NotImplementedError


class ExecBackend(ProverBackend):
    """The 'fake prover': executes natively, returns an empty proof."""

    prover_type = protocol.PROVER_EXEC

    def prove(self, program_input: ProgramInput, proof_format: str) -> dict:
        output = self.execute(program_input)
        return {
            "backend": self.prover_type,
            "format": proof_format,
            "output": "0x" + output.encode().hex(),
            "proof": None,
        }

    def verify(self, proof: dict) -> bool:
        if proof.get("backend") != self.prover_type:
            return False
        try:
            ProgramOutput.decode(bytes.fromhex(proof["output"][2:]))
            return True
        except (KeyError, TypeError, ValueError):
            return False
