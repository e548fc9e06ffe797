"""ProverBackend interface + registry: a copy of
`ethrex_tpu/prover/backend.py` (parity with upstream ethrex's
ProverBackend trait, crates/prover/src/backend/mod.rs:81-147 —
prover_type / execute / prove / verify / to_proof_bytes).  A backend
object is what the proof client drives: it asks for `prover_type`,
calls `prewarm` once and `prove` for every assigned batch; the
sequencer's side calls `check_coverage`, `verify_submission` and
`to_proof_bytes`.  `get_backend("tpu")` is the port's `GpuBackend` on
the card."""

from __future__ import annotations

from ..guest.execution import ProgramInput, ProgramOutput, execution_program
from . import protocol


class ProverBackend:
    prover_type: str = ""

    def execute(self, program_input: ProgramInput) -> ProgramOutput:
        """Run the guest program natively (no proof)."""
        return execution_program(program_input)

    def prewarm(self) -> int:
        """Build or restore whatever this backend needs before its first
        assignment; returns how many artifacts it warmed.  Backends with
        nothing to build warm 0."""
        return 0

    def prove(self, program_input: ProgramInput, proof_format: str) -> dict:
        raise NotImplementedError

    def verify(self, proof: dict) -> bool:
        raise NotImplementedError

    def check_coverage(self, proof: dict, expected_mode: str) -> bool:
        """Anti-downgrade hook: does this proof carry the VM-circuit
        coverage the batch's committer derived?  Backends without VM
        modes accept everything."""
        return True

    def verify_submission(self, proof: dict) -> bool:
        """Coordinator-side gate at ProofSubmit time: reject a corrupt
        proof immediately so the batch is re-assignable instead of
        stalling until send_proofs' full audit.  Must be cheap — backends
        whose verify() is expensive override with a structural check."""
        try:
            return self.verify(proof)
        except Exception:  # noqa: BLE001 — any crash on a submit is a no
            return False   # (the proof came off the wire untrusted)

    def to_proof_bytes(self, proof: dict) -> bytes:
        import json

        return json.dumps(proof, separators=(",", ":")).encode()


class ExecBackend(ProverBackend):
    """The 'fake prover': executes natively, returns an empty proof —
    unblocks full-pipeline integration exactly like upstream ethrex's exec
    backend (crates/prover/src/backend/exec.rs)."""

    prover_type = protocol.PROVER_EXEC

    def prove(self, program_input: ProgramInput, proof_format: str) -> dict:
        from ..utils import tracing

        # a stage span even on the exec path: an exec-backed fleet's
        # shipped span subtree still carries per-stage attribution for
        # the merged batch trace (docs/OBSERVABILITY.md)
        with tracing.span("prover.execute", stage="execute"):
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
            from ..guest.execution import ProgramOutput

            ProgramOutput.decode(bytes.fromhex(proof["output"][2:]))
            return True
        except (KeyError, TypeError, ValueError):
            return False


def get_backend(name: str) -> ProverBackend:
    """The backend of a wire name: `GpuBackend` on the card for the
    STARK prover's "tpu", `ExecBackend` for "exec"."""
    from .gpu_backend import GpuBackend

    backends = {
        protocol.PROVER_EXEC: ExecBackend,
        protocol.PROVER_TPU: GpuBackend,
    }
    cls = backends.get(name)
    if cls is None:
        raise ValueError(f"unknown prover backend {name!r}")
    return cls()
