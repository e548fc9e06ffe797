"""A batch proved by the port settles through the JAX package's unmodified
L2 stack: a sequencer with an in-memory L1 that needs `tpu` proofs, one
ETH transfer, the reference's `ProverClient` driving
`GpuBackend(device="cpu")` over the coordinator's TCP protocol, then
`send_proofs` (which checks the proof with `TpuBackend.verify_with_input`)
and the L1's verified batch (tests/test_l2_pipeline.py's shape).  Marked
slow: the round (the port's CPU proof, the sequencer's JAX verification
and its re-execution of the batch) takes about ten minutes on a CPU."""

from __future__ import annotations

import pytest

from ethrex_tpu.prover import protocol
from ethrex_tpu.prover.client import ProverClient
from ethrex_tpu_torch.prover.gpu_backend import GpuBackend
from tests.test_l2_pipeline import _setup, _transfer


@pytest.mark.slow
def test_port_proof_settles_on_the_reference_sequencer():
    node, l1, seq = _setup([protocol.PROVER_TPU])
    try:
        node.submit_transaction(_transfer(0))
        seq.produce_block()
        batch = seq.commit_next_batch()
        assert batch is not None and batch.number == 1
        client = ProverClient(GpuBackend(device="cpu"),
                              [("127.0.0.1", seq.coordinator.port)],
                              prewarm=False)
        assert client.poll_once() == 1
        proof = seq.rollup.get_proof(1, protocol.PROVER_TPU)
        assert proof["backend"] == "tpu" and proof["vm"]["mode"] == \
            "transfer"
        assert seq.send_proofs() == (1, 1)
        assert l1.last_verified_batch() == 1
    finally:
        seq.stop()
