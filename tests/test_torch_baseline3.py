"""The port's host stack on the committed BASELINE-3 ProgramInput (1,000
transactions over 4 blocks; `ethrex_tpu_torch/fixtures/`) against the JAX
package.

The port executes the batch statelessly on its pure-Python paths, builds
the VM batch and the state-update access records.  The output bytes, the
executor's write log, the receipts and the VM batch are held equal to the
reference's (which runs here with its native helpers where they load); the
fine write log, the VM metadata, the tree shape, the segment counts and
the access records to `baseline3_expected.json`, which
tests/test_torch_program_input.py holds to the reference.  Bar: equal
bytes."""

from __future__ import annotations

import hashlib

from ethrex_tpu.guest import access_log as jal
from ethrex_tpu.guest import transfer_log as jtl
from ethrex_tpu.guest.execution import ProgramInput as JProgramInput
from ethrex_tpu.guest.execution import execution_program as jexecute
from ethrex_tpu.guest.witness_oracles import WitnessOracles as JOracles
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.guest import access_log
from ethrex_tpu_torch.guest import transfer_log as tl
from ethrex_tpu_torch.guest.execution import execution_program
from ethrex_tpu_torch.guest.witness_oracles import WitnessOracles
from ethrex_tpu_torch.prover import gpu_backend
from tests.test_torch_host_batches import plain


def test_baseline3_host_stack_equals_the_reference():
    want = fixtures.expected("baseline3")
    obj = fixtures.program_input_json("baseline3")
    pi = fixtures.load_program_input("baseline3")
    jpi = JProgramInput.from_json(obj)

    log: list = []
    receipts: list = []
    out = execution_program(pi, write_log=log, receipts_out=receipts)
    jlog: list = []
    jreceipts: list = []
    jout = jexecute(jpi, write_log=jlog, receipts_out=jreceipts)
    assert out.encode() == jout.encode()
    assert hashlib.sha256(out.encode()).hexdigest() == want["output_sha256"]
    assert access_log.raw_log_to_json(log) == jal.raw_log_to_json(jlog)
    assert [[r.encode() for r in b] for b in receipts] == \
        [[r.encode() for r in b] for b in jreceipts]

    vb = tl.build_vm_batch(pi.blocks, log, receipts,
                           oracles=WitnessOracles(pi.witness,
                                                  out.initial_state_root))
    jvb = jtl.build_vm_batch(jpi.blocks, jlog, jreceipts,
                             oracles=JOracles(jpi.witness,
                                              jout.initial_state_root))
    for field in ("segs", "tok_segs", "blocks", "bc_calls"):
        assert plain(getattr(vb, field)) == plain(getattr(jvb, field)), field
    assert {"transfer": len(vb.segs), "token": len(vb.tok_segs),
            "generic": len(vb.bc_calls)} == want["segments"]
    meta = gpu_backend._vm_meta_json(vb)
    assert meta["mode"] == want["mode"] == "token"
    assert fixtures.json_sha256(meta) == want["vm_meta_sha256"]
    assert fixtures.json_sha256(access_log.raw_log_to_json(
        vb.blocks_log)) == want["write_log_sha256"]

    records, r_pre, r_post, depth = access_log.build_access_records(
        access_log.flatten_entries(vb.blocks_log))
    assert depth == want["depth"]
    assert gpu_backend._schedule_for(depth) == want["seg_periods"]
    assert fixtures.records_summary(records, r_pre, r_post) == \
        want["records"]
