"""The committed BASELINE-3 ProgramInput and the reference's results on it.

`baseline3_program_input` builds BASELINE-3's batch with the JAX package's
node (`ethrex_tpu/perf/bench_suite.py measure_config3`): 4 blocks of 125
ETH transfers and 125 token-template calls, from one sender (secret
0xA11CE) over `bench_suite._token_genesis`, block b at timestamp 12 (b + 1).
Each block's 250 transactions are passed to `Node.produce_block` as
`forced_txs`: submitted through the mempool, its cap of 64 transactions a
sender would refuse them.  The tests hold the committed fixture
(`ethrex_tpu_torch/fixtures/`) equal to a fresh build, byte for byte, and
its expected results equal to what the reference computes on it; the
port's `ProgramInput` round-trips the fixture unchanged.  The small
`mixed` fixture (tests/test_torch_host_batches.py `mixed_batch`: two ETH
transfers and two token calls) is what tests/test_torch_cuda.py proves
with `GpuBackend` on the card.

    python -m tests.test_torch_program_input    # rewrite both files
"""

from __future__ import annotations

import gzip
import hashlib
import json

from ethrex_tpu.crypto import secp256k1
from ethrex_tpu.guest import access_log as jal
from ethrex_tpu.guest import token_template as jtt
from ethrex_tpu.guest import transfer_log as jtl
from ethrex_tpu.guest.execution import ProgramInput as JProgramInput
from ethrex_tpu.guest.execution import execution_program as jexecute
from ethrex_tpu.guest.witness import generate_witness
from ethrex_tpu.guest.witness_oracles import WitnessOracles as JOracles
from ethrex_tpu.node import Node
from ethrex_tpu.perf.bench_suite import _token_genesis
from ethrex_tpu.primitives.genesis import Genesis
from ethrex_tpu.primitives.transaction import Transaction
from ethrex_tpu.prover import tpu_backend as jtb
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.guest.execution import ProgramInput

SECRET = 0xA11CE
BLOCKS, PER_BLOCK = 4, 125


def baseline3_program_input() -> JProgramInput:
    sender = secp256k1.pubkey_to_address(secp256k1.pubkey_from_secret(SECRET))
    token, genesis = _token_genesis(sender)
    node = Node(Genesis.from_json(genesis))
    nonce = 0
    blocks = []
    for b in range(BLOCKS):
        txs = []
        for i in range(PER_BLOCK):
            txs.append(Transaction(
                tx_type=2, chain_id=1337, nonce=nonce,
                max_priority_fee_per_gas=1, max_fee_per_gas=10**10,
                gas_limit=21_000, to=bytes([0x50 + i % 32]) * 20,
                value=100 + i).sign(SECRET))
            txs.append(Transaction(
                tx_type=2, chain_id=1337, nonce=nonce + 1,
                max_priority_fee_per_gas=1, max_fee_per_gas=10**10,
                gas_limit=100_000, to=token, value=0,
                data=jtt.transfer_calldata(bytes([0x60 + i % 16]) * 20,
                                           10 + i)).sign(SECRET))
            nonce += 2
        block = node.produce_block(timestamp=12 * (b + 1), forced_txs=txs)
        assert len(block.body.transactions) == 2 * PER_BLOCK
        blocks.append(block)
    witness = generate_witness(node.chain, blocks)
    return JProgramInput(blocks=blocks, witness=witness, config=node.config)


def reference_expected(pi: JProgramInput) -> dict:
    """The JAX package's results on `pi`, as `fixtures.expected` holds
    them."""
    coarse: list = []
    receipts: list = []
    out = jexecute(pi, write_log=coarse, receipts_out=receipts)
    vb = jtl.build_vm_batch(pi.blocks, coarse, receipts,
                            oracles=JOracles(pi.witness,
                                             out.initial_state_root))
    records, r_pre, r_post, depth = jal.build_access_records(
        jal.flatten_entries(vb.blocks_log))
    meta = jtb._vm_meta_json(vb)
    return {
        "output_sha256": hashlib.sha256(out.encode()).hexdigest(),
        "write_log_sha256": fixtures.json_sha256(
            jal.raw_log_to_json(vb.blocks_log)),
        "vm_meta_sha256": fixtures.json_sha256(meta),
        "depth": depth,
        "seg_periods": jtb._schedule_for(depth),
        "mode": meta["mode"],
        "segments": {"transfer": len(vb.segs), "token": len(vb.tok_segs),
                     "generic": len(vb.bc_calls)},
        "records": fixtures.records_summary(records, r_pre, r_post),
    }


def test_fixture_is_the_reference_build_and_its_results():
    pi = baseline3_program_input()
    fresh = fixtures.canonical_json(pi.to_json())
    path = fixtures.HERE / "baseline3_program_input.json.gz"
    assert gzip.decompress(path.read_bytes()) == fresh
    want = reference_expected(pi)
    assert want["segments"] == {"transfer": 2000, "token": 500,
                                "generic": 0}
    assert want["mode"] == "token"
    assert fixtures.expected("baseline3") == want


def test_mixed_fixture_is_the_reference_build():
    from tests.test_torch_host_batches import mixed_batch

    path = fixtures.HERE / "mixed_program_input.json.gz"
    assert gzip.decompress(path.read_bytes()) == \
        fixtures.canonical_json(mixed_batch().to_json())


def test_port_program_input_round_trips_the_fixture():
    obj = fixtures.program_input_json("baseline3")
    pi = ProgramInput.from_json(obj)
    assert len(pi.blocks) == BLOCKS
    assert all(len(b.body.transactions) == 2 * PER_BLOCK for b in pi.blocks)
    assert fixtures.canonical_json(pi.to_json()) == \
        fixtures.canonical_json(obj)
    # and the reference reads the same bytes back the same way
    assert fixtures.canonical_json(JProgramInput.from_json(obj).to_json()) \
        == fixtures.canonical_json(obj)


if __name__ == "__main__":
    from tests.test_torch_host_batches import mixed_batch

    (fixtures.HERE / "mixed_program_input.json.gz").write_bytes(
        gzip.compress(fixtures.canonical_json(mixed_batch().to_json()),
                      mtime=0))
    pi = baseline3_program_input()
    (fixtures.HERE / "baseline3_program_input.json.gz").write_bytes(
        gzip.compress(fixtures.canonical_json(pi.to_json()), mtime=0))
    (fixtures.HERE / "baseline3_expected.json").write_text(
        json.dumps(reference_expected(pi), indent=1, sort_keys=True) + "\n")
