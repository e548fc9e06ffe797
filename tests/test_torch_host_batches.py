"""The port's stateless execution, `build_vm_batch` and access records
against the JAX package's, on small executed batches.

The batches are the reference tests' own: the all-transfer and the token
batch of tests/test_vm_proof.py (`_transfer_chain`, `_token_batch`), its
contract-recipient batch (a transfer-shaped call to a contract, outside
the VM circuits: both packages raise `NotTransferBatch`), the
transfer/deploy/contract-call chain of tests/test_stateless.py, and a
block of two ETH transfers and two token calls (`mixed_batch`, which the
backend tests prove).  Each goes through the wire form
(`ProgramInput.to_json`) into the port.  Bar: equal bytes for the output,
the write logs, the receipts, the VM batch and the access records.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ethrex_tpu.crypto.keccak import keccak256 as jkeccak256
from ethrex_tpu.guest import access_log as jal
from ethrex_tpu.guest import token_template as jtt
from ethrex_tpu.guest import transfer_log as jtl
from ethrex_tpu.guest.execution import ProgramInput as JProgramInput
from ethrex_tpu.guest.execution import execution_program as jexecute
from ethrex_tpu.guest.witness import generate_witness
from ethrex_tpu.guest.witness_oracles import WitnessOracles as JOracles
from ethrex_tpu.node import Node
from ethrex_tpu.primitives import rlp as jrlp
from ethrex_tpu.primitives.genesis import Genesis
from ethrex_tpu.primitives.transaction import Transaction as JTransaction
from ethrex_tpu.prover import tpu_backend as jtb
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.guest import access_log
from ethrex_tpu_torch.guest import transfer_log as tl
from ethrex_tpu_torch.guest.execution import ProgramInput, execution_program
from ethrex_tpu_torch.guest.witness_oracles import WitnessOracles
from ethrex_tpu_torch.prover import gpu_backend
from tests.test_stateless import GENESIS, SECRET, _make_chain_with_blocks
from tests.test_vm_proof import OTHER, TOKEN, _token_batch, _transfer_chain


def _program_input(node, blocks) -> JProgramInput:
    return JProgramInput(blocks=blocks,
                         witness=generate_witness(node.chain, blocks),
                         config=node.config)


def _tx(nonce, to, value=0, data=b"", gas=21_000):
    return JTransaction(tx_type=2, chain_id=1337, nonce=nonce,
                        max_priority_fee_per_gas=1, max_fee_per_gas=10**10,
                        gas_limit=gas, to=to, value=value,
                        data=data).sign(SECRET)


def transfer_batch() -> JProgramInput:
    return _program_input(*_transfer_chain())


def contract_recipient_batch() -> JProgramInput:
    """tests/test_vm_proof.py's contract recipient: a contract deployed in
    one block, then called with value (and no data) in the next; the
    batch is the second block."""
    node = Node(Genesis.from_json(GENESIS))
    node.produce_block(forced_txs=[_tx(0, b"", gas=100_000, data=bytes.
                                       fromhex("600160005260086018f3"))])
    from tests.test_stateless import SENDER

    contract = jkeccak256(jrlp.encode([SENDER, 0]))[12:]
    block = node.produce_block(forced_txs=[_tx(1, contract, value=5,
                                               gas=50_000)])
    return _program_input(node, [block])


def stateless_batch() -> JProgramInput:
    return _program_input(*_make_chain_with_blocks())


def mixed_batch() -> JProgramInput:
    """One block of two ETH transfers and two token-template calls."""
    from tests.test_stateless import SENDER

    genesis = dict(GENESIS)
    genesis["alloc"] = {
        "0x" + SENDER.hex(): {"balance": hex(10**21)},
        "0x" + TOKEN.hex(): {
            "balance": "0x0", "code": "0x" + jtt.TEMPLATE_CODE.hex(),
            "storage": {hex(jtt.balance_slot(SENDER)): hex(1_000_000)}},
    }
    node = Node(Genesis.from_json(genesis))
    txs = [_tx(0, OTHER, value=100),
           _tx(1, TOKEN, data=jtt.transfer_calldata(OTHER, 12345),
               gas=100_000),
           _tx(2, OTHER, value=101),
           _tx(3, TOKEN, data=jtt.transfer_calldata(SENDER, 7),
               gas=100_000)]
    block = node.produce_block(timestamp=12, forced_txs=txs)
    assert len(block.body.transactions) == 4
    return _program_input(node, [block])


BATCHES = {"transfer": transfer_batch, "token": _token_batch,
           "contract_recipient": contract_recipient_batch,
           "stateless_chain": stateless_batch, "mixed": mixed_batch}
IN_SCOPE = {"transfer": "transfer", "token": "token", "mixed": "token"}


def plain(x):
    """A comparable form of the two packages' host objects: class name
    and fields, with bytes as hex and account states as their RLP."""
    if type(x).__name__ == "AccountState":
        return x.encode().hex()
    if dataclasses.is_dataclass(x):
        return [type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)}]
    if hasattr(x, "__dict__"):
        return [type(x).__name__, {k: plain(v) for k, v in vars(x).items()}]
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (bytes, bytearray)):
        return bytes(x).hex()
    if isinstance(x, np.integer):
        return int(x)
    assert x is None or isinstance(x, (bool, int, str)), type(x)
    return x


@pytest.fixture(scope="module", params=sorted(BATCHES))
def executed(request):
    """(name, reference ProgramInput, the reference's artifacts, the
    port's artifacts): output, coarse log, receipts."""
    jpi = BATCHES[request.param]()
    pi = ProgramInput.from_json(jpi.to_json())
    arts = []
    for execute, prog in ((jexecute, jpi), (execution_program, pi)):
        log: list = []
        receipts: list = []
        out = execute(prog, write_log=log, receipts_out=receipts)
        arts.append((out, log, receipts))
    return request.param, jpi, pi, arts[0], arts[1]


def test_execution_equals_the_reference(executed):
    _, _, _, (jout, jlog, jrec), (out, log, rec) = executed
    assert out.encode() == jout.encode()
    assert access_log.raw_log_to_json(log) == jal.raw_log_to_json(jlog)
    assert [[r.encode() for r in b] for b in rec] == \
        [[r.encode() for r in b] for b in jrec]


def test_vm_batch_and_records_equal_the_reference(executed):
    name, jpi, pi, (jout, jlog, jrec), (out, log, rec) = executed
    try:
        jvb = jtl.build_vm_batch(jpi.blocks, jlog, jrec,
                                 oracles=JOracles(jpi.witness,
                                                  jout.initial_state_root))
    except jtl.NotTransferBatch:
        jvb = None
    if jvb is None:
        assert name not in IN_SCOPE
        with pytest.raises(tl.NotTransferBatch):
            tl.build_vm_batch(pi.blocks, log, rec,
                              oracles=WitnessOracles(pi.witness,
                                                     out.initial_state_root))
        jfine, fine = jlog, log
    else:
        vb = tl.build_vm_batch(pi.blocks, log, rec,
                               oracles=WitnessOracles(pi.witness,
                                                      out.initial_state_root))
        for field in ("blocks_log", "segs", "tok_segs", "blocks",
                      "bc_calls"):
            assert plain(getattr(vb, field)) == plain(getattr(jvb, field)), \
                field
        assert gpu_backend._vm_meta_json(vb) == jtb._vm_meta_json(jvb)
        assert gpu_backend._vm_meta_json(vb)["mode"] == IN_SCOPE[name]
        jfine, fine = jvb.blocks_log, vb.blocks_log
    jentries = jal.flatten_entries(jfine)
    entries = access_log.flatten_entries(fine)
    assert plain(entries) == plain(jentries)
    want = jal.build_access_records(jentries)
    got = access_log.build_access_records(entries)
    assert got[3] == want[3]
    assert fixtures.records_summary(*got[:3]) == \
        fixtures.records_summary(*want[:3])


def test_exec_backend_equals_the_reference(executed):
    from ethrex_tpu.prover.backend import ExecBackend as JExecBackend
    from ethrex_tpu_torch.prover.backend import ExecBackend

    _, jpi, pi, _, _ = executed
    proof = ExecBackend().prove(pi, "stark")
    assert proof == JExecBackend().prove(jpi, "stark")
    assert ExecBackend().verify(proof) and JExecBackend().verify(proof)
    assert not ExecBackend().verify(dict(proof, backend="tpu"))
