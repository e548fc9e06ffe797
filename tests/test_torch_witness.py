"""The port's witness generation (`ethrex_tpu_torch/guest/witness.py
generate_witness`, with the store's recording hooks) against the JAX
package's.

Each package's node produces the same chain from the same signed
transactions: the `mixed` batch (one block of two ETH transfers and two
token-template calls, tests/test_torch_host_batches.py `mixed_batch`),
and a four-block chain that deploys a counter and a contract that
stores BLOCKHASH(n - 1), then calls both (code, storage and ancestor
headers in the witness).  `generate_witness` over each package's chain
gives the same `to_json()`, the same per-block write log and the same
receipts, with the native engines on and with both off
(ETHREX_TPU_NATIVE_MPT=0, ETHREX_TPU_NATIVE_EVM=0): the node order of
the witness follows the order the trie reads them in.  The port's
witness then executes statelessly in the port to the chain's last state
root.  Bar: equal bytes.
"""

from __future__ import annotations

import pytest
import torch

from ethrex_tpu.crypto.keccak import keccak256
from ethrex_tpu.evm import vm as jvm
from ethrex_tpu.guest.witness import generate_witness as jgenerate_witness
from ethrex_tpu.node import Node as JNode
from ethrex_tpu.primitives import rlp
from ethrex_tpu.primitives.genesis import Genesis as JGenesis
from ethrex_tpu.primitives.transaction import Transaction as JTransaction
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.guest.execution import ProgramInput, execution_program
from ethrex_tpu_torch.guest.witness import RecordingDict, generate_witness
from ethrex_tpu_torch.node import Node
from ethrex_tpu_torch.primitives.genesis import Genesis
from ethrex_tpu_torch.primitives.transaction import Transaction
from tests.test_stateless import GENESIS, SECRET, SENDER
from tests.test_torch_block_import import _genesis_json

OTHER = bytes.fromhex("44" * 20)
TOKEN = bytes.fromhex("7070" * 10)
# PUSH8 <runtime> PUSH0 MSTORE PUSH1 8 PUSH1 24 RETURN: deploys 8 bytes
_DEPLOY = "67{}5f5260086018f3"
COUNTER = bytes.fromhex(_DEPLOY.format("5f546001015f5500"))  # slot0 += 1
# NUMBER PUSH1 1 SWAP1 SUB BLOCKHASH PUSH0 SSTORE: slot0 = blockhash(n-1)
BLOCKHASHER = bytes.fromhex(_DEPLOY.format("436001900340" + "5f55"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tx(nonce, to, value=0, data=b"", gas=100_000):
    return JTransaction(tx_type=2, chain_id=1337, nonce=nonce,
                        max_priority_fee_per_gas=1, max_fee_per_gas=10**10,
                        gas_limit=gas, to=to, value=value,
                        data=data).sign(SECRET)


def _mixed():
    from ethrex_tpu.guest import token_template as jtt

    return _genesis_json("mixed"), [[
        _tx(0, OTHER, value=100, gas=21_000),
        _tx(1, TOKEN, data=jtt.transfer_calldata(OTHER, 12345)),
        _tx(2, OTHER, value=101, gas=21_000),
        _tx(3, TOKEN, data=jtt.transfer_calldata(SENDER, 7))]]


def _contracts():
    counter = keccak256(rlp.encode([SENDER, 2]))[12:]
    hasher = keccak256(rlp.encode([SENDER, 3]))[12:]
    return dict(GENESIS), [
        [_tx(0, OTHER, value=100, gas=21_000),
         _tx(1, OTHER, value=200, gas=21_000)],
        [_tx(2, b"", data=COUNTER), _tx(3, b"", data=BLOCKHASHER)],
        [_tx(4, counter), _tx(5, hasher)],
        [_tx(6, counter), _tx(7, hasher), _tx(8, counter)],
    ]


CHAINS = {"mixed": _mixed, "contracts": _contracts}


def _produce(node_cls, genesis_cls, convert, genesis, batches):
    node = node_cls(genesis_cls.from_json(genesis))
    blocks = []
    for b, txs in enumerate(batches):
        for tx in txs:
            node.submit_transaction(convert(tx))
        block = node.produce_block(timestamp=12 * (b + 1))
        assert len(block.body.transactions) == len(txs)
        blocks.append(block)
    return node, blocks


def _witness(generate, node, blocks):
    write_log: list = []
    receipts: list = []
    witness = generate(node.chain, blocks, write_log=write_log,
                       receipts_out=receipts)
    return (fixtures.canonical_json(witness.to_json()), write_log,
            [[r.encode() for r in block] for block in receipts])


@pytest.mark.parametrize("engines", ["native", "python"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_generate_witness_equals_the_reference(chain, engines, monkeypatch):
    if engines == "python":
        monkeypatch.setenv("ETHREX_TPU_NATIVE_MPT", "0")
        monkeypatch.setenv("ETHREX_TPU_NATIVE_EVM", "0")
        monkeypatch.setattr(jvm, "_NATIVE_STATE", [None])
    genesis, batches = CHAINS[chain]()
    node, blocks = _produce(
        Node, Genesis,
        lambda t: Transaction.decode_canonical(t.encode_canonical()),
        genesis, batches)
    jnode, jblocks = _produce(JNode, JGenesis, lambda t: t, genesis,
                              batches)
    assert [b.hash for b in blocks] == [b.hash for b in jblocks]
    port = _witness(generate_witness, node, blocks)
    ref = _witness(jgenerate_witness, jnode, jblocks)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert len(port[1]) == len(port[2]) == len(blocks)

    # the port's witness re-executes statelessly in the port
    pi = ProgramInput(blocks=blocks, witness=generate_witness(
        node.chain, blocks), config=node.config)
    out = execution_program(ProgramInput.from_json(pi.to_json()))
    assert out.final_state_root == blocks[-1].header.state_root


def test_contracts_witness_carries_code_and_ancestor_headers():
    genesis, batches = _contracts()
    node, blocks = _produce(
        Node, Genesis,
        lambda t: Transaction.decode_canonical(t.encode_canonical()),
        genesis, batches)
    # the batch is the last two blocks: both contracts' code, and the
    # headers back to the oldest BLOCKHASH the batch reads
    witness = generate_witness(node.chain, blocks[2:])
    assert len(witness.codes) == 2
    numbers = [h.number for h in witness.block_headers]
    assert numbers == list(range(numbers[0], blocks[2].header.number))
    assert numbers[-1] == blocks[1].header.number


def test_recording_dict_records_first_reads_only():
    inner = {b"a": b"1", b"b": b"2"}
    rec = RecordingDict(inner)
    assert rec.get(b"b") == b"2" and rec.get(b"a") == b"1"
    assert rec.get(b"missing") is None
    assert rec[b"b"] == b"2"
    rec[b"c"] = b"3"
    rec[b"a"] = b"changed"  # content-addressed: a known key is kept
    assert list(rec.accessed) == [b"b", b"a"]
    assert inner == {b"a": b"1", b"b": b"2", b"c": b"3"}
