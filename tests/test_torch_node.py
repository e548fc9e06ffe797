"""The port's node (`ethrex_tpu_torch/node.py`: mempool, payload, fork
choice) and its batch-building functions (`ethrex_tpu_torch/fixtures/
build.py`) against the JAX package's node.

BASELINE-3 built by the port's node is byte-equal to the committed
fixture (which `tests/test_torch_program_input.py` holds equal to the
JAX package's build), and, with both native engines off
(ETHREX_TPU_NATIVE_MPT=0, ETHREX_TPU_NATIVE_EVM=0), to the JAX package's
build under the same knobs.  BASELINE-1 through the mempool equals the
JAX package's on the same stream and timestamp, and at timestamp 12
hashes to `fixtures.build.BASELINE1_SHA256`, the digest that
`chip_smoke.py` holds the card host's build to.  The mempool refuses a
sender's 65th transaction with the same reason in both packages, and a
reorg between two branches through `ReorgHandler.apply` leaves the same
head, canonical index, tx locations and pool in both.  Bar: equal bytes.
"""

from __future__ import annotations

import gzip
import hashlib

import pytest
import torch

from ethrex_tpu.blockchain.payload import build_payload as jbuild_payload
from ethrex_tpu.blockchain.payload import \
    create_payload_header as jcreate_payload_header
from ethrex_tpu.evm import vm as jvm
from ethrex_tpu.evm.executor import InvalidTransaction as JInvalidTransaction
from ethrex_tpu.guest.execution import ProgramInput as JProgramInput
from ethrex_tpu.guest.witness import generate_witness as jgenerate_witness
from ethrex_tpu.node import Node as JNode
from ethrex_tpu.primitives.genesis import Genesis as JGenesis
from ethrex_tpu.primitives.transaction import Transaction as JTransaction
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.blockchain import mempool
from ethrex_tpu_torch.blockchain.payload import (build_payload,
                                                 create_payload_header)
from ethrex_tpu_torch.evm.executor import InvalidTransaction
from ethrex_tpu_torch.fixtures import build
from ethrex_tpu_torch.node import Node
from ethrex_tpu_torch.primitives.genesis import Genesis
from ethrex_tpu_torch.primitives.transaction import Transaction
from tests.test_torch_program_input import \
    baseline3_program_input as jbaseline3_program_input


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bytes(pi) -> bytes:
    return fixtures.canonical_json(pi.to_json())


def _port_tx(jtx) -> Transaction:
    """The same signed transaction as a port object, through its wire
    form."""
    return Transaction.decode_canonical(jtx.encode_canonical())


def _ref_tx(tx) -> JTransaction:
    """The same signed transaction as a JAX-package object."""
    return JTransaction.decode_canonical(tx.encode_canonical())


# ---------------------------------------------------------------------------
# building the batches
# ---------------------------------------------------------------------------

def test_baseline3_build_is_the_committed_fixture():
    walls: dict = {}
    pi = build.baseline3_program_input(walls=walls)
    path = fixtures.HERE / "baseline3_program_input.json.gz"
    assert _bytes(pi) == gzip.decompress(path.read_bytes())
    assert len(walls["produce_block"]) == build.BASELINE3_BLOCKS
    assert walls["build"] >= walls["generate_witness"] > 0


def test_baseline3_build_equals_the_reference_with_native_engines_off(
        monkeypatch):
    monkeypatch.setenv("ETHREX_TPU_NATIVE_MPT", "0")
    monkeypatch.setenv("ETHREX_TPU_NATIVE_EVM", "0")
    # the JAX package caches its native-loop probe; probe it again
    monkeypatch.setattr(jvm, "_NATIVE_STATE", [None])
    port = _bytes(build.baseline3_program_input())
    assert port == _bytes(jbaseline3_program_input())


def _reference_baseline1(timestamp: int) -> JProgramInput:
    node = JNode(JGenesis.from_json(
        build.baseline1_genesis(build.sender_address())))
    for tx in build.baseline1_transactions():
        node.submit_transaction(_ref_tx(tx))
    block = node.produce_block(timestamp=timestamp)
    return JProgramInput(blocks=[block],
                         witness=jgenerate_witness(node.chain, [block]),
                         config=node.config)


@pytest.mark.parametrize("timestamp", [12, 1_700_000_000])
def test_baseline1_through_the_mempool_equals_the_reference(timestamp):
    pi = build.baseline1_program_input(timestamp)
    assert len(pi.blocks[0].body.transactions) == build.BASELINE1_TXS
    assert pi.blocks[0].header.timestamp == timestamp
    assert _bytes(pi) == _bytes(_reference_baseline1(timestamp))


def test_baseline1_hashes_to_its_committed_digest():
    digest = hashlib.sha256(_bytes(build.baseline1_program_input(12)))
    assert digest.hexdigest() == build.BASELINE1_SHA256


# ---------------------------------------------------------------------------
# the mempool's admission
# ---------------------------------------------------------------------------

def _submit_all(node, txs, error):
    """Submit `txs` in order; the index, message and reason of the first
    refusal (None if every one was admitted)."""
    for i, tx in enumerate(txs):
        try:
            node.submit_transaction(tx)
        except error as e:
            return i, str(e), getattr(e, "reason", None)
    return None


def test_sender_cap_refuses_the_65th_transaction_alike():
    sender = build.sender_address()
    genesis = build.baseline1_genesis(sender)
    jtxs = [JTransaction(
        tx_type=2, chain_id=build.CHAIN_ID, nonce=n,
        max_priority_fee_per_gas=1, max_fee_per_gas=10**10,
        gas_limit=21_000, to=bytes([0x50]) * 20, value=1 + n,
    ).sign(build.SECRET) for n in range(mempool.MAX_SENDER_SLOTS + 1)]
    port = _submit_all(Node(Genesis.from_json(genesis)),
                       [_port_tx(t) for t in jtxs], InvalidTransaction)
    ref = _submit_all(JNode(JGenesis.from_json(genesis)), jtxs,
                      JInvalidTransaction)
    assert port == ref
    assert port[0] == mempool.MAX_SENDER_SLOTS
    assert port[2] == "sender_limit"


@pytest.mark.parametrize("case", ["wrong_chain_id", "nonce_too_low",
                                  "underpriced", "replacement"])
def test_admission_verdicts_match_the_reference(case):
    sender = build.sender_address()
    genesis = build.baseline1_genesis(sender)

    def tx(nonce, tip=1, fee=10**10, chain_id=build.CHAIN_ID, value=1):
        return JTransaction(
            tx_type=2, chain_id=chain_id, nonce=nonce,
            max_priority_fee_per_gas=tip, max_fee_per_gas=fee,
            gas_limit=21_000, to=bytes([0x51]) * 20,
            value=value).sign(build.SECRET)

    stream = {
        "wrong_chain_id": [tx(0, chain_id=1)],
        "nonce_too_low": [tx(0), tx(1)],
        "underpriced": [tx(0, fee=1, tip=1)],
        "replacement": [tx(0, tip=100, fee=10**10), tx(0, tip=105,
                                                       fee=10**10),
                        tx(0, tip=200, fee=2 * 10**10, value=2)],
    }[case]
    results = []
    for make_node, convert, error in (
            (lambda: Node(Genesis.from_json(genesis)), _port_tx,
             InvalidTransaction),
            (lambda: JNode(JGenesis.from_json(genesis)), lambda t: t,
             JInvalidTransaction)):
        node = make_node()
        if case == "nonce_too_low":
            node.submit_transaction(convert(stream[0]))
            node.produce_block(timestamp=12)
            outcome = _submit_all(node, [convert(stream[0]),
                                         convert(stream[1])], error)
        else:
            outcome = _submit_all(node, [convert(t) for t in stream], error)
        pool = sorted(h.hex() for h in node.mempool.by_hash)
        results.append((outcome, pool, node.mempool.stats_json()))
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# fork choice: a reorg between two branches
# ---------------------------------------------------------------------------

def _reorg_drill(node_cls, genesis_cls, payload_header, payload, convert):
    """Branch A (two blocks through the mempool) is canonical; branch B
    (three blocks sealed on genesis, another coinbase, a subset of A's
    transactions) is then made the head, and A again.  The head, the
    canonical index, every tx location and the pool after each move."""
    sender = build.sender_address()
    node = node_cls(genesis_cls.from_json(build.baseline1_genesis(sender)))
    txs = [convert(t) for t in build.baseline1_transactions()]
    for tx in txs[:4]:
        node.submit_transaction(tx)
    node.produce_block(timestamp=12)
    for tx in txs[4:7]:
        node.submit_transaction(tx)
    node.produce_block(timestamp=24)
    a_head = node.store.head_header().hash

    parent = node.store.get_header(node.store.canonical_hash(0))
    for ts, chosen in ((13, txs[:2]), (25, txs[2:3]), (37, [])):
        header = payload_header(parent, node.config, timestamp=ts,
                                coinbase=b"\x99" * 20)
        block = payload(node.chain, parent, header, list(chosen), []).block
        node.chain.add_block(block)
        parent = block.header
    b_head = parent.hash

    def snapshot(outcome):
        store = node.store
        head = store.head_header()
        return {
            "head": head.hash.hex(),
            "canonical": [store.canonical_hash(n).hex()
                          for n in range(head.number + 1)],
            "above_head": store.canonical_hash(head.number + 1),
            "txloc": {t.hash.hex(): (None if loc is None
                                     else (loc[0].hex(), loc[1]))
                      for t in txs
                      for loc in [store.canonical_tx_location(t.hash)]},
            "pool": sorted(h.hex() for h in node.mempool.by_hash),
            "outcome": (outcome.depth, outcome.reinjected, outcome.evicted,
                        outcome.pruned,
                        [b.hash.hex() for b in outcome.adopted],
                        [b.hash.hex() for b in outcome.orphaned]),
        }

    steps = [snapshot(node.reorg_handler.apply(b_head))]
    steps.append(snapshot(node.reorg_handler.apply(a_head)))
    steps.append(node.reorg_handler.stats_json())
    return steps


def test_two_branch_reorg_matches_the_reference():
    port = _reorg_drill(Node, Genesis, create_payload_header, build_payload,
                        _port_tx)
    ref = _reorg_drill(JNode, JGenesis, jcreate_payload_header,
                       jbuild_payload, _ref_tx)
    assert port == ref
    to_b, back_to_a = port[0], port[1]
    # A's two blocks were orphaned, B's three adopted; the transactions
    # only A included went back to the pool
    assert to_b["outcome"][0] == 2 and len(to_b["outcome"][4]) == 3
    assert to_b["outcome"][1] == 4 and len(to_b["pool"]) == 4
    assert back_to_a["outcome"][0] == 3 and back_to_a["pool"] == []


def test_dev_producer_includes_submitted_transactions_and_stops():
    node = Node(Genesis.from_json(
        build.baseline1_genesis(build.sender_address())))
    for tx in build.baseline1_transactions():
        node.submit_transaction(tx)
    node.start_dev_producer(block_time=0.05)
    try:
        import time

        deadline = time.monotonic() + 60
        while len(node.mempool) and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        assert node.stop(timeout=30)
    assert len(node.mempool) == 0
    included = [tx for n in range(1, node.store.latest_number() + 1)
                for tx in node.store.get_block(
                    node.store.canonical_hash(n)).body.transactions]
    assert [tx.hash for tx in included] == \
        [tx.hash for tx in build.baseline1_transactions()]


# ---------------------------------------------------------------------------
# the chain-path telemetry that the mempool and the node feed
# ---------------------------------------------------------------------------

def _drive_chain_path(module, sample: int):
    """One scripted pipeline on a fake clock: 12 admissions, a
    replacement and an eviction, two blocks, a batch that is proved and
    settled.  The instrument's own JSON, its health and its verdict."""
    now = [100.0]
    path = module.ChainPath(sample=sample, ring=8, window=30.0,
                            clock=lambda: now[0])
    hashes = [bytes([n]) * 32 for n in range(12)]
    for h in hashes:
        path.tx_admitted(h)
        now[0] += 0.25
    path.tx_removed(hashes[0], "replaced", 0.5)
    path.tx_removed(hashes[1], "fifo", 1.0)
    for number, block in ((1, hashes[2:7]), (2, hashes[7:])):
        now[0] += 2.0
        path.txs_selected(block)
        now[0] += 0.125
        path.block_produced(number, block, 0.125)
        for h in block:
            path.tx_removed(h, "included", 3.0)
    now[0] += 5.0
    path.blocks_batched(1, 1, 2, trace_id="ab" * 16)
    now[0] += 7.0
    path.batch_proved(1)
    now[0] += 1.0
    path.batches_settled(1)
    return (path.to_json(), path.health_json(),
            module.explain_chain_path(path), path.errors)


@pytest.mark.parametrize("sample", [1, 3])
def test_chain_path_reads_as_the_reference(sample):
    from ethrex_tpu.perf import chain_path as jchain_path
    from ethrex_tpu_torch.perf import chain_path

    port = _drive_chain_path(chain_path, sample)
    assert port == _drive_chain_path(jchain_path, sample)
    assert port[3] == 0
    assert port[0]["blocksProduced"] == 2

