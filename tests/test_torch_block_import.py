"""The port's block import (`ethrex_tpu_torch/blockchain/blockchain.py`,
`storage/store.py`, `primitives/bal.py`, `blockchain/sender_recovery.py`,
`utils/ef_blockchain.py`) against the JAX package's.

The blocks are the committed `mixed` and BASELINE-3 batches
(`ethrex_tpu_torch/fixtures/`), imported over their genesis into a
fresh store of each package by `add_block`, `add_blocks_in_batch` and
`add_blocks_pipelined`: the same state roots and the same store tables
(headers, blocks, receipts, tx locations, trie nodes, code).  A block
with a wrong state root, gas used or base fee is refused by both with
the same message and leaves no chain record in either store.  `generate_bal`
derives the same EIP-7928 list, and an import that checks a claimed
list accepts it in both.  The five vendored EF BlockchainTest units pass
under the port's runner with the JAX runner's outcomes, and
`recover_senders` marks the same transactions invalid.  With the
node table's diff layering on, both stores hold the same layers and base
through a refused import, an import, a finalization and a close.  Bar:
equal bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch

from ethrex_tpu.blockchain import sender_recovery as jsender_recovery
from ethrex_tpu.blockchain.blockchain import Blockchain as JBlockchain
from ethrex_tpu.blockchain.blockchain import InvalidBlock as JInvalidBlock
from ethrex_tpu.crypto import secp256k1 as jsecp
from ethrex_tpu.primitives.block import Block as JBlock
from ethrex_tpu.primitives.genesis import Genesis as JGenesis
from ethrex_tpu.primitives.transaction import \
    SENDER_INVALID as JSENDER_INVALID
from ethrex_tpu.primitives.transaction import Transaction as JTransaction
from ethrex_tpu.storage.store import Store as JStore
from ethrex_tpu.utils import ef_blockchain as jef
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.blockchain import sender_recovery
from ethrex_tpu_torch.blockchain.blockchain import Blockchain, InvalidBlock
from ethrex_tpu_torch.fixtures import build
from ethrex_tpu_torch.guest import token_template as tt
from ethrex_tpu_torch.primitives.genesis import Genesis
from ethrex_tpu_torch.primitives.transaction import (SENDER_INVALID,
                                                     Transaction)
from ethrex_tpu_torch.storage.store import Store
from ethrex_tpu_torch.utils import ef_blockchain
from tests.test_stateless import GENESIS, SENDER

EF_SMOKE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "ef_blockchain", "smoke.json")
TOKEN = bytes.fromhex("7070" * 10)
IMPORTERS = ["add_block", "add_blocks_in_batch", "add_blocks_pipelined"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    # the recovery pools' threads end with the module
    for module in (sender_recovery, jsender_recovery):
        if module._pool is not None:
            module._pool.shutdown(wait=True)
            module._pool = None


def _genesis_json(name: str) -> dict:
    if name == "baseline3":
        return build.token_genesis(build.sender_address())[1]
    # tests/test_torch_host_batches.py mixed_batch's genesis
    genesis = dict(GENESIS)
    genesis["alloc"] = {
        "0x" + SENDER.hex(): {"balance": hex(10**21)},
        "0x" + TOKEN.hex(): {
            "balance": "0x0", "code": "0x" + tt.TEMPLATE_CODE.hex(),
            "storage": {hex(tt.balance_slot(SENDER)): hex(1_000_000)}},
    }
    return genesis


def _chains(name: str):
    """A fresh (port chain, reference chain) over the batch's genesis and
    the batch's blocks as each package's objects."""
    g = _genesis_json(name)
    store, jstore = Store(), JStore()
    genesis, jgenesis = Genesis.from_json(g), JGenesis.from_json(g)
    store.init_genesis(genesis)
    jstore.init_genesis(jgenesis)
    blocks = fixtures.load_program_input(name).blocks
    jblocks = [JBlock.decode(b.encode()) for b in blocks]
    return ((Blockchain(store, genesis.config), blocks),
            (JBlockchain(jstore, jgenesis.config), jblocks))


def _tables(store) -> dict:
    """Every table the import writes, as bytes in hex."""
    return {
        "headers": {k.hex(): v.encode().hex()
                    for k, v in store.headers.items()},
        "blocks": {k.hex(): store.get_block(k).encode().hex()
                   for k in store.headers},
        "receipts": {k.hex(): [r.encode().hex() for r in v]
                     for k, v in store.receipts.items()},
        "tx_index": {k.hex(): (v[0].hex(), v[1])
                     for k, v in store.tx_index.items()},
        "nodes": {k.hex(): bytes(v).hex() for k, v in store.nodes.items()},
        "code": {k.hex(): bytes(v).hex() for k, v in store.code.items()},
        "canonical": {n: h.hex() for n, h in store.canonical.items()},
    }


def _import(chain, blocks, importer: str) -> None:
    if importer == "add_block":
        for block in blocks:
            chain.add_block(block)
    else:
        getattr(chain, importer)(blocks)


@pytest.mark.parametrize("importer", IMPORTERS)
@pytest.mark.parametrize("name", ["mixed", "baseline3"])
def test_import_writes_the_reference_tables(name, importer):
    (chain, blocks), (jchain, jblocks) = _chains(name)
    _import(chain, blocks, importer)
    _import(jchain, jblocks, importer)
    tables = _tables(chain.store)
    assert tables == _tables(jchain.store)
    assert set(tables["headers"]) >= {b.hash.hex() for b in blocks}
    assert len(tables["tx_index"]) == sum(len(b.body.transactions)
                                          for b in blocks)
    # the batch importer merkleizes once, at its last block
    merkleized = blocks[-1:] if importer == "add_blocks_in_batch" else blocks
    for block in merkleized:
        assert chain.store.nodes.get(block.header.state_root) is not None


def _tamper(block, field: str):
    header = dataclasses.replace(block.header)
    if field == "state_root":
        header.state_root = b"\x11" * 32
    elif field == "gas_used":
        header.gas_used += 1
    else:
        header.base_fee_per_gas += 1
    return type(block)(header, block.body)


@pytest.mark.parametrize("field", ["state_root", "gas_used", "base_fee"])
@pytest.mark.parametrize("importer", ["add_block", "add_blocks_pipelined"])
def test_invalid_block_is_refused_alike(field, importer):
    (chain, blocks), (jchain, jblocks) = _chains("mixed")
    before = _tables(chain.store)
    outcomes = []
    for ch, bl, error in ((chain, blocks, InvalidBlock),
                          (jchain, jblocks, JInvalidBlock)):
        with pytest.raises(error) as info:
            _import(ch, [_tamper(bl[0], field)], importer)
        outcomes.append(str(info.value))
    assert outcomes[0] == outcomes[1]
    assert field.replace("_", " ") in outcomes[0]
    after = _tables(chain.store)
    assert after == _tables(jchain.store)
    # no chain record of the refused block; the trie nodes that its
    # merkleize wrote stay, content-addressed, in both
    after.pop("nodes"), before.pop("nodes")
    assert after == before


def _layers(store) -> dict:
    """The diff layers over the node table and the base beneath them."""
    nodes = store.nodes
    return {
        "tags": [(n, h.hex()) for n, h in nodes.layer_tags()],
        "layers": [{k.hex(): bytes(v).hex() for k, v in w.items()}
                   for _, w in nodes.layers],
        "base": {k.hex(): bytes(v).hex() for k, v in nodes.base.items()},
        "pending": nodes.pending(),
    }


@pytest.mark.parametrize("importer", IMPORTERS)
def test_layered_store_matches_the_reference(importer):
    """Diff layering on: a refused import, the batch's import, a
    finalization and a close leave the same layers and base tables."""
    from ethrex_tpu.blockchain.fork_choice import \
        apply_fork_choice as japply_fork_choice
    from ethrex_tpu_torch.blockchain.fork_choice import apply_fork_choice

    (chain, blocks), (jchain, jblocks) = _chains("baseline3")
    chain.store.enable_layering()
    jchain.store.enable_layering()
    for ch, bl, error in ((chain, blocks, InvalidBlock),
                          (jchain, jblocks, JInvalidBlock)):
        with pytest.raises(error, match="state root"):
            _import(ch, [_tamper(bl[0], "state_root")], importer)
    assert _layers(chain.store) == _layers(jchain.store)
    assert chain.store.nodes.layer_tags() == []

    _import(chain, blocks, importer)
    _import(jchain, jblocks, importer)
    assert _tables(chain.store) == _tables(jchain.store)
    layered = _layers(chain.store)
    assert layered == _layers(jchain.store)
    # the batch importer writes straight to the base; the others open
    # a layer per block or per batch
    if importer == "add_blocks_in_batch":
        assert layered["tags"] == []
    else:
        assert layered["tags"]
        assert blocks[-1].header.state_root.hex() not in layered["base"]

    fork_choice = ((apply_fork_choice, chain, blocks),
                   (japply_fork_choice, jchain, jblocks))
    for apply, ch, bl in fork_choice:
        apply(ch.store, bl[-1].hash, finalized_hash=bl[1].hash)
    assert _layers(chain.store) == _layers(jchain.store)
    assert all(n > 2 for n, _ in chain.store.nodes.layer_tags())
    assert _tables(chain.store) == _tables(jchain.store)

    chain.store.close()
    jchain.store.close()
    settled = _layers(chain.store)
    assert settled == _layers(jchain.store)
    assert settled["tags"] == [] and settled["pending"] == (0, 0)
    assert blocks[-1].header.state_root.hex() in settled["base"]


@pytest.mark.parametrize("name", ["mixed", "baseline3"])
def test_generate_bal_and_a_checked_import_match_the_reference(name):
    (chain, blocks), (jchain, jblocks) = _chains(name)
    for block, jblock in zip(blocks, jblocks):
        parent = chain.store.get_header(block.header.parent_hash)
        jparent = jchain.store.get_header(jblock.header.parent_hash)
        bal = chain.generate_bal(block, parent)
        jbal = jchain.generate_bal(jblock, jparent)
        assert bal.encode() == jbal.encode()
        assert bal.hash() == jbal.hash()
        assert len(bal.accounts) > 0
        chain.add_block(block, bal=bal)
        jchain.add_block(jblock, bal=jbal)
    assert _tables(chain.store) == _tables(jchain.store)


def test_a_tampered_bal_is_refused_alike():
    (chain, blocks), (jchain, jblocks) = _chains("mixed")
    outcomes = []
    for ch, block, error in ((chain, blocks[0], InvalidBlock),
                             (jchain, jblocks[0], JInvalidBlock)):
        parent = ch.store.get_header(block.header.parent_hash)
        bal = ch.generate_bal(block, parent)
        # claim one account fewer than the block touches
        bal.accounts = bal.accounts[:-1]
        with pytest.raises(error) as info:
            ch.add_block(block, bal=bal)
        outcomes.append(str(info.value))
    assert outcomes[0] == outcomes[1] == "block access list mismatch"


def _ef_units() -> dict:
    with open(EF_SMOKE) as f:
        return json.load(f)


@pytest.mark.parametrize("unit", sorted(_ef_units()))
def test_ef_blockchain_unit_matches_the_reference_runner(unit):
    outcomes = []
    for runner in (ef_blockchain, jef):
        try:
            runner.run_unit(unit, _ef_units()[unit])
            outcomes.append(None)
        except runner.FixtureFailure as e:
            outcomes.append(str(e))
    assert outcomes == [None, None]


def test_ef_blockchain_smoke_file_passes():
    result = ef_blockchain.run_fixture_file(EF_SMOKE)
    assert result == jef.run_fixture_file(EF_SMOKE)
    assert result == {"passed": 5, "skipped": 0, "failures": []}


# a small r whose x-coordinate is off the curve: recovery fails in the
# engine, not by inspection
NON_RESIDUE_R = next(r for r in range(2, 100)
                     if jsecp.recover(b"\x55" * 32, r, 1, 0) is None)


def _recovery_batch() -> list:
    """Signed transactions of three types, then each way a signature can
    be invalid: high s, a v out of range, an r off the curve, r = 0."""
    txs = []
    for n in range(12):
        kind = n % 3
        tx = JTransaction(
            tx_type=(0, 1, 2)[kind], chain_id=1337, nonce=n,
            gas_price=10**10 if kind < 2 else 0,
            max_priority_fee_per_gas=1 if kind == 2 else 0,
            max_fee_per_gas=10**10 if kind == 2 else 0,
            gas_limit=21_000, to=bytes([0x40 + n]) * 20,
            value=n).sign(0xB0B + n)
        txs.append(tx)
    high_s = dataclasses.replace(txs[2])
    high_s.s, high_s.v = jsecp.N - high_s.s, high_s.v ^ 1
    bad_v = dataclasses.replace(txs[5])
    bad_v.v = 7
    off_curve = dataclasses.replace(txs[8])
    off_curve.r, off_curve.s = NON_RESIDUE_R, 1
    zero_r = dataclasses.replace(txs[11])
    zero_r.r = 0
    return txs + [high_s, bad_v, off_curve, zero_r]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_recover_senders_marks_the_same_transactions_invalid(mode):
    jtxs = _recovery_batch()
    txs = [Transaction.decode_canonical(t.encode_canonical()) for t in jtxs]
    jtxs = [JTransaction.decode_canonical(t.encode_canonical())
            for t in jtxs]
    if mode == "sync":
        counts = (sender_recovery.recover_senders(txs),
                  jsender_recovery.recover_senders(jtxs))
        assert counts[0] == counts[1]
    else:
        sender_recovery.recover_senders_async(txs).wait(60)
        jsender_recovery.recover_senders_async(jtxs).wait(60)

    def senders(batch, invalid):
        return ["invalid" if t._sender is invalid else t._sender.hex()
                for t in batch]

    port = senders(txs, SENDER_INVALID)
    assert port == senders(jtxs, JSENDER_INVALID)
    assert port[12:] == ["invalid"] * 4
    assert "invalid" not in port[:12]
    # the cache is what the executor reads
    assert [t.sender() for t in txs[:12]] == [bytes.fromhex(s)
                                              for s in port[:12]]
