"""The port's copies of the host primitives against the JAX package's:
keccak (the single-message form against the batched one), secp256k1 and
P-256, transaction, block and receipt encodings and hashes, sender
recovery, the trie and the fork schedule.  The inputs are the reference's
own test fixtures (tests/test_primitives.py, tests/test_sender_recovery.py,
tests/test_trie.py) and seeded random data.  Bar: equal bytes."""

from __future__ import annotations

import random

import numpy as np
import pytest

from ethrex_tpu.crypto import p256 as jp256
from ethrex_tpu.crypto import secp256k1 as jsecp
from ethrex_tpu.crypto.keccak import _keccak256_py
from ethrex_tpu.primitives import rlp as jrlp
from ethrex_tpu.primitives.block import Block as JBlock
from ethrex_tpu.primitives.block import BlockBody as JBlockBody
from ethrex_tpu.primitives.block import BlockHeader as JBlockHeader
from ethrex_tpu.primitives.block import Withdrawal as JWithdrawal
from ethrex_tpu.primitives.genesis import ChainConfig as JChainConfig
from ethrex_tpu.primitives.receipt import Log as JLog
from ethrex_tpu.primitives.receipt import Receipt as JReceipt
from ethrex_tpu.primitives.transaction import Transaction as JTransaction
from ethrex_tpu.trie import trie as jtrie
from ethrex_tpu_torch.crypto import p256, secp256k1
from ethrex_tpu_torch.crypto.keccak import keccak256, keccak256_batch
from ethrex_tpu_torch.primitives.block import Block, BlockHeader
from ethrex_tpu_torch.primitives.genesis import ChainConfig
from ethrex_tpu_torch.primitives.receipt import Receipt
from ethrex_tpu_torch.primitives.transaction import Transaction
from ethrex_tpu_torch.trie import trie
from tests.test_primitives import SECRET
from tests.test_sender_recovery import _tx_of_every_type

LENGTHS = (0, 1, 31, 32, 55, 64, 135, 136, 137, 200, 271, 272, 273, 500)
# the second secret of tests/test_primitives.py's secp256k1 test
SECRET2 = int("B71C71A67E1177AD4E901695E1B4B9EE"
              "17AE16C6668D313EAC2F96DBCDA3F291", 16)


@pytest.mark.parametrize("length", LENGTHS)
def test_single_message_keccak_equals_the_batched_one(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (3, length), dtype=np.uint8)
    batched = keccak256_batch(msgs)
    for msg, want in zip(msgs, batched):
        got = keccak256(msg.tobytes())
        assert got == want.tobytes() == _keccak256_py(msg.tobytes())


def test_secp256k1_and_p256_equal_the_reference():
    msg = keccak256(b"test message")
    for secret in (SECRET, SECRET2):
        sig = secp256k1.sign(msg, secret)
        assert sig == jsecp.sign(msg, secret)
        r, s, rec = sig
        for rid in (rec, rec ^ 1):
            assert secp256k1.recover_address(msg, r, s, rid) == \
                jsecp.recover_address(msg, r, s, rid)
        assert secp256k1.recover(msg, 0, s, rec) is None
    qx, qy = p256.pubkey_from_secret(0x1234567)
    r, s = p256.sign_for_tests(msg, 0x1234567)
    assert p256.verify(msg, r, s, qx, qy) and jp256.verify(msg, r, s, qx, qy)
    for args in ((msg, r, s + 1, qx, qy), (msg, r, s, qx, qy + 1),
                 (b"\x00" * 32, r, s, qx, qy)):
        assert p256.verify(*args) is jp256.verify(*args) is False


def test_transactions_encode_hash_and_recover_as_the_reference():
    txs = _tx_of_every_type()
    assert len({tx.tx_type for tx in txs}) >= 5
    for jtx in txs:
        wire = jtx.encode_canonical()
        tx = Transaction.decode_canonical(wire)
        assert tx.encode_canonical() == wire
        assert tx.hash == jtx.hash
        assert tx.signing_hash() == jtx.signing_hash()
        assert tx.sender() == JTransaction.decode_canonical(wire).sender()
        assert tx.effective_gas_price(7) == jtx.effective_gas_price(7)
    # signing itself: RFC 6979 nonces give the reference's bytes (the
    # fixture signs its i-th transaction with secret 0xAA1 + i)
    for i, jtx in enumerate(txs[:-1]):
        fields = Transaction.decode_canonical(jtx.encode_canonical())
        fields.v = fields.r = fields.s = 0
        fields._sender = None
        assert fields.sign(0xAA1 + i).encode_canonical() == \
            jtx.encode_canonical()


def test_blocks_and_receipts_encode_as_the_reference():
    txs = _tx_of_every_type()[:-1]
    header = JBlockHeader(number=5, gas_limit=30_000_000, timestamp=1000,
                          base_fee_per_gas=7, withdrawals_root=b"\x11" * 32,
                          blob_gas_used=0, excess_blob_gas=0,
                          parent_beacon_block_root=b"\x22" * 32)
    jblock = JBlock(header, JBlockBody(
        transactions=txs, withdrawals=[JWithdrawal(1, 2, b"\xcc" * 20, 3)]))
    wire = jblock.encode()
    block = Block.decode(wire)
    assert block.encode() == wire and block.hash == jblock.hash
    assert BlockHeader.decode(header.encode()).hash == header.hash
    assert [t.hash for t in block.body.transactions] == \
        [t.hash for t in txs]
    for jrec in (JReceipt(tx_type=2, succeeded=True,
                          cumulative_gas_used=21000,
                          logs=[JLog(address=b"\xaa" * 20,
                                     topics=[b"\x01" * 32], data=b"xy")]),
                 JReceipt(tx_type=0, succeeded=False,
                          cumulative_gas_used=1)):
        rec = Receipt.decode(jrec.encode())
        assert rec.encode() == jrec.encode() and rec.bloom == jrec.bloom


def test_tries_hash_as_the_reference():
    t, jt = trie.Trie(), jtrie.Trie()
    for k, v in [(b"do", b"verb"), (b"dog", b"puppy"), (b"doge", b"coin"),
                 (b"horse", b"stallion")]:
        t.insert(k, v)
        jt.insert(k, v)
    assert t.root_hash() == jt.root_hash() == bytes.fromhex(
        "5991bb8c6514148a29db676a14ac506cd2cd5775ace63c30a4fe457715e9ac84")
    rng = random.Random(42)
    t, jt = trie.Trie(), jtrie.Trie()
    keys = [keccak256(rng.randbytes(8)) for _ in range(200)]
    for i, k in enumerate(keys):
        v = jrlp.encode(rng.randrange(1, 1 << 64))
        t.insert(k, v)
        jt.insert(k, v)
        if i % 3 == 2:
            gone = keys[rng.randrange(i)]
            t.remove(gone)
            jt.remove(gone)
        if i % 20 == 0:
            assert t.root_hash() == jt.root_hash()
    root = t.commit()
    assert root == jt.commit()
    # a witness trie over the committed nodes reads what was written
    w = trie.Trie.from_nodes(root, dict(t._store))
    assert w.get(keys[-1]) == jt.get(keys[-1])
    items = [(jrlp.encode(i), rng.randbytes(rng.randrange(1, 80)))
             for i in range(40)]
    assert trie.trie_root_from_items(items) == \
        jtrie.trie_root_from_items(items)
    with pytest.raises(trie.MissingNode):
        trie.Trie.from_nodes(root, {}).get(keys[0])


def test_fork_schedule_equals_the_reference():
    cfg = {"chainId": 1337, "homesteadBlock": 0, "berlinBlock": 0,
           "londonBlock": 10, "terminalTotalDifficulty": 0,
           "shanghaiTime": 100, "cancunTime": 200, "pragueTime": 300,
           "blobSchedule": {"prague": {"target": 6, "max": 9}}}
    port, ref = ChainConfig.from_json(cfg), JChainConfig.from_json(cfg)
    for number, ts in ((0, 0), (20, 50), (20, 150), (20, 250), (20, 350)):
        assert port.fork_at(number, ts) == ref.fork_at(number, ts)
        assert port.blob_params_at(ts) == ref.blob_params_at(ts)


def test_host_stack_imports_leave_jax_and_the_jax_package_out():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import ethrex_tpu_torch.prover.gpu_backend, "
            "ethrex_tpu_torch.prover.backend, ethrex_tpu_torch.fixtures, "
            "ethrex_tpu_torch.guest.execution, "
            "ethrex_tpu_torch.guest.access_log, "
            "ethrex_tpu_torch.guest.witness_oracles, "
            "ethrex_tpu_torch.evm.executor, ethrex_tpu_torch.evm.precompiles, "
            "ethrex_tpu_torch.blockchain.blockchain, "
            "ethrex_tpu_torch.storage.store, ethrex_tpu_torch.l2.messages\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'ethrex_tpu' or "
            "m.startswith('ethrex_tpu.')]\n"
            "assert not bad, bad\n"
            "ethrex_tpu_torch.fixtures.load_program_input('mixed')\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
