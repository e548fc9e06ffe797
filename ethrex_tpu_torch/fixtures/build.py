"""Build the benchmark batches' `ProgramInput`s with the port's own node.

Each function makes a `Node` over a seeded genesis, produces its blocks
and records their witness with `guest.witness.generate_witness`, the way
a sequencer hands a batch to a prover.  The batches are those of
`ethrex_tpu/perf/bench_suite.py`:

* `baseline3_program_input`: BASELINE-3, 4 blocks of 125 ETH transfers
  and 125 token-template calls from one sender over `token_genesis`.
  Each block's 250 transactions go to `Node.produce_block` as
  `forced_txs`: the mempool's cap of 64 slots a sender would refuse them
  if they were submitted.  Its canonical JSON is the committed
  `baseline3_program_input.json.gz`.
* `baseline1_program_input`: BASELINE-1, one block of 10 ETH transfers
  submitted through `Node.submit_transaction` (the mempool's admission)
  and drained by `produce_block`.

Both take the block timestamps as arguments: `produce_block` otherwise
reads the wall clock, and the batch's bytes would change with it.

    python -m ethrex_tpu_torch.fixtures.build   # sha256 of both builds
"""

from __future__ import annotations

import time

from ..crypto import secp256k1
from ..guest import token_template as tt
from ..guest.execution import ProgramInput
from ..guest.witness import generate_witness
from ..node import Node
from ..primitives.genesis import Genesis
from ..primitives.transaction import Transaction

SECRET = 0xA11CE
CHAIN_ID = 1337
TOKEN = bytes.fromhex("7070" * 10)   # the token template's address
BASELINE3_BLOCKS, BASELINE3_PER_BLOCK = 4, 125
BASELINE1_TXS = 10
# sha256 of BASELINE-1's canonical JSON at timestamp 12, as this module's
# `__main__` prints it; the reference's node builds the same bytes
BASELINE1_SHA256 = \
    "380e20e54d13acf9720670ae64b171781f8e52b3dc6cd6220d2d3aea9ec7c27c"


def sender_address(secret: int = SECRET) -> bytes:
    return secp256k1.pubkey_to_address(secp256k1.pubkey_from_secret(secret))


def token_genesis(sender: bytes):
    """(token address, genesis JSON): the sender holds 10^21 wei and 10^15
    tokens of the token template deployed at `TOKEN`."""
    storage = {hex(tt.balance_slot(sender)): hex(10**15)}
    return TOKEN, {
        "config": {"chainId": CHAIN_ID, "terminalTotalDifficulty": 0,
                   "shanghaiTime": 0, "cancunTime": 0},
        "alloc": {
            "0x" + sender.hex(): {"balance": hex(10**21)},
            "0x" + TOKEN.hex(): {"balance": "0x0",
                                 "code": "0x" + tt.TEMPLATE_CODE.hex(),
                                 "storage": storage},
        },
        "gasLimit": hex(60_000_000), "baseFeePerGas": "0x7",
        "timestamp": "0x0",
    }


def _transfer(nonce: int, to: bytes, value: int) -> Transaction:
    return Transaction(
        tx_type=2, chain_id=CHAIN_ID, nonce=nonce,
        max_priority_fee_per_gas=1, max_fee_per_gas=10**10,
        gas_limit=21_000, to=to, value=value).sign(SECRET)


def baseline3_transactions(block: int) -> list:
    """Block `block`'s 250 signed transactions: alternately an ETH
    transfer and a token transfer, nonces counted from the block's
    first."""
    nonce = 2 * BASELINE3_PER_BLOCK * block
    txs = []
    for i in range(BASELINE3_PER_BLOCK):
        txs.append(_transfer(nonce, bytes([0x50 + i % 32]) * 20, 100 + i))
        txs.append(Transaction(
            tx_type=2, chain_id=CHAIN_ID, nonce=nonce + 1,
            max_priority_fee_per_gas=1, max_fee_per_gas=10**10,
            gas_limit=100_000, to=TOKEN, value=0,
            data=tt.transfer_calldata(bytes([0x60 + i % 16]) * 20,
                                      10 + i)).sign(SECRET))
        nonce += 2
    return txs


def baseline3_program_input(timestamps=None,
                            walls: dict | None = None) -> ProgramInput:
    """BASELINE-3's `ProgramInput`, block b at `timestamps[b]` (default
    12 (b + 1)).  `walls`, when given, receives the seconds of each
    `produce_block` (`produce_block`, a list), of `generate_witness` and
    of the whole build (`build`)."""
    if timestamps is None:
        timestamps = [12 * (b + 1) for b in range(BASELINE3_BLOCKS)]
    t_build = time.perf_counter()
    _, genesis = token_genesis(sender_address())
    node = Node(Genesis.from_json(genesis))
    produce_s = []
    blocks = []
    for b, ts in enumerate(timestamps):
        txs = baseline3_transactions(b)
        t0 = time.perf_counter()
        block = node.produce_block(timestamp=ts, forced_txs=txs)
        produce_s.append(time.perf_counter() - t0)
        if len(block.body.transactions) != len(txs):
            raise RuntimeError(
                f"block {block.header.number} holds "
                f"{len(block.body.transactions)} of {len(txs)} "
                "transactions")
        blocks.append(block)
    t0 = time.perf_counter()
    witness = generate_witness(node.chain, blocks)
    witness_s = time.perf_counter() - t0
    pi = ProgramInput(blocks=blocks, witness=witness, config=node.config)
    if walls is not None:
        walls.update(produce_block=produce_s, generate_witness=witness_s,
                     build=time.perf_counter() - t_build)
    return pi


def baseline1_genesis(sender: bytes) -> dict:
    return {
        "config": {"chainId": CHAIN_ID, "terminalTotalDifficulty": 0,
                   "shanghaiTime": 0, "cancunTime": 0},
        "alloc": {"0x" + sender.hex(): {"balance": hex(10**21)}},
        "gasLimit": hex(30_000_000), "baseFeePerGas": "0x7",
        "timestamp": "0x0",
    }


def baseline1_transactions() -> list:
    return [_transfer(n, bytes([0x50 + n]) * 20, 1000 + n)
            for n in range(BASELINE1_TXS)]


def baseline1_program_input(timestamp: int = 12) -> ProgramInput:
    """BASELINE-1's `ProgramInput`: its 10 transfers submitted through
    the mempool and produced as one block at `timestamp`."""
    node = Node(Genesis.from_json(baseline1_genesis(sender_address())))
    for tx in baseline1_transactions():
        node.submit_transaction(tx)
    block = node.produce_block(timestamp=timestamp)
    if len(block.body.transactions) != BASELINE1_TXS:
        raise RuntimeError(
            f"the block holds {len(block.body.transactions)} of "
            f"{BASELINE1_TXS} transactions")
    witness = generate_witness(node.chain, [block])
    return ProgramInput(blocks=[block], witness=witness, config=node.config)


if __name__ == "__main__":
    import hashlib

    from . import canonical_json

    for name, build in (("baseline3", baseline3_program_input),
                        ("baseline1", baseline1_program_input)):
        walls: dict = {}
        pi = build(walls=walls) if name == "baseline3" else build()
        digest = hashlib.sha256(canonical_json(pi.to_json())).hexdigest()
        print(name, digest, walls)
