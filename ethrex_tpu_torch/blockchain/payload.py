"""Payload building: create a block skeleton, fill it from the mempool,
finalize roots — a copy of `ethrex_tpu/blockchain/payload.py` (upstream
ethrex's crates/blockchain/payload.rs create_payload / build_payload /
fill_transactions / finalize_payload)."""

from __future__ import annotations

import dataclasses
import time

from ..primitives.block import (Block, BlockBody, BlockHeader, ZERO_HASH,
                                ZERO_NONCE)
from ..primitives.transaction import TYPE_PRIVILEGED
from ..primitives.genesis import Fork
from ..primitives.receipt import Receipt, logs_bloom
from ..evm import gas as G
from ..evm.db import StateDB
from ..evm.executor import InvalidTransaction, execute_tx
from ..evm.vm import BlockEnv
from .blockchain import (Blockchain, compute_receipts_root,
                         compute_requests_hash, compute_tx_root,
                         compute_withdrawals_root, next_base_fee)


@dataclasses.dataclass
class PayloadBuildResult:
    block: Block
    receipts: list
    state_db: StateDB
    fees_collected: int = 0


def create_payload_header(parent: BlockHeader, config, *, timestamp: int,
                          coinbase: bytes, prev_randao: bytes = ZERO_HASH,
                          gas_limit: int | None = None,
                          extra_data: bytes = b"") -> BlockHeader:
    fork = config.fork_at(parent.number + 1, timestamp)
    h = BlockHeader(
        parent_hash=parent.hash, coinbase=coinbase,
        number=parent.number + 1,
        gas_limit=gas_limit or parent.gas_limit,
        timestamp=timestamp, extra_data=extra_data,
        prev_randao=prev_randao, nonce=ZERO_NONCE, difficulty=0,
    )
    if fork >= Fork.LONDON:
        h.base_fee_per_gas = next_base_fee(parent)
    if fork >= Fork.SHANGHAI:
        h.withdrawals_root = None  # filled at finalize
    if fork >= Fork.CANCUN:
        target, max_bg, fraction = config.blob_params_at(timestamp)
        h.excess_blob_gas = G.calc_excess_blob_gas(
            parent.excess_blob_gas or 0, parent.blob_gas_used or 0,
            target, max_bg, fraction,
            parent_base_fee=parent.base_fee_per_gas or 0,
            eip7918=fork >= Fork.OSAKA)
    return h


def build_payload(chain: Blockchain, parent: BlockHeader,
                  header: BlockHeader, txs: list, withdrawals: list,
                  parent_beacon_block_root: bytes = ZERO_HASH,
                  mempool=None) -> PayloadBuildResult:
    """Execute txs on top of parent and finalize a full block.

    txs: ordered candidate transactions; invalid ones are skipped (and
    dropped from `mempool` if given) rather than failing the build.

    The build is decomposed into profiler stage spans under component
    ``payload`` (select / execute / merkleize / seal; drain and prewarm
    are recorded by the producer around this call) so the producer has
    the same stage breakdown the prover has — the chain-path X-ray
    reads it to say where a slow block spent its wall.
    """
    from ..perf.profiler import record_stage

    config = chain.config
    fork = config.fork_at(header.number, header.timestamp)
    env = BlockEnv(
        number=header.number, coinbase=header.coinbase,
        timestamp=header.timestamp, gas_limit=header.gas_limit,
        prev_randao=header.prev_randao,
        base_fee=header.base_fee_per_gas or 0,
        excess_blob_gas=header.excess_blob_gas or 0,
        parent_beacon_block_root=parent_beacon_block_root,
    )
    state = chain.store.state_db(parent.state_root)
    chain._pre_tx_system_ops(state, env, dataclasses.replace(
        header, parent_beacon_block_root=parent_beacon_block_root), fork)

    receipts = []
    included = []
    gas_used = 0
    blob_gas = 0
    fees = 0
    _, max_blob_gas, _ = config.blob_params_at(header.timestamp)
    select_s = 0.0
    execute_s = 0.0
    clock = time.monotonic
    for tx in txs:
        t_sel = clock()
        if gas_used + tx.gas_limit > header.gas_limit:
            select_s += clock() - t_sel
            continue
        tx_blob_gas = G.BLOB_GAS_PER_BLOB * len(tx.blob_versioned_hashes)
        if blob_gas + tx_blob_gas > max_blob_gas:
            select_s += clock() - t_sel
            continue
        t_exec = clock()
        select_s += t_exec - t_sel
        try:
            result = execute_tx(tx, state, env, config)
        except InvalidTransaction:
            execute_s += clock() - t_exec
            if mempool is not None:
                mempool.remove_transaction(tx.hash,
                                           reason="invalid_at_build")
            continue
        execute_s += clock() - t_exec
        gas_used += result.gas_used
        blob_gas += tx_blob_gas
        if tx.tx_type != TYPE_PRIVILEGED:
            tip = (tx.effective_gas_price(env.base_fee) or 0) - env.base_fee
            fees += result.gas_used * tip
        included.append(tx)
        receipts.append(Receipt(
            tx_type=tx.tx_type, succeeded=result.success,
            cumulative_gas_used=gas_used, logs=result.logs))

    t_seal = clock()
    for wd in withdrawals or []:
        if wd.amount:
            state.begin_tx()
            state.add_balance(wd.address, wd.amount * 10**9)
            state.finalize_tx()
    requests = chain._post_tx_requests(state, env, receipts, fork)

    header = dataclasses.replace(header)
    header.gas_used = gas_used
    t_merk = clock()
    header.tx_root = compute_tx_root(included)
    header.receipts_root = compute_receipts_root(receipts)
    header.bloom = logs_bloom([l for r in receipts for l in r.logs])
    merkleize_s = clock() - t_merk
    if fork >= Fork.SHANGHAI:
        header.withdrawals_root = compute_withdrawals_root(withdrawals or [])
    if fork >= Fork.CANCUN:
        header.blob_gas_used = blob_gas
        header.parent_beacon_block_root = parent_beacon_block_root
    if fork >= Fork.PRAGUE:
        header.requests_hash = compute_requests_hash(requests)
    t_merk = clock()
    header.state_root = chain.store.apply_account_updates(
        parent.state_root, state)
    merkleize_s += clock() - t_merk
    body = BlockBody(
        transactions=included, uncles=[],
        withdrawals=list(withdrawals or [])
        if fork >= Fork.SHANGHAI else None,
    )
    record_stage("payload", "select", select_s)
    record_stage("payload", "execute", execute_s)
    record_stage("payload", "merkleize", merkleize_s)
    record_stage("payload", "seal", clock() - t_seal - merkleize_s)
    return PayloadBuildResult(block=Block(header, body), receipts=receipts,
                              state_db=state, fees_collected=fees)
