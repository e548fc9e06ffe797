"""Block validation and execution for stateless batch execution: the parts
of `ethrex_tpu/blockchain/blockchain.py` that `guest.execution` calls
(`validate_header`, `execute_block`, `_validate_body_roots` and the root
and base-fee helpers).  Import into a store, the pipelined importer and the
block access list (EIP-7928) belong to the node and are not copied.
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..crypto.keccak import keccak256
from ..primitives import rlp
from ..primitives.block import Block, BlockHeader
from ..primitives.genesis import ChainConfig, Fork
from ..primitives.receipt import Receipt
from ..evm import gas as G
from ..evm.db import StateDB
from ..evm.executor import InvalidTransaction, execute_tx
from ..evm.vm import EVM, BlockEnv, Message
from ..trie.trie import trie_root_from_items

ELASTICITY_MULTIPLIER = 2
BASE_FEE_MAX_CHANGE_DENOMINATOR = 8
GAS_LIMIT_ADJUSTMENT_FACTOR = 1024
MIN_GAS_LIMIT = 5000

SYSTEM_ADDRESS = bytes.fromhex("fffffffffffffffffffffffffffffffffffffffe")
BEACON_ROOTS_ADDRESS = bytes.fromhex(
    "000f3df6d732807ef1319fb7b8bb8522d0beac02")
HISTORY_STORAGE_ADDRESS = bytes.fromhex(
    "0000f90827f1c53a10cb7a02335b175320002935")
WITHDRAWAL_REQUESTS_ADDRESS = bytes.fromhex(
    "00000961ef480eb55e80d19ad83579a64c007002")
CONSOLIDATION_REQUESTS_ADDRESS = bytes.fromhex(
    "0000bbddc7ce488642fb579f8b00f3a590007251")
DEPOSIT_CONTRACT_ADDRESS = bytes.fromhex(
    "00000000219ab540356cbb839cbe05303d7705fa")

GWEI = 10**9


class InvalidBlock(Exception):
    pass


@dataclasses.dataclass
class ExecutionOutcome:
    receipts: list
    state_db: StateDB
    gas_used: int
    blob_gas_used: int
    requests: list  # raw request bytes (type || data), non-empty only


class Blockchain:
    def __init__(self, config: ChainConfig):
        self.config = config

    # ------------------------------------------------------------------
    # header validation (parent-relative)
    # ------------------------------------------------------------------
    def validate_header(self, header: BlockHeader, parent: BlockHeader):
        if header.number != parent.number + 1:
            raise InvalidBlock("bad block number")
        if header.timestamp <= parent.timestamp:
            raise InvalidBlock("timestamp not after parent")
        if len(header.extra_data) > 32:
            raise InvalidBlock("extra data too long")
        fork = self.config.fork_at(header.number, header.timestamp)
        # gas limit bounds
        diff = abs(header.gas_limit - parent.gas_limit)
        if diff >= parent.gas_limit // GAS_LIMIT_ADJUSTMENT_FACTOR:
            raise InvalidBlock("gas limit change too large")
        if header.gas_limit < MIN_GAS_LIMIT:
            raise InvalidBlock("gas limit too low")
        if header.gas_used > header.gas_limit:
            raise InvalidBlock("gas used above limit")
        if fork >= Fork.LONDON:
            expected = next_base_fee(parent)
            if header.base_fee_per_gas != expected:
                raise InvalidBlock(
                    f"bad base fee {header.base_fee_per_gas} != {expected}")
        if fork >= Fork.PARIS:
            if header.difficulty != 0 or header.nonce != b"\x00" * 8:
                raise InvalidBlock("post-merge difficulty/nonce must be zero")
        if fork >= Fork.SHANGHAI and header.withdrawals_root is None:
            raise InvalidBlock("missing withdrawals root")
        if fork >= Fork.CANCUN:
            if header.blob_gas_used is None or header.excess_blob_gas is None:
                raise InvalidBlock("missing blob gas fields")
            # spec + reference (block.rs validate_excess_blob_gas): the
            # schedule and fork are resolved at the NEW block's timestamp
            target, max_bg, fraction = self.config.blob_params_at(
                header.timestamp)
            expected_excess = G.calc_excess_blob_gas(
                parent.excess_blob_gas or 0, parent.blob_gas_used or 0,
                target, max_bg, fraction,
                parent_base_fee=parent.base_fee_per_gas or 0,
                eip7918=fork >= Fork.OSAKA)
            if header.excess_blob_gas != expected_excess:
                raise InvalidBlock("bad excess blob gas")
            if header.parent_beacon_block_root is None:
                raise InvalidBlock("missing parent beacon block root")
        if fork >= Fork.PRAGUE and header.requests_hash is None:
            raise InvalidBlock("missing requests hash")

    # ------------------------------------------------------------------
    # system operations
    # ------------------------------------------------------------------
    def _system_call(self, state: StateDB, block_env: BlockEnv,
                     target: bytes, data: bytes):
        if not state.get_code(target):
            return None
        evm = EVM(state, block_env, self.config)
        ok, _, out = evm.execute_message(Message(
            caller=SYSTEM_ADDRESS, to=target, code_address=target,
            value=0, data=data, gas=30_000_000))
        return out if ok else None

    def _pre_tx_system_ops(self, state: StateDB, env: BlockEnv,
                           header: BlockHeader, fork: Fork):
        state.begin_tx()
        if fork >= Fork.CANCUN and header.parent_beacon_block_root:
            self._system_call(state, env, BEACON_ROOTS_ADDRESS,
                              header.parent_beacon_block_root)
        if fork >= Fork.PRAGUE:
            self._system_call(state, env, HISTORY_STORAGE_ADDRESS,
                              header.parent_hash)
        state.finalize_tx()

    def _post_tx_requests(self, state: StateDB, env: BlockEnv,
                          receipts: list, fork: Fork) -> list:
        if fork < Fork.PRAGUE:
            return []
        requests = []
        # EIP-6110 deposits from the deposit contract logs
        deposit_data = b""
        for rec in receipts:
            for log in rec.logs:
                if log.address == DEPOSIT_CONTRACT_ADDRESS and log.topics:
                    deposit_data += _parse_deposit_log(log.data)
        if deposit_data:
            requests.append(b"\x00" + deposit_data)
        state.begin_tx()
        out = self._system_call(state, env, WITHDRAWAL_REQUESTS_ADDRESS, b"")
        if out:
            requests.append(b"\x01" + out)
        out = self._system_call(state, env, CONSOLIDATION_REQUESTS_ADDRESS,
                                b"")
        if out:
            requests.append(b"\x02" + out)
        state.finalize_tx()
        return requests

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute_block(self, block: Block, parent: BlockHeader,
                      state: StateDB) -> ExecutionOutcome:
        """Execute `block` on `state` (mutating it): system operations,
        transactions, withdrawals and Prague requests."""
        header = block.header
        fork = self.config.fork_at(header.number, header.timestamp)
        env = BlockEnv(
            number=header.number, coinbase=header.coinbase,
            timestamp=header.timestamp, gas_limit=header.gas_limit,
            prev_randao=header.prev_randao,
            base_fee=header.base_fee_per_gas or 0,
            excess_blob_gas=header.excess_blob_gas or 0,
            parent_beacon_block_root=header.parent_beacon_block_root
            or b"\x00" * 32,
            difficulty=header.difficulty,
        )
        self._pre_tx_system_ops(state, env, header, fork)

        receipts = []
        gas_used = 0
        blob_gas_used = 0
        for i, tx in enumerate(block.body.transactions):
            try:
                result = execute_tx(tx, state, env, self.config)
            except InvalidTransaction as e:
                raise InvalidBlock(f"tx {i} invalid: {e}")
            gas_used += result.gas_used
            if gas_used > header.gas_limit:
                raise InvalidBlock("block gas limit exceeded")
            blob_gas_used += G.BLOB_GAS_PER_BLOB * len(
                tx.blob_versioned_hashes)
            receipts.append(Receipt(
                tx_type=tx.tx_type, succeeded=result.success,
                cumulative_gas_used=gas_used, logs=result.logs))
        _, max_blob_gas, _ = self.config.blob_params_at(header.timestamp)
        if blob_gas_used > max_blob_gas:
            raise InvalidBlock("blob gas above maximum")

        # withdrawals
        if block.body.withdrawals:
            for wd in block.body.withdrawals:
                if wd.amount:
                    state.begin_tx()
                    state.add_balance(wd.address, wd.amount * GWEI)
                    state.finalize_tx()
        requests = self._post_tx_requests(state, env, receipts, fork)
        return ExecutionOutcome(receipts=receipts, state_db=state,
                                gas_used=gas_used,
                                blob_gas_used=blob_gas_used,
                                requests=requests)

    def _validate_body_roots(self, block: Block):
        header = block.header
        if compute_tx_root(block.body.transactions) != header.tx_root:
            raise InvalidBlock("transactions root mismatch")
        if block.body.withdrawals is not None:
            wroot = compute_withdrawals_root(block.body.withdrawals)
            if wroot != header.withdrawals_root:
                raise InvalidBlock("withdrawals root mismatch")
        if header.uncles_hash != keccak256(rlp.encode(block.body.uncles)):
            raise InvalidBlock("uncles hash mismatch")


def _parse_deposit_log(data: bytes) -> bytes:
    """Extract the 7685 deposit request payload from a deposit-event log."""
    # DepositEvent(bytes pubkey, bytes wc, bytes amount, bytes sig, bytes idx)
    # ABI-encoded dynamic fields; offsets at fixed positions.
    try:
        out = b""
        for i in range(5):
            off = int.from_bytes(data[32 * i:32 * (i + 1)], "big")
            ln = int.from_bytes(data[off:off + 32], "big")
            out += data[off + 32:off + 32 + ln]
        return out
    except Exception:
        return b""


def next_base_fee(parent: BlockHeader) -> int:
    """EIP-1559 base fee update."""
    if parent.base_fee_per_gas is None:
        return 1_000_000_000  # first London block
    parent_base = parent.base_fee_per_gas
    target = parent.gas_limit // ELASTICITY_MULTIPLIER
    if parent.gas_used == target:
        return parent_base
    if parent.gas_used > target:
        delta = max(
            parent_base * (parent.gas_used - target) // target
            // BASE_FEE_MAX_CHANGE_DENOMINATOR, 1)
        return parent_base + delta
    delta = parent_base * (target - parent.gas_used) // target \
        // BASE_FEE_MAX_CHANGE_DENOMINATOR
    return parent_base - delta


def compute_tx_root(txs) -> bytes:
    return trie_root_from_items(
        [(rlp.encode(i), tx.encode_canonical()) for i, tx in enumerate(txs)])


def compute_receipts_root(receipts) -> bytes:
    return trie_root_from_items(
        [(rlp.encode(i), r.encode()) for i, r in enumerate(receipts)])


def compute_withdrawals_root(withdrawals) -> bytes:
    return trie_root_from_items(
        [(rlp.encode(i), rlp.encode(w.to_fields()))
         for i, w in enumerate(withdrawals)])


def compute_requests_hash(requests: list[bytes]) -> bytes:
    acc = hashlib.sha256()
    for req in requests:
        if len(req) > 1:
            acc.update(hashlib.sha256(req).digest())
    return acc.digest()
