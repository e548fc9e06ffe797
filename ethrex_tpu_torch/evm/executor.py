"""Transaction-level execution: validation, gas accounting, refunds, fees.

A copy of `ethrex_tpu/evm/executor.py` without its per-stage timers: the
prepare/validate/execute/finalize flow as one function.
"""

from __future__ import annotations

from ..crypto.keccak import keccak256
from ..primitives.genesis import ChainConfig, Fork
from ..primitives.transaction import TYPE_BLOB, TYPE_PRIVILEGED, Transaction
from . import gas as G
from . import precompiles
from .db import StateDB
from .vm import EVM, BlockEnv, Message, TxResult, DELEGATION_PREFIX


class InvalidTransaction(Exception):
    pass


def validate_tx(tx: Transaction, sender: bytes, state: StateDB,
                block: BlockEnv, config: ChainConfig,
                fork: Fork) -> int:
    """Stateful validation; returns the effective gas price.

    Raises InvalidTransaction for consensus-invalid txs (block becomes
    invalid if included) — mirrors LEVM's validation list.
    """
    if tx.gas_limit > block.gas_limit:
        raise InvalidTransaction("gas limit above block gas limit")
    eff_price = tx.effective_gas_price(block.base_fee)
    if eff_price is None:
        raise InvalidTransaction("max fee per gas below base fee")
    if tx.max_fee() < tx.priority_fee():
        raise InvalidTransaction("priority fee above max fee")
    nonce = state.get_nonce(sender)
    if tx.nonce != nonce:
        raise InvalidTransaction(f"nonce mismatch: tx {tx.nonce} != {nonce}")
    if nonce >= (1 << 64) - 1:
        raise InvalidTransaction("nonce overflow")
    sender_code = state.get_code(sender)
    if sender_code and not sender_code.startswith(DELEGATION_PREFIX):
        raise InvalidTransaction("sender is not an EOA (EIP-3607)")
    # balance must cover value + gas_limit * max_fee (+ blob fees)
    cost = tx.value + tx.gas_limit * tx.max_fee()
    if tx.tx_type == TYPE_BLOB:
        if not tx.blob_versioned_hashes:
            raise InvalidTransaction("blob tx without blobs")
        for h in tx.blob_versioned_hashes:
            if len(h) != 32 or h[0] != 0x01:
                raise InvalidTransaction("bad blob versioned hash")
        blob_gas = G.BLOB_GAS_PER_BLOB * len(tx.blob_versioned_hashes)
        _, max_blob_gas, fraction = config.blob_params_at(block.timestamp)
        if blob_gas > max_blob_gas:
            raise InvalidTransaction("too many blobs")
        blob_fee = G.blob_base_fee(block.excess_blob_gas, fraction)
        if tx.max_fee_per_blob_gas < blob_fee:
            raise InvalidTransaction("blob fee below blob base fee")
        cost += blob_gas * tx.max_fee_per_blob_gas
        if tx.is_create:
            raise InvalidTransaction("blob tx cannot create")
    if state.get_balance(sender) < cost:
        raise InvalidTransaction("insufficient balance for gas * price")
    if tx.is_create and fork >= Fork.SHANGHAI \
            and len(tx.data) > G.MAX_INITCODE_SIZE:
        raise InvalidTransaction("initcode too large")
    if tx.chain_id is not None and tx.chain_id != config.chain_id:
        raise InvalidTransaction("wrong chain id")
    intrinsic, floor = G.intrinsic_gas(tx, fork)
    if tx.gas_limit < max(intrinsic, floor):
        raise InvalidTransaction("intrinsic gas above gas limit")
    return eff_price


def _apply_authorizations(tx: Transaction, state: StateDB,
                          config: ChainConfig) -> int:
    """EIP-7702: apply authorization tuples; returns refund for non-empty
    accounts."""
    from ..crypto import secp256k1
    from ..primitives import rlp

    refund = 0
    for auth in tx.authorization_list:
        if auth["chain_id"] not in (0, config.chain_id):
            continue
        if auth["nonce"] >= (1 << 64) - 1:
            continue
        if auth["s"] > secp256k1.N // 2:
            continue
        msg = keccak256(b"\x05" + rlp.encode(
            [auth["chain_id"], auth["address"], auth["nonce"]]))
        authority = secp256k1.recover_address(
            msg, auth["r"], auth["s"], auth["y_parity"])
        if authority is None:
            continue
        code = state.get_code(authority)
        if code and not code.startswith(DELEGATION_PREFIX):
            continue
        if state.get_nonce(authority) != auth["nonce"]:
            continue
        if state.account_exists(authority) and not state.is_empty(authority):
            refund += G.PER_EMPTY_ACCOUNT_AUTH - G.PER_AUTH_BASE
        state.warm_address(authority)
        if auth["address"] == b"\x00" * 20:
            state.set_code(authority, b"")
        else:
            state.set_code(authority, DELEGATION_PREFIX + auth["address"])
        state.increment_nonce(authority)
    return refund


def execute_privileged_tx(tx: Transaction, state: StateDB, block: BlockEnv,
                          config: ChainConfig) -> TxResult:
    """L1-originated deposit/message: mint value, run the call gas-free
    (authorization is the L1 inclusion proof, checked by the committer)."""
    state.begin_tx()
    sender = tx.from_addr
    state.add_balance(sender, tx.value)      # bridge mint
    state.increment_nonce(sender)
    evm = EVM(state, block, config, origin=sender)
    code, code_src = evm.resolve_code(tx.to) if tx.to else (b"", b"")
    msg = Message(caller=sender, to=tx.to, code_address=code_src,
                  value=tx.value, data=tx.data,
                  gas=max(tx.gas_limit, 21000) - G.TX_BASE, code=code)
    ok, _, output = evm.execute_message(msg)
    if not ok and tx.value:
        # the deposited VALUE must reach the recipient even when the call's
        # effects revert (the L1 deposit is consumed either way; leaving the
        # mint stranded at the bridge alias would burn user funds)
        state.sub_balance(sender, tx.value)
        state.add_balance(tx.to, tx.value)
    logs = list(state.logs) if ok else []
    state.finalize_tx()
    return TxResult(success=ok, gas_used=G.TX_BASE, output=output,
                    logs=logs, error=None if ok else "deposit call reverted")


def execute_tx(tx: Transaction, state: StateDB, block: BlockEnv,
               config: ChainConfig) -> TxResult:
    """Execute one transaction against the state (mutating it)."""
    if tx.tx_type == TYPE_PRIVILEGED:
        return execute_privileged_tx(tx, state, block, config)
    fork = config.fork_at(block.number, block.timestamp)
    sender = tx.sender()
    if sender is None:
        raise InvalidTransaction("invalid signature")
    state.begin_tx()
    state.clear_empty = fork >= Fork.SPURIOUS_DRAGON  # EIP-161
    eff_price = validate_tx(tx, sender, state, block, config, fork)

    # buy gas
    state.sub_balance(sender, tx.gas_limit * eff_price)
    if tx.tx_type == TYPE_BLOB:
        blob_gas = G.BLOB_GAS_PER_BLOB * len(tx.blob_versioned_hashes)
        _, _, fraction = config.blob_params_at(block.timestamp)
        state.sub_balance(
            sender,
            blob_gas * G.blob_base_fee(block.excess_blob_gas, fraction))
    state.increment_nonce(sender)

    intrinsic, floor = G.intrinsic_gas(tx, fork)
    gas = tx.gas_limit - intrinsic

    # warm-up (EIP-2929 + EIP-3651)
    state.warm_address(sender)
    if tx.to:
        state.warm_address(tx.to)
    if fork >= Fork.SHANGHAI:
        state.warm_address(block.coinbase)
    for addr in precompiles.active_precompiles(fork):
        state.warm_address(addr)
    for addr, slots in tx.access_list:
        state.warm_address(addr)
        for slot in slots:
            state.warm_slot(addr, slot)

    evm = EVM(state, block, config, gas_price=eff_price, origin=sender,
              blob_hashes=tx.blob_versioned_hashes)
    auth_refund = 0
    if tx.authorization_list:
        auth_refund = _apply_authorizations(tx, state, config)

    created = None
    if tx.is_create:
        msg = Message(caller=sender, to=b"", code_address=b"",
                      value=tx.value, data=b"", gas=gas, is_create=True,
                      code=tx.data)
        ok, gas_left, output = evm.execute_message(msg)
        if ok:
            created = output
            output = b""
    else:
        code, code_src = evm.resolve_code(tx.to)
        msg = Message(caller=sender, to=tx.to, code_address=code_src,
                      value=tx.value, data=tx.data, gas=gas, code=code)
        if precompiles.get_precompile(tx.to, fork) is not None:
            msg.code_address = tx.to
        ok, gas_left, output = evm.execute_message(msg)

    # refunds (pre-London: capped at gas_used/2; EIP-3529: gas_used/5)
    gas_used = tx.gas_limit - gas_left
    if ok:
        cap = gas_used // G.schedule_for(fork).refund_divisor
        refund = min(max(state.refund, 0) + auth_refund, cap)
        gas_used -= refund
    if fork >= Fork.PRAGUE:
        gas_used = max(gas_used, floor)  # EIP-7623 calldata floor
    gas_left = tx.gas_limit - gas_used

    # return unused gas, pay the coinbase the priority fee
    state.set_balance(
        sender, state.get_balance(sender) + gas_left * eff_price)
    tip = eff_price - block.base_fee
    if tip > 0:
        state.add_balance(block.coinbase, gas_used * tip)

    logs = list(state.logs) if ok else []
    state.finalize_tx()
    return TxResult(success=ok, gas_used=gas_used, output=output,
                    logs=logs, created=created,
                    error=None if ok else "execution reverted")
