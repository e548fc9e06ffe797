"""Fine-grained VM log: the bridge between executed batches and the VM
circuits (models/transfer_air.py for account semantics; the token/storage
circuit consumes the TokSeg stream).  A copy of
`ethrex_tpu/guest/transfer_log.py`.

For a batch whose transactions are all plain ETH transfers OR calls to the
canonical token template (guest/token_template.py), this module re-derives
the batch's state writes per transaction from first principles:

  * plain transfer:  nonce + 1, balance - value - fee, balance + value,
                     coinbase + tip
  * token transfer:  nonce + 1, balance - fee, coinbase + tip, PLUS the
    two storage-slot writes of the template's transfer(dst, v):
        balances[caller] -= v   (slot keccak(pad32(caller)||pad32(0)))
        balances[dst]    += v   (slot keccak(pad32(dst)||pad32(0)))
                                               (SLOAD/SSTORE/CALL)

and emits a per-tx ordered raw log — sender row, the tx's slot rows,
coinbase row, with each touched token contract's account row once at block
end — whose per-key old/new chain is exactly what the state-update AIR and
the witness replay audit consume.

Safety: the model's final per-account AND per-slot states are compared
against the executor's coarse write log.  ANY behavioral difference — a
recipient with code, an EIP-7702 delegation, a token contract whose
bytecode is not the template, a reverted call, a balance wrap — makes the
comparison (or an explicit scope check) fail and the prover falls back to
the claimed-log mode, so the circuits never sign off on semantics the
model does not cover.  Per-tx gas for token calls comes from the
executor's receipts (their correctness is bound by the receipts-root check
in guest/execution.py); the analytic 21000 rule still covers transfers.
"""

from __future__ import annotations

import dataclasses

from ..models.transfer_air import CbSeg, TxSeg
from ..primitives.account import EMPTY_CODE_HASH, AccountState
from ..primitives.transaction import TYPE_PRIVILEGED, Transaction
from . import token_template as tmpl

TRANSFER_GAS = 21000


class NotTransferBatch(Exception):
    """The batch is outside the VM circuits' scope."""


def is_plain_transfer(tx: Transaction) -> bool:
    return (tx.tx_type in (0, 1, 2)
            and tx.to is not None
            and not tx.data
            and not tx.access_list
            and not tx.blob_versioned_hashes
            and not tx.authorization_list)


def is_token_call_shape(tx: Transaction) -> bool:
    """Static shape of a provable token-template call (the target's code
    is checked against the template hash during the build)."""
    return (tx.tx_type in (0, 1, 2)
            and tx.to is not None
            and tx.value == 0
            and tmpl.decode_transfer_calldata(tx.data) is not None
            and not tx.access_list
            and not tx.blob_versioned_hashes
            and not tx.authorization_list)


def is_generic_call_shape(tx: Transaction) -> bool:
    """Static shape of a potentially-provable generic bytecode call
    (models/bytecode_air.py).  Over-approximates: whether the
    EXECUTED trace stays inside the circuit's opcode subset and machine
    envelope is only known after running guest/bytecode_vm.run_trace."""
    return (tx.tx_type in (0, 1, 2)
            and tx.to is not None
            and tx.value == 0
            and not tx.access_list
            and not tx.blob_versioned_hashes
            and not tx.authorization_list)


@dataclasses.dataclass
class TxMeta:
    sender: bytes
    recipient: bytes      # tx.to: transfer recipient / called contract
    value: int
    fee: int
    tip: int
    kind: str = "xfer"    # "xfer" | "tok" | "gen"
    gas: int = TRANSFER_GAS
    dst: bytes = b""      # token transfer destination (kind == "tok")
    amount: int = 0       # token transfer amount (kind == "tok")
    data: bytes = b""     # calldata (kind == "gen")
    code: bytes = b""     # contract bytecode (kind == "gen")
    steps: list = dataclasses.field(default_factory=list)  # StepRecs


@dataclasses.dataclass
class BlockMeta:
    coinbase: bytes
    base_fee: int
    txs: list


@dataclasses.dataclass
class TokSeg:
    """One token-transfer's storage semantics (models/token_air.py)."""

    amount: int
    kf: int       # from-balance slot (mapping key as int)
    fold: int
    fnew: int
    kt: int       # to-balance slot
    told: int
    tnew: int
    noop: bool = False   # amount == 0: no slot rows


@dataclasses.dataclass
class BcCall:
    """One generic call's circuit witness (models/bytecode_air.py)."""

    steps: list            # bytecode_vm.StepRec
    snaps: list            # bytecode_vm.Snapshot


@dataclasses.dataclass
class VmBatch:
    blocks_log: list       # fine per-tx raw log
    segs: list             # TxSeg/CbSeg stream (account circuit)
    tok_segs: list         # TokSeg stream (storage circuit; may be empty)
    blocks: list           # BlockMeta per block
    bc_calls: list = dataclasses.field(default_factory=list)  # BcCall


def _first_seen_olds(coarse_log: list) -> dict:
    pre: dict[bytes, bytes] = {}
    for block in coarse_log:
        for entry in block:
            if entry[0] == "acct" and entry[1] not in pre:
                pre[entry[1]] = entry[3]
    return pre


def _first_seen_slot_olds(coarse_log: list) -> dict:
    pre: dict[tuple, int] = {}
    for block in coarse_log:
        for entry in block:
            if entry[0] == "slot":
                k = (entry[1], entry[2])
                if k not in pre:
                    pre[k] = entry[3]
    return pre


def _final_news(coarse_log: list) -> dict:
    fin: dict[bytes, bytes] = {}
    for block in coarse_log:
        for entry in block:
            if entry[0] == "acct":
                fin[entry[1]] = entry[4]
    return fin


def _final_slot_news(coarse_log: list) -> dict:
    fin: dict[tuple, int] = {}
    for block in coarse_log:
        for entry in block:
            if entry[0] == "slot":
                fin[(entry[1], entry[2])] = entry[4]
    return fin


def build_vm_batch(blocks, coarse_log: list,
                   receipts_per_block: list | None,
                   oracles=None) -> VmBatch:
    """Derive the fine log + circuit segments for a transfer/token/
    generic batch.

    `blocks` are the executed blocks, `coarse_log` the executor's raw
    write log (source of batch-pre states and the consistency oracle),
    `receipts_per_block` the executor's receipts (per-tx gas for token
    and generic calls; may be None for batches without calls).
    `oracles` (optional, guest/witness_oracles.WitnessOracles-shaped)
    resolves batch-pre account RLPs / storage slots / code for the
    GENERIC call class — reads the coarse log never witnessed; without
    it, generic calls fall back to claimed-log mode.  Raises
    NotTransferBatch when out of scope.
    """
    from . import bytecode_vm as bv

    for block in coarse_log:
        for entry in block:
            if entry[0] == "clear":
                raise NotTransferBatch("batch clears storage")

    state: dict[bytes, AccountState | None] = {}
    pre = _first_seen_olds(coarse_log)
    spre = _first_seen_slot_olds(coarse_log)
    sstate: dict[tuple, int] = {}
    sread: dict[tuple, int] = {}          # oracle-resolved batch-pre reads
    token_contracts: dict[bytes, AccountState] = {}  # validated templates
    contract_rlp: dict[bytes, bytes] = {}  # generic targets: current RLP
    contract_code: dict[bytes, bytes] = {}

    def acct(addr: bytes) -> AccountState | None:
        if addr not in state:
            rlp_bytes = pre.get(addr, b"")
            state[addr] = AccountState.decode(rlp_bytes) if rlp_bytes \
                else None
        return state[addr]

    def sget(contract: bytes, slot: int) -> int:
        k = (contract, slot)
        if k not in sstate:
            if k not in spre:
                # a slot the coarse log never witnessed (net-zero across
                # the block): its pre value is unknowable here
                raise NotTransferBatch("slot without a coarse log entry")
            sstate[k] = spre[k]
        return sstate[k]

    def gen_sget(contract: bytes, slot: int) -> int:
        """Current value of a slot for the generic interpreter: model
        state, else the coarse log's batch-pre, else the witness
        oracle (a slot only ever READ never surfaces in any write log)."""
        k = (contract, slot)
        if k in sstate:
            return sstate[k]
        if k in spre:
            return spre[k]
        if k not in sread:
            v = None if oracles is None else oracles.sload(contract, slot)
            if v is None:
                raise NotTransferBatch("generic read outside the oracle")
            sread[k] = int(v)
        return sread[k]

    def gen_contract(addr: bytes) -> bytes:
        """The generic target's CURRENT account RLP + cached code."""
        if addr not in contract_rlp:
            rlp_bytes = pre.get(addr, b"")
            if not rlp_bytes and oracles is not None:
                rlp_bytes = oracles.account_rlp(addr) or b""
            if not rlp_bytes:
                raise NotTransferBatch("generic target unresolvable")
            contract_rlp[addr] = rlp_bytes
        if addr not in contract_code:
            st = AccountState.decode(contract_rlp[addr])
            code = b"" if st.code_hash == EMPTY_CODE_HASH else (
                None if oracles is None else oracles.code(st.code_hash))
            if code is None:
                raise NotTransferBatch("generic target code unresolvable")
            contract_code[addr] = code
        return contract_code[addr]

    def validate_token_contract(addr: bytes) -> None:
        if addr in token_contracts:
            return
        rlp_bytes = pre.get(addr, b"")
        if not rlp_bytes:
            raise NotTransferBatch("token target without a coarse entry")
        st = AccountState.decode(rlp_bytes)
        if st.code_hash != tmpl.TEMPLATE_CODE_HASH:
            raise NotTransferBatch("call target is not the token template")
        token_contracts[addr] = st

    blocks_log = []
    segs: list = []
    tok_segs: list = []
    bc_calls: list = []
    gen_targets: set[bytes] = set()
    metas = []
    for bi, block in enumerate(blocks):
        h = block.header
        base_fee = h.base_fee_per_gas or 0
        receipts = receipts_per_block[bi] if receipts_per_block else None
        rows = []
        txmetas = []
        touched_contracts: list[bytes] = []
        cum_gas = 0
        for ti, tx in enumerate(block.body.transactions):
            if tx.tx_type == TYPE_PRIVILEGED:
                raise NotTransferBatch("privileged tx in batch")
            plain = is_plain_transfer(tx)
            token = not plain and is_token_call_shape(tx)
            generic = (not plain and not token
                       and is_generic_call_shape(tx))
            if not plain and not token and not generic:
                raise NotTransferBatch("tx shape out of scope")
            if plain and receipts_per_block is not None:
                # a data-less value-0 call to a CONTRACT is statically a
                # transfer shape; the executor's gas betrays the code run
                rec_gas = (receipts_per_block[bi][ti].cumulative_gas_used
                           - cum_gas)
                if rec_gas != TRANSFER_GAS and is_generic_call_shape(tx):
                    plain, generic = False, True
            sender = tx.sender()
            if sender is None:
                raise NotTransferBatch("unrecoverable sender")
            price = tx.effective_gas_price(base_fee)
            if price is None or price < base_fee:
                raise NotTransferBatch("underpriced tx")
            if receipts is not None:
                rec = receipts[ti]
                gas_used = rec.cumulative_gas_used - cum_gas
                cum_gas = rec.cumulative_gas_used
                succeeded = rec.succeeded
            else:
                gas_used = TRANSFER_GAS
                succeeded = True

            if plain:
                if gas_used != TRANSFER_GAS or not succeeded:
                    raise NotTransferBatch("transfer gas out of model")
                value = tx.value
                gas = TRANSFER_GAS
            else:
                if receipts is None:
                    raise NotTransferBatch("call without receipts")
                if not succeeded:
                    raise NotTransferBatch("reverted call")
                if token:
                    validate_token_contract(tx.to)
                value = 0
                gas = gas_used
            fee = gas * price
            tip = gas * (price - base_fee)

            s_old = acct(sender)
            if s_old is None or s_old.nonce != tx.nonce \
                    or s_old.balance < value + fee:
                raise NotTransferBatch("sender state out of scope")
            s_new = dataclasses.replace(
                s_old, nonce=s_old.nonce + 1,
                balance=s_old.balance - value - fee)
            state[sender] = s_new
            rows.append(("acct", sender, None, s_old.encode(),
                         s_new.encode(), False))

            if plain:
                # A zero-value credit touches nothing on chain, and an
                # untouched account never appears in the coarse log or the
                # witness — so its true pre-state is UNKNOWN here.  No-op
                # credits therefore emit NO log row at all (the circuit's
                # NOP segment absorbs zero digests and pins the amount to
                # zero); emitting an old=absent row would make honest
                # proofs fail the witness audit whenever the account
                # exists.
                r_created = False
                r_noop = tx.value == 0
                if r_noop:
                    r_old = r_new = None
                else:
                    r_old = acct(tx.to)
                    if r_old is None:
                        r_created = True
                        r_new = AccountState(nonce=0, balance=value)
                    else:
                        if r_old.code_hash != EMPTY_CODE_HASH:
                            raise NotTransferBatch("recipient has code")
                        r_new = dataclasses.replace(
                            r_old, balance=r_old.balance + value)
                    state[tx.to] = r_new
                    rows.append(("acct", tx.to, None,
                                 r_old.encode() if r_old else b"",
                                 r_new.encode(), False))
                segs.append(TxSeg(sender, tx.to, s_old, s_new, r_old,
                                  r_new, value, fee, tip, r_created,
                                  r_noop))
                txmetas.append(TxMeta(sender, tx.to, value, fee, tip))
            elif generic:
                if oracles is None:
                    raise NotTransferBatch("generic call without oracles")
                code = gen_contract(tx.to)
                try:
                    gsteps, gsnaps, gwrites = bv.run_trace(
                        code, tx.data, sender, 0,
                        lambda slot, _to=tx.to: gen_sget(_to, slot),
                        address=tx.to)
                except bv.UnsupportedTrace as e:
                    raise NotTransferBatch(f"generic trace: {e}")
                # per-tx slot rows in first-touch order; reads emit no-op
                # rows so their values are bound into r_pre and audited
                # by the witness replay
                txold: dict[int, int] = {}
                order: list[int] = []
                for st in gsteps:
                    if st.op in (bv.OP_SLOAD, bv.OP_SSTORE) \
                            and st.a not in txold:
                        txold[st.a] = gen_sget(tx.to, st.a)
                        order.append(st.a)
                txnew = dict(txold)
                for slot, v in gwrites:
                    txnew[slot] = v
                for slot in order:
                    rows.append(("slot", tx.to, slot, txold[slot],
                                 txnew[slot]))
                for slot in order:
                    sstate[(tx.to, slot)] = txnew[slot]
                if tx.to not in touched_contracts:
                    touched_contracts.append(tx.to)
                gen_targets.add(tx.to)
                segs.append(TxSeg(sender, tx.to, s_old, s_new, None, None,
                                  0, fee, tip, False, True))
                bc_calls.append(BcCall(gsteps, gsnaps))
                txmetas.append(TxMeta(sender, tx.to, 0, fee, tip,
                                      kind="gen", gas=gas, data=tx.data,
                                      code=code, steps=gsteps))
            else:
                dst, amount = tmpl.decode_transfer_calldata(tx.data)
                # code-hash pin FIRST, even for zero-amount calls: a
                # "tok"-labeled tx must always mean template semantics
                # (a noop call to arbitrary code would otherwise pass
                # the oracle and mislabel the metadata)
                validate_token_contract(tx.to)
                if amount == 0:
                    # template SSTOREs unchanged values: no net writes
                    tok_segs.append(TokSeg(0, 0, 0, 0, 0, 0, 0, noop=True))
                else:
                    kf = tmpl.balance_slot(sender)
                    bf = sget(tx.to, kf)
                    if bf < amount:
                        raise NotTransferBatch(
                            "token balance model underflow (call should "
                            "have reverted)")
                    sstate[(tx.to, kf)] = bf - amount
                    rows.append(("slot", tx.to, kf, bf, bf - amount))
                    kt = tmpl.balance_slot(dst)
                    bt = sget(tx.to, kt)
                    if bt + amount >= 1 << 256:
                        raise NotTransferBatch("token balance wrap")
                    sstate[(tx.to, kt)] = bt + amount
                    rows.append(("slot", tx.to, kt, bt, bt + amount))
                    if tx.to not in touched_contracts:
                        touched_contracts.append(tx.to)
                    tok_segs.append(TokSeg(amount, kf, bf, bf - amount,
                                           kt, bt, bt + amount))
                # account stream: value-0 tx with a NOP recipient; the
                # storage semantics live in the token stream
                segs.append(TxSeg(sender, tx.to, s_old, s_new, None, None,
                                  0, fee, tip, False, True))
                txmetas.append(TxMeta(sender, tx.to, 0, fee, tip,
                                      kind="tok", gas=gas, dst=dst,
                                      amount=amount))

            cb_created = False
            cb_noop = tip == 0
            if cb_noop:
                cb_old = cb_new = None
            else:
                cb_old = acct(h.coinbase)
                if cb_old is None:
                    cb_created = True
                    cb_new = AccountState(nonce=0, balance=tip)
                else:
                    if cb_old.code_hash != EMPTY_CODE_HASH:
                        raise NotTransferBatch("coinbase has code")
                    cb_new = dataclasses.replace(
                        cb_old, balance=cb_old.balance + tip)
                state[h.coinbase] = cb_new
                rows.append(("acct", h.coinbase, None,
                             cb_old.encode() if cb_old else b"",
                             cb_new.encode(), False))
            segs.append(CbSeg(h.coinbase, cb_old, cb_new, tip,
                              cb_created, cb_noop))

        # each touched token contract's account row, verbatim from the
        # coarse log (its new storage_root is MPT work the witness replay
        # re-derives from our per-tx slot rows; the circuits never see
        # it).  Only the storage_root may change.
        coarse_accts = {e[1]: e for e in coarse_log[bi]
                        if e[0] == "acct"}
        for caddr in touched_contracts:
            centry = coarse_accts.get(caddr)
            if centry is None:
                if caddr not in gen_targets:
                    raise NotTransferBatch(
                        "token contract missing from the coarse log")
                # read-only this block: a no-op account row still binds
                # the contract's code_hash + storage_root into r_pre (the
                # pure verifier pins the claimed code to this row)
                cur = contract_rlp.get(caddr) or pre.get(caddr, b"")
                if not cur:
                    raise NotTransferBatch("contract row unresolvable")
                rows.append(("acct", caddr, None, cur, cur, False))
                continue
            _, _, _, old_rlp, new_rlp, cleared = centry
            if cleared or not old_rlp or not new_rlp:
                raise NotTransferBatch("contract lifecycle change")
            o = AccountState.decode(old_rlp)
            n = AccountState.decode(new_rlp)
            if (o.nonce, o.balance, o.code_hash) != \
                    (n.nonce, n.balance, n.code_hash):
                raise NotTransferBatch(
                    "called contract account fields changed")
            rows.append(centry)
            contract_rlp[caddr] = new_rlp
        blocks_log.append(rows)
        metas.append(BlockMeta(h.coinbase, base_fee, txmetas))

    # consistency oracle: the model must reproduce the executor's final
    # states exactly, or the batch is out of scope
    fin = _final_news(coarse_log)
    for addr, want in fin.items():
        if addr in token_contracts or addr in gen_targets:
            continue  # storage_root delta audited via the witness replay
        got = state.get(addr)
        got_rlp = got.encode() if got is not None else b""
        if got_rlp != want:
            raise NotTransferBatch(
                f"model diverges from executor at {addr.hex()}")
    for addr, st in state.items():
        if addr not in fin:
            want_rlp = pre.get(addr, b"")
            if (st.encode() if st else b"") != want_rlp:
                raise NotTransferBatch(
                    f"model touches {addr.hex()} the executor did not")
    sfin = _final_slot_news(coarse_log)
    for key, want_v in sfin.items():
        if key[0] not in token_contracts and key[0] not in gen_targets:
            raise NotTransferBatch(
                "storage write outside the model")
        if sstate.get(key) != want_v:
            raise NotTransferBatch(
                f"slot model diverges at {key[0].hex()}[{key[1]:#x}]")
    # slots the model touched but the coarse log netted out: the model's
    # final value must equal the batch-pre value (else it diverges from
    # the executor, which saw no net write there).  Token-path keys came
    # through sget (coarse-seeded); generic keys may be oracle-seeded.
    for key, v in sstate.items():
        if key in sfin:
            continue
        base = spre.get(key, sread.get(key))
        if base is None or v != base:
            raise NotTransferBatch(
                "model writes a slot the executor did not")
    return VmBatch(blocks_log=blocks_log, segs=segs, tok_segs=tok_segs,
                   blocks=metas, bc_calls=bc_calls)
