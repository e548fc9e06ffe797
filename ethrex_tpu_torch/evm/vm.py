"""EVM interpreter: a copy of `ethrex_tpu/evm/vm.py` over a journaled
StateDB, with fork-gated opcode tables and substate checkpointing.  A
frame of at least `_NATIVE_MIN_CODE` bytes runs in the native loop
(`evm/native_vm.py`, `native/evm.cpp`), which escapes to the Python
handlers for state, environment and call opcodes; shorter frames, and
every frame under ETHREX_TPU_NATIVE_EVM=0, run the Python dispatch loop
`EVM._run_py`, the oracle of the native loop.

Supported semantics: Frontier → Prague.  Berlin+ uses the EIP-2929
warm/cold accounting; pre-Berlin forks consult the per-fork `Schedule`
(evm/gas.py): EIP-150 repricing, EIP-160/161/170, the legacy /
EIP-1283 / EIP-2200 SSTORE regimes, pre-Byzantium opcode sets, and the
pre-London refund rules.  Opcode availability is a per-fork dispatch
table (reference: fork-gated const tables, levm/src/opcodes.rs:450-657).
"""

from __future__ import annotations

import dataclasses
import os
import sys

from ..crypto.keccak import keccak256
from ..primitives import rlp
from ..primitives.account import EMPTY_CODE_HASH
from ..primitives.genesis import ChainConfig, Fork
from ..primitives.receipt import Log
from . import gas as G
from . import native_vm as nv
from . import precompiles
from .db import StateDB

sys.setrecursionlimit(40000)  # EVM call depth 1024 x python frames per level

U256_MAX = (1 << 256) - 1
DELEGATION_PREFIX = b"\xef\x01\x00"


class VMError(Exception):
    """Exceptional halt — consumes all gas in the frame."""


class OutOfGas(VMError):
    pass


class StackError(VMError):
    pass


class InvalidJump(VMError):
    pass


class InvalidOpcode(VMError):
    pass


class StaticViolation(VMError):
    pass


class _Halt(Exception):
    """Normal halt (STOP/RETURN/REVERT/SELFDESTRUCT)."""

    def __init__(self, output: bytes = b"", reverted: bool = False):
        self.output = output
        self.reverted = reverted


@dataclasses.dataclass
class BlockEnv:
    number: int = 0
    coinbase: bytes = b"\x00" * 20
    timestamp: int = 0
    gas_limit: int = 30_000_000
    prev_randao: bytes = b"\x00" * 32
    base_fee: int = 0
    excess_blob_gas: int = 0
    parent_beacon_block_root: bytes = b"\x00" * 32
    difficulty: int = 0

    @property
    def blob_base_fee(self) -> int:
        return G.blob_base_fee(self.excess_blob_gas)


@dataclasses.dataclass
class Message:
    caller: bytes
    to: bytes                 # storage/execution context address
    code_address: bytes       # where code lives (differs for *CALLCODE)
    value: int
    data: bytes
    gas: int
    depth: int = 0
    is_static: bool = False
    is_create: bool = False
    code: bytes = b""
    salt: int | None = None   # CREATE2
    transfers_value: bool = True  # False for DELEGATECALL
    kind: str = ""            # CALL/DELEGATECALL/STATICCALL/...


@dataclasses.dataclass
class TxResult:
    success: bool
    gas_used: int
    output: bytes
    logs: list
    error: str | None = None
    created: bytes | None = None


def u256(v: int) -> int:
    return v & U256_MAX


def to_signed(v: int) -> int:
    return v - (1 << 256) if v >> 255 else v


def addr_from_u256(v: int) -> bytes:
    return (v & ((1 << 160) - 1)).to_bytes(20, "big")


class Frame:
    __slots__ = ("stack", "memory", "pc", "gas", "code", "msg",
                 "return_data", "jumpdests", "logs_start")

    def __init__(self, msg: Message, code: bytes):
        self.stack: list[int] = []
        self.memory = bytearray()
        self.pc = 0
        self.gas = msg.gas
        self.code = code
        self.msg = msg
        self.return_data = b""
        self.jumpdests = _valid_jumpdests(code)

    # stack helpers ------------------------------------------------------
    def push(self, v: int):
        if len(self.stack) >= 1024:
            raise StackError("stack overflow")
        self.stack.append(v)

    def pop(self) -> int:
        if not self.stack:
            raise StackError("stack underflow")
        return self.stack.pop()

    def use_gas(self, amount: int):
        if self.gas < amount:
            raise OutOfGas(f"need {amount}, have {self.gas}")
        self.gas -= amount

    # memory helpers -----------------------------------------------------
    def expand_memory(self, offset: int, length: int):
        if length == 0:
            return
        new_size = offset + length
        if new_size > len(self.memory):
            self.use_gas(G.memory_expansion(len(self.memory), new_size))
            aligned = ((new_size + 31) // 32) * 32
            self.memory.extend(b"\x00" * (aligned - len(self.memory)))

    def mread(self, offset: int, length: int) -> bytes:
        if length == 0:
            return b""
        self.expand_memory(offset, length)
        return bytes(self.memory[offset:offset + length])

    def mwrite(self, offset: int, data: bytes):
        if not data:
            return
        self.expand_memory(offset, len(data))
        self.memory[offset:offset + len(data)] = data


def _valid_jumpdests(code: bytes) -> frozenset:
    dests = set()
    i = 0
    n = len(code)
    while i < n:
        op = code[i]
        if op == 0x5B:
            dests.add(i)
            i += 1
        elif 0x60 <= op <= 0x7F:
            i += op - 0x5F + 1
        else:
            i += 1
    return frozenset(dests)


def _check_mem_bounds(offset: int, length: int):
    if length > (1 << 32) or offset > (1 << 32):
        raise OutOfGas("memory offset/length too large")


class EVM:
    """One EVM instance per transaction execution."""

    def __init__(self, state: StateDB, block: BlockEnv, config: ChainConfig,
                 gas_price: int = 0, origin: bytes = b"\x00" * 20,
                 blob_hashes: list | None = None):
        self.state = state
        self.block = block
        self.config = config
        self.fork = config.fork_at(block.number, block.timestamp)
        self.sched = G.schedule_for(self.fork)
        self.gas_price = gas_price
        self.origin = origin
        self.blob_hashes = blob_hashes or []

    def fork_at_least(self, fork: Fork) -> bool:
        return self.fork >= fork

    # ------------------------------------------------------------------
    # code resolution (EIP-7702 delegation)
    # ------------------------------------------------------------------
    def resolve_code(self, address: bytes) -> tuple[bytes, bytes]:
        """Returns (code, code_source_address); follows 7702 delegation."""
        code = self.state.get_code(address)
        if (self.fork_at_least(Fork.PRAGUE)
                and code.startswith(DELEGATION_PREFIX) and len(code) == 23):
            target = code[3:23]
            return self.state.get_code(target), target
        return code, address

    # ------------------------------------------------------------------
    # message execution
    # ------------------------------------------------------------------
    def execute_message(self, msg: Message) -> tuple[bool, int, bytes]:
        """Returns (success, gas_left, output)."""
        snap = self.state.snapshot()
        logs_len = len(self.state.logs)
        if msg.is_create:
            ok, gas_left, out = self._execute_create(msg)
        else:
            ok, gas_left, out = self._execute_call(msg)
        if not ok:
            self.state.revert(snap)
            del self.state.logs[logs_len:]
        return ok, gas_left, out

    def _transfer(self, frm: bytes, to: bytes, value: int):
        if value:
            self.state.sub_balance(frm, value)
            self.state.add_balance(to, value)
        else:
            self.state._load(to)  # touch target so existence is tracked

    def _execute_call(self, msg: Message) -> tuple[bool, int, bytes]:
        if (not self.sched.eip161 and msg.transfers_value
                and msg.kind in ("CALL", "")
                and not self.state.account_exists(msg.to)):
            # pre-EIP-161: calling a nonexistent account instantiates it
            # (empty), value or not — inside this call's revert scope
            self.state.create_empty(msg.to)
        if msg.value and msg.kind == "CALLCODE":
            # CALLCODE transfers nothing (to == caller) but the spec still
            # requires the balance check
            if self.state.get_balance(msg.caller) < msg.value:
                return False, msg.gas, b""
        if msg.transfers_value and msg.value:
            if self.state.get_balance(msg.caller) < msg.value:
                return False, msg.gas, b""
            self._transfer(msg.caller, msg.to, msg.value)
        pre = precompiles.get_precompile(msg.code_address, self.fork)
        if pre is not None:
            try:
                gas_cost, output = pre(msg.data, msg.gas, self.fork)
            except precompiles.PrecompileError:
                return False, 0, b""
            if gas_cost > msg.gas:
                return False, 0, b""
            return True, msg.gas - gas_cost, output
        code = msg.code if msg.code else self.state.get_code(msg.code_address)
        if not code:
            return True, msg.gas, b""
        frame = Frame(msg, code)
        try:
            self._run(frame)
            return True, frame.gas, b""
        except _Halt as h:
            if h.reverted:
                return False, frame.gas, h.output
            return True, frame.gas, h.output
        except VMError:
            return False, 0, b""

    def _execute_create(self, msg: Message) -> tuple[bool, int, bytes]:
        sender_nonce = self.state.get_nonce(msg.caller)
        if msg.salt is not None:
            new_addr = keccak256(
                b"\xff" + msg.caller + msg.salt.to_bytes(32, "big")
                + keccak256(msg.code))[12:]
        else:
            new_addr = keccak256(
                rlp.encode([msg.caller, sender_nonce - 1]))[12:]
        self.state.warm_address(new_addr)
        # collision check (EIP-7610: non-empty storage also collides)
        if (self.state.get_nonce(new_addr) != 0
                or self.state.get_code(new_addr) != b""
                or self.state.has_nonempty_storage(new_addr)):
            return False, 0, b""
        if self.state.get_balance(msg.caller) < msg.value:
            return False, msg.gas, b""
        self.state.mark_created(new_addr)
        self.state.set_nonce(new_addr, 1)
        self._transfer(msg.caller, new_addr, msg.value)
        run_msg = dataclasses.replace(msg, to=new_addr,
                                      code_address=new_addr)
        frame = Frame(run_msg, msg.code)
        frame.msg = run_msg
        try:
            self._run(frame)
            deployed = b""
        except _Halt as h:
            if h.reverted:
                return False, frame.gas, h.output
            deployed = h.output
        except VMError:
            return False, 0, b""
        # deposit code
        if self.sched.max_code_size and len(deployed) > self.sched.max_code_size:
            return False, 0, b""   # EIP-170 (Spurious Dragon+)
        if self.fork >= Fork.LONDON and deployed[:1] == b"\xef":
            return False, 0, b""   # EIP-3541
        try:
            frame.use_gas(G.CODE_DEPOSIT_BYTE * len(deployed))
        except OutOfGas:
            if not self.sched.strict_deposit:
                # Frontier: unaffordable deposit leaves an empty contract
                return True, frame.gas, new_addr
            return False, 0, b""
        self.state.set_code(new_addr, deployed)
        return True, frame.gas, new_addr

    # ------------------------------------------------------------------
    # the dispatch loop
    # ------------------------------------------------------------------
    def _run(self, f: Frame):
        handlers = _handlers_for(self.fork)
        if _native_available() and (
                len(f.code) >= _NATIVE_MIN_CODE or _native_forced()):
            return self._run_native(f, handlers)
        return self._run_py(f, handlers)

    def _run_py(self, f: Frame, handlers):
        """The Python dispatch loop."""
        code = f.code
        n = len(code)
        while f.pc < n:
            op = code[f.pc]
            handler = handlers[op]
            if handler is None:
                raise InvalidOpcode(hex(op))
            f.pc += 1
            handler(self, f)
        raise _Halt(b"")

    def _run_native(self, f: Frame, handlers):
        """Hybrid dispatch: the C++ loop (native/evm.cpp) runs frame-local
        opcodes; state/env/call opcodes escape to the canonical Python
        handlers one at a time and the loop re-enters."""
        lib = nv._load()
        nf = nv.NativeFrame(lib, f.code, f.msg.data, f.gas,
                            self.sched.exp_byte,
                            _native_mask_for(self.fork))
        try:
            while True:
                rc = nf.run()
                if rc == nv.HALT_ESCAPE:
                    nf.pull_into(f)
                    op = f.code[f.pc]
                    handler = handlers[op]
                    if handler is None:
                        raise InvalidOpcode(hex(op))
                    f.pc += 1
                    handler(self, f)   # may raise _Halt / VMError
                    nf.push_from(f)
                    continue
                if rc in (nv.HALT_STOP, nv.HALT_CODE_END):
                    f.gas = lib.evm_gas(nf.ptr)
                    raise _Halt(b"")
                if rc in (nv.HALT_RETURN, nv.HALT_REVERT):
                    nf.pull_into(f)
                    off, length = nf.output()
                    raise _Halt(bytes(f.memory[off:off + length]),
                                reverted=(rc == nv.HALT_REVERT))
                if rc == nv.HALT_OOG:
                    raise OutOfGas("native frame")
                if rc == nv.HALT_INVALID_JUMP:
                    raise InvalidJump("native frame")
                if rc == nv.HALT_STACK:
                    raise StackError("native frame")
                raise InvalidOpcode("native frame")
        finally:
            nf.close()


# ---------------------------------------------------------------------------
# opcode handlers — op_xxx(evm, frame)
# ---------------------------------------------------------------------------

def _bin(cost, fn):
    def h(evm, f):
        f.use_gas(cost)
        a = f.pop()
        b = f.pop()
        f.push(fn(a, b))
    return h


def _stop(evm, f):
    raise _Halt(b"")


def _sdiv(a, b):
    if b == 0:
        return 0
    sa, sb = to_signed(a), to_signed(b)
    q = abs(sa) // abs(sb)
    return u256(-q if (sa < 0) != (sb < 0) else q)


def _smod(a, b):
    if b == 0:
        return 0
    sa, sb = to_signed(a), to_signed(b)
    r = abs(sa) % abs(sb)
    return u256(-r if sa < 0 else r)


def _addmod(evm, f):
    f.use_gas(G.MID)
    a, b, m = f.pop(), f.pop(), f.pop()
    f.push((a + b) % m if m else 0)


def _mulmod(evm, f):
    f.use_gas(G.MID)
    a, b, m = f.pop(), f.pop(), f.pop()
    f.push((a * b) % m if m else 0)


def _exp(evm, f):
    base, ex = f.pop(), f.pop()
    f.use_gas(G.exp_cost(ex, evm.sched.exp_byte))
    f.push(pow(base, ex, 1 << 256))


def _signextend(evm, f):
    f.use_gas(G.LOW)
    k, v = f.pop(), f.pop()
    if k >= 31:
        f.push(v)
        return
    bit = 8 * (k + 1) - 1
    if (v >> bit) & 1:
        f.push(u256(v | (U256_MAX << bit)))
    else:
        f.push(v & ((1 << (bit + 1)) - 1))


def _byte(evm, f):
    f.use_gas(G.VERYLOW)
    i, v = f.pop(), f.pop()
    f.push((v >> (8 * (31 - i))) & 0xFF if i < 32 else 0)


def _shl(evm, f):
    f.use_gas(G.VERYLOW)
    sh, v = f.pop(), f.pop()
    f.push(u256(v << sh) if sh < 256 else 0)


def _shr(evm, f):
    f.use_gas(G.VERYLOW)
    sh, v = f.pop(), f.pop()
    f.push(v >> sh if sh < 256 else 0)


def _sar(evm, f):
    f.use_gas(G.VERYLOW)
    sh, v = f.pop(), f.pop()
    sv = to_signed(v)
    if sh >= 256:
        f.push(U256_MAX if sv < 0 else 0)
    else:
        f.push(u256(sv >> sh))


def _keccak(evm, f):
    offset, length = f.pop(), f.pop()
    _check_mem_bounds(offset, length)
    f.use_gas(G.keccak_cost(length))
    data = f.mread(offset, length)
    f.push(int.from_bytes(keccak256(data), "big"))


# --- environment -----------------------------------------------------------

def _address(evm, f):
    f.use_gas(G.BASE)
    f.push(int.from_bytes(f.msg.to, "big"))


def _balance(evm, f):
    addr = addr_from_u256(f.pop())
    if evm.sched.pre_berlin:
        f.use_gas(evm.sched.balance)
    else:
        warm = evm.state.warm_address(addr)
        f.use_gas(G.WARM_ACCESS if warm else G.COLD_ACCOUNT_ACCESS)
    f.push(evm.state.get_balance(addr))


def _origin(evm, f):
    f.use_gas(G.BASE)
    f.push(int.from_bytes(evm.origin, "big"))


def _caller(evm, f):
    f.use_gas(G.BASE)
    f.push(int.from_bytes(f.msg.caller, "big"))


def _callvalue(evm, f):
    f.use_gas(G.BASE)
    f.push(f.msg.value)


def _calldataload(evm, f):
    f.use_gas(G.VERYLOW)
    off = f.pop()
    if off >= len(f.msg.data):
        f.push(0)
        return
    chunk = f.msg.data[off:off + 32]
    f.push(int.from_bytes(chunk.ljust(32, b"\x00"), "big"))


def _calldatasize(evm, f):
    f.use_gas(G.BASE)
    f.push(len(f.msg.data))


def _copy_to_mem(f, src: bytes):
    dst, off, length = f.pop(), f.pop(), f.pop()
    _check_mem_bounds(dst, length)
    f.use_gas(G.VERYLOW + G.copy_cost(length))
    data = src[off:off + length] if off < len(src) else b""
    f.mwrite(dst, data.ljust(length, b"\x00"))


def _calldatacopy(evm, f):
    _copy_to_mem(f, f.msg.data)


def _codesize(evm, f):
    f.use_gas(G.BASE)
    f.push(len(f.code))


def _codecopy(evm, f):
    _copy_to_mem(f, f.code)


def _gasprice(evm, f):
    f.use_gas(G.BASE)
    f.push(evm.gas_price)


def _ext_account_gas(evm, f, addr, flat_cost=None):
    if evm.sched.pre_berlin:
        f.use_gas(evm.sched.extcode if flat_cost is None else flat_cost)
    else:
        warm = evm.state.warm_address(addr)
        f.use_gas(G.WARM_ACCESS if warm else G.COLD_ACCOUNT_ACCESS)


def _extcodesize(evm, f):
    addr = addr_from_u256(f.pop())
    _ext_account_gas(evm, f, addr)
    f.push(len(evm.state.get_code(addr)))


def _extcodecopy(evm, f):
    addr = addr_from_u256(f.pop())
    dst, off, length = f.pop(), f.pop(), f.pop()
    _check_mem_bounds(dst, length)
    if evm.sched.pre_berlin:
        base = evm.sched.extcode
    else:
        warm = evm.state.warm_address(addr)
        base = G.WARM_ACCESS if warm else G.COLD_ACCOUNT_ACCESS
    f.use_gas(base + G.copy_cost(length))
    code = evm.state.get_code(addr)
    data = code[off:off + length] if off < len(code) else b""
    f.mwrite(dst, data.ljust(length, b"\x00"))


def _returndatasize(evm, f):
    f.use_gas(G.BASE)
    f.push(len(f.return_data))


def _returndatacopy(evm, f):
    dst, off, length = f.pop(), f.pop(), f.pop()
    _check_mem_bounds(dst, length)
    f.use_gas(G.VERYLOW + G.copy_cost(length))
    if off + length > len(f.return_data):
        raise VMError("returndatacopy out of bounds")
    f.mwrite(dst, f.return_data[off:off + length])


def _extcodehash(evm, f):
    addr = addr_from_u256(f.pop())
    _ext_account_gas(evm, f, addr, flat_cost=evm.sched.extcodehash)
    if not evm.state.account_exists(addr) or evm.state.is_empty(addr):
        f.push(0)
    else:
        code = evm.state.get_code(addr)
        f.push(int.from_bytes(
            keccak256(code) if code else EMPTY_CODE_HASH, "big"))


# --- block context ---------------------------------------------------------

def _blockhash(evm, f):
    f.use_gas(G.BLOCKHASH)
    num = f.pop()
    cur = evm.block.number
    if num >= cur or num < max(0, cur - 256):
        f.push(0)
    else:
        f.push(int.from_bytes(evm.state.source.get_block_hash(num), "big"))


def _coinbase(evm, f):
    f.use_gas(G.BASE)
    f.push(int.from_bytes(evm.block.coinbase, "big"))


def _timestamp(evm, f):
    f.use_gas(G.BASE)
    f.push(evm.block.timestamp)


def _number(evm, f):
    f.use_gas(G.BASE)
    f.push(evm.block.number)


def _prevrandao(evm, f):
    f.use_gas(G.BASE)
    if evm.fork >= Fork.PARIS:
        f.push(int.from_bytes(evm.block.prev_randao, "big"))
    else:
        f.push(evm.block.difficulty)


def _gaslimit(evm, f):
    f.use_gas(G.BASE)
    f.push(evm.block.gas_limit)


def _chainid(evm, f):
    f.use_gas(G.BASE)
    f.push(evm.config.chain_id)


def _selfbalance(evm, f):
    f.use_gas(G.LOW)
    f.push(evm.state.get_balance(f.msg.to))


def _basefee(evm, f):
    f.use_gas(G.BASE)
    f.push(evm.block.base_fee)


def _blobhash(evm, f):
    f.use_gas(G.VERYLOW)
    i = f.pop()
    if i < len(evm.blob_hashes):
        f.push(int.from_bytes(evm.blob_hashes[i], "big"))
    else:
        f.push(0)


def _blobbasefee(evm, f):
    f.use_gas(G.BASE)
    f.push(evm.block.blob_base_fee)


# --- stack / memory / storage / flow ---------------------------------------

def _pop(evm, f):
    f.use_gas(G.BASE)
    f.pop()


def _mload(evm, f):
    off = f.pop()
    _check_mem_bounds(off, 32)
    f.use_gas(G.VERYLOW)
    f.push(int.from_bytes(f.mread(off, 32), "big"))


def _mstore(evm, f):
    off, val = f.pop(), f.pop()
    _check_mem_bounds(off, 32)
    f.use_gas(G.VERYLOW)
    f.mwrite(off, val.to_bytes(32, "big"))


def _mstore8(evm, f):
    off, val = f.pop(), f.pop()
    _check_mem_bounds(off, 1)
    f.use_gas(G.VERYLOW)
    f.mwrite(off, bytes([val & 0xFF]))


def _sload(evm, f):
    slot = f.pop()
    if evm.sched.pre_berlin:
        f.use_gas(evm.sched.sload)
    else:
        warm = evm.state.warm_slot(f.msg.to, slot)
        # EIP-2929: cold SLOAD costs 2100 TOTAL (not 2100 + warm 100)
        f.use_gas(G.WARM_ACCESS if warm else G.COLD_SLOAD)
    f.push(evm.state.get_storage(f.msg.to, slot))


def _sstore(evm, f):
    if f.msg.is_static:
        raise StaticViolation("SSTORE in static context")
    regime = evm.sched.sstore_regime
    if regime == "legacy":
        # Frontier..Byzantium and Petersburg: flat SET/RESET + clear refund
        slot, value = f.pop(), f.pop()
        addr = f.msg.to
        current = evm.state.get_storage(addr, slot)
        if current == 0 and value != 0:
            f.use_gas(G.SSTORE_LEGACY_SET)
        else:
            f.use_gas(G.SSTORE_LEGACY_RESET)
            if current != 0 and value == 0:
                evm.state.add_refund(G.SSTORE_LEGACY_REFUND)
        evm.state.set_storage(addr, slot, value)
        return
    if regime != "net1283" and f.gas <= G.SSTORE_SENTRY:
        raise OutOfGas("SSTORE sentry")  # EIP-2200+; 1283 had no sentry
    slot, value = f.pop(), f.pop()
    addr = f.msg.to
    current = evm.state.get_storage(addr, slot)
    original = evm.state.get_original_storage(addr, slot)
    if regime in ("net1283", "net2200"):
        # EIP-1283 (Constantinople) / EIP-2200 (Istanbul) net metering:
        # same structure as Berlin with (no-op, dirty) = net_sload and
        # full SSTORE_LEGACY_RESET, refund 15000, no warm/cold
        noop = evm.sched.net_sload
        if current == value:
            f.use_gas(noop)
        elif current == original:
            if original == 0:
                f.use_gas(G.SSTORE_LEGACY_SET)
            else:
                f.use_gas(G.SSTORE_LEGACY_RESET)
                if value == 0:
                    evm.state.add_refund(G.SSTORE_LEGACY_REFUND)
        else:
            f.use_gas(noop)
            if original != 0:
                if current == 0:
                    evm.state.sub_refund(G.SSTORE_LEGACY_REFUND)
                elif value == 0:
                    evm.state.add_refund(G.SSTORE_LEGACY_REFUND)
            if value == original:
                if original == 0:
                    evm.state.add_refund(G.SSTORE_LEGACY_SET - noop)
                else:
                    evm.state.add_refund(G.SSTORE_LEGACY_RESET - noop)
        evm.state.set_storage(addr, slot, value)
        return
    # Berlin+ (EIP-2929 + EIP-3529)
    warm = evm.state.warm_slot(addr, slot)
    cost = 0 if warm else G.COLD_SLOAD
    if current == value:
        cost += G.WARM_ACCESS
    elif current == original:
        if original == 0:
            cost += G.SSTORE_SET
        else:
            cost += G.SSTORE_RESET
            if value == 0:
                # 15000 on Berlin (EIP-2200); 4800 only from London
                evm.state.add_refund(evm.sched.sstore_clear_refund)
    else:
        cost += G.WARM_ACCESS
        if original != 0:
            if current == 0:
                evm.state.sub_refund(evm.sched.sstore_clear_refund)
            elif value == 0:
                evm.state.add_refund(evm.sched.sstore_clear_refund)
        if value == original:
            if original == 0:
                evm.state.add_refund(G.SSTORE_SET - G.WARM_ACCESS)
            else:
                # EIP-3529: SSTORE_RESET(2900) - WARM_ACCESS(100) = 2800
                evm.state.add_refund(G.SSTORE_RESET - G.WARM_ACCESS)
    f.use_gas(cost)
    evm.state.set_storage(addr, slot, value)


def _jump(evm, f):
    f.use_gas(G.MID)
    dest = f.pop()
    if dest not in f.jumpdests:
        raise InvalidJump(str(dest))
    # land ON the JUMPDEST: it executes (and charges its 1 gas) like any
    # other instruction — jumping past it undercharges every jump taken
    f.pc = dest


def _jumpi(evm, f):
    f.use_gas(G.HIGH)
    dest, cond = f.pop(), f.pop()
    if cond:
        if dest not in f.jumpdests:
            raise InvalidJump(str(dest))
        f.pc = dest


def _pc(evm, f):
    f.use_gas(G.BASE)
    f.push(f.pc - 1)


def _msize(evm, f):
    f.use_gas(G.BASE)
    f.push(len(f.memory))


def _gas(evm, f):
    f.use_gas(G.BASE)
    f.push(f.gas)


def _jumpdest(evm, f):
    f.use_gas(G.JUMPDEST)


def _tload(evm, f):
    f.use_gas(G.WARM_ACCESS)
    slot = f.pop()
    f.push(evm.state.get_transient(f.msg.to, slot))


def _tstore(evm, f):
    if f.msg.is_static:
        raise StaticViolation("TSTORE in static context")
    f.use_gas(G.WARM_ACCESS)
    slot, value = f.pop(), f.pop()
    evm.state.set_transient(f.msg.to, slot, value)


def _mcopy(evm, f):
    dst, src, length = f.pop(), f.pop(), f.pop()
    _check_mem_bounds(max(dst, src), length)
    f.use_gas(G.VERYLOW + G.copy_cost(length))
    if length:
        f.expand_memory(max(dst, src), length)
        data = bytes(f.memory[src:src + length])
        f.mwrite(dst, data)


def _push0(evm, f):
    if evm.fork < Fork.SHANGHAI:
        raise InvalidOpcode("PUSH0 before Shanghai")
    f.use_gas(G.BASE)
    f.push(0)


def _make_push(nbytes):
    def h(evm, f):
        f.use_gas(G.VERYLOW)
        data = f.code[f.pc:f.pc + nbytes]
        f.pc += nbytes
        f.push(int.from_bytes(data.ljust(nbytes, b"\x00"), "big"))
    return h


def _make_dup(depth):
    def h(evm, f):
        f.use_gas(G.VERYLOW)
        if len(f.stack) < depth:
            raise StackError("dup underflow")
        f.push(f.stack[-depth])
    return h


def _make_swap(depth):
    def h(evm, f):
        f.use_gas(G.VERYLOW)
        if len(f.stack) < depth + 1:
            raise StackError("swap underflow")
        f.stack[-1], f.stack[-depth - 1] = f.stack[-depth - 1], f.stack[-1]
    return h


def _make_log(ntopics):
    def h(evm, f):
        if f.msg.is_static:
            raise StaticViolation("LOG in static context")
        off, length = f.pop(), f.pop()
        topics = [f.pop().to_bytes(32, "big") for _ in range(ntopics)]
        _check_mem_bounds(off, length)
        f.use_gas(G.LOG + G.LOG_TOPIC * ntopics + G.LOG_DATA * length)
        data = f.mread(off, length)
        evm.state.add_log(Log(address=f.msg.to, topics=topics, data=data))
    return h


# --- calls / creates -------------------------------------------------------

def _call_gas(evm, f, addr, value, new_account: bool):
    if evm.sched.pre_berlin:
        cost = evm.sched.call
    else:
        warm = evm.state.warm_address(addr)
        cost = G.WARM_ACCESS if warm else G.COLD_ACCOUNT_ACCESS
    if value:
        cost += G.CALL_VALUE
    if new_account:
        cost += G.NEW_ACCOUNT
    return cost


def _do_call(evm, f, *, kind: str):
    gas_req = f.pop()
    addr = addr_from_u256(f.pop())
    value = f.pop() if kind in ("call", "callcode") else 0
    in_off, in_len = f.pop(), f.pop()
    out_off, out_len = f.pop(), f.pop()
    _check_mem_bounds(in_off, in_len)
    _check_mem_bounds(out_off, out_len)
    if kind == "call" and value and f.msg.is_static:
        raise StaticViolation("CALL with value in static context")
    # memory expansion first
    f.expand_memory(in_off, in_len)
    f.expand_memory(out_off, out_len)
    if evm.sched.eip161:
        new_account = (kind == "call" and value != 0
                       and (not evm.state.account_exists(addr)
                            or evm.state.is_empty(addr)))
    else:
        # pre-EIP-161: CALL to a nonexistent account charges G_newaccount
        # and instantiates the (empty) account even for zero value
        new_account = (kind == "call"
                       and not evm.state.account_exists(addr))
    f.use_gas(_call_gas(evm, f, addr, value, new_account))
    if evm.sched.call_63_64:
        max_gas = f.gas - f.gas // 64   # EIP-150
        gas = min(gas_req, max_gas)
    else:
        gas = gas_req                   # pre-Tangerine: no cap, OOG if short
    f.use_gas(gas)
    stipend = G.CALL_STIPEND if value else 0
    data = f.mread(in_off, in_len)
    code, code_src = evm.resolve_code(addr)
    if f.msg.depth + 1 > 1024:
        f.push(0)
        f.return_data = b""
        f.gas += gas + stipend
        return
    if kind == "call":
        msg = Message(caller=f.msg.to, to=addr, code_address=code_src,
                      value=value, data=data, gas=gas + stipend,
                      depth=f.msg.depth + 1, is_static=f.msg.is_static,
                      code=code, kind="CALL")
    elif kind == "callcode":
        msg = Message(caller=f.msg.to, to=f.msg.to, code_address=addr,
                      value=value, data=data, gas=gas + stipend,
                      depth=f.msg.depth + 1, is_static=f.msg.is_static,
                      code=code, transfers_value=False, kind="CALLCODE")
    elif kind == "delegatecall":
        msg = Message(caller=f.msg.caller, to=f.msg.to, code_address=addr,
                      value=f.msg.value, data=data, gas=gas,
                      depth=f.msg.depth + 1, is_static=f.msg.is_static,
                      code=code, transfers_value=False, kind="DELEGATECALL")
    else:  # staticcall
        msg = Message(caller=f.msg.to, to=addr, code_address=code_src,
                      value=0, data=data, gas=gas,
                      depth=f.msg.depth + 1, is_static=True, code=code,
                      kind="STATICCALL")
    # precompiles execute against the *call target* address
    if (precompiles.get_precompile(addr, evm.fork) is not None
            and kind in ("call", "staticcall")):
        msg.code_address = addr
    ok, gas_left, output = evm.execute_message(msg)
    f.return_data = output
    if out_len and output:
        f.mwrite(out_off, output[:out_len])  # partial copy, rest untouched
    f.gas += gas_left
    f.push(1 if ok else 0)


def _call(evm, f):
    _do_call(evm, f, kind="call")


def _callcode(evm, f):
    _do_call(evm, f, kind="callcode")


def _delegatecall(evm, f):
    _do_call(evm, f, kind="delegatecall")


def _staticcall(evm, f):
    _do_call(evm, f, kind="staticcall")


def _do_create(evm, f, *, is_create2: bool):
    if f.msg.is_static:
        raise StaticViolation("CREATE in static context")
    value = f.pop()
    off, length = f.pop(), f.pop()
    _check_mem_bounds(off, length)
    salt = f.pop() if is_create2 else None
    if (evm.fork >= Fork.SHANGHAI and length > G.MAX_INITCODE_SIZE):
        raise OutOfGas("initcode too large")
    cost = G.CREATE
    if evm.fork >= Fork.SHANGHAI:
        cost += G.init_code_cost(length)
    if is_create2:
        cost += G.keccak_cost(length) - G.KECCAK256
    f.use_gas(cost)
    initcode = f.mread(off, length)
    f.return_data = b""
    if (evm.state.get_balance(f.msg.to) < value
            or f.msg.depth + 1 > 1024
            or evm.state.get_nonce(f.msg.to) >= (1 << 64) - 1):
        f.push(0)
        return
    if evm.sched.call_63_64:
        gas = f.gas - f.gas // 64
    else:
        gas = f.gas   # pre-Tangerine: the child gets everything
    f.use_gas(gas)
    evm.state.increment_nonce(f.msg.to)
    msg = Message(caller=f.msg.to, to=b"", code_address=b"", value=value,
                  data=b"", gas=gas, depth=f.msg.depth + 1,
                  is_static=f.msg.is_static, is_create=True, code=initcode,
                  salt=salt, kind="CREATE2" if is_create2 else "CREATE")
    ok, gas_left, output = evm.execute_message(msg)
    f.gas += gas_left
    if ok:
        f.push(int.from_bytes(output, "big"))  # output = new address
    else:
        f.return_data = output if output else b""
        f.push(0)


def _create(evm, f):
    _do_create(evm, f, is_create2=False)


def _create2(evm, f):
    _do_create(evm, f, is_create2=True)


def _return(evm, f):
    off, length = f.pop(), f.pop()
    _check_mem_bounds(off, length)
    raise _Halt(f.mread(off, length))


def _revert(evm, f):
    off, length = f.pop(), f.pop()
    _check_mem_bounds(off, length)
    raise _Halt(f.mread(off, length), reverted=True)


def _invalid(evm, f):
    raise InvalidOpcode("0xfe")


def _selfdestruct(evm, f):
    if f.msg.is_static:
        raise StaticViolation("SELFDESTRUCT in static context")
    target = addr_from_u256(f.pop())
    balance = evm.state.get_balance(f.msg.to)
    if evm.sched.pre_berlin:
        cost = evm.sched.selfdestruct
        if evm.sched.eip161:
            if balance and (not evm.state.account_exists(target)
                            or evm.state.is_empty(target)):
                cost += G.NEW_ACCOUNT
        elif evm.sched.call_63_64:
            # EIP-150..EIP-158: charged on plain nonexistence
            if not evm.state.account_exists(target):
                cost += G.NEW_ACCOUNT
    else:
        warm = evm.state.warm_address(target)
        cost = G.SELFDESTRUCT + (0 if warm else G.COLD_ACCOUNT_ACCESS)
        if balance and (not evm.state.account_exists(target)
                        or evm.state.is_empty(target)):
            cost += G.NEW_ACCOUNT
    f.use_gas(cost)
    if evm.sched.selfdestruct_refund \
            and f.msg.to not in evm.state.destroyed_accounts:
        evm.state.add_refund(evm.sched.selfdestruct_refund)
    addr = f.msg.to
    if evm.fork >= Fork.CANCUN and addr not in evm.state.created_accounts:
        # EIP-6780: only move the balance
        if target != addr:
            evm.state.sub_balance(addr, balance)
            evm.state.add_balance(target, balance)
        else:
            pass  # self-transfer: balance unchanged
    else:
        if target != addr:
            evm.state.add_balance(target, balance)
        evm.state.destroy_account(addr)
    raise _Halt(b"")


# ---------------------------------------------------------------------------
# dispatch table
# ---------------------------------------------------------------------------

_HANDLERS: list = [None] * 256

# opcodes by the fork that introduced them (removed from earlier forks'
# tables; reference: fork-gated const tables, levm/src/opcodes.rs:450-657)
_OPCODE_SINCE = {
    Fork.HOMESTEAD: [0xF4],                        # DELEGATECALL
    Fork.BYZANTIUM: [0x3D, 0x3E, 0xFA, 0xFD],      # RETURNDATA*, STATICCALL,
                                                   # REVERT
    Fork.CONSTANTINOPLE: [0x1B, 0x1C, 0x1D,        # SHL/SHR/SAR
                          0x3F, 0xF5],             # EXTCODEHASH, CREATE2
    Fork.ISTANBUL: [0x46, 0x47],                   # CHAINID, SELFBALANCE
    Fork.LONDON: [0x48],                           # BASEFEE
    Fork.SHANGHAI: [0x5F],                         # PUSH0
    Fork.CANCUN: [0x49, 0x4A, 0x5C, 0x5D, 0x5E],   # BLOBHASH, BLOBBASEFEE,
                                                   # TLOAD/TSTORE, MCOPY
}

_FORK_HANDLERS: dict = {}


def _handlers_for(fork) -> list:
    table = _FORK_HANDLERS.get(fork)
    if table is None:
        table = list(_HANDLERS)
        for since, ops in _OPCODE_SINCE.items():
            if fork < since:
                for op in ops:
                    table[op] = None
        _FORK_HANDLERS[fork] = table
    return table


def _install():
    H = _HANDLERS
    H[0x00] = _stop
    H[0x01] = _bin(G.VERYLOW, lambda a, b: u256(a + b))
    H[0x02] = _bin(G.LOW, lambda a, b: u256(a * b))
    H[0x03] = _bin(G.VERYLOW, lambda a, b: u256(a - b))
    H[0x04] = _bin(G.LOW, lambda a, b: a // b if b else 0)
    H[0x05] = _bin(G.LOW, _sdiv)
    H[0x06] = _bin(G.LOW, lambda a, b: a % b if b else 0)
    H[0x07] = _bin(G.LOW, _smod)
    H[0x08] = _addmod
    H[0x09] = _mulmod
    H[0x0A] = _exp
    H[0x0B] = _signextend
    H[0x10] = _bin(G.VERYLOW, lambda a, b: int(a < b))
    H[0x11] = _bin(G.VERYLOW, lambda a, b: int(a > b))
    H[0x12] = _bin(G.VERYLOW, lambda a, b: int(to_signed(a) < to_signed(b)))
    H[0x13] = _bin(G.VERYLOW, lambda a, b: int(to_signed(a) > to_signed(b)))
    H[0x14] = _bin(G.VERYLOW, lambda a, b: int(a == b))

    def _iszero(evm, f):
        f.use_gas(G.VERYLOW)
        f.push(int(f.pop() == 0))
    H[0x15] = _iszero
    H[0x16] = _bin(G.VERYLOW, lambda a, b: a & b)
    H[0x17] = _bin(G.VERYLOW, lambda a, b: a | b)
    H[0x18] = _bin(G.VERYLOW, lambda a, b: a ^ b)

    def _not(evm, f):
        f.use_gas(G.VERYLOW)
        f.push(u256(~f.pop()))
    H[0x19] = _not
    H[0x1A] = _byte
    H[0x1B] = _shl
    H[0x1C] = _shr
    H[0x1D] = _sar
    H[0x20] = _keccak
    H[0x30] = _address
    H[0x31] = _balance
    H[0x32] = _origin
    H[0x33] = _caller
    H[0x34] = _callvalue
    H[0x35] = _calldataload
    H[0x36] = _calldatasize
    H[0x37] = _calldatacopy
    H[0x38] = _codesize
    H[0x39] = _codecopy
    H[0x3A] = _gasprice
    H[0x3B] = _extcodesize
    H[0x3C] = _extcodecopy
    H[0x3D] = _returndatasize
    H[0x3E] = _returndatacopy
    H[0x3F] = _extcodehash
    H[0x40] = _blockhash
    H[0x41] = _coinbase
    H[0x42] = _timestamp
    H[0x43] = _number
    H[0x44] = _prevrandao
    H[0x45] = _gaslimit
    H[0x46] = _chainid
    H[0x47] = _selfbalance
    H[0x48] = _basefee
    H[0x49] = _blobhash
    H[0x4A] = _blobbasefee
    H[0x50] = _pop
    H[0x51] = _mload
    H[0x52] = _mstore
    H[0x53] = _mstore8
    H[0x54] = _sload
    H[0x55] = _sstore
    H[0x56] = _jump
    H[0x57] = _jumpi
    H[0x58] = _pc
    H[0x59] = _msize
    H[0x5A] = _gas
    H[0x5B] = _jumpdest
    H[0x5C] = _tload
    H[0x5D] = _tstore
    H[0x5E] = _mcopy
    H[0x5F] = _push0
    for i in range(1, 33):
        H[0x5F + i] = _make_push(i)
    for i in range(1, 17):
        H[0x7F + i] = _make_dup(i)
        H[0x8F + i] = _make_swap(i)
    for i in range(5):
        H[0xA0 + i] = _make_log(i)
    H[0xF0] = _create
    H[0xF1] = _call
    H[0xF2] = _callcode
    H[0xF3] = _return
    H[0xF4] = _delegatecall
    H[0xF5] = _create2
    H[0xFA] = _staticcall
    H[0xFD] = _revert
    H[0xFE] = _invalid
    H[0xFF] = _selfdestruct


_install()


_NATIVE_MIN_CODE = 64
_NATIVE_MASKS: dict = {}


def _native_available() -> bool:
    # the switch is read at every call, so a test can flip it; the
    # library loads once (a failed build raises)
    return nv.available()


def _native_forced() -> bool:
    return nv.forced()


def _native_mask_for(fork) -> bytes:
    mask = _NATIVE_MASKS.get(fork)
    if mask is None:
        mask = nv.native_op_mask(fork)
        _NATIVE_MASKS[fork] = mask
    return mask
