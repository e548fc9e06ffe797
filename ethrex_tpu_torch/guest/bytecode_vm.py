"""Restricted-subset EVM bytecode interpreter + step checker: the host
side of the generic VM circuit (models/bytecode_air.py).

A copy of `ethrex_tpu/guest/bytecode_vm.py` (host code).

Scope of the VM arithmetization (beyond the
transfer/token classes): a transaction calling ARBITRARY bytecode is
provable when the executed trace stays inside a supported opcode subset
and machine envelope.  The reference gets generality by executing the
guest inside the zkVM (crates/guest-program/src/common/execution.rs:42-209,
crates/prover/src/backend/sp1.rs:145-163); here the machine is
arithmetized directly: the circuit proves every step's stack/memory/
storage/control-flow semantics, while the parts a verifier can check by
pure data indexing — opcode bytes against the code, push immediates,
calldata words, caller/callvalue, the storage log's old/new values — are
absorbed into the proof's public digest and re-derived natively by
`check_steps` (no EVM execution: array lookups and dict replay only).

Supported executed-opcode subset (v1):
    STOP ADD SUB LT GT EQ ISZERO NOT ADDRESS CALLER CALLVALUE
    CALLDATALOAD CALLDATASIZE POP MLOAD MSTORE SLOAD SSTORE JUMP JUMPI
    JUMPDEST PC PUSH0..PUSH32 DUP1..DUP14 SWAP1..SWAP13 RETURN
Machine envelope: stack depth <= 14, memory = four 32-byte words at
offsets 0/32/64/96 (word-aligned access), <= MAX_STEPS steps, top-level
call only, value == 0, successful execution (a trace reaching REVERT or
an unsupported opcode falls back to the claimed-log mode — the code may
CONTAIN anything; only the executed path must stay in the subset).

Gas is NOT modeled here: the real executor ran with gas and succeeded, so
the successful path's semantics are gas-independent; the fee arithmetic
is proven by the transfer circuit from the receipt's per-tx gas (whose
truth the witness replay audits, prover/tpu_backend.py).
"""

from __future__ import annotations

import dataclasses

# executed-opcode subset
OP_STOP = 0x00
OP_ADD = 0x01
OP_SUB = 0x03
OP_LT = 0x10
OP_GT = 0x11
OP_EQ = 0x14
OP_ISZERO = 0x15
OP_NOT = 0x19
OP_ADDRESS = 0x30
OP_CALLER = 0x33
OP_CALLVALUE = 0x34
OP_CDLOAD = 0x35
OP_CDSIZE = 0x36
OP_POP = 0x50
OP_MLOAD = 0x51
OP_MSTORE = 0x52
OP_SLOAD = 0x54
OP_SSTORE = 0x55
OP_JUMP = 0x56
OP_JUMPI = 0x57
OP_JUMPDEST = 0x5B
OP_PC = 0x58
OP_PUSH0 = 0x5F
OP_RETURN = 0xF3
OP_REVERT = 0xFD

MAX_DEPTH = 14       # circuit stack window (EVM allows 1024)
MEM_WORDS = 4        # word-aligned offsets 0, 32, 64, 96
MAX_STEPS = 2048
MAX_DUP = 14         # DUP1..DUP14
MAX_SWAP = 13        # SWAP1..SWAP13 (window exchange 0 <-> n)

U256 = (1 << 256) - 1

_SIMPLE_OPS = {OP_STOP, OP_ADD, OP_SUB, OP_LT, OP_GT, OP_EQ, OP_ISZERO,
               OP_NOT, OP_ADDRESS, OP_CALLER, OP_CALLVALUE, OP_CDLOAD,
               OP_CDSIZE, OP_POP, OP_MLOAD, OP_MSTORE, OP_SLOAD,
               OP_SSTORE, OP_JUMP, OP_JUMPI, OP_JUMPDEST, OP_PC,
               OP_RETURN}


class UnsupportedTrace(Exception):
    """The executed path left the provable subset/envelope."""


class StepCheckError(Exception):
    """A claimed step list fails the native data checks."""


@dataclasses.dataclass
class StepRec:
    """One executed step — exactly the data the circuit absorbs into its
    public digest (everything a verifier must cross-check natively)."""

    pc: int
    op: int
    pushlen: int = 0
    imm: int = 0      # PUSH immediate
    a: int = 0        # SLOAD/SSTORE slot; CALLDATALOAD offset
    b: int = 0        # loaded/stored/env value; ALU result

    def to_json(self) -> list:
        return [self.pc, self.op, self.pushlen, hex(self.imm),
                hex(self.a), hex(self.b)]

    @classmethod
    def from_json(cls, row: list) -> "StepRec":
        pc, op, pushlen = int(row[0]), int(row[1]), int(row[2])
        imm, a, b = int(row[3], 16), int(row[4], 16), int(row[5], 16)
        for v in (imm, a, b):
            if not 0 <= v <= U256:
                raise StepCheckError("step value out of u256 range")
        if not (0 <= pc < 1 << 24 and 0 <= op < 256 and 0 <= pushlen <= 32):
            raise StepCheckError("step header out of range")
        return cls(pc, op, pushlen, imm, a, b)


@dataclasses.dataclass
class Snapshot:
    """Machine state BEFORE a step (trace-generation witness)."""

    stack: tuple      # top-first ints, len <= MAX_DEPTH
    mem: tuple        # MEM_WORDS ints


def code_at(code: bytes, pc: int) -> int:
    """Byte at pc; past the end every byte reads as STOP (EVM implicit
    halt semantics)."""
    return code[pc] if pc < len(code) else OP_STOP


def analyze_code(code: bytes):
    """(instruction_starts, jumpdests) by the canonical PUSH-skip scan."""
    starts = set()
    jumpdests = set()
    pc = 0
    while pc < len(code):
        starts.add(pc)
        op = code[pc]
        if op == OP_JUMPDEST:
            jumpdests.add(pc)
        pc += 1 + (op - OP_PUSH0 if OP_PUSH0 < op <= OP_PUSH0 + 32 else 0)
    return starts, jumpdests


def _push_imm(code: bytes, pc: int, k: int) -> int:
    data = code[pc + 1:pc + 1 + k]
    return int.from_bytes(data + b"\x00" * (k - len(data)), "big")


def run_trace(code: bytes, calldata: bytes, caller: bytes, callvalue: int,
              sload, max_steps: int = MAX_STEPS,
              address: bytes = b"\x00" * 20):
    """Execute, producing (steps, snapshots, writes).

    `sload(slot) -> int` reads CURRENT storage (the caller layers batch
    state over the pre-state oracle); `writes` is the ordered list of
    (slot, value) SSTOREs in execution order.  Raises UnsupportedTrace
    when the executed path leaves the subset or envelope.
    """
    stack: list[int] = []
    mem = [0] * MEM_WORDS
    store: dict[int, int] = {}
    steps: list[StepRec] = []
    snaps: list[Snapshot] = []
    writes: list[tuple[int, int]] = []
    _starts, _jumpdests = analyze_code(code)
    pc = 0

    def need(k):
        if len(stack) < k:
            raise UnsupportedTrace(f"stack underflow at pc {pc}")

    while True:
        if len(steps) >= max_steps:
            raise UnsupportedTrace("step limit exceeded")
        op = code_at(code, pc)
        snaps.append(Snapshot(tuple(stack), tuple(mem)))
        if OP_PUSH0 <= op <= OP_PUSH0 + 32:
            k = op - OP_PUSH0
            if len(stack) >= MAX_DEPTH:
                raise UnsupportedTrace("stack deeper than the window")
            v = _push_imm(code, pc, k)
            steps.append(StepRec(pc, op, k, v))
            stack.insert(0, v)
            pc += 1 + k
        elif 0x80 <= op < 0x80 + MAX_DUP:
            n = op - 0x80 + 1
            need(n)
            if len(stack) >= MAX_DEPTH:
                raise UnsupportedTrace("stack deeper than the window")
            steps.append(StepRec(pc, op))
            stack.insert(0, stack[n - 1])
            pc += 1
        elif 0x90 <= op < 0x90 + MAX_SWAP:
            n = op - 0x90 + 1
            need(n + 1)
            steps.append(StepRec(pc, op))
            stack[0], stack[n] = stack[n], stack[0]
            pc += 1
        elif op in _SIMPLE_OPS:
            if op == OP_STOP:
                steps.append(StepRec(pc, op))
                break
            elif op == OP_RETURN:
                need(2)
                steps.append(StepRec(pc, op))
                break
            elif op in (OP_ADD, OP_SUB, OP_LT, OP_GT, OP_EQ):
                need(2)
                a, b = stack[0], stack[1]
                if op == OP_ADD:
                    res = (a + b) & U256
                    out = res
                elif op == OP_SUB:
                    res = (a - b) & U256
                    out = res
                elif op == OP_LT:
                    res = (a - b) & U256
                    out = 1 if a < b else 0
                elif op == OP_GT:
                    res = (b - a) & U256
                    out = 1 if a > b else 0
                else:  # EQ
                    res = 0
                    out = 1 if a == b else 0
                steps.append(StepRec(pc, op, b=res))
                stack[:2] = [out]
                pc += 1
            elif op == OP_ISZERO:
                need(1)
                steps.append(StepRec(pc, op))
                stack[0] = 1 if stack[0] == 0 else 0
                pc += 1
            elif op == OP_NOT:
                need(1)
                steps.append(StepRec(pc, op))
                stack[0] = U256 ^ stack[0]
                pc += 1
            elif op == OP_PC:
                if len(stack) >= MAX_DEPTH:
                    raise UnsupportedTrace("stack deeper than the window")
                steps.append(StepRec(pc, op))
                stack.insert(0, pc)
                pc += 1
            elif op == OP_ADDRESS:
                if len(stack) >= MAX_DEPTH:
                    raise UnsupportedTrace("stack deeper than the window")
                v = int.from_bytes(address, "big")
                steps.append(StepRec(pc, op, b=v))
                stack.insert(0, v)
                pc += 1
            elif op == OP_CALLER:
                if len(stack) >= MAX_DEPTH:
                    raise UnsupportedTrace("stack deeper than the window")
                v = int.from_bytes(caller, "big")
                steps.append(StepRec(pc, op, b=v))
                stack.insert(0, v)
                pc += 1
            elif op == OP_CALLVALUE:
                if len(stack) >= MAX_DEPTH:
                    raise UnsupportedTrace("stack deeper than the window")
                steps.append(StepRec(pc, op, b=callvalue))
                stack.insert(0, callvalue)
                pc += 1
            elif op == OP_CDSIZE:
                if len(stack) >= MAX_DEPTH:
                    raise UnsupportedTrace("stack deeper than the window")
                steps.append(StepRec(pc, op, b=len(calldata)))
                stack.insert(0, len(calldata))
                pc += 1
            elif op == OP_CDLOAD:
                need(1)
                off = stack[0]
                data = calldata[off:off + 32] if off < len(calldata) else b""
                v = int.from_bytes(data + b"\x00" * (32 - len(data)), "big")
                steps.append(StepRec(pc, op, a=off, b=v))
                stack[0] = v
                pc += 1
            elif op == OP_POP:
                need(1)
                steps.append(StepRec(pc, op))
                stack.pop(0)
                pc += 1
            elif op in (OP_MLOAD, OP_MSTORE):
                need(1 if op == OP_MLOAD else 2)
                off = stack[0]
                if off % 32 or off >= 32 * MEM_WORDS:
                    raise UnsupportedTrace("memory access outside the file")
                w = off // 32
                if op == OP_MLOAD:
                    steps.append(StepRec(pc, op))
                    stack[0] = mem[w]
                else:
                    steps.append(StepRec(pc, op))
                    mem[w] = stack[1]
                    stack[:2] = []
                pc += 1
            elif op == OP_SLOAD:
                need(1)
                slot = stack[0]
                v = store[slot] if slot in store else int(sload(slot))
                steps.append(StepRec(pc, op, a=slot, b=v))
                stack[0] = v
                pc += 1
            elif op == OP_SSTORE:
                need(2)
                slot, v = stack[0], stack[1]
                steps.append(StepRec(pc, op, a=slot, b=v))
                store[slot] = v
                writes.append((slot, v))
                stack[:2] = []
                pc += 1
            elif op in (OP_JUMP, OP_JUMPI):
                need(1 if op == OP_JUMP else 2)
                target = stack[0]
                if op == OP_JUMP:
                    steps.append(StepRec(pc, op))
                    stack.pop(0)
                    taken = True
                else:
                    cond = stack[1]
                    steps.append(StepRec(pc, op))
                    stack[:2] = []
                    taken = cond != 0
                if taken:
                    if target not in _jumpdests:
                        raise UnsupportedTrace("invalid jump (would revert)")
                    pc = target
                else:
                    pc += 1
            elif op == OP_JUMPDEST:
                steps.append(StepRec(pc, op))
                pc += 1
        else:
            raise UnsupportedTrace(f"unsupported opcode 0x{op:02x}")
    return steps, snaps, writes


# ---------------------------------------------------------------------------
# Native verifier side: data checks over a CLAIMED step list
# ---------------------------------------------------------------------------

def check_steps(code: bytes, calldata: bytes, caller: bytes,
                callvalue: int, steps: list[StepRec],
                slot_rows: list[tuple[int, int, int]],
                address: bytes = b"\x00" * 20) -> None:
    """Validate a claimed step list by pure data indexing — no EVM
    execution.  The circuit proves the machine SEMANTICS over these
    steps; this function pins everything the circuit takes as absorbed
    input to its real source:

      * op == code[pc] at a legal instruction start; PUSH immediates ==
        the code's bytes; jump landings are JUMPDESTs;
      * ADDRESS/CALLER/CALLVALUE/CALLDATASIZE/CALLDATALOAD values ==
        the claimed tx envelope / calldata bytes;
      * SLOAD/SSTORE records replay consistently against `slot_rows`
        (the tx's (slot, old, new) write-log rows in first-touch order,
        the SAME rows the state circuit applies);
      * the trace starts at pc 0, halts with STOP/RETURN, and ALU
        result values are in u256 (canonical re-limbing happens in the
        digest recompute, so a non-canonical in-circuit witness cannot
        match).

    Raises StepCheckError on any mismatch.
    """
    if not steps or len(steps) > MAX_STEPS:
        raise StepCheckError("empty or oversized step list")
    starts, jumpdests = analyze_code(code)

    def legal_pc(pc):
        return pc >= len(code) or pc in starts

    if steps[0].pc != 0:
        raise StepCheckError("trace does not start at pc 0")
    rows_by_slot = {}
    order = []
    for slot, old, new in slot_rows:
        if slot in rows_by_slot:
            raise StepCheckError("duplicate slot row")
        rows_by_slot[slot] = (old, new)
        order.append(slot)
    cur: dict[int, int] = {}
    touch_order: list[int] = []

    for i, st in enumerate(steps):
        if not legal_pc(st.pc):
            raise StepCheckError(f"step {i}: pc inside push data")
        op = code_at(code, st.pc)
        if st.op != op:
            raise StepCheckError(f"step {i}: opcode does not match code")
        is_push = OP_PUSH0 <= op <= OP_PUSH0 + 32
        want_len = op - OP_PUSH0 if is_push else 0
        if st.pushlen != want_len:
            raise StepCheckError(f"step {i}: push length mismatch")
        if is_push:
            if st.imm != _push_imm(code, st.pc, want_len):
                raise StepCheckError(f"step {i}: immediate mismatch")
        elif st.imm:
            raise StepCheckError(f"step {i}: immediate outside PUSH")
        supported = (is_push or 0x80 <= op < 0x80 + MAX_DUP
                     or 0x90 <= op < 0x90 + MAX_SWAP or op in _SIMPLE_OPS)
        if not supported:
            raise StepCheckError(f"step {i}: unsupported opcode 0x{op:02x}")

        halt = op in (OP_STOP, OP_RETURN)
        if halt != (i == len(steps) - 1):
            raise StepCheckError("halt must be exactly the last step")

        # record fields: pin to their native sources
        if op == OP_CALLER:
            want_b = int.from_bytes(caller, "big")
        elif op == OP_ADDRESS:
            want_b = int.from_bytes(address, "big")
        elif op == OP_CALLVALUE:
            want_b = callvalue
        elif op == OP_CDSIZE:
            want_b = len(calldata)
        elif op == OP_CDLOAD:
            off = st.a
            data = calldata[off:off + 32] if off < len(calldata) else b""
            want_b = int.from_bytes(data + b"\x00" * (32 - len(data)),
                                    "big")
        elif op == OP_SLOAD:
            slot = st.a
            if slot not in rows_by_slot:
                raise StepCheckError("SLOAD of a slot without a log row")
            if slot not in cur:
                cur[slot] = rows_by_slot[slot][0]
                touch_order.append(slot)
            want_b = cur[slot]
        elif op == OP_SSTORE:
            slot = st.a
            if slot not in rows_by_slot:
                raise StepCheckError("SSTORE of a slot without a log row")
            if slot not in cur:
                cur[slot] = rows_by_slot[slot][0]
                touch_order.append(slot)
            cur[slot] = st.b
            want_b = st.b
        elif op in (OP_ADD, OP_SUB, OP_LT, OP_GT):
            want_b = None   # in-circuit result; range via canonical limbs
        else:
            want_b = 0
        if want_b is not None and st.b != want_b:
            raise StepCheckError(f"step {i}: record value mismatch")
        if op not in (OP_SLOAD, OP_SSTORE, OP_CDLOAD) and st.a:
            raise StepCheckError(f"step {i}: record slot outside scope")

        # control flow landings (the circuit proves the TRANSITION; the
        # landing's JUMPDEST-ness is a code property checked here)
        if i + 1 < len(steps):
            nxt = steps[i + 1].pc
            if op == OP_JUMP:
                if nxt not in jumpdests:
                    raise StepCheckError("jump lands outside a JUMPDEST")
            elif op == OP_JUMPI:
                if nxt != st.pc + 1 and nxt not in jumpdests:
                    raise StepCheckError("jumpi lands outside a JUMPDEST")

    # storage replay must cover the rows exactly
    if touch_order != order:
        raise StepCheckError("slot rows do not match the touch order")
    for slot, (old, new) in rows_by_slot.items():
        if cur.get(slot, old) != new:
            raise StepCheckError("slot row final value mismatch")
