"""The canonical token template: the contract class whose calls the token
circuit (models/token_air.py) can prove.  A copy of
`ethrex_tpu/guest/token_template.py`.

It widens the VM arithmetization beyond plain transfers to storage writes
and CALL: an ERC-20-subset token
whose `transfer(address,uint256)` call reads and writes balance slots of a
slot-0 Solidity mapping.  The bytecode is hand-assembled here so its semantics
are EXACTLY the rules the circuit arithmetizes:

    transfer(dst, v):
        kf = keccak(pad32(caller) || pad32(0));  bf = sload(kf)
        revert if bf < v
        sstore(kf, bf - v)
        kt = keccak(pad32(dst) || pad32(0));     bt = sload(kt)
        sstore(kt, bt + v)            # unchecked add (wrap caught by the
        return true                   # fine-log model's executor oracle)
    balanceOf(a): return sload(keccak(pad32(a) || pad32(0)))

The prover's fine-log model (guest/transfer_log.build_vm_batch) models
these rules per transaction and checks the callee's code hash against
TEMPLATE_CODE_HASH; the executor-consistency oracle compares the model's
final state against the real execution — so the circuit never signs off
on semantics the deployed code does not have.  The verifier-side
counterpart (recomputing the circuit digest from the claimed log and
re-pinning the code hash from the witness) lives in
`ethrex_tpu/prover/tpu_backend.py`.
"""

from __future__ import annotations

from ..crypto.keccak import _keccak256_py, keccak256

SELECTOR_TRANSFER = bytes.fromhex("a9059cbb")
SELECTOR_BALANCE_OF = bytes.fromhex("70a08231")

_OPS = {
    "STOP": 0x00, "ADD": 0x01, "SUB": 0x03, "LT": 0x10, "EQ": 0x14,
    "AND": 0x16, "SHR": 0x1C, "SHA3": 0x20, "CALLER": 0x33,
    "CALLDATALOAD": 0x35, "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52,
    "SLOAD": 0x54, "SSTORE": 0x55, "JUMPI": 0x57, "JUMPDEST": 0x5B,
    "DUP1": 0x80, "DUP2": 0x81, "DUP3": 0x82, "DUP4": 0x83,
    "SWAP1": 0x90, "SWAP2": 0x91, "RETURN": 0xF3, "REVERT": 0xFD,
}


def assemble(program: list) -> bytes:
    """Tiny two-pass assembler: items are mnemonics, ("PUSHn", bytes),
    ("PUSHLABEL", name) (2-byte target), or ("LABEL", name)."""
    # pass 1: offsets
    offsets = {}
    pc = 0
    for item in program:
        if isinstance(item, str):
            pc += 1
        elif item[0] == "LABEL":
            offsets[item[1]] = pc
            pc += 1  # JUMPDEST emitted at the label
        elif item[0] == "PUSHLABEL":
            pc += 3
        else:
            pc += 1 + len(item[1])
    out = bytearray()
    for item in program:
        if isinstance(item, str):
            out.append(_OPS[item])
        elif item[0] == "LABEL":
            out.append(_OPS["JUMPDEST"])
        elif item[0] == "PUSHLABEL":
            out += bytes([0x61]) + offsets[item[1]].to_bytes(2, "big")
        else:
            data = item[1]
            out += bytes([0x5F + len(data)]) + data  # PUSH1..PUSH32
    return bytes(out)


def _push(value: int, width: int = 1):
    return ("PUSH", value.to_bytes(width, "big"))


_ADDR_MASK = ("PUSH", b"\xff" * 20)

_PROGRAM = [
    # dispatcher
    _push(0), "CALLDATALOAD", _push(0xE0), "SHR",
    "DUP1", ("PUSH", SELECTOR_TRANSFER), "EQ",
    ("PUSHLABEL", "xfer"), "JUMPI",
    "DUP1", ("PUSH", SELECTOR_BALANCE_OF), "EQ",
    ("PUSHLABEL", "balf"), "JUMPI",
    _push(0), "DUP1", "REVERT",

    # transfer(address dst, uint256 v)
    ("LABEL", "xfer"), "POP",
    _push(0x24), "CALLDATALOAD",                      # [v]
    _push(0x04), "CALLDATALOAD", _ADDR_MASK, "AND",   # [v, dst]
    # kf = keccak(pad32(caller) || pad32(0))
    "CALLER", _push(0), "MSTORE",
    _push(0), _push(0x20), "MSTORE",
    _push(0x40), _push(0), "SHA3",                    # [v, dst, kf]
    "DUP1", "SLOAD",                                  # [v, dst, kf, bf]
    "DUP4", "DUP2", "LT",                             # [.., bf, bf<v]
    ("PUSHLABEL", "rev"), "JUMPI",                    # [v, dst, kf, bf]
    "DUP4", "SWAP1", "SUB",                           # [v, dst, kf, bf-v]
    "SWAP1", "SSTORE",                                # [v, dst]
    # kt = keccak(pad32(dst) || pad32(0))  (mem[0x20] still holds 0)
    _push(0), "MSTORE",                               # [v]
    _push(0x40), _push(0), "SHA3",                    # [v, kt]
    "DUP1", "SLOAD",                                  # [v, kt, bt]
    "DUP3", "ADD",                                    # [v, kt, bt+v]
    "SWAP1", "SSTORE",                                # [v]
    "POP",
    _push(1), _push(0), "MSTORE",
    _push(0x20), _push(0), "RETURN",

    # balanceOf(address a)
    ("LABEL", "balf"), "POP",
    _push(0x04), "CALLDATALOAD", _ADDR_MASK, "AND",
    _push(0), "MSTORE",
    _push(0), _push(0x20), "MSTORE",
    _push(0x40), _push(0), "SHA3", "SLOAD",
    _push(0), "MSTORE",
    _push(0x20), _push(0), "RETURN",

    ("LABEL", "rev"), _push(0), "DUP1", "REVERT",
]

TEMPLATE_CODE = assemble(_PROGRAM)
TEMPLATE_CODE_HASH = _keccak256_py(TEMPLATE_CODE)


def balance_slot(holder: bytes) -> int:
    """Mapping key of `holder`'s balance (Solidity slot-0 mapping rule)."""
    return int.from_bytes(
        keccak256(b"\x00" * 12 + holder + b"\x00" * 32), "big")


def transfer_calldata(dst: bytes, amount: int) -> bytes:
    return (SELECTOR_TRANSFER + b"\x00" * 12 + dst
            + amount.to_bytes(32, "big"))


def decode_transfer_calldata(data: bytes):
    """(dst, amount) if `data` is exactly a transfer() call, else None."""
    if len(data) != 68 or data[:4] != SELECTOR_TRANSFER:
        return None
    if any(data[4:16]):
        return None  # dirty upper address bytes change the slot: refuse
    return data[16:36], int.from_bytes(data[36:68], "big")
