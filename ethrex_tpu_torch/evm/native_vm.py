"""ctypes bridge to the native EVM hot loop (`native/evm.cpp`).

The C++ interpreter executes every frame-local opcode at native speed and
ESCAPES to the Python interpreter for state/env/call opcodes, which run
through the canonical handlers (evm/vm.py) and re-enter the loop.  The
hybrid keeps a single source of truth for all stateful semantics while
removing the per-opcode Python dispatch cost from the hot path, as the
reference's `evm/native_vm.py` does.

On by default; ETHREX_TPU_NATIVE_EVM=0 selects the pure-Python loop
(`EVM._run_py`) and =1 forces the native loop for every frame.  The
library is built at first use by `ethrex_tpu_torch.native`; a failed
build raises.  Held against the Python loop over the whole EF fork
ladder (tests/test_torch_native_evm.py).
"""

from __future__ import annotations

import ctypes
import os

from .. import native

HALT_STOP = 0
HALT_RETURN = 1
HALT_REVERT = 2
HALT_ESCAPE = 3
HALT_OOG = 4
HALT_INVALID_OP = 5
HALT_INVALID_JUMP = 6
HALT_STACK = 7
HALT_CODE_END = 8

# opcodes the native loop handles (frame-local semantics only); MCOPY and
# PUSH0 are additionally fork-gated by the caller
_NATIVE_OPS = (
    [0x00] + list(range(0x01, 0x0C)) + list(range(0x10, 0x1E)) + [0x20]
    + [0x35, 0x36, 0x37, 0x38, 0x39]
    + [0x50, 0x51, 0x52, 0x53, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x5B]
    + [0x5E, 0x5F]
    + list(range(0x60, 0xA0))          # PUSH/DUP/SWAP
    + [0xF3, 0xFD, 0xFE]
)
# ADDMOD/MULMOD escape (512-bit intermediates stay in Python)
_NATIVE_SET = frozenset(_NATIVE_OPS) - {0x08, 0x09}


def _bind(lib) -> None:
    lib.evm_frame_new.restype = ctypes.c_void_p
    lib.evm_frame_new.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p]
    lib.evm_frame_free.argtypes = [ctypes.c_void_p]
    lib.evm_run.argtypes = [ctypes.c_void_p]
    lib.evm_run.restype = ctypes.c_int
    for name, res in (("evm_gas", ctypes.c_uint64),
                      ("evm_pc", ctypes.c_uint64),
                      ("evm_stack_len", ctypes.c_uint32),
                      ("evm_mem_size", ctypes.c_uint64),
                      ("evm_ret_off", ctypes.c_uint64),
                      ("evm_ret_len", ctypes.c_uint64)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = res
    lib.evm_set_gas.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.evm_set_pc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.evm_stack_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.evm_stack_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.evm_mem_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.evm_mem_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]


def _load():
    return native.load("evm", _bind)


def available() -> bool:
    """False when ETHREX_TPU_NATIVE_EVM=0 (read at every call); else True
    once the loop is built and loaded (a failed build raises
    `native.BuildError`)."""
    if os.environ.get("ETHREX_TPU_NATIVE_EVM") == "0":
        return False
    _load()
    return True


def forced() -> bool:
    """ETHREX_TPU_NATIVE_EVM=1 forces the native loop for every frame
    (differential testing); the default is a size heuristic — tiny frames
    are dominated by per-frame setup and stay in Python
    (vm._NATIVE_MIN_CODE)."""
    return os.environ.get("ETHREX_TPU_NATIVE_EVM") == "1"


def native_op_mask(fork) -> bytes:
    """The 256-byte handled-natively map for a fork: an opcode outside the
    fork's dispatch table must NOT run natively — escaping it lets the
    Python side raise the canonical InvalidOpcode."""
    from ..primitives.genesis import Fork

    mask = bytearray(256)
    for op in _NATIVE_SET:
        mask[op] = 1
    if fork < Fork.SHANGHAI:
        mask[0x5F] = 0
    if fork < Fork.CANCUN:
        mask[0x5E] = 0
    if fork < Fork.CONSTANTINOPLE:
        mask[0x1B] = mask[0x1C] = mask[0x1D] = 0
    if fork < Fork.BYZANTIUM:
        mask[0xFD] = 0
    return bytes(mask)


class NativeFrame:
    """C-owned frame: code/calldata/memory/stack live in the extension;
    sync helpers move state to/from the Python Frame around escapes."""

    __slots__ = ("lib", "ptr")

    def __init__(self, lib, code: bytes, calldata: bytes, gas: int,
                 exp_byte: int, mask: bytes):
        self.lib = lib
        self.ptr = lib.evm_frame_new(code, len(code), calldata,
                                     len(calldata), gas, exp_byte, mask)

    def run(self) -> int:
        return self.lib.evm_run(self.ptr)

    # -- state sync ------------------------------------------------------
    def pull_into(self, f) -> None:
        """Native state -> Python Frame (before an escaped op runs)."""
        lib, ptr = self.lib, self.ptr
        f.gas = lib.evm_gas(ptr)
        f.pc = lib.evm_pc(ptr)
        n = lib.evm_stack_len(ptr)
        buf = ctypes.create_string_buffer(32 * n)
        lib.evm_stack_read(ptr, buf)
        raw = buf.raw
        f.stack = [int.from_bytes(raw[32 * i:32 * i + 32], "big")
                   for i in range(n)]
        msize = lib.evm_mem_size(ptr)
        mbuf = ctypes.create_string_buffer(max(msize, 1))
        lib.evm_mem_read(ptr, mbuf)
        f.memory = bytearray(mbuf.raw[:msize])

    def push_from(self, f) -> None:
        """Python Frame -> native state (after an escaped op ran)."""
        lib, ptr = self.lib, self.ptr
        lib.evm_set_gas(ptr, f.gas)
        lib.evm_set_pc(ptr, f.pc)
        n = len(f.stack)
        buf = b"".join(v.to_bytes(32, "big") for v in f.stack)
        lib.evm_stack_write(ptr, buf, n)
        lib.evm_mem_write(ptr, bytes(f.memory), len(f.memory))

    def output(self) -> tuple[int, int]:
        return (self.lib.evm_ret_off(self.ptr),
                self.lib.evm_ret_len(self.ptr))

    def close(self):
        if self.ptr:
            self.lib.evm_frame_free(self.ptr)
            self.ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
