"""The port's native host engines (`ethrex_tpu_torch/native/`) against
their Python oracles in the port and against the JAX package.

Keccak-256 at every length 0-400 (the rate boundaries 135-137 and
271-273 among them); secp256k1 recovery on 200 valid signatures and on
every kind of invalid one; the MPT merkleizer on the reference's own
cases (tests/test_native_mpt.py: random batches, inline nodes, missing
node parity, fresh-node persistence); the EVM loop, forced native, on a
countdown loop, an escape-heavy frame and 100 seeded random programs
over the opcodes it runs.  Then the build itself: the stamp, concurrent
builds, a broken source that raises with the compiler's output and falls
back to nothing, and an import of every module that builds nothing.
Inputs come from seeded numpy generators.  Bar: equal bytes, equal gas.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ethrex_tpu.crypto import keccak as jkeccak
from ethrex_tpu.crypto import secp256k1 as jsecp
from ethrex_tpu.trie.trie import Trie as JTrie
from ethrex_tpu_torch import native
from ethrex_tpu_torch.crypto import keccak
from ethrex_tpu_torch.crypto import native_secp256k1 as nsecp
from ethrex_tpu_torch.crypto import secp256k1 as secp
from ethrex_tpu_torch.evm import native_vm as nv
from ethrex_tpu_torch.evm import vm
from ethrex_tpu_torch.primitives.account import EMPTY_TRIE_ROOT
from ethrex_tpu_torch.primitives.genesis import ChainConfig
from ethrex_tpu_torch.storage import store as store_mod
from ethrex_tpu_torch.trie.native_mpt import NativeMpt
from ethrex_tpu_torch.trie.trie import MissingNode, Trie
from ethrex_tpu_torch.utils import ef_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Keccak
# ---------------------------------------------------------------------------

def test_keccak_engine_equals_python_and_reference():
    rng = np.random.default_rng(1301)
    lengths = list(range(401))
    assert {135, 136, 137, 271, 272, 273} <= set(lengths)
    for n in lengths:
        msg = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        got = keccak.keccak256(msg)
        assert got == keccak._keccak256_py(msg), n
        assert got == jkeccak.keccak256(msg) == jkeccak._keccak256_py(msg), n
    assert keccak.available()
    assert "keccak" in native.loaded()


def test_keccak_accepts_bytearray_and_memoryview():
    data = bytearray(b"ethrex" * 40)
    want = keccak._keccak256_py(bytes(data))
    assert keccak.keccak256(data) == want
    assert keccak.keccak256(memoryview(data)) == want


# ---------------------------------------------------------------------------
# secp256k1 recovery
# ---------------------------------------------------------------------------

def _signatures(count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        secret = int.from_bytes(bytes(rng.integers(0, 256, 32,
                                                   dtype=np.uint8)),
                                "big") % (secp.N - 1) + 1
        msg = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        r, s, rec = secp.sign(msg, secret)
        out.append((msg, r, s, rec, secret))
    return out


def test_secp256k1_recovery_equals_python_and_reference():
    sigs = _signatures(200, 1302)
    items = []
    for msg, r, s, rec, secret in sigs:
        point = nsecp.recover(msg, r, s, rec)
        assert point == secp.recover(msg, r, s, rec) \
            == secp.pubkey_from_secret(secret)
        addr = secp.recover_address(msg, r, s, rec)
        assert addr == secp.pubkey_to_address(point) \
            == jsecp.recover_address(msg, r, s, rec)
        raw = nsecp.recover_pubkey_bytes(msg, r, s, rec)
        assert raw == point[0].to_bytes(32, "big") + \
            point[1].to_bytes(32, "big")
        items.append((msg, r, s, rec))
    batch = nsecp.recover_batch(items)
    assert batch == [nsecp.recover_pubkey_bytes(*it) for it in items]


def _off_curve_x() -> int:
    # the smallest x whose x^3 + 7 is not a square mod P
    x = 1
    while pow((pow(x, 3, secp.P) + 7) % secp.P, (secp.P - 1) // 2,
              secp.P) == 1:
        x += 1
    return x


def _invalid_cases():
    (msg, r, s, rec, _), = _signatures(1, 1303)
    return {
        "r_zero": (msg, 0, s, rec),
        "s_zero": (msg, r, 0, rec),
        "r_is_n": (msg, secp.N, s, rec),
        "r_above_n": (msg, secp.N + 7, s, rec),
        "s_is_n": (msg, r, secp.N, rec),
        "s_above_n": (msg, r, secp.N + 7, rec),
        "rec_id_2": (msg, r, s, 2),
        "rec_id_3": (msg, r, s, 3),
        "rec_id_2_small_r": (msg, 5, s, 2),
        "rec_id_4": (msg, r, s, 4),
        "x_off_curve": (msg, _off_curve_x(), s, rec),
        "r_above_2_256": (msg, 1 << 256, s, rec),
    }


@pytest.mark.parametrize("case", sorted(_invalid_cases()))
def test_secp256k1_edge_signatures_match(case):
    msg, r, s, rec = _invalid_cases()[case]
    want = secp.recover(msg, r, s, rec)
    assert nsecp.recover(msg, r, s, rec) == want
    assert jsecp.recover(msg, r, s, rec) == want
    addr = None if want is None else secp.pubkey_to_address(want)
    assert secp.recover_address(msg, r, s, rec) == addr
    assert jsecp.recover_address(msg, r, s, rec) == addr
    assert nsecp.recover_batch([(msg, r, s, rec)]) == [
        nsecp.recover_pubkey_bytes(msg, r, s, rec)]
    if case in ("r_zero", "s_zero", "r_is_n", "s_is_n", "x_off_curve",
                "rec_id_4", "r_above_2_256"):
        assert want is None


# ---------------------------------------------------------------------------
# MPT (the reference's tests/test_native_mpt.py cases)
# ---------------------------------------------------------------------------

def _rand_key(rng):
    return bytes(rng.integers(0, 256, 32, dtype=np.uint8))


def _python_apply(table, root, ops, trie=Trie):
    t = trie.from_nodes(root, dict(table), share=True)
    for k, v in ops:
        if v:
            t.insert(k, v)
    for k, v in ops:
        if not v:
            t.remove(k)
    return t.commit()


def test_mpt_random_batches_equal_python_and_reference():
    rng = np.random.default_rng(1304)
    table = {}
    root = EMPTY_TRIE_ROOT
    engine = NativeMpt()
    live = []
    for batch in range(6):
        ops = []
        for _ in range(80):
            k = keccak.keccak256(_rand_key(rng))
            ops.append((k, b"val" + k[:6]))
            live.append(k)
        dels = [live.pop(rng.integers(0, len(live)))
                for _ in range(min(25, len(live) // 2))]
        ops += [(k, b"") for k in dels]
        expected = _python_apply(table, root, ops)
        assert expected == _python_apply(table, root, ops, trie=JTrie)
        root = engine.apply(table, root, ops)
        assert root == expected, f"batch {batch} diverged"


def test_mpt_variable_length_values_and_empty_trie():
    table = {}
    engine = NativeMpt()
    ops = [(keccak.keccak256(bytes([i])), bytes([i]) * (1 + 7 * i))
           for i in range(40)]
    root = engine.apply(table, EMPTY_TRIE_ROOT, ops)
    assert root == _python_apply({}, EMPTY_TRIE_ROOT, ops)
    root = engine.apply(table, root, [(k, b"") for k, _ in ops])
    assert root == EMPTY_TRIE_ROOT


def test_mpt_short_values_inline_nodes():
    table = {}
    engine = NativeMpt()
    ops = [(keccak.keccak256(bytes([i, j])), bytes([i]))
           for i in range(6) for j in range(6)]
    root = engine.apply(table, EMPTY_TRIE_ROOT, ops)
    assert root == _python_apply({}, EMPTY_TRIE_ROOT, ops)
    t = Trie.from_nodes(root, table, share=True)
    assert t.get(keccak.keccak256(bytes([2, 3]))) == bytes([2])


def test_mpt_missing_node_raises_like_python():
    table = {}
    py = Trie.from_nodes(EMPTY_TRIE_ROOT, table, share=True)
    for i in range(100):
        py.insert(keccak.keccak256(bytes([i])), b"v%d" % i)
    root = py.commit()
    pruned = dict(list(table.items())[:3])
    op = (keccak.keccak256(bytes([5])), b"x")
    with pytest.raises(MissingNode):
        _python_apply(pruned, root, [op])
    with pytest.raises(MissingNode):
        NativeMpt().apply(pruned, root, [op])


def test_mpt_fresh_nodes_persist_to_table():
    table = {}
    engine = NativeMpt()
    ops = [(keccak.keccak256(bytes([i])), b"value-%d" % i)
           for i in range(50)]
    root = engine.apply(table, EMPTY_TRIE_ROOT, ops)
    t = Trie.from_nodes(root, table, share=True)
    for i in range(50):
        assert t.get(keccak.keccak256(bytes([i]))) == b"value-%d" % i
    assert set(table) == {keccak.keccak256(n) for n in table.values()}


def test_make_native_engine_follows_the_switch(monkeypatch):
    monkeypatch.delenv("ETHREX_TPU_NATIVE_MPT", raising=False)
    assert isinstance(store_mod._make_native_engine(), NativeMpt)
    monkeypatch.setenv("ETHREX_TPU_NATIVE_MPT", "0")
    assert store_mod._make_native_engine() is None


# ---------------------------------------------------------------------------
# The EVM loop
# ---------------------------------------------------------------------------

def _config(fork: str) -> ChainConfig:
    cfg = dict(ef_state._FORK_CONFIGS[fork])
    cfg.setdefault("terminalTotalDifficulty", 0)
    return ChainConfig.from_json(cfg)


def _evm(fork: str = "Prague"):
    st = store_mod.Store().state_db(EMPTY_TRIE_ROOT)
    return vm.EVM(st, vm.BlockEnv(number=1, timestamp=1000), _config(fork))


def _frame(code: bytes, data: bytes = b"", gas: int = 10_000_000):
    msg = vm.Message(caller=b"\x01" * 20, to=b"\x02" * 20,
                     code_address=b"\x02" * 20, value=0, data=data,
                     gas=gas, code=code)
    return vm.Frame(msg, code)


def _halt(run, f):
    try:
        run(f)
    except vm._Halt as h:
        return ("halt", h.output, h.reverted)
    except vm.VMError as e:
        return (type(e).__name__,)
    raise AssertionError("the loop returned without a halt")


_NATIVE_HALTS = {nv.HALT_OOG: "OutOfGas", nv.HALT_INVALID_OP: "InvalidOpcode",
                 nv.HALT_INVALID_JUMP: "InvalidJump",
                 nv.HALT_STACK: "StackError"}


def _run_native_frame(evm, f):
    """The native loop on frame `f`, escapes run by the Python handlers
    (as `EVM._run_native` does); returns the halt and leaves the native
    state (gas, pc, stack, memory) pulled into `f`."""
    handlers = vm._handlers_for(evm.fork)
    nf = nv.NativeFrame(nv._load(), f.code, f.msg.data, f.gas,
                        evm.sched.exp_byte, vm._native_mask_for(evm.fork))
    try:
        while True:
            rc = nf.run()
            nf.pull_into(f)
            if rc != nv.HALT_ESCAPE:
                break
            op = f.code[f.pc]
            if handlers[op] is None:
                return ("InvalidOpcode",)
            f.pc += 1
            try:
                handlers[op](evm, f)
            except vm._Halt as h:
                return ("halt", h.output, h.reverted)
            except vm.VMError as e:
                return (type(e).__name__,)
            nf.push_from(f)
        if rc in (nv.HALT_STOP, nv.HALT_CODE_END):
            return ("halt", b"", False)
        if rc in (nv.HALT_RETURN, nv.HALT_REVERT):
            off, length = nf.output()
            return ("halt", bytes(f.memory[off:off + length]),
                    rc == nv.HALT_REVERT)
        return (_NATIVE_HALTS[rc],)
    finally:
        nf.close()


def _countdown(n: int) -> bytes:
    """PUSH2 n; [JUMPDEST DUP1 ISZERO PUSH2 exit JUMPI PUSH1 1 SWAP1 SUB
    PUSH2 3 JUMP] exit: JUMPDEST STOP."""
    return bytes([0x61, n >> 8, n & 0xFF,
                  0x5B, 0x80, 0x15, 0x61, 0x00, 0x12, 0x57,
                  0x60, 0x01, 0x90, 0x03,
                  0x61, 0x00, 0x03, 0x56,
                  0x5B, 0x00])


def _compare(code: bytes, data: bytes, gas: int, fork: str,
             monkeypatch) -> tuple:
    evm = _evm(fork)
    f_py = _frame(code, data, gas)
    want = _halt(lambda f: evm._run_py(f, vm._handlers_for(evm.fork)),
                 f_py)
    f_nat = _frame(code, data, gas)
    got = _run_native_frame(_evm(fork), f_nat)
    assert got == want, (code.hex(), fork)
    if want[0] == "halt":
        assert (f_nat.gas, f_nat.stack, bytes(f_nat.memory)) == \
            (f_py.gas, f_py.stack, bytes(f_py.memory)), (code.hex(), fork)
    # the same frame through the interpreter's own entry, forced native
    monkeypatch.setenv("ETHREX_TPU_NATIVE_EVM", "1")
    f_run = _frame(code, data, gas)
    assert _halt(_evm(fork)._run, f_run) == want
    if want[0] == "halt":
        assert f_run.gas == f_py.gas
    monkeypatch.delenv("ETHREX_TPU_NATIVE_EVM")
    return want, f_py.gas


def test_countdown_loop_gas_parity(monkeypatch):
    code = _countdown(2000)
    assert len(code) < vm._NATIVE_MIN_CODE
    halt, gas = _compare(code, b"", 10_000_000, "Prague", monkeypatch)
    assert halt == ("halt", b"", False)
    assert 10_000_000 - gas == 3 + 2000 * 40 + 20 + 1


_FORKS = ["Frontier", "Homestead", "Byzantium", "Constantinople",
          "Istanbul", "Berlin", "London", "Shanghai", "Cancun", "Prague"]
_OPS = sorted(op for op in nv._NATIVE_SET if not 0x60 <= op <= 0x7F)


def _random_program(rng) -> bytes:
    code = bytearray()
    for _ in range(int(rng.integers(16, 40))):
        # seed the stack, mostly with small values (offsets, sizes, shifts)
        width = int(rng.integers(1, 33))
        value = int(rng.integers(0, 96)) if rng.random() < 0.6 else \
            int.from_bytes(bytes(rng.integers(0, 256, width,
                                              dtype=np.uint8)), "big")
        width = max(1, (value.bit_length() + 7) // 8)
        code += bytes([0x5F + width]) + value.to_bytes(width, "big")
    for _ in range(int(rng.integers(8, 100))):
        r = rng.random()
        if r < 0.4:
            width = int(rng.integers(1, 33))
            value = int(rng.integers(0, len(code) + 64)) if r < 0.25 else \
                int.from_bytes(bytes(rng.integers(0, 256, width,
                                                  dtype=np.uint8)), "big")
            width = max(1, (value.bit_length() + 7) // 8)
            code += bytes([0x5F + width]) + value.to_bytes(width, "big")
        else:
            code.append(int(_OPS[rng.integers(0, len(_OPS))]))
    return bytes(code)


def test_random_programs_native_equals_python(monkeypatch):
    rng = np.random.default_rng(1305)
    kinds = {}
    for i in range(100):
        code = _random_program(rng)
        data = bytes(rng.integers(0, 256, int(rng.integers(0, 70)),
                                  dtype=np.uint8))
        fork = _FORKS[i % len(_FORKS)]
        halt, _ = _compare(code, data, 200_000, fork, monkeypatch)
        kinds[halt[0]] = kinds.get(halt[0], 0) + 1
    # the programs reach normal halts and faults both
    assert kinds.get("halt", 0) >= 20 and len(kinds) >= 4, kinds


def test_escape_roundtrip_preserves_state(monkeypatch):
    """SSTORE escapes to Python between native arithmetic: storage and
    gas equal the Python loop's (the reference's own case)."""
    code = bytearray()
    for i in range(64):
        v = i * 3 + 1
        code += bytes([0x61, v >> 8, v & 0xFF, 0x60, i, 0x55])
    code += b"\x00"
    code = bytes(code)

    def run(env):
        monkeypatch.setenv("ETHREX_TPU_NATIVE_EVM", env)
        evm = _evm()
        f = _frame(code)
        halt = _halt(evm._run, f)
        storage = {s: evm.state.get_storage(b"\x02" * 20, s)
                   for s in range(64)}
        return halt, f.gas, storage

    calls = []
    real = vm.EVM._run_native

    def spy(self, f, handlers):
        calls.append(len(f.code))
        return real(self, f, handlers)

    monkeypatch.setattr(vm.EVM, "_run_native", spy)
    py = run("0")
    assert calls == []
    nat = run("")      # the default: a frame of 64 bytes or more is native
    assert calls == [len(code)]
    assert py == nat
    assert nat[2] == {i: i * 3 + 1 for i in range(64)}


def test_short_frames_stay_in_python_unless_forced(monkeypatch):
    calls = []
    real = vm.EVM._run_native

    def spy(self, f, handlers):
        calls.append(len(f.code))
        return real(self, f, handlers)

    monkeypatch.setattr(vm.EVM, "_run_native", spy)
    monkeypatch.delenv("ETHREX_TPU_NATIVE_EVM", raising=False)
    code = _countdown(10)
    halt = _halt(_evm()._run, _frame(code))
    assert calls == []
    monkeypatch.setenv("ETHREX_TPU_NATIVE_EVM", "1")
    assert _halt(_evm()._run, _frame(code)) == halt
    assert calls == [len(code)]


def test_native_op_mask_follows_the_fork():
    shanghai = nv.native_op_mask(_config("Shanghai").fork_at(1, 1000))
    london = nv.native_op_mask(_config("London").fork_at(1, 1000))
    frontier = nv.native_op_mask(_config("Frontier").fork_at(1, 1000))
    assert shanghai[0x5F] == 1 and london[0x5F] == 0
    assert shanghai[0x5E] == 0
    assert frontier[0x1B] == frontier[0xFD] == 0
    assert shanghai[0x08] == shanghai[0x09] == 0       # ADDMOD, MULMOD


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------

def test_build_stamp_and_rebuild(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(native.SRC_DIR / "keccak.c", src / "keccak.c")
    out = tmp_path / "out"
    lib = native.build("keccak", src_dir=src, build_dir=out)
    first = lib.stat().st_mtime_ns
    assert native.build("keccak", src_dir=src, build_dir=out) == lib
    assert lib.stat().st_mtime_ns == first          # the stamp matched
    (src / "keccak.c").write_text((src / "keccak.c").read_text()
                                  + "\n/* changed */\n")
    native.build("keccak", src_dir=src, build_dir=out)
    assert lib.stat().st_mtime_ns != first          # a source changed
    assert sorted(p.name for p in out.iterdir()) == ["libkeccak.so",
                                                     "libkeccak.stamp"]


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("evm.cpp", "keccak.c"):
        shutil.copy(native.SRC_DIR / name, src / name)
    out = tmp_path / "out"
    code = textwrap.dedent(f"""
        import ctypes
        from ethrex_tpu_torch import native
        lib = native.build("evm", src_dir={str(src)!r},
                           build_dir={str(out)!r})
        ctypes.CDLL(str(lib)).evm_frame_new
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stderr=subprocess.PIPE) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-800:]
    assert sorted(p.name for p in out.iterdir()) == ["libevm.so",
                                                     "libevm.stamp"]


def test_broken_source_raises_and_falls_back_to_nothing(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "keccak.c").write_text(
        "void keccak256(const char *in, long n, char *out) { oops }\n")
    with pytest.raises(native.BuildError, match="error"):
        native.build("keccak", src_dir=src, build_dir=tmp_path / "out")
    assert not (tmp_path / "out" / "libkeccak.so").exists()
    # the engine's own loader raises too: keccak256 does not fall back
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(keccak, "_fn", None)
    with pytest.raises(native.BuildError, match="oops"):
        keccak.keccak256(b"abc")
    with pytest.raises(native.BuildError):
        keccak.available()
    assert keccak._fn is None


def test_missing_compiler_raises_everywhere(monkeypatch, tmp_path):
    """No compiler: every engine raises where it is first used, and
    nothing selects a Python path but the two switches."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_compiler_versions", {})
    monkeypatch.setattr(keccak, "_fn", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("ETHREX_TPU_NATIVE_EVM", raising=False)
    monkeypatch.delenv("ETHREX_TPU_NATIVE_MPT", raising=False)
    with pytest.raises(native.BuildError, match="not found"):
        keccak.keccak256(b"")
    with pytest.raises(native.BuildError):
        secp.recover_address(b"\x00" * 32, 1, 1, 0)
    with pytest.raises(native.BuildError):
        store_mod._make_native_engine()
    with pytest.raises(native.BuildError):
        vm._native_available()
    monkeypatch.setenv("ETHREX_TPU_NATIVE_EVM", "0")
    monkeypatch.setenv("ETHREX_TPU_NATIVE_MPT", "0")
    assert vm._native_available() is False
    assert store_mod._make_native_engine() is None


def test_import_builds_nothing(tmp_path):
    """Every module of the port imports on a box with no compiler, and
    importing builds and loads no engine."""
    code = textwrap.dedent("""
        import importlib, pkgutil
        import ethrex_tpu_torch
        from ethrex_tpu_torch import native
        names = [m.name for m in pkgutil.walk_packages(
            ethrex_tpu_torch.__path__, "ethrex_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert native.loaded() == [] and native.BUILD_S == {}, (
            native.loaded(), native.BUILD_S)
        print(len(names))
    """)
    env = dict(os.environ, PATH=str(tmp_path), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert int(proc.stdout.split()[-1]) > 80
