"""The EF state-test ladder through the port's `utils/ef_state.py` on the
Python dispatch loop, and BASELINE-3's execution with the native host
engines on, against the JAX package.

The fork ladder (`tests/fixtures/ef_state/forks`: 4,807 cases over 14
forks, Frontier to Prague) runs once per module with
ETHREX_TPU_NATIVE_EVM=0, so every frame goes through `EVM._run_py`;
Keccak, sender recovery and the MPT merkleizer run in their engines.
Every case must pass, fork by fork.  The top-level fixtures and the
matrix give the same post-state root, logs digest, rejection and gas as
the reference's `ef_state.execute_case`.  The same ladder with the
native loop forced is tests/test_torch_native_evm.py, in a file of its
own so that the two ladders run on different workers.
"""

from __future__ import annotations

import os

import pytest

from ethrex_tpu.guest.execution import ProgramInput as JProgramInput
from ethrex_tpu.guest.execution import execution_program as jexecute
from ethrex_tpu.guest import access_log as jal
from ethrex_tpu.utils import ef_state as jef
from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.crypto import keccak
from ethrex_tpu_torch.crypto import native_secp256k1 as nsecp
from ethrex_tpu_torch.evm import vm
from ethrex_tpu_torch.guest import access_log
from ethrex_tpu_torch.guest.execution import execution_program
from ethrex_tpu_torch.trie.native_mpt import NativeMpt
from ethrex_tpu_torch.utils import ef_state

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "ef_state")

# the ladder's cases per fork (tests/fixtures/ef_state/forks)
LADDER = {"Frontier": 336, "Homestead": 336, "EIP150": 336, "EIP158": 336,
          "Byzantium": 339, "Constantinople": 350, "ConstantinopleFix": 350,
          "Istanbul": 348, "Berlin": 348, "London": 347, "Paris": 347,
          "Shanghai": 346, "Cancun": 344, "Prague": 344}


def ladder_results() -> dict:
    """fork -> [passed, failed, the first failures' details] over the
    fork ladder, under the EVM switch the caller set."""
    passed, failed = ef_state.run_directory(os.path.join(FIXDIR, "forks"))
    out = {fork: [0, 0, []] for fork in LADDER}
    for r in passed:
        out.setdefault(r.case.fork, [0, 0, []])[0] += 1
    for r in failed:
        row = out.setdefault(r.case.fork, [0, 0, []])
        row[1] += 1
        if len(row[2]) < 3:
            row[2].append(f"{r.case.name}{r.case.indexes}: {r.detail}")
    return out


@pytest.fixture(scope="module")
def python_ladder():
    prev = os.environ.get("ETHREX_TPU_NATIVE_EVM")
    os.environ["ETHREX_TPU_NATIVE_EVM"] = "0"
    native_frames = []
    real = vm.EVM._run_native
    vm.EVM._run_native = lambda self, f, h: native_frames.append(f) or \
        real(self, f, h)
    try:
        return ladder_results(), native_frames
    finally:
        vm.EVM._run_native = real
        if prev is None:
            os.environ.pop("ETHREX_TPU_NATIVE_EVM")
        else:
            os.environ["ETHREX_TPU_NATIVE_EVM"] = prev


@pytest.mark.parametrize("fork", list(LADDER))
def test_ladder_on_the_python_loop(python_ladder, fork):
    results, native_frames = python_ladder
    n_pass, n_fail, details = results[fork]
    assert native_frames == []
    assert n_fail == 0, details
    assert n_pass == LADDER[fork]
    assert set(results) == set(LADDER)


def _fixture_files(which: str) -> list:
    if which == "matrix":
        d = os.path.join(FIXDIR, "matrix")
        return [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".json")]
    return [os.path.join(FIXDIR, which)]


@pytest.mark.parametrize("which", sorted(
    f for f in os.listdir(FIXDIR) if f.endswith(".json")) + ["matrix"])
def test_fixtures_equal_the_reference(which):
    n = 0
    for path in _fixture_files(which):
        cases = ef_state.load_fixture_file(path)
        jcases = jef.load_fixture_file(path)
        assert [(c.name, c.fork, c.indexes) for c in cases] == \
            [(c.name, c.fork, c.indexes) for c in jcases]
        for case, jcase in zip(cases, jcases):
            assert case.tx.encode_canonical() == jcase.tx.encode_canonical()
            got = ef_state.execute_case(case)
            assert got == jef.execute_case(jcase), (case.name, case.fork)
            assert ef_state.run_case(case).passed, \
                (case.name, case.fork, ef_state.run_case(case).detail)
            n += 1
    assert n >= 1


def test_baseline3_with_the_engines_on_equals_the_reference(monkeypatch):
    """With no switch set, BASELINE-3's execution goes through native
    Keccak, native sender recovery, the NativeMpt merkleizer and the
    native loop for every frame of 64 bytes or more; its output, write
    log and receipts equal the reference's."""
    for var in ("ETHREX_TPU_NATIVE_EVM", "ETHREX_TPU_NATIVE_MPT"):
        monkeypatch.delenv(var, raising=False)
    calls = {"keccak": 0, "recover": 0, "mpt": 0, "native_frames": [],
             "python_frames": []}
    keccak.available()
    real_keccak = keccak._fn

    def count_keccak(data):
        calls["keccak"] += 1
        return real_keccak(data)

    real_recover = nsecp.recover_pubkey_bytes

    def count_recover(*args):
        calls["recover"] += 1
        return real_recover(*args)

    real_apply = NativeMpt.apply

    def count_apply(self, *args):
        calls["mpt"] += 1
        return real_apply(self, *args)

    real_native, real_py = vm.EVM._run_native, vm.EVM._run_py

    def native_frame(self, f, handlers):
        calls["native_frames"].append(len(f.code))
        return real_native(self, f, handlers)

    def python_frame(self, f, handlers):
        calls["python_frames"].append(len(f.code))
        return real_py(self, f, handlers)

    monkeypatch.setattr(keccak, "_fn", count_keccak)
    monkeypatch.setattr(nsecp, "recover_pubkey_bytes", count_recover)
    monkeypatch.setattr(NativeMpt, "apply", count_apply)
    monkeypatch.setattr(vm.EVM, "_run_native", native_frame)
    monkeypatch.setattr(vm.EVM, "_run_py", python_frame)

    obj = fixtures.program_input_json("baseline3")
    pi = fixtures.load_program_input("baseline3")
    calls["keccak"] = calls["recover"] = 0
    log: list = []
    receipts: list = []
    out = execution_program(pi, write_log=log, receipts_out=receipts)
    jlog: list = []
    jreceipts: list = []
    jout = jexecute(JProgramInput.from_json(obj), write_log=jlog,
                    receipts_out=jreceipts)
    assert out.encode() == jout.encode()
    assert access_log.raw_log_to_json(log) == jal.raw_log_to_json(jlog)
    assert [[r.encode() for r in b] for b in receipts] == \
        [[r.encode() for r in b] for b in jreceipts]

    n_tx = sum(len(b.body.transactions) for b in pi.blocks)
    assert calls["recover"] >= n_tx == 1000
    assert calls["keccak"] > 1000
    assert calls["mpt"] >= len(pi.blocks)
    assert calls["native_frames"], "no frame ran in the native loop"
    assert min(calls["native_frames"]) >= vm._NATIVE_MIN_CODE
    assert all(n < vm._NATIVE_MIN_CODE for n in calls["python_frames"])
