"""The EF fork ladder with the port's native EVM loop forced, and the
port's execution with its engines on against its own run with every
engine off.

The ladder's roots and logs digests are the fixtures' own, so running it
with ETHREX_TPU_NATIVE_EVM=1 holds every opcode the native loop handles,
and its gas, to them over all 14 forks.  It runs in a child process, as
the reference's tests/test_native_evm.py runs its own: the library's
state is global to a process.  The mixed batch (one block of two ETH
transfers and two token calls) executes with the engines on and with
every engine off (both switches at 0, Keccak and recovery through their
Python oracles): output, write log and receipts are equal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from ethrex_tpu_torch import fixtures
from ethrex_tpu_torch.crypto import keccak
from ethrex_tpu_torch.crypto import native_secp256k1 as nsecp
from ethrex_tpu_torch.crypto import secp256k1 as secp
from ethrex_tpu_torch.evm import vm
from ethrex_tpu_torch.guest import access_log
from ethrex_tpu_torch.guest.execution import execution_program
from ethrex_tpu_torch.trie.native_mpt import NativeMpt
from tests.test_torch_ef_state import FIXDIR, LADDER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def forced_ladder():
    code = textwrap.dedent(f"""
        import json, os
        from ethrex_tpu_torch.evm import vm
        from ethrex_tpu_torch.utils import ef_state
        frames = []
        real = vm.EVM._run_native
        vm.EVM._run_native = lambda self, f, h: frames.append(1) or \\
            real(self, f, h)
        out = {{}}
        passed, failed = ef_state.run_directory(
            os.path.join({FIXDIR!r}, "forks"))
        for ok, results in ((True, passed), (False, failed)):
            for r in results:
                row = out.setdefault(r.case.fork, [0, 0, []])
                row[0 if ok else 1] += 1
                if not ok and len(row[2]) < 3:
                    row[2].append(f"{{r.case.name}}{{r.case.indexes}}: "
                                  f"{{r.detail}}")
        passed, failed = ef_state.run_directory({FIXDIR!r})
        out["all"] = [len(passed), len(failed),
                      [r.detail for r in failed[:3]]]
        out["native_frames"] = len(frames)
        print(json.dumps(out))
    """)
    env = dict(os.environ, ETHREX_TPU_NATIVE_EVM="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-1500:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fork", list(LADDER))
def test_ladder_with_the_native_loop_forced(forced_ladder, fork):
    n_pass, n_fail, details = forced_ladder[fork]
    assert n_fail == 0, details
    assert n_pass == LADDER[fork]


def test_every_fixture_with_the_native_loop_forced(forced_ladder):
    n_pass, n_fail, details = forced_ladder["all"]
    assert n_fail == 0, details
    assert n_pass > sum(LADDER.values())
    # forced: every frame of both runs went through the native loop
    assert forced_ladder["native_frames"] >= n_pass + sum(LADDER.values())


def _execute(pi):
    log: list = []
    receipts: list = []
    out = execution_program(pi, write_log=log, receipts_out=receipts)
    return (out.encode(), access_log.raw_log_to_json(log),
            [[r.encode() for r in b] for b in receipts])


def test_mixed_engines_on_equals_every_engine_off(monkeypatch):
    for var in ("ETHREX_TPU_NATIVE_EVM", "ETHREX_TPU_NATIVE_MPT"):
        monkeypatch.delenv(var, raising=False)
    pi = fixtures.load_program_input("mixed")
    on = _execute(pi)

    def python_recover(msg, r, s, rec):
        point = secp.recover(msg, r, s, rec)
        return None if point is None else \
            point[0].to_bytes(32, "big") + point[1].to_bytes(32, "big")

    def refuse(*args):
        raise AssertionError("an engine ran with every engine off")

    monkeypatch.setenv("ETHREX_TPU_NATIVE_EVM", "0")
    monkeypatch.setenv("ETHREX_TPU_NATIVE_MPT", "0")
    monkeypatch.setattr(keccak, "_fn", keccak._keccak256_py)
    monkeypatch.setattr(nsecp, "recover_pubkey_bytes", python_recover)
    monkeypatch.setattr(NativeMpt, "apply", refuse)
    monkeypatch.setattr(vm.EVM, "_run_native", refuse)
    off = _execute(fixtures.load_program_input("mixed"))
    assert on == off
