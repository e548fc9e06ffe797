"""Time the host steps that the native host engines serve, on the
committed BASELINE-3 ProgramInput (1,000 transactions over 4 blocks).

    python3 -m ethrex_tpu_torch.tools.host_walls [--runs N] [--off]

Per run, host wall seconds of:
1. `guest.execution.execution_program` (stateless execution: sender
   recovery, the EVM, the merkleize step), the `execute` step of
   `GpuBackend.prove` and of `verify_with_input`;
2. `guest.transfer_log.build_vm_batch` on its write log and receipts;
3. `guest.access_log.replay_log_against_witness` of the VM batch's write
   log against the witness (the replay of `verify_with_input`).

Each run loads the input afresh (its own wall, `load_s`) and its output
is held equal to the first's.  One JSON line with the
medians, every run, the host's CPU model and, where `nvidia-smi` exists,
the card's name and power limit.  `--off` runs with every engine off:
both switches at 0, Keccak and sender recovery through their Python
oracles (this tree only).  The tool uses only functions the port had
before its host engines, so copied into an earlier tree (into
`<tree>/ethrex_tpu_torch/tools/`, run from `<tree>`) it times that
tree's pure-Python paths; host code only, no card needed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time


def _engines_off() -> None:
    from ..crypto import keccak, native_secp256k1, secp256k1

    def recover(msg, r, s, rec):
        point = secp256k1.recover(msg, r, s, rec)
        return None if point is None else \
            point[0].to_bytes(32, "big") + point[1].to_bytes(32, "big")

    os.environ["ETHREX_TPU_NATIVE_EVM"] = "0"
    os.environ["ETHREX_TPU_NATIVE_MPT"] = "0"
    keccak._fn = keccak._keccak256_py
    native_secp256k1.recover_pubkey_bytes = recover


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def _card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def one_run(pi) -> tuple[dict, tuple]:
    from ..guest import access_log
    from ..guest import transfer_log as tl
    from ..guest.execution import execution_program
    from ..guest.witness_oracles import WitnessOracles

    walls = {}
    t0 = time.perf_counter()
    log: list = []
    receipts: list = []
    out = execution_program(pi, write_log=log, receipts_out=receipts)
    walls["execute_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vb = tl.build_vm_batch(pi.blocks, log, receipts,
                           oracles=WitnessOracles(pi.witness,
                                                  out.initial_state_root))
    walls["build_vm_batch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    access_log.replay_log_against_witness(
        vb.blocks_log, pi.witness.nodes, out.initial_state_root,
        out.final_state_root)
    walls["replay_s"] = time.perf_counter() - t0
    result = (out.encode(), access_log.raw_log_to_json(log),
              [[r.encode() for r in b] for b in receipts])
    return walls, result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--off", action="store_true")
    args = ap.parse_args()
    if args.off:
        _engines_off()
    from .. import fixtures

    runs = []
    first = None
    for _ in range(args.runs):
        # a fresh input each run: a transaction caches its sender
        t0 = time.perf_counter()
        pi = fixtures.load_program_input("baseline3")
        load_s = time.perf_counter() - t0
        walls, result = one_run(pi)
        walls["load_s"] = load_s
        if first is None:
            first = result
        elif result != first:
            raise AssertionError("a run's output differs from the first's")
        runs.append(walls)
    medians = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(json.dumps({"tree": os.getcwd(), "engines": "off" if args.off
                      else "default", "cpu": _cpu_model(), "card": _card(),
                      "median": medians, "runs": runs}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
