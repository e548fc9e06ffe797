"""Time kernel K6 (the generated AIR constraint kernels, in the combine
mode the prover runs) for several caps on the graph one kernel holds, on
one CUDA card.

    python3 -m ethrex_tpu_torch.tools.air_kernel_split

For each of three AIRs of the batch-proof path at its full LDE size
(StateUpdateAir 115 x 2^22, TransferAir 278 x 2^23, FriVerifyAir 90 x
2^25) and each cap in `CAPS`, it generates the combine-mode source
(`stark/air_codegen.py cuda_source`), builds every source with one nvcc
each, all started together (`-Xptxas -v`, printed), checks the result
against the prover's default cap, and prints the median time of 5
launches (CUDA events) and the nvcc wall per source.  Needs a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

CAPS = (600, 900, 1200, 1800, 2500)


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("air_kernel_split needs a CUDA card")
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.models import fri_verifier_air as fva
    from ethrex_tpu_torch.models import state_update_air as sua
    from ethrex_tpu_torch.models import transfer_air as ta
    from ethrex_tpu_torch.ops import babybear as bb
    from ethrex_tpu_torch.stark import air_codegen as cg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    airs = {"StateUpdateAir": (sua.StateUpdateAir(10, seg_periods=16),
                               1 << 22),
            "TransferAir": (ta.TransferAir(), 1 << 23),
            "FriVerifyAir": (fva.FriVerifyAir(22), 1 << 25)}
    texts = {(name, cap): cg.cuda_source(cg.record(air), cap, "combine")
             for name, (air, _) in airs.items() for cap in CAPS}
    kernels.build_generated([t for t, _ in texts.values()], verbose=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def field(shape):
        # random residues made on the card (the LDEs are gigabytes)
        return torch.randint(0, bb.P, shape, generator=gen,
                             dtype=torch.int32, device=dev)

    rows = []
    for name, (air, N) in airs.items():
        lde = field((air.width, N))
        per = field((air.num_periodic, N))
        apow = field((air.num_constraints, 4))
        want = cg.combine(air, lde, per, 8, apow)
        for cap in CAPS:
            got = cg.combine(air, lde, per, 8, apow, max_nodes=cap)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} cap {cap} differs")
            del got
            text, nk = texts[(name, cap)]
            ms = _ms(lambda: cg.combine(air, lde, per, 8, apow,
                                        max_nodes=cap))
            rows.append(dict(air=name, cap=cap, kernels=nk, ms=ms,
                             nvcc_s=round(kernels.GENERATED_BUILD_S.get(
                                 kernels._generated_key(text), 0.0), 1)))
            print(json.dumps(rows[-1]), flush=True)
        del lde, per, want
        torch.cuda.empty_cache()
    print(json.dumps({"air_kernel_split": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
