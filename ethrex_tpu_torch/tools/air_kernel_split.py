"""Time kernel K6 (the generated AIR constraint kernels) for several caps
on the graph one kernel holds, on one CUDA card.

    python3 -m ethrex_tpu_torch.tools.air_kernel_split

For each AIR of the batch-proof path at its full LDE size (StateUpdateAir
115 x 2^22, FriVerifyAir 90 x 2^24) and each cap in `CAPS`, it generates
the source (`stark/air_codegen.py cuda_source`), builds every source with
one nvcc each, all started together (`-Xptxas -v`, printed), checks the
result against the prover's default cap, and prints the median time of 5
launches (CUDA events) and the nvcc wall per source.  Needs a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

CAPS = (300, 600, 1200, 2500, 10 ** 6)


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
    from ethrex_tpu_torch.ops import babybear as bb
    from ethrex_tpu_torch.stark import air_codegen as cg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    airs = {"StateUpdateAir": (sua.StateUpdateAir(10, seg_periods=16),
                               1 << 22),
            "FriVerifyAir": (fva.FriVerifyAir(21), 1 << 24)}
    texts = {(name, cap): cg.cuda_source(cg.record(air), cap)
             for name, (air, _) in airs.items() for cap in CAPS}
    kernels.build_generated([t for t, _ in texts.values()], verbose=True)
    rng = np.random.default_rng(7)
    rows = []
    for name, (air, N) in airs.items():
        lde = bb.from_numpy(rng.integers(0, bb.P, (air.width, N),
                                         dtype=np.uint64).astype(np.uint32),
                            dev)
        per = bb.from_numpy(rng.integers(
            0, bb.P, (air.num_periodic, N), dtype=np.uint64).astype(
            np.uint32), dev)
        want = cg.evaluate(air, lde, per, 8)
        for cap in CAPS:
            got = cg.evaluate(air, lde, per, 8, max_nodes=cap)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} cap {cap} differs")
            del got
            text, nk = texts[(name, cap)]
            ms = _ms(lambda: cg.evaluate(air, lde, per, 8, max_nodes=cap))
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
