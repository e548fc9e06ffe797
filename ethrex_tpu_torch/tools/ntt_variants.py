"""Time plan variants of kernel K1 (csrc/ntt.cu) on the card: the pass
plan's tile budget and stage cap (`ops/ntt.py` NTT_TILE_ELEMS, NTT_MAX_L)
at every coset-LDE shape of the main path.

    python3 -m ethrex_tpu_torch.tools.ntt_variants   # needs one CUDA card

Each variant patches the plan constants and runs the package's own
kernel; every output is held bit-equal to the default plan's.  Times are
CUDA events, median of 5 after a warm-up, of the iNTT and the forward
transform as the prover runs them.  Prints one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import babybear as bb
from ..ops import ntt
from .p2_sass import _median_ms

PLANS = {"tile 2^14, L <= 11": (1 << 14, 11),
         "tile 2^13, L <= 11": (1 << 13, 11),
         "tile 2^15, L <= 11": (1 << 15, 11),
         "tile 2^14, L <= 10": (1 << 14, 10)}
SHAPES = (("state", 115, 19), ("transfer", 278, 20), ("outer", 90, 22))


def main() -> int:
    if not torch.cuda.is_available():
        print("ntt_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    saved = (ntt.NTT_TILE_ELEMS, ntt.NTT_MAX_L)
    report = {}
    try:
        for tag, w, log_n in SHAPES:
            n, N = 1 << log_n, 8 << log_n
            x = torch.randint(0, bb.P, (w, n), generator=gen,
                              dtype=torch.int32, device=dev)
            pre = ntt.lde_prescale(log_n, bb.GENERATOR, dev)

            def lde():
                return ntt.scaled_ntt(ntt.scaled_ntt(x, inverse=True),
                                      n_out=N, pre=pre)

            want = lde()
            for pname, (tile, max_l) in PLANS.items():
                ntt.NTT_TILE_ELEMS, ntt.NTT_MAX_L = tile, max_l
                got = lde()
                eq = bool(torch.equal(got, want))
                del got
                report.setdefault(tag, {})[pname] = dict(
                    bit_equal=eq, ms=_median_ms(lde),
                    plan=ntt.ntt_plan(log_n) + ntt.ntt_plan(log_n + 3))
                ntt.NTT_TILE_ELEMS, ntt.NTT_MAX_L = saved
            del x, want
            torch.cuda.empty_cache()
    finally:
        ntt.NTT_TILE_ELEMS, ntt.NTT_MAX_L = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "lde": report}), flush=True)
    ok = all(v["bit_equal"] for t in report.values() for v in t.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
