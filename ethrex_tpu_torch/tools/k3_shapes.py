"""Time kernel K3 (`ops/babybear.py mod_matmul`) at every shape the
batch-proof path and the fused step give it, on one CUDA card.

    python3 -m ethrex_tpu_torch.tools.k3_shapes

Shapes, for the VM path's five large STARKs (state 115 x 2^19,
TransferAir 278 x 2^20, TokenAir 117 x 2^18, BytecodeAir 354 x 2^19,
the outer FriVerifyAir 90 x 2^22; blowup 8):

  * quotient: the alpha combination of the (K, N) constraint stack read
    in place as (N, K) @ (K, 4), the form the prover used before the
    combination moved into the generated constraint kernels;
  * deep: the LDE rows (N, w), read in place from the (w, N) columns, at
    two (w, 4) power columns, as two m = 4 calls and as one m = 8 call;
  * open: the trace coefficients (w, n) (the split-k kernel) at two
    (n, 4) power tables, as two calls and as one m = 8 call;
  * fused: the fused step's comb (N, 64) @ (64, 4) and its trace at zeta
    (64, n) @ (n, 4), at log_n 15 and 20 (blowup 4).

Each m = 8 result is held equal to its two m = 4 results.  It prints one
JSON line per shape (median of 5 CUDA-event timings after a warm-up; the
bytes each call must move) and a last line with all of them.  Needs a
card; the inputs are random field elements made on the card.

`chip_smoke.py` times K3 at the path's shapes as they are now; this tool
stays for what the smoke cannot do: it needs nothing of the package but
`ops.babybear.mod_matmul`, so it also runs on a tree from before K3's
m = 8 form and the fused quotient, and times the earlier design's
shapes (the quotient's stack, two m = 4 calls) against the current
kernel.  PERF.md's "before" times of K3 come from it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12


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


def _rand(gen, shape, dev):
    return torch.randint(0, 2013265921, shape, generator=gen,
                         dtype=torch.int32, device=dev)


def path_shapes():
    """(tag, width, log n, constraints) of the VM path's large STARKs."""
    from ..models import bytecode_air as bca
    from ..models import fri_verifier_air as fva
    from ..models import state_update_air as sua
    from ..models import token_air as tka
    from ..models import transfer_air as ta

    airs = (("state", sua.StateUpdateAir(10, seg_periods=16), 19),
            ("transfer", ta.TransferAir(), 20),
            ("token", tka.TokenAir(), 18),
            ("bytecode", bca.BytecodeAir(), 19),
            ("outer", fva.FriVerifyAir(22), 22))
    return [(tag, air.width, log_n, air.num_constraints)
            for tag, air, log_n in airs]


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    from .. import kernels
    from ..ops import babybear as bb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    rows = []

    def record(**row):
        row["bytes_bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        rows.append(row)
        print(json.dumps(row), flush=True)

    def pair(tag, phase, a, n, k, extra_bytes):
        b1, b2 = _rand(gen, (k, 4), dev), _rand(gen, (k, 4), dev)
        b8 = torch.cat([b1, b2], dim=1)
        two = torch.cat([bb.mod_matmul(a, b1), bb.mod_matmul(a, b2)], dim=1)
        if not torch.equal(bb.mod_matmul(a, b8), two):
            raise AssertionError(f"{tag} {phase}: m = 8 differs from two "
                                 f"m = 4 calls")
        del two
        ms2 = _ms(lambda: (bb.mod_matmul(a, b1), bb.mod_matmul(a, b2)))
        ms8 = _ms(lambda: bb.mod_matmul(a, b8))
        record(tag=tag, phase=phase, shape=f"({n}, {k}) @ ({k}, 8)",
               two_m4_ms=ms2, one_m8_ms=ms8, products=n * k * 8,
               bytes=4 * (n * k + n * 8) + extra_bytes)

    for tag, w, log_n, K in path_shapes():
        n, N = 1 << log_n, 1 << (log_n + 3)
        if tag in ("state", "transfer"):
            cons = _rand(gen, (K, N), dev)
            apow = _rand(gen, (K, 4), dev)
            ms = _ms(lambda: bb.mod_matmul(cons.T, apow))
            record(tag=tag, phase="quotient", shape=f"({N}, {K}) @ ({K}, 4)",
                   ms=ms, products=N * K * 4, bytes=4 * (K * N + 4 * K
                                                         + 4 * N))
            del cons
            torch.cuda.empty_cache()
        lde = _rand(gen, (w, N), dev)
        pair(tag, "deep", lde.T, N, w, 4 * 8 * w)
        del lde
        torch.cuda.empty_cache()
        coeffs = _rand(gen, (w, n), dev)
        pair(tag, "open", coeffs, w, n, 4 * 8 * n)
        del coeffs
        torch.cuda.empty_cache()
    for log_n in (15, 20):
        n, N = 1 << log_n, 1 << (log_n + 2)
        lde = _rand(gen, (64, N), dev)
        g = _rand(gen, (64, 4), dev)
        ms = _ms(lambda: bb.mod_matmul(lde.T, g))
        record(tag=f"fused{log_n}", phase="comb", shape=f"({N}, 64) @ (64, 4)",
               ms=ms, products=N * 64 * 4, bytes=4 * (64 * N + 4 * 64 + 4 * N))
        del lde
        coeffs = _rand(gen, (64, n), dev)
        pows = _rand(gen, (n, 4), dev)
        ms = _ms(lambda: bb.mod_matmul(coeffs, pows))
        record(tag=f"fused{log_n}", phase="trace at zeta",
               shape=f"(64, {n}) @ ({n}, 4)", ms=ms, products=64 * n * 4,
               bytes=4 * (64 * n + 4 * n + 4 * 64))
        del coeffs, pows
        torch.cuda.empty_cache()
    print(json.dumps({"k3_shapes": rows,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
