"""Time the prover's `tables` phase, kernel K7 (batch inversion) and
kernel K8 (the DEEP codeword) at the main path's shapes, on one CUDA card.

    python3 -m ethrex_tpu_torch.tools.tables_k7_k8

1. `stark.prover._tables` for each large STARK of the VM path (state
   2^19 x 115, TransferAir 2^20 x 278, TokenAir 2^18 x 117, BytecodeAir
   2^19 x 354, the outer FriVerifyAir 2^22 x 90; blowup 8), its cache
   emptied first, once to warm up and once under torch.profiler: the
   wall and the device time by function, grouped as K7 (`k_batch_inv`,
   `k_divisor_inv`), `to_mont_cols`, K1 (the periodic columns' LDE),
   PyTorch's own kernels (the glue that builds the divisor stack), copies
   and fills.
2. K7 on the outer proof's divisor stack (8 + 11 x 2^25 nonzero random
   elements), its first 2^22 results held equal to the plain version's.
3. K8 at the state and the outer proof's shapes (two openings, 8
   quotient chunks), held equal to its plain version at the state shape.

Times: median of 5 CUDA-event timings around the call after a warm-up
(`ms`, the wrapper's host work included: K8's constants come to the
host), and the mean device time of the kernel's functions over 5 calls
from torch.profiler (`device_ms`).  Prints one JSON
line per measurement and the card's name and power limit first.  It
uses only `_tables`, `_TABLE_CACHE`, `batch_mont_inv` and `deep_compose`,
so it runs on a tree from before K7's and K8's current designs as well:
PERF.md's before-and-after numbers of the two kernels and of `tables`
come from runs of it on both trees in one call.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12
P = 2013265921


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


def _device_ms(fn, name: str, reps=5) -> float:
    """Mean device ms of the launches of device functions whose name
    holds `name` in `reps` calls of `fn` (torch.profiler, after a
    warm-up call; the mean over the events recorded, since the card can
    drop the first launches of a profiler session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(us) / len(us) / 1e3


def _rand(gen, shape, dev):
    return torch.randint(0, P, shape, generator=gen, dtype=torch.int32,
                         device=dev)


def _group(name: str) -> str:
    if "batch_inv" in name or "divisor_inv" in name:
        return "K7"
    if "to_mont_cols" in name:
        return "to_mont_cols"
    if "ntt_pass" in name:
        return "K1"
    if name.startswith("Memcpy"):
        return "copies"
    if name.startswith("Memset"):
        return "fills"
    return "torch"


def path_airs():
    """(tag, AIR, log n) of the VM path's large STARKs."""
    from ..models import bytecode_air as bca
    from ..models import fri_verifier_air as fva
    from ..models import state_update_air as sua
    from ..models import token_air as tka
    from ..models import transfer_air as ta

    return (("state", sua.StateUpdateAir(10, seg_periods=16), 19),
            ("transfer", ta.TransferAir(), 20),
            ("token", tka.TokenAir(), 18),
            ("bytecode", bca.BytecodeAir(), 19),
            ("outer", fva.FriVerifyAir(22), 22))


def profile_tables(dev) -> list:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops import babybear as bb
    from ..stark import prover

    rows = []
    for tag, air, log_n in path_airs():
        prover._TABLE_CACHE.clear()
        prover._tables(air, log_n, 3, bb.GENERATOR, dev)
        torch.cuda.synchronize()
        prover._TABLE_CACHE.clear()
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prover._tables(air, log_n, 3, bb.GENERATOR, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_fn: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_fn[e.name] = by_fn.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        by_group: dict = {}
        for name, ms in by_fn.items():
            g = _group(name)
            by_group[g] = round(by_group.get(g, 0.0) + ms, 3)
        prover._TABLE_CACHE.clear()
        torch.cuda.empty_cache()
        row = dict(what="tables", tag=tag, log_n=log_n,
                   boundaries=len(air.boundaries([0] * air.num_pub_inputs,
                                                 1 << log_n)),
                   wall_s=wall, device_ms=round(sum(by_fn.values()), 3),
                   by_group=by_group,
                   top=sorted(((k[:80], round(v, 3)) for k, v in
                               by_fn.items()), key=lambda kv: -kv[1])[:8])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def time_k7(dev, gen) -> dict:
    from ..ops import babybear as bb

    n = 8 + 11 * (1 << 25)
    a = _rand(gen, (n,), dev)
    a[a == 0] = bb.MONT_ONE
    head = a[:1 << 22]
    if not torch.equal(bb.batch_mont_inv(a)[:1 << 22],
                       bb.batch_mont_inv_plain(head)):
        raise AssertionError("K7 differs from its plain version")
    ms = _ms(lambda: bb.batch_mont_inv(a))
    row = dict(what="batch_inv", n=n, ms=ms,
               device_ms=_device_ms(lambda: bb.batch_mont_inv(a),
                                    "k_batch_inv"),
               bytes_bound_ms=8 * n / HBM_BYTES_PER_S * 1e3)
    print(json.dumps(row), flush=True)
    del a
    torch.cuda.empty_cache()
    return row


def time_k8(dev, gen) -> list:
    from ..ops import ext

    rows = []
    for tag, w, n in (("state", 115, 1 << 19), ("outer", 90, 1 << 22)):
        B, N = 8, n << 3
        pts = _rand(gen, (N,), dev)
        pt = [tuple(_rand(gen, (4,), dev).tolist()) for _ in (0, 1)]
        s12 = _rand(gen, (N, 8), dev)
        opens = [(pt[o], s12[:, 4 * o:4 * o + 4], _rand(gen, (w, 4), dev),
                  _rand(gen, (w, 4), dev)) for o in (0, 1)]
        q = dict(q_lde=_rand(gen, (B, 4, N), dev),
                 q_z=_rand(gen, (B, 4), dev), gq=_rand(gen, (B, 4), dev))
        if tag == "state" and not torch.equal(
                ext.deep_compose(pts, opens, **q),
                ext.deep_compose_plain(pts, opens, **q)):
            raise AssertionError("K8 differs from its plain version")
        ms = _ms(lambda: ext.deep_compose(pts, opens, **q))
        row = dict(what="deep_compose", tag=tag, N=N, ms=ms,
                   device_ms=_device_ms(
                       lambda: ext.deep_compose(pts, opens, **q), "k_deep"),
                   bytes_bound_ms=4 * N * (1 + 8 + 4 * B + 4)
                   / HBM_BYTES_PER_S * 1e3)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del pts, s12, opens, q
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("tables_k7_k8: needs a CUDA card", file=sys.stderr)
        return 2
    from .. import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    out = dict(tables=profile_tables(dev), batch_inv=time_k7(dev, gen),
               deep_compose=time_k8(dev, gen))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
