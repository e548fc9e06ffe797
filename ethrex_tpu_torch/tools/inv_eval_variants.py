"""Time the block shapes of two test-only kernels on one CUDA card:
`ext_batch_inv` (csrc/ext_inv.cu: THREADS x CHUNK elements a block, one
ext inverse each) at (2^20, 4) and `eval_poly_at` (csrc/poly_eval.cu:
THREADS threads taking ITERS quads each, a block's span of a row) at
64 x 2^16, the shapes `chip_smoke.py` times them at.

    python3 -m ethrex_tpu_torch.tools.inv_eval_variants [--parent TREE]

Each variant is the committed source with its `constexpr int` block sizes
replaced, built as a generated library (`kernels.build_generated`, its
ptxas report printed), held bit-equal to the plain version first (with
zero elements for the inverse), then timed by device time (torch.profiler,
mean over 5 calls after a warm-up step), warm (the inputs left in L2 by
the call before) and cold (L2 flushed before each call by reading a 256
MB buffer).  With `--parent TREE`, the two sources of an earlier tree
(`TREE/ethrex_tpu_torch/csrc/ext_inv.cu` and `poly_eval.cu`, the designs
before the current ones: a chunk of 16 elements a thread, and one block a
row over two power tables made on the host) are built, checked and timed
the same way, through their own C interfaces, as the variant `parent`.
The variants run in turns, in order and then in reverse, the parent
first and last, so a drift of the card shows as a difference between a
variant's two runs.  The card's name and power limit print first, one
JSON line a variant and run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from .timing import device_ms, l2_flusher

P = 2013265921
SEED = 20261019
# (THREADS, CHUNK) of ext_batch_inv; the first is the committed one
EXT_VARIANTS = ((128, 8), (128, 4), (128, 16), (256, 8), (256, 4))
# (THREADS, ITERS) of eval_poly_at; the first is the committed one
EVAL_VARIANTS = ((256, 4), (256, 8), (128, 8), (128, 16), (512, 4))
# the earlier ext_batch_inv's elements a thread
PARENT_CHUNK = 16

_VP, _VL, _VI, _VU = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_uint)


def _with(src: str, **consts) -> str:
    for name, value in consts.items():
        src, k = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        assert k == 1, name
    return src


def _time(fn, function: str, flush) -> dict:
    def cold():
        flush()
        fn()

    warm = device_ms(fn)["device_ms_by_function"].get(function)
    cold_ms = device_ms(cold)["device_ms_by_function"].get(function)
    return dict(device_ms=warm, cold_device_ms=cold_ms)


def _turns(variants: list) -> list:
    """Each variant in order, then in reverse."""
    return variants + variants[::-1]


def ext_variants(dev, gen, flush, parent: Path | None) -> list:
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.ops import ext

    n = 1 << 20
    a = torch.randint(0, P, (n, 4), generator=gen, dtype=torch.int32,
                      device=dev)
    az = a.clone()
    az[::997] = 0
    az[8192:12288] = 0
    want, want_z = ext.batch_inv_plain(a), ext.batch_inv_plain(az)
    base = (kernels.CSRC / "ext_inv.cu").read_text()
    # label -> (source, argtypes, the entry's arguments between n and fr)
    variants = {f"{t}x{c}": (_with(base, THREADS=t, CHUNK=c),
                             [_VP, _VP, _VL, _VP, _VP], ())
                for t, c in EXT_VARIANTS}
    if parent is not None:
        variants = {"parent": (
            (parent / "ethrex_tpu_torch/csrc/ext_inv.cu").read_text(),
            [_VP, _VP, _VL, _VI, _VP, _VP], (PARENT_CHUNK,)), **variants}
    kernels.build_generated([v[0] for v in variants.values()], verbose=True)
    runs = []
    for label in _turns(list(variants)):
        text, argtypes, extra = variants[label]
        fn_c = kernels.load_generated(text, ["ext_batch_inv"],
                                      argtypes).ext_batch_inv

        def call(x, out):
            stream = torch.cuda.current_stream(dev).cuda_stream
            kernels.check(fn_c(x.data_ptr(), out.data_ptr(), n, *extra,
                               ext._FR_ALL.ctypes.data, stream),
                          "ext_batch_inv")
            return out

        out = torch.empty_like(a)
        if not (torch.equal(call(a, out), want)
                and torch.equal(call(az, torch.empty_like(a)), want_z)):
            raise AssertionError(f"ext_batch_inv {label} differs from the "
                                 f"plain version")
        row = dict(kernel="ext_batch_inv", variant=label,
                   **_time(lambda: call(a, out), "k_ext_batch_inv", flush))
        print(json.dumps(row), flush=True)
        runs.append(row)
    return runs


def _parent_tables(pt: int, n: int, dev):
    """The earlier eval_poly_at's two power tables of the Montgomery point
    `pt` (x^i for i below 2^lg_blk, and x^(2^lg_blk j)), as its wrapper
    made them on the host."""
    from ethrex_tpu_torch.ops import babybear as bb
    from ethrex_tpu_torch.ops import ntt

    x = ntt._point_mont(pt)
    lg_blk = max(4, (max(n, 1).bit_length() + 1) // 2)
    nb = max(1, -(-n // (1 << lg_blk)))
    small = bb.from_numpy(bb.to_mont_host(bb.powers_host(x, 1 << lg_blk)),
                          dev)
    big = bb.from_numpy(bb.to_mont_host(bb.powers_host(
        pow(x, 1 << lg_blk, P), nb)), dev)
    return small, big, lg_blk


def eval_variants(dev, gen, flush, parent: Path | None) -> list:
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.ops import ntt

    rows, n = 64, 1 << 16
    c = torch.randint(0, P, (rows, n), generator=gen, dtype=torch.int32,
                      device=dev)
    pt = 987654321
    want = ntt.eval_poly_at_plain(c, pt)
    base = (kernels.CSRC / "poly_eval.cu").read_text()
    words = torch.zeros(rows, dtype=torch.int64, device=dev)

    def new_args(out):
        words.zero_()
        return (c.data_ptr(), n, n, rows, None, pt, 1, words.data_ptr(),
                out.data_ptr())

    variants = {f"{t}x{i}": (_with(base, THREADS=t, ITERS=i,
                                   LOG_STRIDE=(4 * t).bit_length() - 1),
                             [_VP, _VL, _VL, _VI, _VP, _VU, _VI, _VP, _VP,
                              _VP], new_args)
                for t, i in EVAL_VARIANTS}
    if parent is not None:
        small, big, lg_blk = _parent_tables(pt, n, dev)

        def parent_args(out):
            return (c.data_ptr(), n, n, rows, small.data_ptr(),
                    big.data_ptr(), lg_blk, out.data_ptr())

        variants = {"parent": (
            (parent / "ethrex_tpu_torch/csrc/poly_eval.cu").read_text(),
            [_VP, _VL, _VL, _VI, _VP, _VP, _VI, _VP, _VP], parent_args),
            **variants}
    kernels.build_generated([v[0] for v in variants.values()], verbose=True)
    runs = []
    for label in _turns(list(variants)):
        text, argtypes, args = variants[label]
        fn_c = kernels.load_generated(text, ["eval_poly_at"],
                                      argtypes).eval_poly_at
        out = torch.empty(rows, dtype=torch.int32, device=dev)

        def call():
            stream = torch.cuda.current_stream(dev).cuda_stream
            kernels.check(fn_c(*args(out), stream), "eval_poly_at")
            return out

        if not torch.equal(call(), want):
            raise AssertionError(f"eval_poly_at {label} differs from the "
                                 f"plain version")
        row = dict(kernel="eval_poly_at", variant=label,
                   **_time(call, "k_eval_poly_at", flush))
        print(json.dumps(row), flush=True)
        runs.append(row)
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an earlier tree whose two sources are "
                         "timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("inv_eval_variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = l2_flusher(dev)
    ext_variants(dev, gen, flush, args.parent)
    eval_variants(dev, gen, flush, args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
