"""Time kernel K11 (the open phase's power tables and the quotient chunks
at zeta) and kernel K10 (the roots of a forest of Merkle trees) at the
main path's shapes, on one CUDA card.

    python3 -m ethrex_tpu_torch.tools.k10_k11

Measurements, each held bit-equal to the plain versions first:
1. `stark.prover.phase_open` (the trace's iNTT, both points' power
   tables, the trace at both points (K3) and the chunks at zeta) at the
   outer proof's shape (w = 90, n = 2^22, B = 8) and the state proof's
   (w = 115, n = 2^19, B = 8);
2. the K11 work of that phase alone: `ext.open_powers` where the tree has
   it, else the separate calls it replaced (two `powers_table` calls into
   the column blocks of one (n, 8) table, and `eval_ext_poly_at_ext`);
3. the fused step's power table, `ext.powers_table` at n = 2^20;
4. `merkle.batched_roots` on the fused step's FRI forests at log_n 20 (17
   trees, 4,194,272 leaves) and 15 (12 trees), with its launches a call.

Per measurement: `call_ms`, the median of 5 CUDA-event timings around the
call after a warm-up (the wrapper's host work included), and from
torch.profiler the device time a call of every device function it
launched (`device_ms_by_function`; copies and fills by the profiler's
name) and their sum (`device_ms`), over 5 calls after a warm-up step.
The card's name and power limit print first, one JSON line a
measurement.  The tool uses only public functions of `ops/ext.py`,
`ops/merkle.py` and `stark/prover.py`, so it runs on a tree from before
the current K10 and K11 (copy it and `timing.py` into
`<tree>/ethrex_tpu_torch/tools/` and run it from `<tree>`): PERF.md's
before-and-after numbers come from runs on both trees in one call.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from .timing import call_ms as _ms
from .timing import device_ms as _device

P = 2013265921
SEED = 20261018


def _rand(gen, shape, dev):
    return torch.randint(0, P, shape, generator=gen, dtype=torch.int32,
                         device=dev)


def _point(gen):
    return tuple(int(v) for v in torch.randint(0, P, (4,), generator=gen))


def k11_open(points, n, chunks):
    """The open phase's K11 work as this tree does it."""
    from ..ops import babybear as bb
    from ..ops import ext

    if hasattr(ext, "open_powers"):
        return ext.open_powers(points, n, chunks)
    pows = torch.empty((n, 8), dtype=bb.I32, device=chunks.device)
    ext.powers_table(points[0], n, out=pows[:, :4])
    ext.powers_table(points[1], n, out=pows[:, 4:])
    return pows, ext.eval_ext_poly_at_ext(chunks, points[0])


def open_phase(dev, gen) -> list:
    from ..ops import ext
    from ..stark import prover

    cpu_gen = torch.Generator().manual_seed(SEED)
    rows = []
    for tag, w, log_n in (("outer", 90, 22), ("state", 115, 19)):
        n, B = 1 << log_n, 8
        cols = _rand(gen, (w, n), dev)
        chunks = _rand(gen, (B, 4, n), dev).permute(0, 2, 1)
        z, zg = _point(cpu_gen), _point(cpu_gen)
        pows, q = k11_open((z, zg), n, chunks)
        plain = ext.eval_ext_poly_at_ext_plain(chunks, z)
        if not (torch.equal(q, plain)
                and torch.equal(pows[:, :4],
                                ext.ext_powers_blocked(z, n, device=dev))
                and torch.equal(pows[:, 4:],
                                ext.ext_powers_blocked(zg, n, device=dev))):
            raise AssertionError(f"K11 at the {tag} shape differs from its "
                                 f"plain versions")
        del pows, q, plain
        for what, fn in (
                ("phase_open", lambda: prover.phase_open(cols, chunks, z, zg)),
                ("k11_open", lambda: k11_open((z, zg), n, chunks))):
            row = dict(what=what, tag=tag, w=w, n=n, B=B,
                       call_ms=_ms(fn), **_device(fn))
            rows.append(row)
            print(json.dumps(row), flush=True)
        del cols, chunks
        torch.cuda.empty_cache()
    return rows


def fused_table(dev, gen) -> dict:
    from ..ops import ext

    n = 1 << 20
    z = _point(torch.Generator().manual_seed(SEED + 1))
    if not torch.equal(ext.powers_table(z, n, dev),
                       ext.ext_powers_blocked(z, n, device=dev)):
        raise AssertionError("the fused step's power table differs from "
                             "its plain version")

    def fn():
        return ext.powers_table(z, n, dev)

    row = dict(what="powers_table", tag="fused step, log_n 20", n=n,
               call_ms=_ms(fn), **_device(fn))
    print(json.dumps(row), flush=True)
    return row


def forests(dev, gen) -> list:
    from .. import kernels
    from ..ops import merkle

    rows = []
    for log_n in (20, 15):
        log_N = log_n + 2
        sizes = tuple(1 << (log_N - 1 - k) for k in range(log_N - 5))
        d = _rand(gen, (sum(sizes), 8), dev)
        kernels.reset_launches()
        got = torch.stack(merkle.batched_roots(d, sizes))
        launches = kernels.LAUNCHES["merkle_batched_level"]
        if not torch.equal(got, torch.stack(
                merkle.batched_roots_plain(d, sizes))):
            raise AssertionError(f"K10 at log_n {log_n} differs from its "
                                 f"plain version")

        def fn():
            return merkle.batched_roots(d, sizes)

        row = dict(what="batched_roots", tag=f"fused step, log_n {log_n}",
                   trees=len(sizes), leaves=sum(sizes),
                   launches_per_call=launches, call_ms=_ms(fn),
                   **_device(fn))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del d
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("k10_k11: torch.cuda.is_available() is False; needs a CUDA "
              "card", file=sys.stderr)
        return 2
    from .. import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = dict(open=open_phase(dev, gen), table=fused_table(dev, gen),
               forests=forests(dev, gen))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
