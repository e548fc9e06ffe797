"""Registers, spills and SASS opcode mix of kernel K2 (csrc/poseidon2.cu),
with its leaf-hash and tree times on the state proof's shapes.

    python3 -m ethrex_tpu_torch.tools.p2_sass   # needs one CUDA card

poseidon2.cu is compiled with the package's flags plus `-Xptxas -v` into
`build/ethrex_tpu_torch/p2_sass/` and disassembled with cuobjdump.  The
times are the package's own wrappers: the leaf hash of 2^22 rows of 115
columns (read column-major, in place) and the Merkle tree above those
2^22 digests (`merkle.levels_above`), CUDA events, median of 5 after a
warm-up.  Prints one JSON line.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from .. import kernels
from ..ops import babybear as bb
from ..ops import merkle
from ..ops import poseidon2 as p2

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def sass_opcodes(path: Path) -> dict[str, Counter]:
    """Opcode histogram (base mnemonic) per kernel of a built object."""
    cuobjdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    per: dict[str, Counter] = {}
    name = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            per[name] = Counter()
            continue
        m = _OP.search(line)
        if name and m:
            per[name][m.group(1)] += 1
    return per


def _median_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("p2_sass: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out_dir = kernels.BUILD_DIR / "p2_sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libposeidon2.so"
    built = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(kernels.CSRC), "-shared", str(kernels.CSRC / "poseidon2.cu"),
         "-o", str(so)], capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    ptxas = [ln.strip() for ln in (built.stdout + built.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    w, N = 115, 1 << 22
    lde = torch.randint(0, bb.P, (w, N), generator=gen, dtype=torch.int32,
                        device=dev)
    buf = torch.empty((2 * N - 1, 8), dtype=torch.int32, device=dev)
    buf[:N] = p2.hash_leaves(lde.T)
    report = dict(
        ptxas=ptxas,
        hash_leaves_ms=_median_ms(lambda: p2.hash_leaves(lde.T,
                                                         out=buf[:N])),
        tree_ms=_median_ms(lambda: merkle.levels_above(buf, N)),
        tree_launches=len(merkle.subtree_plan(N)),
        sass={fn: dict(sum=sum(c.values()), **dict(c.most_common(12)))
              for fn, c in sass_opcodes(so).items()
              if "hash_leaves" in fn or "subtree" in fn})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "shape": f"leaves ({N}, {w}), tree "
                      f"over {N}", **report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
