"""How many 32-bit multiply issue slots one BabyBear Montgomery product
costs on this card.

    python3 -m ethrex_tpu_torch.tools.int_mul_rate   # needs one CUDA card

`chip_smoke.py` bounds the integer-bound kernels by their Montgomery
products times a cost per product over the card's 32-bit multiply rate.
This script measures that cost instead of assuming it:

  1. SASS count.  Two straight-line kernels differ only in a chain of 16
     `bb::mul` calls (csrc/babybear.cuh); `cuobjdump -sass` of each gives
     the multiply opcodes (IMAD*, IMUL*) the 16 products add, so the
     difference over 16 is the multiply instructions per product.
  2. Issue rate.  One kernel per opcode (IMAD, IMAD.WIDE.U32,
     IMAD.HI.U32) and one of whole Montgomery products runs 8
     independent chains per thread over every SM; CUDA events give each
     its rate in instructions per SM per clock (clock: nvidia-smi's
     clocks.max.sm).  An opcode that runs at half the IMAD rate takes two
     issue slots.

It prints one JSON line: the SASS histogram, each rate, and
`slots_per_mont`, the sum over the product's multiply opcodes of the
IMAD rate over that opcode's rate.  The same two measures are taken of a
raw product summed lazily (`bb::mad`, with a `bb::fold` after every
fourth term, as kernels K3 and K6 sum the alpha combination):
`slots_per_raw` from its opcodes, `slots_per_raw_by_rate` from its rate
(`rate_raw`).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from .. import kernels

CHAIN = 16      # products in the straight-line SASS probe
LANES = 8       # independent chains per thread in the rate kernels
ITERS = 4096

SOURCE = r"""
#include <cstring>

#include "babybear.cuh"

template <int K>
__device__ __forceinline__ uint32_t chain(uint32_t x, uint32_t y) {
#pragma unroll
  for (int i = 0; i < K; ++i) x = bb::mul(x, y);
  return x;
}

extern "C" __global__ void probe_0(uint32_t* io, uint32_t y) {
  io[threadIdx.x] = chain<0>(io[threadIdx.x], y);
}
extern "C" __global__ void probe_16(uint32_t* io, uint32_t y) {
  io[threadIdx.x] = chain<16>(io[threadIdx.x], y);
}

// raw products summed lazily, as K3 and K6's alpha combination do: a
// multiply-add a term and a fold after every fourth
template <int K>
__device__ __forceinline__ unsigned long long raw_chain(const uint32_t* x,
                                                        uint32_t y) {
  unsigned long long acc = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    acc = bb::mad(x[i * 32], y, acc);
    if (i % 4 == 3) acc = bb::fold(acc);
  }
  return acc;
}

extern "C" __global__ void probe_raw_0(unsigned long long* out,
                                       const uint32_t* x, uint32_t y) {
  out[threadIdx.x] = raw_chain<0>(x + threadIdx.x, y);
}
extern "C" __global__ void probe_raw_16(unsigned long long* out,
                                        const uint32_t* x, uint32_t y) {
  out[threadIdx.x] = raw_chain<16>(x + threadIdx.x, y);
}

// 8 independent lazy sums a thread; each term's multiplicand is the
// sum's low word (a chain the compiler cannot hoist), 4 terms a fold
extern "C" __global__ void rate_raw(uint32_t* out, uint32_t y, int iters) {
  unsigned long long x[8];
  uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = t * 8u + c;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int c = 0; c < 8; ++c) x[c] = bb::mad((uint32_t)x[c], y, x[c]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] = bb::fold(x[c]);
  }
  uint32_t s = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) s ^= (uint32_t)x[c] ^ (uint32_t)(x[c] >> 32);
  out[t] = s;
}

#define RATE_KERNEL(NAME, STEP)                                          \
  extern "C" __global__ void NAME(uint32_t* out, uint32_t y, int iters) { \
    uint32_t x[8];                                                        \
    uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;                   \
    _Pragma("unroll") for (int c = 0; c < 8; ++c) x[c] = (t * 8u + c) % bb::P; \
    for (int i = 0; i < iters; ++i) {                                     \
      _Pragma("unroll") for (int c = 0; c < 8; ++c) { STEP; }             \
    }                                                                     \
    uint32_t s = 0;                                                       \
    _Pragma("unroll") for (int c = 0; c < 8; ++c) s ^= x[c];              \
    out[t] = s;                                                           \
  }

RATE_KERNEL(rate_imad, x[c] = x[c] * y + (uint32_t)c)
RATE_KERNEL(rate_wide, { unsigned long long w = (unsigned long long)x[c] * y;
                         x[c] = (uint32_t)w ^ (uint32_t)(w >> 32); })
RATE_KERNEL(rate_hi, x[c] = __umulhi(x[c], y) ^ (uint32_t)c)
RATE_KERNEL(rate_mont, x[c] = bb::mul(x[c], y))

extern "C" int launch(const char* name, void* out, unsigned y, int iters,
                      int blocks, int threads) {
  void* fn = nullptr;
  if (!strcmp(name, "rate_imad")) fn = (void*)rate_imad;
  if (!strcmp(name, "rate_wide")) fn = (void*)rate_wide;
  if (!strcmp(name, "rate_hi")) fn = (void*)rate_hi;
  if (!strcmp(name, "rate_mont")) fn = (void*)rate_mont;
  if (!strcmp(name, "rate_raw")) fn = (void*)rate_raw;
  if (!fn) return -1;
  void* args[] = {&out, &y, &iters};
  cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, 0, 0);
  return (int)cudaGetLastError();
}
"""

_MUL = re.compile(r"\b(IMAD(?:\.[A-Z0-9]+)*|IMUL(?:\.[A-Z0-9]+)*)\b")
# IMAD forms the compiler uses as a move, an add or a shift
_NOT_MUL = (".MOV", ".IADD", ".SHL")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def _sass_multiplies(sass: str) -> dict[str, Counter]:
    """Multiply opcodes per kernel in `cuobjdump -sass` output."""
    per: dict[str, Counter] = {}
    name = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            per[name] = Counter()
        elif name and "/*" in line:
            for op in _MUL.findall(line.split(";")[0]):
                per[name][op] += 1
    return per


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("int_mul_rate: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = kernels.BUILD_DIR / "int_mul_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "int_mul_rate.cu"
    src.write_text(SOURCE)
    so = out_dir / "libint_mul_rate.so"
    nvcc = kernels._nvcc()
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-I",
                    str(kernels.CSRC), str(src), "-o", str(so)], check=True)
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    per = _sass_multiplies(sass)
    added = per["probe_16"] - per["probe_0"]
    per_mont = {op: n / CHAIN for op, n in sorted(added.items())
                if not any(t in op for t in _NOT_MUL)}
    added_raw = per["probe_raw_16"] - per["probe_raw_0"]
    per_raw = {op: n / CHAIN for op, n in sorted(added_raw.items())
               if not any(t in op for t in _NOT_MUL)}

    lib = ctypes.CDLL(str(so))
    lib.launch.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int]
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    blocks, threads = sms * 16, 256
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    clock_hz = float(_smi("clocks.max.sm")) * 1e6
    rates = {}
    for name in ("rate_imad", "rate_wide", "rate_hi", "rate_mont",
                 "rate_raw"):
        def run():
            kernels.check(lib.launch(name.encode(), out.data_ptr(), 12345,
                                     ITERS, blocks, threads), name)
        run()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        # rate_raw does four products a lane and iteration
        ops = blocks * threads * ITERS * LANES * (4 if name == "rate_raw"
                                                  else 1)
        rates[name] = dict(s=best, per_s=ops / best,
                           per_sm_per_clk=ops / best / sms / clock_hz)
    imad = rates["rate_imad"]["per_sm_per_clk"]
    slot = {"IMAD": 1.0,
            "IMAD.WIDE.U32": imad / rates["rate_wide"]["per_sm_per_clk"],
            "IMAD.HI.U32": imad / rates["rate_hi"]["per_sm_per_clk"]}
    slots = sum(n * slot.get(op, slot.get(op.split(".")[0], 1.0))
                for op, n in per_mont.items())
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "power_limit": _smi("power.limit"), "sms": sms,
        "clock_max_sm_hz": clock_hz,
        "sass_multiplies_per_mont": per_mont,
        "sass": {k: dict(v) for k, v in sorted(per.items())},
        "rates": rates, "slots_per_opcode": slot,
        "slots_per_mont": slots,
        "mont_per_s": rates["rate_mont"]["per_s"],
        "sass_multiplies_per_raw": per_raw,
        # slots by the opcode count, and by the measured rate of lazily
        # summed raw products against the IMAD rate
        "slots_per_raw": sum(n * slot.get(op, slot.get(op.split(".")[0],
                                                       1.0))
                             for op, n in per_raw.items()),
        "slots_per_raw_by_rate": imad / rates["rate_raw"]["per_sm_per_clk"],
        "raw_per_s": rates["rate_raw"]["per_s"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
