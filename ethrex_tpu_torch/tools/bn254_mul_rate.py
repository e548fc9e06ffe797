"""Throughput and single-thread latency of one BN254 Montgomery product
(and of the point operations built on it) on this card.

    python3 -m ethrex_tpu_torch.tools.bn254_mul_rate   # needs one CUDA card

Kernel K5 (csrc/bn254_msm.cu) sums its buckets over many threads, where
the product's throughput sets the time, but its reductions are chains of
dependent point additions in one lane (a `k_window_sum` lane runs about
20), whose latency sets the time; a Horner combination over the windows
would be a chain of 248 doublings.  This script measures both, for the
product of csrc/bn254.cuh (CIOS on 64-bit partial products,
`bn254::mul`) and for a variant written with PTX carry chains
(`mad.lo.cc` / `madc.hi.cc` / `addc`, `mul_ptx` below), held equal to it
on random inputs first:

  1. SASS count: two straight-line kernels differ only in a chain of 16
     products; `cuobjdump -sass` of each gives the multiply opcodes a
     product adds (as `tools/int_mul_rate.py` does for BabyBear).
  2. Latency: one thread runs a chain of dependent operations (products,
     Fp2 products, G1 and G2 doublings, additions and mixed additions as
     the header has them, with each product a call to one copy of its
     code, and the G1 addition with its products inlined),
     timed by `clock64()` in the kernel; cycles per operation, and ns at
     the clock nvidia-smi reports while the card is busy.
  3. Throughput: every SM runs 4 independent product chains a thread;
     CUDA events give products per second.
  4. The SASS of each latency kernel: instructions, local-memory loads
     and stores, branches and calls.

It prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .. import kernels

CHAIN = 16      # products in the straight-line SASS probe
LAT_OPS = 256   # dependent operations in a latency chain
LANES = 4       # independent chains per thread in the rate kernels
ITERS = 256

SOURCE = r"""
#include <cstring>

#include "bn254.cuh"

using namespace bn254;

// CIOS with the carries in PTX carry chains: per word a_i, the low halves
// of a_i b into t[0..7] (carry into t[8]), the high halves into t[1..8];
// then m = t0 (-1/p) and the same for m p; then a shift by one word.  t
// stays below 2p < 2^255 at each round's start, so 9 words never carry out.
__device__ __forceinline__ Fp mul_ptx(const Fp& a, const Fp& b) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int k = 0; k <= NW; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t ai = a.w[i];
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(ai), "r"(b.w[0]));
#pragma unroll
    for (int j = 1; j < NW; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(ai), "r"(b.w[j]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[NW]));
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(ai), "r"(b.w[0]));
#pragma unroll
    for (int j = 1; j < NW - 1; ++j)
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(ai), "r"(b.w[j]));
    asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(t[NW]) : "r"(ai), "r"(b.w[NW - 1]));
    const uint32_t m = t[0] * kNP;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(m), "r"(kP[0]));
#pragma unroll
    for (int j = 1; j < NW; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(m), "r"(kP[j]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[NW]));
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(m), "r"(kP[0]));
#pragma unroll
    for (int j = 1; j < NW - 1; ++j)
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(m), "r"(kP[j]));
    asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(t[NW]) : "r"(m), "r"(kP[NW - 1]));
#pragma unroll
    for (int k = 0; k < NW; ++k) t[k] = t[k + 1];
    t[NW] = 0u;
  }
  Fp r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[k];
  if (geq_p(r.w)) sub_p(r.w);
  return r;
}

// `padd` with its products inlined (`mul_inline`), against the header's
// called form
__device__ __forceinline__ Pt<Fp> padd_inlined(const Pt<Fp>& P1,
                                               const Pt<Fp>& P2) {
  if (is_zero(P1.Z)) return P2;
  if (is_zero(P2.Z)) return P1;
  Fp Z1Z1 = mul_inline(P1.Z, P1.Z);
  Fp Z2Z2 = mul_inline(P2.Z, P2.Z);
  Fp U1 = mul_inline(P1.X, Z2Z2);
  Fp U2 = mul_inline(P2.X, Z1Z1);
  Fp S1 = mul_inline(mul_inline(P1.Y, P2.Z), Z2Z2);
  Fp S2 = mul_inline(mul_inline(P2.Y, P1.Z), Z1Z1);
  Fp H = sub(U2, U1);
  Fp Rr = sub(S2, S1);
  if (is_zero(H)) return is_zero(Rr) ? pdbl(P1) : infinity<Fp>();
  Fp HH = mul_inline(H, H);
  Fp HHH = mul_inline(H, HH);
  Fp V = mul_inline(U1, HH);
  Fp X3 = sub(sub(mul_inline(Rr, Rr), HHH), add(V, V));
  Fp Y3 = sub(mul_inline(Rr, sub(V, X3)), mul_inline(S1, HHH));
  Fp Z3 = mul_inline(mul_inline(P1.Z, P2.Z), H);
  return Pt<Fp>{X3, Y3, Z3};
}

struct MulC { __device__ static Fp f(const Fp& a, const Fp& b) { return mul_inline(a, b); } };
struct MulPtx { __device__ static Fp f(const Fp& a, const Fp& b) { return mul_ptx(a, b); } };

__device__ __forceinline__ Fp load(const uint32_t* p) {
  Fp v;
#pragma unroll
  for (int k = 0; k < NW; ++k) v.w[k] = p[k];
  return v;
}
__device__ __forceinline__ void store(const Fp& v, uint32_t* p) {
#pragma unroll
  for (int k = 0; k < NW; ++k) p[k] = v.w[k];
}

// out[i] = a[i] b[i] by each variant, to hold them equal
template <class M>
__global__ void k_products(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) store(M::f(load(a + 8 * i), load(b + 8 * i)), out + 8 * i);
}

template <class M, int K>
__device__ __forceinline__ Fp chain(Fp x, const Fp& y) {
#pragma unroll
  for (int i = 0; i < K; ++i) x = M::f(x, y);
  return x;
}
extern "C" __global__ void probe_c_0(uint32_t* io) { store(chain<MulC, 0>(load(io), load(io + 8)), io); }
extern "C" __global__ void probe_c_16(uint32_t* io) { store(chain<MulC, 16>(load(io), load(io + 8)), io); }
extern "C" __global__ void probe_ptx_0(uint32_t* io) { store(chain<MulPtx, 0>(load(io), load(io + 8)), io); }
extern "C" __global__ void probe_ptx_16(uint32_t* io) { store(chain<MulPtx, 16>(load(io), load(io + 8)), io); }

// one thread: a chain of `ops` dependent operations; cycles by clock64
template <int OP>
__global__ void k_latency(const uint32_t* in, uint32_t* out, long long* cycles, int ops) {
  Fp a = load(in), b = load(in + 8), c = load(in + 16);
  Fp2 a2{a, b}, b2{b, c};
  Pt<Fp> P{a, b, c}, Q{b, c, a};
  Pt<Fp2> P2{a2, b2, Fp2{c, a}}, Q2{b2, a2, Fp2{a, c}};
  long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < ops; ++i) {
    if (OP == 0) a = mul_inline(a, b);
    if (OP == 1) a = mul_ptx(a, b);
    if (OP == 2) a2 = mul(a2, b2);
    if (OP == 3) P = pdbl(P);
    if (OP == 4) P = padd(P, Q);
    if (OP == 5) P = madd(P, b, c);
    if (OP == 6) P2 = pdbl(P2);
    if (OP == 7) P2 = padd(P2, Q2);
    if (OP == 8) P2 = madd(P2, b2, a2);
    if (OP == 9) P = padd_inlined(P, Q);
  }
  long long t1 = clock64();
  store(a, out);
  store(a2.c0, out + 8);
  store(P.X, out + 16);
  store(P2.X.c0, out + 24);
  cycles[0] = t1 - t0;
}

template <class M>
__global__ void k_rate(const uint32_t* in, uint32_t* out, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  Fp x[4];
  Fp y = load(in);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = load(in + 8 * (c + 1));
    x[c].w[0] ^= (uint32_t)t;
  }
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = M::f(x[c], y);
  }
  uint32_t s = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) s ^= x[c].w[0] ^ x[c].w[7];
  out[t] = s;
}

extern "C" int products(int ptx, const void* a, const void* b, void* out, int n) {
  if (ptx) k_products<MulPtx><<<(n + 127) / 128, 128>>>((const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  else k_products<MulC><<<(n + 127) / 128, 128>>>((const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int latency(int op, const void* in, void* out, void* cycles, int ops) {
  const uint32_t* i = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  long long* c = (long long*)cycles;
  switch (op) {
    case 0: k_latency<0><<<1, 1>>>(i, o, c, ops); break;
    case 1: k_latency<1><<<1, 1>>>(i, o, c, ops); break;
    case 2: k_latency<2><<<1, 1>>>(i, o, c, ops); break;
    case 3: k_latency<3><<<1, 1>>>(i, o, c, ops); break;
    case 4: k_latency<4><<<1, 1>>>(i, o, c, ops); break;
    case 5: k_latency<5><<<1, 1>>>(i, o, c, ops); break;
    case 6: k_latency<6><<<1, 1>>>(i, o, c, ops); break;
    case 7: k_latency<7><<<1, 1>>>(i, o, c, ops); break;
    case 8: k_latency<8><<<1, 1>>>(i, o, c, ops); break;
    case 9: k_latency<9><<<1, 1>>>(i, o, c, ops); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int rate(int ptx, const void* in, void* out, int iters, int blocks, int threads) {
  if (ptx) k_rate<MulPtx><<<blocks, threads>>>((const uint32_t*)in, (uint32_t*)out, iters);
  else k_rate<MulC><<<blocks, threads>>>((const uint32_t*)in, (uint32_t*)out, iters);
  return (int)cudaGetLastError();
}
"""

LATENCY_OPS = ("mul", "mul_ptx", "fp2_mul", "g1_dbl", "g1_add", "g1_madd",
               "g2_dbl", "g2_add", "g2_madd", "g1_add_products_inlined")

_MUL = re.compile(r"\b(IMAD(?:\.[A-Z0-9]+)*|IMUL(?:\.[A-Z0-9]+)*)\b")
_NOT_MUL = (".MOV", ".IADD", ".SHL")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


def _sass_multiplies(sass: str) -> dict[str, Counter]:
    per: dict[str, Counter] = {}
    name = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            per[name] = Counter()
        elif name and "/*" in line:
            for op in _MUL.findall(line.split(";")[0]):
                if not any(t in op for t in _NOT_MUL):
                    per[name][op] += 1
    return per


def _latency_sass(sass: str) -> dict:
    """Per latency kernel (one per entry of LATENCY_OPS): its SASS
    instructions, local-memory loads and stores, branches and calls
    (the point functions, not inlined, are compiled into each kernel)."""
    out: dict = {}
    name = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            op = re.search(r"k_latencyILi(\d+)E", m.group(1))
            name = LATENCY_OPS[int(op.group(1))] if op else None
            if name:
                out[name] = Counter()
        elif name and "/*" in line and ";" in line:
            toks = [t for t in line.split("*/", 1)[-1].split()
                    if not t.startswith("@")]
            if not toks:
                continue
            head = toks[0].split(".")[0]
            out[name]["instructions"] += 1
            if head in ("LDL", "STL", "BRA", "CALL", "RET", "IMAD",
                        "IADD3", "ISETP"):
                out[name][head] += 1
    return {k: dict(v) for k, v in out.items()}


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def _words(vals) -> torch.Tensor:
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(raw, dtype="<u4").astype(
        np.uint32).view(np.int32).copy()).cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("bn254_mul_rate: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = kernels.BUILD_DIR / "bn254_mul_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "bn254_mul_rate.cu"
    src.write_text(SOURCE)
    so = out_dir / "libbn254_mul_rate.so"
    nvcc = kernels._nvcc()
    build = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                            "-shared", "-I", str(kernels.CSRC), str(src),
                            "-o", str(so)], capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + build.stdout + build.stderr)
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    per = _sass_multiplies(sass)
    latency_sass = _latency_sass(sass)
    sass_per_mul = {
        v: {op: n / CHAIN for op, n in sorted(
            (per[f"probe_{v}_16"] - per[f"probe_{v}_0"]).items())}
        for v in ("c", "ptx")}

    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.products.argtypes = [ci, vp, vp, vp, ci]
    lib.latency.argtypes = [ci, vp, vp, vp, ci]
    lib.rate.argtypes = [ci, vp, vp, ci, ci, ci]
    for fn in (lib.products, lib.latency, lib.rate):
        fn.restype = ci

    # the two products agree with Python's on random Montgomery inputs
    rng = np.random.default_rng(7)
    n = 4096
    a = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    b = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    a[:4] = [0, 1, P - 1, P - 1]
    b[:4] = [P - 1, P - 1, P - 1, 1]
    rinv = pow(1 << 256, -1, P)
    want = _words([x * y * rinv % P for x, y in zip(a, b)])
    ta, tb = _words(a), _words(b)
    agree = {}
    for ptx in (0, 1):
        got = torch.empty_like(ta)
        kernels.check(lib.products(ptx, ta.data_ptr(), tb.data_ptr(),
                                   got.data_ptr(), n), "products")
        torch.cuda.synchronize()
        agree["ptx" if ptx else "c"] = bool(torch.equal(got, want))
    if not all(agree.values()):
        raise AssertionError(f"a product differs from Python's: {agree}")

    inp = _words([int.from_bytes(rng.bytes(32), "little") % P
                  for _ in range(5)])
    out = torch.empty(64, dtype=torch.int32, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    latency = {}
    for op, name in enumerate(LATENCY_OPS):
        for ops in (LAT_OPS, 2 * LAT_OPS):      # the difference drops set-up
            kernels.check(lib.latency(op, inp.data_ptr(), out.data_ptr(),
                                      cyc.data_ptr(), ops), name)
            torch.cuda.synchronize()
            if ops == LAT_OPS:
                c1 = int(cyc.item())
        latency[name] = (int(cyc.item()) - c1) / LAT_OPS
    clock_busy_hz = float(_smi("clocks.sm")) * 1e6
    clock_max_hz = float(_smi("clocks.max.sm")) * 1e6

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    for threads in (128, 256):
        blocks = sms * 8
        res = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
        for ptx in (0, 1):
            def run():
                kernels.check(lib.rate(ptx, inp.data_ptr(), res.data_ptr(),
                                       ITERS, blocks, threads), "rate")
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
            rates[f"{'ptx' if ptx else 'c'}_{threads}"] = \
                blocks * threads * ITERS * LANES / best
    ptxas = [ln.strip() for ln in build.stdout.splitlines() + build.stderr.
             splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "power_limit": _smi("power.limit"), "sms": sms,
        "clock_sm_hz_after": clock_busy_hz, "clock_max_sm_hz": clock_max_hz,
        "agree_with_python": agree,
        "sass_multiplies_per_product": sass_per_mul,
        "latency_cycles": latency,
        "latency_ns_at_max_clock": {k: v / clock_max_hz * 1e9
                                    for k, v in latency.items()},
        "products_per_s": rates,
        "latency_kernel_sass": latency_sass,
        "ptxas": ptxas,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
