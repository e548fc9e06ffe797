// BabyBear field arithmetic shared by every kernel of ethrex_tpu_torch.
//
// Elements are residues below p = 15 * 2^27 + 1 in Montgomery form with
// R = 2^32, exactly as ethrex_tpu/ops/babybear.py:26-33 defines them:
// mul(a, b) = a * b * R^{-1} mod p (the reference reduces with -p^{-1},
// `mul` below with p^{-1}: the same residue).  Tensors on the PyTorch side
// are int32; the kernels read the same memory as uint32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bb {

constexpr uint32_t P = 2013265921u;
constexpr uint32_t PINV = 2281701377u; // p^{-1} mod 2^32
constexpr uint32_t R2 = 1172168163u;   // R^2 mod p
constexpr uint32_t MONT_ONE = 268435454u;  // R mod p
constexpr uint32_t W_M = 939524073u;   // 11 (x^4 = W) in Montgomery form

// min(a + b, c) in 32-bit unsigned arithmetic (the sum wraps).  nvcc
// compiles it for sm_90 to one DPX instruction, VIADDMNMX (the SASS counts
// of tools/p2_sass.py show it), so every reduction below is one add
// and one add-min, with no compare and no select.
__device__ __forceinline__ uint32_t addmin(uint32_t a, uint32_t b,
                                           uint32_t c) {
  return min(a + b, c);
}

// s < 2p -> s mod p: s - p wraps above s exactly when s < p
__device__ __forceinline__ uint32_t reduce2p(uint32_t s) {
  return addmin(s, 0u - P, s);
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return reduce2p(a + b);  // a + b < 2p < 2^32
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  uint32_t d = a - b;      // wraps when a < b; then d + p is the residue
  return addmin(d, P, d);
}

// Montgomery product a * b * R^{-1} mod p, exact and canonical whenever
// a * b < p * 2^32 (so for a < 2^32 and b < p, not only for a, b < p).
// With m = lo * p^{-1} mod 2^32 the low words of x and m * p are equal, so
// (x - m p) / 2^32 = hi - umulhi(m, p) with no carry to test; the value
// lies in (-p, p) and one add-min of p makes it canonical.  On sm_90a it
// compiles to three multiplies, IMAD.WIDE.U32, IMAD and IMAD.HI.U32 (the
// wide and high forms issue at half the IMAD rate: five IMAD issue slots
// a product, measured by ethrex_tpu_torch/tools/int_mul_rate.py), plus
// one add and one add-min.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint64_t x = (uint64_t)a * b;
  uint32_t lo = (uint32_t)x;
  uint32_t hi = (uint32_t)(x >> 32);
  uint32_t t = hi - __umulhi(lo * PINV, P);
  return addmin(t, P, t);
}

// Montgomery reduction of a 64-bit value: x * R^{-1} mod p, canonical,
// for any x < p * 2^32 (the same steps as `mul` after its product).
__device__ __forceinline__ uint32_t redc(uint64_t x) {
  uint32_t lo = (uint32_t)x;
  uint32_t hi = (uint32_t)(x >> 32);
  uint32_t t = hi - __umulhi(lo * PINV, P);
  return addmin(t, P, t);
}

// Lazy sums of raw products.  A raw product of two residues is at most
// (p - 1)^2 = 225 * 2^54, and one 64-bit multiply-add (IMAD.WIDE.U32)
// adds it to a 64-bit accumulator: acc = mad(a, b, acc).  `fold` maps
// any 64-bit acc to a value below 2^60 with the same residue, hi * 2^32
// + lo -> hi * (2^32 mod p) + lo (2^32 mod p = MONT_ONE < 2^28), one more
// IMAD.WIDE.U32.  Below 2^60, four raw products fit:
// 2^60 + 4 * 225 * 2^54 = 964 * 2^54 < 2^64.  So a sum folds once every
// four terms, and a folded sum (< 2^60 < p * 2^32) takes `redc` directly:
// redc(fold(sum of (aR)(bR))) is the Montgomery form of sum ab.
__device__ __forceinline__ uint64_t mad(uint32_t a, uint32_t b,
                                        uint64_t acc) {
  return (uint64_t)a * b + acc;
}

__device__ __forceinline__ uint64_t fold(uint64_t x) {
  return (uint64_t)(uint32_t)(x >> 32) * MONT_ONE + (uint32_t)x;
}

__device__ __forceinline__ uint32_t mpow(uint32_t a, uint32_t e) {
  uint32_t r = MONT_ONE;
  while (e) {
    if (e & 1u) r = mul(r, a);
    a = mul(a, a);
    e >>= 1;
  }
  return r;
}

// Quartic extension F_p[x]/(x^4 - 11): schoolbook product, Montgomery
// coordinates (ethrex_tpu/ops/ext.py:43 `mul`).
__device__ __forceinline__ void ext_mul(const uint32_t a[4],
                                        const uint32_t b[4], uint32_t c[4]) {
  uint32_t t0 = add(add(mul(a[1], b[3]), mul(a[2], b[2])), mul(a[3], b[1]));
  uint32_t t1 = add(mul(a[2], b[3]), mul(a[3], b[2]));
  uint32_t t2 = mul(a[3], b[3]);
  c[0] = add(mul(a[0], b[0]), mul(t0, W_M));
  c[1] = add(add(mul(a[0], b[1]), mul(a[1], b[0])), mul(t1, W_M));
  c[2] = add(add(mul(a[0], b[2]), mul(a[1], b[1])),
             add(mul(a[2], b[0]), mul(t2, W_M)));
  c[3] = add(add(mul(a[0], b[3]), mul(a[1], b[2])),
             add(mul(a[2], b[1]), mul(a[3], b[0])));
}

}  // namespace bb
