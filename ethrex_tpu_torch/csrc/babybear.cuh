// BabyBear field arithmetic shared by every kernel of ethrex_tpu_torch.
//
// Elements are residues below p = 15 * 2^27 + 1 in Montgomery form with
// R = 2^32, exactly as ethrex_tpu/ops/babybear.py:26-33 defines them:
// NP = -p^{-1} mod 2^32, and mul(a, b) = a * b * R^{-1} mod p.  Tensors on
// the PyTorch side are int32; the kernels read the same memory as uint32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bb {

constexpr uint32_t P = 2013265921u;
constexpr uint32_t NP = 2013265919u;   // -p^{-1} mod 2^32
constexpr uint32_t R2 = 1172168163u;   // R^2 mod p
constexpr uint32_t MONT_ONE = 268435454u;  // R mod p
constexpr uint32_t W_M = 939524073u;   // 11 (x^4 = W) in Montgomery form

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2p < 2^32
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + P - b;
}

// Montgomery product: a * b * R^{-1} mod p, inputs and output below p.
// On sm_90a it compiles to three multiplies, IMAD.WIDE.U32, IMAD and
// IMAD.HI.U32; the wide and high forms issue at half the IMAD rate, so a
// product costs five IMAD issue slots (ethrex_tpu_torch/tools/
// int_mul_rate.py measures both).
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint64_t x = (uint64_t)a * b;
  uint32_t lo = (uint32_t)x;
  uint32_t hi = (uint32_t)(x >> 32);
  uint32_t m = lo * NP;
  uint32_t mp_hi = __umulhi(m, P);
  // x + m*p == 0 (mod 2^32): the low words carry iff lo != 0
  uint32_t t = hi + mp_hi + (lo != 0u);  // < 2p
  return t >= P ? t - P : t;
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
