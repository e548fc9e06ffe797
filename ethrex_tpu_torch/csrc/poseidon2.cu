// K2: width-16 Poseidon2 over BabyBear (x^7 S-box, 4 + 13 + 4 rounds), as
// the rate-8 leaf sponge and the 2-to-1 Merkle compression.
//
// Replaces the jax.jit programs ethrex_tpu/ops/poseidon2.py:191 `permute`,
// :222 `compress` and :232 `hash_leaves`, and the level loop of
// ethrex_tpu/ops/merkle.py:22-53 (`build_levels_with`/`commit_levels`),
// which the wrapper (ethrex_tpu_torch/ops/merkle.py) drives one
// p2_compress_level launch per tree level, keeping every level.
//
// Design: one thread per leaf row (or per output node) holds the 16-lane
// state in registers for the whole permutation; the round constants and
// the internal diagonal mu live in __constant__ memory, read uniformly by
// every thread of a warp.  The leaf hash reads its rows through strides
// (row, column and column-group), so the prover hashes the column-major
// LDE and the paired FRI codeword in place, with no transposed copy.
//
// Bound on this card: 32-bit integer multiplies.  One permutation is
// about 772 Montgomery products (each three multiply instructions, five
// IMAD issue slots: see babybear.cuh `mul`); the state proof runs about
// 97 M permutations.  Memory traffic is one read of each leaf row and one
// 32-byte digest write per row.
#include "babybear.cuh"

__constant__ uint32_t c_ext_rc[8][16];
__constant__ uint32_t c_int_rc[13];
__constant__ uint32_t c_mu[16];

namespace {

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = bb::mul(x, x);
  uint32_t x4 = bb::mul(x2, x2);
  return bb::mul(bb::mul(x4, x2), x);
}

__device__ __forceinline__ uint32_t dbl(uint32_t x) { return bb::add(x, x); }

// M4 evaluation chain of ethrex_tpu/ops/poseidon2.py `_m4`
__device__ __forceinline__ void m4(uint32_t* x) {
  uint32_t t0 = bb::add(x[0], x[1]);
  uint32_t t1 = bb::add(x[2], x[3]);
  uint32_t t2 = bb::add(dbl(x[1]), t1);
  uint32_t t3 = bb::add(dbl(x[3]), t0);
  uint32_t t4 = bb::add(dbl(dbl(t1)), t3);
  uint32_t t5 = bb::add(dbl(dbl(t0)), t2);
  uint32_t t6 = bb::add(t3, t5);
  uint32_t t7 = bb::add(t2, t4);
  x[0] = t6;
  x[1] = t5;
  x[2] = t7;
  x[3] = t4;
}

__device__ __forceinline__ void external_linear(uint32_t* s) {
#pragma unroll
  for (int b = 0; b < 4; ++b) m4(s + 4 * b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t sum = bb::add(bb::add(s[j], s[4 + j]), bb::add(s[8 + j], s[12 + j]));
#pragma unroll
    for (int b = 0; b < 4; ++b) s[4 * b + j] = bb::add(s[4 * b + j], sum);
  }
}

__device__ __forceinline__ void ext_round(uint32_t* s, int r) {
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = sbox(bb::add(s[j], c_ext_rc[r][j]));
  external_linear(s);
}

__device__ __forceinline__ void permute(uint32_t* s) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < 4; ++r) ext_round(s, r);
#pragma unroll 1
  for (int r = 0; r < 13; ++r) {
    s[0] = sbox(bb::add(s[0], c_int_rc[r]));
    uint32_t tot = s[0];
#pragma unroll
    for (int j = 1; j < 16; ++j) tot = bb::add(tot, s[j]);
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = bb::add(tot, bb::mul(s[j], c_mu[j]));
  }
#pragma unroll 1
  for (int r = 4; r < 8; ++r) ext_round(s, r);
}

// element (i, c) of the leaf matrix lives at
//   i*row_stride + (c % inner)*col_stride + (c / inner)*group_stride
__global__ void k_hash_leaves(const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out, long long m, int w,
                              long long row_stride, long long col_stride,
                              int inner, long long group_stride) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint32_t* row = in + i * row_stride;
  uint32_t s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0;
  for (int c0 = 0; c0 < w; c0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int c = c0 + j;
      if (c < w) {
        uint32_t v = row[(long long)(c % inner) * col_stride +
                         (long long)(c / inner) * group_stride];
        s[j] = bb::add(s[j], v);
      }
    }
    permute(s);
  }
  uint4* o = reinterpret_cast<uint4*>(out + i * 8);
  o[0] = make_uint4(s[0], s[1], s[2], s[3]);
  o[1] = make_uint4(s[4], s[5], s[6], s[7]);
}

__global__ void k_compress_level(const uint32_t* __restrict__ level,
                                 uint32_t* __restrict__ out, long long m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint4* src = reinterpret_cast<const uint4*>(level + i * 16);
  uint32_t s[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v = src[q];
    s[4 * q] = v.x;
    s[4 * q + 1] = v.y;
    s[4 * q + 2] = v.z;
    s[4 * q + 3] = v.w;
  }
  uint32_t left[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) left[j] = s[j];
  permute(s);
  uint4* o = reinterpret_cast<uint4*>(out + i * 8);
  o[0] = make_uint4(bb::add(s[0], left[0]), bb::add(s[1], left[1]),
                    bb::add(s[2], left[2]), bb::add(s[3], left[3]));
  o[1] = make_uint4(bb::add(s[4], left[4]), bb::add(s[5], left[5]),
                    bb::add(s[6], left[6]), bb::add(s[7], left[7]));
}

}  // namespace

extern "C" {

// Montgomery-form constants from the host (ethrex_tpu_torch/ops/poseidon2):
// ext_rc[8*16], int_rc[13], mu[16].
int p2_set_constants(const void* ext_rc, const void* int_rc, const void* mu) {
  cudaMemcpyToSymbol(c_ext_rc, ext_rc, sizeof(uint32_t) * 8 * 16);
  cudaMemcpyToSymbol(c_int_rc, int_rc, sizeof(uint32_t) * 13);
  cudaMemcpyToSymbol(c_mu, mu, sizeof(uint32_t) * 16);
  return (int)cudaGetLastError();
}

int p2_hash_leaves(const void* in, void* out, long long m, int w,
                   long long row_stride, long long col_stride, int inner,
                   long long group_stride, cudaStream_t stream) {
  if (m > 0) {
    k_hash_leaves<<<(unsigned)((m + 127) / 128), 128, 0, stream>>>(
        (const uint32_t*)in, (uint32_t*)out, m, w, row_stride, col_stride,
        inner, group_stride);
  }
  return (int)cudaGetLastError();
}

// level: (2m, 8) digests -> out: (m, 8)
int p2_compress_level(const void* level, void* out, long long m,
                      cudaStream_t stream) {
  if (m > 0) {
    k_compress_level<<<(unsigned)((m + 127) / 128), 128, 0, stream>>>(
        (const uint32_t*)level, (uint32_t*)out, m);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
