// Base-field polynomials at one base-field point: rows of Montgomery
// coefficients (rows, n) -> (rows,) values.  A test-only helper of the
// reference: no prover path calls it.
//
// Replaces the jax.jit program ethrex_tpu/ops/ntt.py:166 `eval_poly_at`
// (a Horner scan, sequential in n).  Here one block per row evaluates its
// chunks in parallel: thread t takes the coefficients i = t, t + 256, ...,
// multiplies each by x^i = big[i >> b] * small[i & (2^b - 1)] (two short
// host tables, 2^b about sqrt(n), as K11 builds its power tables), and sums the
// canonical products in a 64-bit lane (exact below 2^32 terms); a shared
// reduction gives the row's sum mod p.  The value of a polynomial at a
// point is unique, so the order of the sum does not matter.
//
// Bound on this card: one read of the coefficients (two products a word).
#include "babybear.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void k_eval_poly_at(const uint32_t* __restrict__ coeffs,
                               long long row_stride, long long n,
                               const uint32_t* __restrict__ small,
                               const uint32_t* __restrict__ big, int lg_blk,
                               uint32_t* __restrict__ out) {
  __shared__ unsigned long long sh[kThreads];
  const uint32_t* row = coeffs + (long long)blockIdx.x * row_stride;
  unsigned long long acc = 0;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const uint32_t xi = bb::mul(__ldg(big + (i >> lg_blk)),
                                __ldg(small + (i & ((1 << lg_blk) - 1))));
    acc += bb::mul(row[i], xi);
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = (uint32_t)(sh[0] % bb::P);
}

}  // namespace

extern "C" {

// coeffs: element (r, i) at r * row_stride + i; small (2^lg_blk,), big
// (ceil(n / 2^lg_blk),) Montgomery powers of the point -> out (rows,)
int eval_poly_at(const void* coeffs, long long row_stride, long long n,
                 int rows, const void* small, const void* big, int lg_blk,
                 void* out, cudaStream_t stream) {
  if (rows > 0) {
    k_eval_poly_at<<<rows, kThreads, 0, stream>>>(
        (const uint32_t*)coeffs, row_stride, n, (const uint32_t*)small,
        (const uint32_t*)big, lg_blk, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
