// K7: elementwise inverse of a BabyBear array (Montgomery form), by
// Montgomery's trick over a chunk of elements per thread.
//
// Replaces the jax.jit program ethrex_tpu/ops/babybear.py:147
// `batch_mont_inv` (two associative scans over the whole array), used for
// the divisor tables of the quotient (ethrex_tpu/stark/prover.py:516) and
// for the norms inside ethrex_tpu/ops/ext.py:134 `inv_x_minus_zeta`.
//
// Thread t owns the elements t, t + T, t + 2T, ... (T threads in all, so
// a warp's loads are contiguous).  A forward pass writes each element's
// prefix product into out and keeps the running product; one Fermat power
// (x^(p-2), 30 squarings and 15 products) inverts it; a backward pass turns
// every prefix into the element's inverse.  A zero element is skipped in
// the products and gets 0, as the per-element Fermat power gives it, so
// the kernel equals the plain version on every input.
//
// Bound on this card: memory.  Per element it reads a twice and out once
// and writes out twice (the bound counts one read and one write), and does
// three Montgomery products plus ~45/chunk for the power.
#include "babybear.cuh"

namespace {

__global__ void k_batch_inv(const uint32_t* __restrict__ a,
                            uint32_t* __restrict__ out, long long n,
                            long long threads, int chunk) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  uint32_t acc = bb::MONT_ONE;
  int cnt = 0;
  for (long long i = t; i < n && cnt < chunk; i += threads, ++cnt) {
    uint32_t x = a[i];
    out[i] = acc;
    if (x != 0u) acc = bb::mul(acc, x);
  }
  uint32_t inv = bb::mpow(acc, bb::P - 2u);
  for (int k = cnt - 1; k >= 0; --k) {
    long long i = t + (long long)k * threads;
    uint32_t x = a[i];
    if (x != 0u) {
      out[i] = bb::mul(inv, out[i]);
      inv = bb::mul(inv, x);
    } else {
      out[i] = 0u;
    }
  }
}

}  // namespace

extern "C" {

int batch_inv(const void* a, void* out, long long n, int chunk,
              cudaStream_t stream) {
  if (n <= 0) return 0;
  long long threads = (n + chunk - 1) / chunk;
  k_batch_inv<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n, threads, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
