// K7: elementwise inverse of a BabyBear array (Montgomery form), by
// Montgomery's trick over a block of THREADS x CHUNK elements.
//
// Replaces the jax.jit program ethrex_tpu/ops/babybear.py:147
// `batch_mont_inv` (two associative scans over the whole array), used for
// the divisor tables of the quotient (ethrex_tpu/stark/prover.py:516) and
// for the norms inside ethrex_tpu/ops/ext.py:134 `inv_x_minus_zeta`.
//
// Bound on this card: memory, one read and one write of 4 bytes an
// element.  The design moves no more than that and keeps the arithmetic
// near 3 products an element:
//  * A thread loads its CHUNK elements (THREADS apart, so a warp's loads
//    are contiguous) into registers and keeps their running products
//    there; it writes each inverse once.
//  * `block_inv` scans the threads' products across the block (shuffles
//    within a warp, then the warps' products in warp 0), both ways, so
//    one inversion serves the whole block: every thread's product's
//    inverse is the block's inverse times the products before and after
//    it.
//  * A zero element is left out of the products and gets 0, as the
//    per-element Fermat power gives it, so the kernel equals the plain
//    version on every input (an all-zero chunk, warp or block included).
//    An element past n is left out the same way.
//
// `divisor_inv` is the same inversion over the quotient's divisors
// x - c_j (ethrex_tpu/stark/prover.py:488-499, 516): each block loads its
// THREADS x CHUNK domain points once and inverts x - c_j for every
// constant c_j in turn, so the (1 + nb, N) stack of differences is never
// written to memory.  mont(x) - mont(c) = mont(x - c), so it equals the
// reference's inverses of its canonical stack.
#include "babybear.cuh"

namespace {

constexpr int CHUNK = 16;       // elements a thread
constexpr int THREADS = 128;    // threads a block
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// The block's THREADS x CHUNK values v, inverted in place (zeros to 0).
// Every thread of the block calls it; smem holds 2 WARPS words.
__device__ __forceinline__ void block_inv(uint32_t v[CHUNK],
                                          uint32_t* smem) {
  uint32_t pre[CHUNK];
  uint32_t run = bb::MONT_ONE;
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    pre[c] = run;
    if (v[c] != 0u) run = bb::mul(run, v[c]);
  }
  // inclusive prefix and suffix products of the warp's threads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = run, suf = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(FULL, inc, d);
    const uint32_t w = __shfl_down_sync(FULL, suf, d);
    if (lane >= d) inc = bb::mul(inc, u);
    if (lane + d < 32) suf = bb::mul(suf, w);
  }
  uint32_t before = __shfl_up_sync(FULL, inc, 1);
  uint32_t after = __shfl_down_sync(FULL, suf, 1);
  if (lane == 0) before = bb::MONT_ONE;
  if (lane == 31) {
    after = bb::MONT_ONE;
    smem[warp] = inc;                  // the warp's product
  }
  __syncthreads();
  if (warp == 0) {
    // the same over the warps' products (lanes past WARPS hold one),
    // and the inverse of the block's product
    uint32_t wi = lane < WARPS ? smem[lane] : bb::MONT_ONE, ws = wi;
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const uint32_t u = __shfl_up_sync(FULL, wi, d);
      const uint32_t w = __shfl_down_sync(FULL, ws, d);
      if (lane >= d) wi = bb::mul(wi, u);
      if (lane + d < 32) ws = bb::mul(ws, w);
    }
    uint32_t wb = __shfl_up_sync(FULL, wi, 1);
    uint32_t wa = __shfl_down_sync(FULL, ws, 1);
    const uint32_t total_inv =
        bb::mpow(__shfl_sync(FULL, wi, WARPS - 1), bb::P - 2u);
    if (lane == 0) wb = bb::MONT_ONE;
    if (lane < WARPS) smem[WARPS + lane] = bb::mul(total_inv, bb::mul(wb, wa));
  }
  __syncthreads();
  // the inverse of this thread's product, then of each element, last first
  uint32_t inv = bb::mul(smem[WARPS + warp], bb::mul(before, after));
#pragma unroll
  for (int c = CHUNK - 1; c >= 0; --c) {
    const uint32_t x = v[c];
    v[c] = x != 0u ? bb::mul(inv, pre[c]) : 0u;
    if (x != 0u) inv = bb::mul(inv, x);
  }
}

__global__ void __launch_bounds__(THREADS)
k_batch_inv(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
            long long n) {
  __shared__ uint32_t smem[2 * WARPS];
  const long long base =
      (long long)blockIdx.x * (THREADS * CHUNK) + threadIdx.x;
  uint32_t v[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const long long i = base + (long long)c * THREADS;
    v[c] = i < n ? a[i] : 0u;
  }
  block_inv(v, smem);
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const long long i = base + (long long)c * THREADS;
    if (i < n) out[i] = v[c];
  }
}

__global__ void __launch_bounds__(THREADS)
k_divisor_inv(const uint32_t* __restrict__ pts,
              const uint32_t* __restrict__ cm, int nd,
              uint32_t* __restrict__ out, long long N) {
  __shared__ uint32_t smem[2 * WARPS];
  const long long base =
      (long long)blockIdx.x * (THREADS * CHUNK) + threadIdx.x;
  uint32_t x[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const long long i = base + (long long)c * THREADS;
    x[c] = i < N ? pts[i] : 0u;
  }
  for (int j = 0; j < nd; ++j) {
    const uint32_t cj = cm[j];
    uint32_t v[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const long long i = base + (long long)c * THREADS;
      v[c] = i < N ? bb::sub(x[c], cj) : 0u;
    }
    block_inv(v, smem);
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const long long i = base + (long long)c * THREADS;
      if (i < N) out[(long long)j * N + i] = v[c];
    }
  }
}

unsigned blocks(long long n) {
  return (unsigned)((n + THREADS * CHUNK - 1) / (THREADS * CHUNK));
}

}  // namespace

extern "C" {

// a (n,) -> out (n,)
int batch_inv(const void* a, void* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  k_batch_inv<<<blocks(n), THREADS, 0, stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// pts (N,), cm (nd,) -> out (nd, N): out[j, i] = 1 / (pts[i] - cm[j])
int divisor_inv(const void* pts, const void* cm, int nd, void* out,
                long long N, cudaStream_t stream) {
  if (N <= 0 || nd <= 0) return 0;
  k_divisor_inv<<<blocks(N), THREADS, 0, stream>>>(
      (const uint32_t*)pts, (const uint32_t*)cm, nd, (uint32_t*)out, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
