// K3: exact modular matmul (n, k) @ (k, m) mod p for small m (<= 8).
//
// Replaces the jax.jit program ethrex_tpu/ops/babybear.py:191
// `mod_matmul` (16 bf16 limb matmuls on the TPU's matrix unit) in both its
// semantics: montgomery=1 takes and returns Montgomery form, montgomery=0
// canonical values.
//
// Arithmetic: each product is reduced by one Montgomery REDC, so a term
// is below p < 2^31 and a u64 accumulator holds 2^33 of them exactly (a
// raw 62-bit product would overflow after four).  In Montgomery mode the
// REDC of (aR)(bR) is (ab)R, so the reduced sum is the Montgomery form of
// the result; in canonical mode the sum is (sum ab)R^{-1} and one more
// product by R^2 restores sum ab.
//
// Two shapes run on the prover's path: tall and narrow ((2^22, 159) and
// (2^22, 115) against (k, 4)), where one thread owns a row and walks k
// (the wrapper passes strides, so the column-major constraint stack and
// LDE are read in place, coalesced across threads), and short with a huge
// k ((115, 2^19) @ (2^19, 4)), where a block per (row, k-slice) reduces in
// shared memory and a second pass sums the slices.
//
// Bound on this card: 32-bit integer multiplies (three instructions, five
// IMAD issue slots per product: see babybear.cuh `mul`) for the
// tall shapes; for the short shape, the one read of a.
#include "babybear.cuh"

namespace {

constexpr int MAXM = 8;

__device__ __forceinline__ uint32_t finish(unsigned long long acc,
                                           int montgomery) {
  uint32_t r = (uint32_t)(acc % bb::P);
  return montgomery ? r : bb::mul(r, bb::R2);
}

__global__ void k_rows(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       uint32_t* __restrict__ out, long long n, long long k,
                       int m, long long rs, long long cs, int montgomery) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long acc[MAXM];
#pragma unroll
  for (int j = 0; j < MAXM; ++j) acc[j] = 0;
  const uint32_t* row = a + i * rs;
  for (long long kk = 0; kk < k; ++kk) {
    uint32_t av = row[kk * cs];
    const uint32_t* bk = b + kk * m;
#pragma unroll
    for (int j = 0; j < MAXM; ++j)
      if (j < m) acc[j] += bb::mul(av, __ldg(bk + j));
  }
#pragma unroll
  for (int j = 0; j < MAXM; ++j)
    if (j < m) out[i * m + j] = finish(acc[j], montgomery);
}

constexpr int SPLIT_THREADS = 256;

// grid (splits, n): block (s, i) sums products over its k-slice
__global__ void k_splitk(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         uint32_t* __restrict__ part, long long n,
                         long long k, int m, long long rs, long long cs,
                         int splits) {
  __shared__ unsigned long long sh[MAXM][SPLIT_THREADS];
  long long i = blockIdx.y;
  int s = blockIdx.x;
  long long chunk = (k + splits - 1) / splits;
  long long k0 = (long long)s * chunk;
  long long k1 = k0 + chunk < k ? k0 + chunk : k;
  unsigned long long acc[MAXM];
#pragma unroll
  for (int j = 0; j < MAXM; ++j) acc[j] = 0;
  const uint32_t* row = a + i * rs;
  for (long long kk = k0 + threadIdx.x; kk < k1; kk += SPLIT_THREADS) {
    uint32_t av = row[kk * cs];
    const uint32_t* bk = b + kk * m;
#pragma unroll
    for (int j = 0; j < MAXM; ++j)
      if (j < m) acc[j] += bb::mul(av, __ldg(bk + j));
  }
#pragma unroll
  for (int j = 0; j < MAXM; ++j) sh[j][threadIdx.x] = acc[j] % bb::P;
  __syncthreads();
  for (int width = SPLIT_THREADS / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) {
#pragma unroll
      for (int j = 0; j < MAXM; ++j)
        sh[j][threadIdx.x] += sh[j][threadIdx.x + width];
    }
    __syncthreads();
  }
  if (threadIdx.x < m)
    part[(i * splits + s) * m + threadIdx.x] =
        (uint32_t)(sh[threadIdx.x][0] % bb::P);
}

__global__ void k_splitk_finish(const uint32_t* __restrict__ part,
                                uint32_t* __restrict__ out, long long n,
                                int m, int splits, int montgomery) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * m) return;
  long long i = t / m;
  int j = (int)(t % m);
  unsigned long long acc = 0;
  for (int s = 0; s < splits; ++s) acc += part[(i * splits + s) * m + j];
  out[t] = finish(acc, montgomery);
}

}  // namespace

extern "C" {

int mod_matmul_rows(const void* a, const void* b, void* out, long long n,
                    long long k, int m, long long rs, long long cs,
                    int montgomery, cudaStream_t stream) {
  if (m < 1 || m > MAXM) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    k_rows<<<(unsigned)((n + 127) / 128), 128, 0, stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, k, m, rs,
        cs, montgomery);
  }
  return (int)cudaGetLastError();
}

int mod_matmul_splitk(const void* a, const void* b, void* part, void* out,
                      long long n, long long k, int m, long long rs,
                      long long cs, int splits, int montgomery,
                      cudaStream_t stream) {
  if (m < 1 || m > MAXM || n > 65535) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    dim3 grid((unsigned)splits, (unsigned)n);
    k_splitk<<<grid, SPLIT_THREADS, 0, stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)part, n, k, m, rs,
        cs, splits);
    long long outs = n * m;
    k_splitk_finish<<<(unsigned)((outs + 127) / 128), 128, 0, stream>>>(
        (const uint32_t*)part, (uint32_t*)out, n, m, splits, montgomery);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
