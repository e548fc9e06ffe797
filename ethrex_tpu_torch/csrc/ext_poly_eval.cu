// K11: quartic-extension polynomials at an extension point, and the power
// table of that point.
//
// Replaces ethrex_tpu/ops/ext.py:175 `eval_ext_poly_at_ext` (sum_i c_i z^i
// over ext coefficients, for the quotient chunks at zeta) and the device
// outer product of ops/ext.py:88 `ext_powers_blocked` (the (n, 4) table
// [1, z, ..., z^(n-1)] that kernel K3 contracts with base coefficients).
// Both build z^i = big[i / blk] * small[i % blk] from two short host
// tables (small = z^0..z^(blk-1), big = z^(blk*0), z^(blk*1), ...); the
// powers of one point are unique, so the values equal the reference's.
//
// The evaluation is a reduction: block (g, r) sums the products of row r's
// coefficients it owns as canonical residues in 64-bit lanes (exact below
// 2^32 terms), reduces them in shared memory and writes one partial mod p;
// a second launch sums the partials of each row.
//
// Bound on this card: memory for the evaluation (one read of the
// coefficients), the products for the table (16 per entry).
#include "babybear.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void power_at(const uint32_t* small,
                                         const uint32_t* big, long long i,
                                         int blk, uint32_t z[4]) {
  bb::ext_mul(big + 4 * (i / blk), small + 4 * (i % blk), z);
}

__global__ void k_table(const uint32_t* __restrict__ small,
                        const uint32_t* __restrict__ big,
                        uint32_t* __restrict__ out, long long n, int blk) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t z[4];
  power_at(small, big, i, blk, z);
  reinterpret_cast<uint4*>(out)[i] = make_uint4(z[0], z[1], z[2], z[3]);
}

__global__ void k_eval_partial(const uint32_t* __restrict__ coeffs,
                               long long row_stride, long long idx_stride,
                               long long coord_stride,
                               const uint32_t* __restrict__ small,
                               const uint32_t* __restrict__ big, int blk,
                               long long n, uint32_t* __restrict__ partial) {
  __shared__ unsigned long long sh[4][kThreads];
  const int g = blockIdx.x, G = gridDim.x, r = blockIdx.y;
  const uint32_t* row = coeffs + (long long)r * row_stride;
  unsigned long long acc[4] = {0, 0, 0, 0};
  for (long long i = (long long)g * kThreads + threadIdx.x; i < n;
       i += (long long)G * kThreads) {
    uint32_t z[4], c[4], t[4];
    power_at(small, big, i, blk, z);
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = row[i * idx_stride + k * coord_stride];
    bb::ext_mul(z, c, t);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += t[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sh[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int k = 0; k < 4; ++k) sh[k][threadIdx.x] += sh[k][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < 4)
    partial[((long long)r * G + g) * 4 + threadIdx.x] =
        (uint32_t)(sh[threadIdx.x][0] % bb::P);
}

__global__ void k_eval_final(const uint32_t* __restrict__ partial, int G,
                             int rows, uint32_t* __restrict__ out) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * 4) return;
  int r = t / 4, k = t % 4;
  unsigned long long s = 0;
  for (int g = 0; g < G; ++g) s += partial[((long long)r * G + g) * 4 + k];
  out[t] = (uint32_t)(s % bb::P);
}

}  // namespace

extern "C" {

// small (blk, 4), big (ceil(n / blk), 4) -> out (n, 4)
int ext_powers_table(const void* small, const void* big, void* out,
                     long long n, int blk, cudaStream_t stream) {
  if (n > 0) {
    k_table<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        (const uint32_t*)small, (const uint32_t*)big, (uint32_t*)out, n, blk);
  }
  return (int)cudaGetLastError();
}

// coeffs: element (r, i, k) at r*row_stride + i*idx_stride + k*coord_stride
// for rows r < rows, i < n; partial (rows, G, 4) scratch -> out (rows, 4)
int ext_poly_eval(const void* coeffs, long long row_stride,
                  long long idx_stride, long long coord_stride,
                  const void* small, const void* big, int blk, long long n,
                  int rows, int G, void* partial, void* out,
                  cudaStream_t stream) {
  if (rows <= 0) return 0;
  dim3 grid((unsigned)G, (unsigned)rows);
  k_eval_partial<<<grid, kThreads, 0, stream>>>(
      (const uint32_t*)coeffs, row_stride, idx_stride, coord_stride,
      (const uint32_t*)small, (const uint32_t*)big, blk, n,
      (uint32_t*)partial);
  int t = rows * 4;
  k_eval_final<<<(t + 127) / 128, 128, 0, stream>>>(
      (const uint32_t*)partial, G, rows, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
