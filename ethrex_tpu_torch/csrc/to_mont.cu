// The trace's upload: a (n, w) matrix of canonical residues, as the host
// generates it, becomes the (w, n) Montgomery columns the prover commits.
//
// Replaces the device conversion ethrex_tpu/ops/babybear.py:117 `to_mont`
// that ethrex_tpu/stark/prover.py:754 runs on the transposed trace (and
// the same conversion of the prover's build-time tables, w = 1).
//
// A block moves a 32 x 32 tile: it reads 32 rows of 32 columns (each read
// a run of consecutive words), multiplies by R^2 (a * R^2 * R^-1 = a R)
// and writes the transposed tile through shared memory, so the writes are
// runs of consecutive words too.  The tile's row stride is 33 words, so
// neither the column reads nor the row writes of shared memory conflict.
//
// Bound on this card: memory, one read and one write of each word.
#include "babybear.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

__global__ void k_to_mont_cols(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, long long n,
                               long long w, long long in_stride) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const long long r0 = (long long)blockIdx.x * kTile;   // rows of in
  const long long c0 = (long long)blockIdx.y * kTile;   // columns of in
  for (int dy = threadIdx.y; dy < kTile; dy += kRowsPerPass) {
    const long long r = r0 + dy, c = c0 + threadIdx.x;
    if (r < n && c < w)
      tile[dy][threadIdx.x] = bb::mul(in[r * in_stride + c], bb::R2);
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < kTile; dy += kRowsPerPass) {
    const long long c = c0 + dy, r = r0 + threadIdx.x;
    if (r < n && c < w) out[c * n + r] = tile[threadIdx.x][dy];
  }
}

}  // namespace

extern "C" {

// in: (n, w) canonical, row stride in_stride -> out: (w, n) Montgomery
int to_mont_cols(const void* in, void* out, long long n, long long w,
                 long long in_stride, cudaStream_t stream) {
  if (n > 0 && w > 0) {
    dim3 grid((unsigned)((n + kTile - 1) / kTile),
              (unsigned)((w + kTile - 1) / kTile));
    k_to_mont_cols<<<grid, dim3(kTile, kRowsPerPass), 0, stream>>>(
        (const uint32_t*)in, (uint32_t*)out, n, w, in_stride);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
