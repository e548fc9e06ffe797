// K4: one FRI fold of a quartic-extension codeword,
//   f'(x^2) = (f(x) + f(-x))/2 + beta * (f(x) - f(-x)) / (2x),
// read from the lo/hi halves of the (2^k, 4) codeword and written as the
// (2^(k-1), 4) folded codeword.
//
// Replaces the jax.jit program ethrex_tpu/ops/fri.py:49 `_fold`.  Inputs:
// beta (4 Montgomery coordinates), the inverse domain points of the first
// half (fri.py:39-46) and 1/2, all Montgomery.  The extension product by
// beta (x^4 = 11) is inlined from babybear.cuh.
//
// Bound on this card: memory; one fused elementwise pass reads 5 words and
// writes 4 per output row, where the unfused version makes a dozen passes.
#include "babybear.cuh"

namespace {

__global__ void k_fold(const uint32_t* __restrict__ cw,
                       const uint32_t* __restrict__ beta,
                       const uint32_t* __restrict__ inv_pts,
                       const uint32_t* __restrict__ inv2_p,
                       uint32_t* __restrict__ out, long long half) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= half) return;
  uint4 lo = reinterpret_cast<const uint4*>(cw)[i];
  uint4 hi = reinterpret_cast<const uint4*>(cw)[i + half];
  uint32_t inv2 = inv2_p[0];
  uint32_t dscale = bb::mul(inv2, inv_pts[i]);
  uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w};
  uint32_t h[4] = {hi.x, hi.y, hi.z, hi.w};
  uint32_t s[4], d[4], bd[4], bt[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[c] = bb::mul(bb::add(l[c], h[c]), inv2);
    d[c] = bb::mul(bb::sub(l[c], h[c]), dscale);
    bt[c] = beta[c];
  }
  bb::ext_mul(bt, d, bd);
  reinterpret_cast<uint4*>(out)[i] =
      make_uint4(bb::add(s[0], bd[0]), bb::add(s[1], bd[1]),
                 bb::add(s[2], bd[2]), bb::add(s[3], bd[3]));
}

}  // namespace

extern "C" {

int fri_fold(const void* codeword, const void* beta, const void* inv_pts,
             const void* inv2, void* out, long long half,
             cudaStream_t stream) {
  if (half > 0) {
    k_fold<<<(unsigned)((half + 255) / 256), 256, 0, stream>>>(
        (const uint32_t*)codeword, (const uint32_t*)beta,
        (const uint32_t*)inv_pts, (const uint32_t*)inv2, (uint32_t*)out,
        half);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
