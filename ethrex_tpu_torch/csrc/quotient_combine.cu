// K9: the constraint quotient's combination over the LDE domain, one fused
// pass per point x:
//
//   Q(x) = acc(x) * (x - g^(n-1)) / (x^n - 1)
//        + sum_j (T_cj(x) - b_j) / (x - g^rj) * alpha^(K+j)
//
// Replaces the ext scalar_mul/add chain of the jitted `phase_quotient`,
// ethrex_tpu/stark/prover.py:540-548.  acc is the K3 alpha-combination of
// the constraint block (N, 4); the divisor inverses come from the prover's
// build-time stack [1/(x^n - 1) per coset class (B), 1/(x - g^(n-1)) (N),
// 1/(x - g^rj) per boundary (nb x N)]; the first is read at i mod B, so no
// (N,) tile of it is made.  The boundary columns c_j are read in place
// from the column-major LDE (w, N).
//
// Bound on this card: memory.  Per point it reads acc (4 words), x - g^(n-1),
// and per boundary one LDE word and one inverse, and writes 4 words; 5 +
// 6 nb Montgomery products.
#include "babybear.cuh"

namespace {

__global__ void k_quotient(const uint32_t* __restrict__ acc,
                           const uint32_t* __restrict__ xm,
                           const uint32_t* __restrict__ inv_stack,
                           const uint32_t* __restrict__ lde,
                           const int* __restrict__ cols,
                           const uint32_t* __restrict__ bvals,
                           const uint32_t* __restrict__ apow,
                           uint32_t* __restrict__ out, long long N, int B,
                           int nb) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t s = bb::mul(xm[i], inv_stack[i & (B - 1)]);
  uint4 a = reinterpret_cast<const uint4*>(acc)[i];
  uint32_t q[4] = {bb::mul(a.x, s), bb::mul(a.y, s), bb::mul(a.z, s),
                   bb::mul(a.w, s)};
  const uint32_t* inv_b = inv_stack + B + N;
  for (int j = 0; j < nb; ++j) {
    uint32_t d = bb::sub(lde[(long long)cols[j] * N + i], bvals[j]);
    uint32_t t = bb::mul(d, inv_b[(long long)j * N + i]);
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = bb::add(q[k], bb::mul(t, apow[4 * j + k]));
  }
  reinterpret_cast<uint4*>(out)[i] = make_uint4(q[0], q[1], q[2], q[3]);
}

}  // namespace

extern "C" {

// acc (N, 4), xm (N,), inv_stack (B + N + nb N,), lde (w, N), cols (nb,)
// int32, bvals (nb,), apow (nb, 4) -> out (N, 4); B a power of two
int quotient_combine(const void* acc, const void* xm, const void* inv_stack,
                     const void* lde, const void* cols, const void* bvals,
                     const void* apow, void* out, long long N, int B, int nb,
                     cudaStream_t stream) {
  if (N > 0) {
    k_quotient<<<(unsigned)((N + 255) / 256), 256, 0, stream>>>(
        (const uint32_t*)acc, (const uint32_t*)xm,
        (const uint32_t*)inv_stack, (const uint32_t*)lde, (const int*)cols,
        (const uint32_t*)bvals, (const uint32_t*)apow, (uint32_t*)out, N, B,
        nb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
