// Inverses in the quartic extension F_p[x]/(x^4 - 11), element-wise and
// batched.  Test-only helpers of the reference: no prover path calls them.
//
// Replaces the jax.jit programs ethrex_tpu/ops/ext.py:183 `ext_inv_device`
// (the norm trick) and :209 `batch_inv` (Montgomery's trick over two
// associative scans).
//
// ext_inv: per element a, the three other conjugates a^p, a^(p^2),
// a^(p^3) are coordinate-wise products with the Frobenius constants, their
// product is conj, and N(a) = (a conj)_0 lies in the base field; then
// a^-1 = conj * N(a)^(p-2): one base-field Fermat power per element.
//
// ext_batch_inv: thread t owns the elements t, t + T, t + 2T, ... (chunk
// of them, so a warp's loads are contiguous), as K7 (batch_inv.cu) does
// in the base field: a forward pass writes each element's prefix product
// into out, one norm-trick inverse of the running product, and a backward
// pass turns every prefix into the element's inverse.  A zero element is
// skipped and gets 0, as the element-wise inverse gives it.  Inverses are
// unique, so both kernels equal the reference on every nonzero input.
//
// Bound on this card: the products (element-wise about 110 a word; batched
// 48 a word plus one inverse a chunk) against one read and one write of
// 16 bytes.
#include "babybear.cuh"

namespace {

struct Frob {
  uint32_t f[3][4];   // coordinate j of a^(p^k) is a_j f[k-1][j]
};

__device__ __forceinline__ void load4(const uint32_t* src, uint32_t a[4]) {
  uint4 v = *reinterpret_cast<const uint4*>(src);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void store4(uint32_t* dst, const uint32_t a[4]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(a[0], a[1], a[2], a[3]);
}

// a^-1 (0 for a = 0: the Fermat power of a zero norm is 0)
__device__ __forceinline__ void ext_inverse(const uint32_t a[4],
                                            const Frob& fr, uint32_t r[4]) {
  uint32_t c1[4], c2[4], c3[4], t[4], conj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c1[j] = bb::mul(a[j], fr.f[0][j]);
    c2[j] = bb::mul(a[j], fr.f[1][j]);
    c3[j] = bb::mul(a[j], fr.f[2][j]);
  }
  bb::ext_mul(c1, c2, t);
  bb::ext_mul(t, c3, conj);
  // (a conj)_0 = a0 c0 + W (a1 c3 + a2 c2 + a3 c1)
  const uint32_t tail = bb::add(bb::add(bb::mul(a[1], conj[3]),
                                        bb::mul(a[2], conj[2])),
                                bb::mul(a[3], conj[1]));
  const uint32_t norm = bb::add(bb::mul(a[0], conj[0]),
                                bb::mul(tail, bb::W_M));
  const uint32_t inv = bb::mpow(norm, bb::P - 2u);
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = bb::mul(conj[j], inv);
}

__device__ __forceinline__ bool is_zero(const uint32_t a[4]) {
  return (a[0] | a[1] | a[2] | a[3]) == 0u;
}

__global__ void k_ext_inv(const uint32_t* __restrict__ a,
                          uint32_t* __restrict__ out, long long n, Frob fr) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[4], r[4];
  load4(a + 4 * i, x);
  ext_inverse(x, fr, r);
  store4(out + 4 * i, r);
}

__global__ void k_ext_batch_inv(const uint32_t* __restrict__ a,
                                uint32_t* __restrict__ out, long long n,
                                long long threads, int chunk, Frob fr) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  uint32_t acc[4] = {bb::MONT_ONE, 0u, 0u, 0u};
  int cnt = 0;
  for (long long i = t; i < n && cnt < chunk; i += threads, ++cnt) {
    uint32_t x[4], y[4];
    load4(a + 4 * i, x);
    store4(out + 4 * i, acc);
    if (!is_zero(x)) {
      bb::ext_mul(acc, x, y);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = y[j];
    }
  }
  uint32_t inv[4];
  ext_inverse(acc, fr, inv);
  for (int k = cnt - 1; k >= 0; --k) {
    const long long i = t + (long long)k * threads;
    uint32_t x[4], pre[4], r[4];
    load4(a + 4 * i, x);
    if (is_zero(x)) {
      const uint32_t z[4] = {0u, 0u, 0u, 0u};
      store4(out + 4 * i, z);
      continue;
    }
    load4(out + 4 * i, pre);
    bb::ext_mul(inv, pre, r);
    store4(out + 4 * i, r);
    bb::ext_mul(inv, x, r);
#pragma unroll
    for (int j = 0; j < 4; ++j) inv[j] = r[j];
  }
}

Frob frob_from(const void* host_fr) {
  Frob fr;
  const uint32_t* f = (const uint32_t*)host_fr;
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 4; ++j) fr.f[k][j] = f[4 * k + j];
  return fr;
}

}  // namespace

extern "C" {

// a, out: (n, 4) Montgomery; fr: 12 host words, the Frobenius constants of
// a^p, a^(p^2), a^(p^3) (Montgomery), passed by value to the kernel
int ext_inv(const void* a, void* out, long long n, const void* fr,
            cudaStream_t stream) {
  if (n > 0) {
    k_ext_inv<<<(unsigned)((n + 127) / 128), 128, 0, stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n, frob_from(fr));
  }
  return (int)cudaGetLastError();
}

int ext_batch_inv(const void* a, void* out, long long n, int chunk,
                  const void* fr, cudaStream_t stream) {
  if (n > 0) {
    long long threads = (n + chunk - 1) / chunk;
    k_ext_batch_inv<<<(unsigned)((threads + 127) / 128), 128, 0, stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n, threads, chunk,
        frob_from(fr));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
