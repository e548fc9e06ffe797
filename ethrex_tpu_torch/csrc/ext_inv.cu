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
// ext_batch_inv: K7's block inversion (batch_inv.cu `block_inv`) carried
// into the extension.  A block takes THREADS x CHUNK elements; thread t
// loads its CHUNK elements THREADS apart (a warp's 16-byte loads are
// contiguous) into registers and keeps their running products there.
// Inclusive prefix and suffix products of the threads' products, by
// shuffles of the four words within a warp and then over the warps'
// products in warp 0, give every thread the product of all the others,
// so one norm-trick inverse of the block's product serves the block.
// Each element is read once and its inverse written once; nothing
// intermediate goes to device memory.  A zero element, or one past n, is
// left out of the products (a product by one) and gets 0, as the
// element-wise inverse gives it; an all-zero chunk, warp or block
// included.  Inverses are unique, so both kernels equal the reference on
// every nonzero input.
//
// Bound on this card: the products against one read and one write of 16
// bytes an element.  ext_inv: about 114 Montgomery products an element.
// ext_batch_inv: one ext product an element forward and two backward,
// and one ext inverse.  Its ext products are lazy (16 raw products, a
// fold and a reduction a coordinate, with W b made once for the b it
// multiplies: W x forward, W inv once for both backward), so 48 raw
// products, 12 reductions and 6 Montgomery products an element; the
// scans add 12 ext products a thread, 1.5 an element at CHUNK = 8.
#include "babybear.cuh"

namespace {

constexpr int THREADS = 128;    // threads a block of k_ext_batch_inv
constexpr int CHUNK = 8;        // elements a thread
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

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

// c = a b in F_p[x]/(x^4 - W), wb = W b (wb[0] unused): four raw
// products a coordinate summed lazily (at most 4 (p - 1)^2 < 2^64), one
// bb::fold (below 2^60 < p 2^32) and one bb::redc each
__device__ __forceinline__ void ext_mul_w(const uint32_t a[4],
                                          const uint32_t b[4],
                                          const uint32_t wb[4],
                                          uint32_t c[4]) {
  c[0] = bb::redc(bb::fold(bb::mad(a[0], b[0], bb::mad(a[1], wb[3],
         bb::mad(a[2], wb[2], (uint64_t)a[3] * wb[1])))));
  c[1] = bb::redc(bb::fold(bb::mad(a[0], b[1], bb::mad(a[1], b[0],
         bb::mad(a[2], wb[3], (uint64_t)a[3] * wb[2])))));
  c[2] = bb::redc(bb::fold(bb::mad(a[0], b[2], bb::mad(a[1], b[1],
         bb::mad(a[2], b[0], (uint64_t)a[3] * wb[3])))));
  c[3] = bb::redc(bb::fold(bb::mad(a[0], b[3], bb::mad(a[1], b[2],
         bb::mad(a[2], b[1], (uint64_t)a[3] * b[0])))));
}

__device__ __forceinline__ void times_w(const uint32_t b[4], uint32_t wb[4]) {
  wb[0] = 0u;
#pragma unroll
  for (int m = 1; m < 4; ++m) wb[m] = bb::mul(b[m], bb::W_M);
}

// a <- a b
__device__ __forceinline__ void mul_into(uint32_t a[4], const uint32_t b[4]) {
  uint32_t wb[4], c[4];
  times_w(b, wb);
  ext_mul_w(a, b, wb, c);
#pragma unroll
  for (int m = 0; m < 4; ++m) a[m] = c[m];
}

__device__ __forceinline__ void set_one(uint32_t a[4]) {
  a[0] = bb::MONT_ONE;
  a[1] = a[2] = a[3] = 0u;
}

// inclusive prefix (inc) and suffix (suf) products over the lanes below
// `lanes` (a power of two), Hillis-Steele: at step d, lane l takes lane
// l - d's prefix and lane l + d's suffix where they exist, one otherwise
__device__ __forceinline__ void warp_scans(uint32_t inc[4], uint32_t suf[4],
                                           int lane, int lanes) {
#pragma unroll
  for (int d = 1; d < lanes; d <<= 1) {
    uint32_t u[4], w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      u[m] = __shfl_up_sync(FULL, inc[m], d);
      w[m] = __shfl_down_sync(FULL, suf[m], d);
    }
    if (lane < d) set_one(u);
    if (lane + d >= 32) set_one(w);
    mul_into(inc, u);
    mul_into(suf, w);
  }
}

__global__ void __launch_bounds__(THREADS)
k_ext_batch_inv(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                long long n, Frob fr) {
  __shared__ uint32_t smem[2 * WARPS][4];
  const long long base =
      (long long)blockIdx.x * (THREADS * CHUNK) + threadIdx.x;
  uint32_t v[CHUNK][4], pre[CHUNK][4];
  uint32_t run[4];
  set_one(run);
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const long long i = base + (long long)c * THREADS;
    if (i < n) {
      load4(a + 4 * i, v[c]);
    } else {
      v[c][0] = v[c][1] = v[c][2] = v[c][3] = 0u;
    }
    // the running product before element c; a zero multiplies by one
#pragma unroll
    for (int m = 0; m < 4; ++m) pre[c][m] = run[m];
    uint32_t x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) x[m] = v[c][m];
    if (is_zero(x)) set_one(x);
    mul_into(run, x);
  }
  // the products of the warp's threads before and after this one
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc[4], suf[4], before[4], after[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) inc[m] = suf[m] = run[m];
  warp_scans(inc, suf, lane, 32);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    before[m] = __shfl_up_sync(FULL, inc[m], 1);
    after[m] = __shfl_down_sync(FULL, suf[m], 1);
  }
  if (lane == 0) set_one(before);
  if (lane == 31) {
    set_one(after);
#pragma unroll
    for (int m = 0; m < 4; ++m) smem[warp][m] = inc[m];   // the warp's
  }
  __syncthreads();
  if (warp == 0) {
    // the same over the warps' products (lanes past WARPS hold one), the
    // one inverse of the block's product, and each warp's factor: that
    // inverse times the other warps' products
    uint32_t wi[4], ws[4], wb[4], wa[4], total[4], f[4];
    if (lane < WARPS) {
#pragma unroll
      for (int m = 0; m < 4; ++m) wi[m] = smem[lane][m];
    } else {
      set_one(wi);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) ws[m] = wi[m];
    warp_scans(wi, ws, lane, WARPS);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wb[m] = __shfl_up_sync(FULL, wi[m], 1);
      wa[m] = __shfl_down_sync(FULL, ws[m], 1);
      total[m] = __shfl_sync(FULL, wi[m], WARPS - 1);
    }
    if (lane == 0) set_one(wb);
    ext_inverse(total, fr, f);
    mul_into(f, wb);
    mul_into(f, wa);
    if (lane < WARPS) {
#pragma unroll
      for (int m = 0; m < 4; ++m) smem[WARPS + lane][m] = f[m];
    }
  }
  __syncthreads();
  // the inverse of this thread's product, then of each element, last
  // first: element c's inverse is inv times the product before it
  uint32_t inv[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) inv[m] = smem[WARPS + warp][m];
  mul_into(inv, before);
  mul_into(inv, after);
#pragma unroll
  for (int c = CHUNK - 1; c >= 0; --c) {
    const long long i = base + (long long)c * THREADS;
    uint32_t winv[4], r[4], x[4], next[4];
    times_w(inv, winv);
    ext_mul_w(pre[c], inv, winv, r);
#pragma unroll
    for (int m = 0; m < 4; ++m) x[m] = v[c][m];
    const bool zero = is_zero(x);
    if (zero) {
      set_one(x);
      r[0] = r[1] = r[2] = r[3] = 0u;
    }
    if (i < n) store4(out + 4 * i, r);
    ext_mul_w(x, inv, winv, next);
#pragma unroll
    for (int m = 0; m < 4; ++m) inv[m] = next[m];
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

int ext_batch_inv(const void* a, void* out, long long n, const void* fr,
                  cudaStream_t stream) {
  if (n > 0) {
    const long long per = THREADS * CHUNK;
    k_ext_batch_inv<<<(unsigned)((n + per - 1) / per), THREADS, 0, stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n, frob_from(fr));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
