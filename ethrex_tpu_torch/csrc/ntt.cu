// K1: batched in-order NTT / iNTT over the last axis of a (rows, n) buffer,
// with the coset scaling and zero padding of the LDE fused into its passes.
//
// Replaces the jax.jit programs ethrex_tpu/ops/ntt.py:51 `ntt`/`intt`,
// :92 `coset_lde`, :115 `coset_intt` and :125 `coset_evals_from_coeffs`.
// The wrapper (ethrex_tpu_torch/ops/ntt.py) composes them from three
// entries:
//   ntt_prepare  out[r, i] = pre[j] * in[r, j], j = bitrev(i), or 0 when
//                j >= m_in (the zero pad of the extension);
//   ntt_stages   the log2(n) radix-2 DIT butterfly stages, 11 at a time
//                inside shared memory: the first 11 on contiguous
//                2048-element tiles, the next 11 on tiles of 2048 strided
//                elements x 8 neighbouring columns (so a 2^22 transform
//                makes two passes over memory, not 12);
//   ntt_scale    out[r, i] *= post[i] (1/n times the inverse coset powers).
// Twiddles are precomputed on the host per (log n, direction), as
// ntt.py:37-47 does, and laid out stage by stage (stage s at offset 2^s-1).
//
// Bound on this card: memory traffic and the 32-bit multiplies of the
// butterflies.  The LDE of the state proof reads and writes 115 x 2^22
// words per pass; the two shared-memory passes replace 22 global ones.
// The bit-reversal gather in ntt_prepare reads scattered words; a later
// version can transpose through shared memory instead.
#include "babybear.cuh"

namespace {

constexpr int TILE_LOG = 11;
constexpr int GROUP = 8;

__global__ void k_prepare(const uint32_t* __restrict__ in,
                          uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ pre, long long rows,
                          long long m_in, long long in_stride, int log_n) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = rows << log_n;
  if (idx >= total) return;
  long long r = idx >> log_n;
  uint32_t i = (uint32_t)(idx & ((1ll << log_n) - 1));
  uint32_t j = log_n == 0 ? 0u : (__brev(i) >> (32 - log_n));
  uint32_t v = 0;
  if ((long long)j < m_in) {
    v = in[r * in_stride + j];
    if (pre != nullptr) v = bb::mul(v, pre[j]);
  }
  out[idx] = v;
}

__global__ void k_stages_shared(uint32_t* __restrict__ data,
                                const uint32_t* __restrict__ tw,
                                int tile_log) {
  extern __shared__ uint32_t sh[];
  const int T = 1 << tile_log;
  uint32_t* base = data + (long long)blockIdx.x * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) sh[i] = base[i];
  __syncthreads();
  for (int s = 0; s < tile_log; ++s) {
    const int half = 1 << s;
    const uint32_t* w = tw + (half - 1);
    for (int t = threadIdx.x; t < T / 2; t += blockDim.x) {
      int j = t & (half - 1);
      int i0 = ((t >> s) << (s + 1)) + j;
      uint32_t u = sh[i0];
      uint32_t v = bb::mul(sh[i0 + half], w[j]);
      sh[i0] = bb::add(u, v);
      sh[i0 + half] = bb::sub(u, v);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) base[i] = sh[i];
}

// Stages [s0, s0 + L) in shared memory.  A tile holds, for one row, the
// elements i = hi * 2^(s0+L) + j * 2^s0 + base0 + g (j < 2^L, g < GROUP):
// every butterfly of those stages pairs two elements of one tile, and the
// GROUP consecutive columns make each global read a full 32-byte sector.
__global__ void k_stages_strided(uint32_t* __restrict__ data,
                                 const uint32_t* __restrict__ tw, int log_n,
                                 int s0, int L) {
  extern __shared__ uint32_t sh[];
  const int T = GROUP << L;
  long long b = blockIdx.x;
  const long long ngroups = (1ll << s0) / GROUP;
  const long long nhi = 1ll << (log_n - s0 - L);
  const long long bg = b % ngroups;
  b /= ngroups;
  const long long hi = b % nhi;
  const long long row = b / nhi;
  uint32_t* base = data + (row << log_n) + (hi << (s0 + L)) + bg * GROUP;
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    sh[t] = base[((long long)(t / GROUP) << s0) + (t % GROUP)];
  __syncthreads();
  for (int ls = 0; ls < L; ++ls) {
    const int half = 1 << ls;
    const uint32_t* w = tw + ((1ll << (s0 + ls)) - 1) + bg * GROUP;
    for (int t = threadIdx.x; t < T / 2; t += blockDim.x) {
      int g = t % GROUP;
      int q = t / GROUP;
      int jl = q & (half - 1);
      int j0 = ((q >> ls) << (ls + 1)) + jl;
      int i0 = j0 * GROUP + g;
      int i1 = i0 + half * GROUP;
      uint32_t u = sh[i0];
      uint32_t v = bb::mul(sh[i1], w[((long long)jl << s0) + g]);
      sh[i0] = bb::add(u, v);
      sh[i1] = bb::sub(u, v);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    base[((long long)(t / GROUP) << s0) + (t % GROUP)] = sh[t];
}

__global__ void k_scale(uint32_t* __restrict__ data,
                        const uint32_t* __restrict__ post, long long rows,
                        int log_n, int scalar) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (rows << log_n)) return;
  uint32_t f = scalar ? post[0] : post[idx & ((1ll << log_n) - 1)];
  data[idx] = bb::mul(data[idx], f);
}

inline unsigned blocks_for(long long threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

int ntt_prepare(const void* in, void* out, const void* pre, long long rows,
                long long m_in, long long in_stride, int log_n, int has_pre,
                cudaStream_t stream) {
  long long total = rows << log_n;
  if (total > 0) {
    k_prepare<<<blocks_for(total, 256), 256, 0, stream>>>(
        (const uint32_t*)in, (uint32_t*)out,
        has_pre ? (const uint32_t*)pre : nullptr, rows, m_in, in_stride,
        log_n);
  }
  return (int)cudaGetLastError();
}

int ntt_stages(void* data, const void* tw, long long rows, int log_n,
               cudaStream_t stream) {
  if (log_n == 0 || rows == 0) return (int)cudaGetLastError();
  uint32_t* d = (uint32_t*)data;
  const uint32_t* w = (const uint32_t*)tw;
  int tile_log = log_n < TILE_LOG ? log_n : TILE_LOG;
  long long tiles = rows << (log_n - tile_log);
  int threads = 1 << (tile_log - 1);
  if (threads < 32) threads = 32;
  k_stages_shared<<<(unsigned)tiles, threads, (1 << tile_log) * 4, stream>>>(
      d, w, tile_log);
  for (int s0 = tile_log; s0 < log_n; s0 += TILE_LOG) {
    int L = log_n - s0 < TILE_LOG ? log_n - s0 : TILE_LOG;
    long long blocks = rows * ((1ll << s0) / GROUP) << (log_n - s0 - L);
    int T = GROUP << L;
    int nthreads = T / 2 < 512 ? (T / 2 < 32 ? 32 : T / 2) : 512;
    int smem = T * 4;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          k_stages_strided, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return (int)err;
    }
    k_stages_strided<<<(unsigned)blocks, nthreads, smem, stream>>>(
        d, w, log_n, s0, L);
  }
  return (int)cudaGetLastError();
}

int ntt_scale(void* data, const void* post, long long rows, int log_n,
              int scalar, cudaStream_t stream) {
  long long total = rows << log_n;
  if (total > 0) {
    k_scale<<<blocks_for(total, 256), 256, 0, stream>>>(
        (uint32_t*)data, (const uint32_t*)post, rows, log_n, scalar);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
