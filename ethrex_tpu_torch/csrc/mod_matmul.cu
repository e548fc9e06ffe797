// K3: exact modular matmul (n, k) @ (k, m) mod p for small m (<= 8).
//
// Replaces the jax.jit program ethrex_tpu/ops/babybear.py:191
// `mod_matmul` (16 bf16 limb matmuls on the TPU's matrix unit) in both its
// semantics: montgomery=1 takes and returns Montgomery form, montgomery=0
// canonical values.
//
// Arithmetic: raw 32 x 32 -> 64-bit products, each one multiply-add into
// a 64-bit accumulator (bb::mad, one IMAD.WIDE.U32), folded below 2^60
// after every fourth term (bb::fold, one more) and reduced once per output
// (bb::redc): 1.25 wide multiplies a product where a Montgomery product
// per term took three multiplies.  In Montgomery mode redc of the sum of
// (aR)(bR) is the Montgomery form of sum ab; in canonical mode the redc
// leaves (sum ab) R^{-1}, and one product by R^2 restores sum ab.  The
// same accumulator runs in the generated constraint kernels' alpha
// combination (stark/air_codegen.py combine).
//
// Two shapes run on the prover's path:
//  * tall and narrow: the DEEP phase's LDE rows (2^21..2^25, w) read in
//    place from the (w, N) columns, at both openings' gamma powers at
//    once (m = 8), and the fused step's (N, 64) @ (64, 4).  One thread
//    owns a row; b is staged in shared memory KTILE rows at a time and
//    read by broadcast; ROWS_UNROLL loads of a are in flight per thread
//    (the loop over k issues them before it multiplies).
//  * short with a huge k: the open phase's trace coefficients (w, n),
//    w <= 354, n up to 2^22, at both points' power tables (m = 8).  A
//    block takes RG rows and a k-slice of SPLIT_CHUNK; each thread holds
//    the b row of its k position in registers for all RG rows, and the
//    block sums its values through shared memory.  Blocks of one slice
//    are launched together (the row group is the fast grid index), so b
//    is read from HBM once and from L2 by the other row groups.  A second
//    pass sums the slices.
//
// Bound on this card: the tall shapes move 4 w bytes a row and do 8 w raw
// products; at 1.25 wide multiplies a product both bounds are close, so
// the kernel must overlap the loads with the multiplies.
#include "babybear.cuh"

namespace {

constexpr int MAXM = 8;
constexpr int ROWS_THREADS = 128;
constexpr int KTILE = 256;
constexpr int ROWS_UNROLL = 8;
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_UNROLL = 16;
constexpr int SPLIT_CHUNK = SPLIT_THREADS * SPLIT_UNROLL;

// rows a split-k block takes: at most 32 accumulators a thread
__host__ __device__ constexpr int rows_per_group(int M) {
  return M >= 4 ? 32 / M : 8;
}

__device__ __forceinline__ uint32_t finish(uint64_t acc, int montgomery) {
  uint32_t r = bb::redc(bb::fold(acc));
  return montgomery ? r : bb::mul(r, bb::R2);
}

template <int M>
__device__ __forceinline__ void load_row(const uint32_t* s, uint32_t* v) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      uint4 w = reinterpret_cast<const uint4*>(s)[q];
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) v[j] = s[j];
  }
}

template <int M>
__global__ void __launch_bounds__(ROWS_THREADS)
    k_rows(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, long long n, long long k, long long rs,
           long long cs, int montgomery) {
  __shared__ __align__(16) uint32_t sb[KTILE * M];
  const long long i = (long long)blockIdx.x * ROWS_THREADS + threadIdx.x;
  const bool live = i < n;
  const uint32_t* row = a + (live ? i : 0) * rs;
  uint64_t acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = 0;
  for (long long k0 = 0; k0 < k; k0 += KTILE) {
    const int kt = (int)(k - k0 < KTILE ? k - k0 : KTILE);
    __syncthreads();
    for (int t = threadIdx.x; t < kt * M; t += ROWS_THREADS)
      sb[t] = __ldg(b + k0 * M + t);
    __syncthreads();
    if (!live) continue;
    const uint32_t* ak = row + k0 * cs;
    int kk = 0;
    // acc < 2^60 at the top of each step: fold after every 4 terms
    for (; kk + ROWS_UNROLL <= kt; kk += ROWS_UNROLL) {
      uint32_t av[ROWS_UNROLL];
#pragma unroll
      for (int u = 0; u < ROWS_UNROLL; ++u)
        av[u] = __ldg(ak + (long long)(kk + u) * cs);
#pragma unroll
      for (int u = 0; u < ROWS_UNROLL; ++u) {
        uint32_t bv[M];
        load_row<M>(sb + (kk + u) * M, bv);
#pragma unroll
        for (int j = 0; j < M; ++j) acc[j] = bb::mad(av[u], bv[j], acc[j]);
        if (u % 4 == 3) {
#pragma unroll
          for (int j = 0; j < M; ++j) acc[j] = bb::fold(acc[j]);
        }
      }
    }
    for (; kk < kt; ++kk) {
      uint32_t av = __ldg(ak + (long long)kk * cs);
      uint32_t bv[M];
      load_row<M>(sb + kk * M, bv);
#pragma unroll
      for (int j = 0; j < M; ++j)
        acc[j] = bb::fold(bb::mad(av, bv[j], acc[j]));
    }
  }
  if (!live) return;
  uint32_t r[M];
#pragma unroll
  for (int j = 0; j < M; ++j) r[j] = finish(acc[j], montgomery);
  uint32_t* o = out + i * M;
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q)
      reinterpret_cast<uint4*>(o)[q] =
          make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) o[j] = r[j];
  }
}

// grid (row groups, splits): block (g, s) sums the products of rows
// [g RG, g RG + RG) over k-slice s into part[(row * splits + s) * M + j]
// (canonical, R^{-1} times the raw sum)
template <int M>
__global__ void __launch_bounds__(SPLIT_THREADS)
    k_splitk(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             uint32_t* __restrict__ part, long long n, long long k,
             long long rs, long long cs, int splits) {
  constexpr int RG = rows_per_group(M);
  constexpr int V = RG * M;          // values a thread contributes, <= 32
  __shared__ uint32_t sh[SPLIT_THREADS * 33];
  __shared__ unsigned long long sh2[SPLIT_THREADS / 32][32];
  const long long r0 = (long long)blockIdx.x * RG;
  const int s = blockIdx.y;
  const long long k0 = (long long)s * SPLIT_CHUNK;
  uint64_t acc[RG][M];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int j = 0; j < M; ++j) acc[r][j] = 0;
#pragma unroll 4
  for (int u = 0; u < SPLIT_UNROLL; ++u) {
    const long long kk = k0 + (long long)u * SPLIT_THREADS + threadIdx.x;
    if (kk < k) {
      uint32_t bv[M];
#pragma unroll
      for (int j = 0; j < M; ++j) bv[j] = __ldg(b + kk * M + j);
      uint32_t av[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r)
        av[r] = r0 + r < n ? __ldg(a + (r0 + r) * rs + kk * cs) : 0u;
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int j = 0; j < M; ++j)
          acc[r][j] = bb::mad(av[r], bv[j], acc[r][j]);
    }
    if (u % 4 == 3) {
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int j = 0; j < M; ++j) acc[r][j] = bb::fold(acc[r][j]);
    }
  }
  // thread t's V values into row t of a 33-word-stride table (no bank
  // conflicts either way), then 32-row column sums, then 8
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int j = 0; j < M; ++j)
      sh[threadIdx.x * 33 + r * M + j] = bb::redc(bb::fold(acc[r][j]));
  __syncthreads();
  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  if (c < V) {
    unsigned long long t = 0;
#pragma unroll 8
    for (int q = 0; q < 32; ++q) t += sh[(g * 32 + q) * 33 + c];
    sh2[g][c] = t;
  }
  __syncthreads();
  if (threadIdx.x < V) {
    unsigned long long t = 0;
#pragma unroll
    for (int q = 0; q < SPLIT_THREADS / 32; ++q) t += sh2[q][threadIdx.x];
    const int r = threadIdx.x / M, j = threadIdx.x % M;
    if (r0 + r < n)
      part[((r0 + r) * splits + s) * M + j] = (uint32_t)(t % bb::P);
  }
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
  uint32_t r = (uint32_t)(acc % bb::P);
  out[t] = montgomery ? r : bb::mul(r, bb::R2);
}

template <int M>
void launch_rows(const void* a, const void* b, void* out, long long n,
                 long long k, long long rs, long long cs, int montgomery,
                 cudaStream_t stream) {
  k_rows<M><<<(unsigned)((n + ROWS_THREADS - 1) / ROWS_THREADS),
              ROWS_THREADS, 0, stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, k, rs, cs,
      montgomery);
}

template <int M>
void launch_splitk(const void* a, const void* b, void* part, long long n,
                   long long k, long long rs, long long cs, int splits,
                   cudaStream_t stream) {
  constexpr int RG = rows_per_group(M);
  dim3 grid((unsigned)((n + RG - 1) / RG), (unsigned)splits);
  k_splitk<M><<<grid, SPLIT_THREADS, 0, stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)part, n, k, rs, cs,
      splits);
}

#define MM_DISPATCH(FN, ...)                     \
  switch (m) {                                   \
    case 1: FN<1>(__VA_ARGS__); break;           \
    case 2: FN<2>(__VA_ARGS__); break;           \
    case 3: FN<3>(__VA_ARGS__); break;           \
    case 4: FN<4>(__VA_ARGS__); break;           \
    case 5: FN<5>(__VA_ARGS__); break;           \
    case 6: FN<6>(__VA_ARGS__); break;           \
    case 7: FN<7>(__VA_ARGS__); break;           \
    default: FN<8>(__VA_ARGS__); break;          \
  }

}  // namespace

extern "C" {

// b (k, m) contiguous; out (n, m) contiguous; a read at a[i rs + kk cs]
int mod_matmul_rows(const void* a, const void* b, void* out, long long n,
                    long long k, int m, long long rs, long long cs,
                    int montgomery, cudaStream_t stream) {
  if (m < 1 || m > MAXM) return (int)cudaErrorInvalidValue;
  if (n > 0) MM_DISPATCH(launch_rows, a, b, out, n, k, rs, cs, montgomery,
                         stream)
  return (int)cudaGetLastError();
}

// splits = ceil(k / SPLIT_CHUNK); part (n, splits, m) scratch
int mod_matmul_splitk(const void* a, const void* b, void* part, void* out,
                      long long n, long long k, int m, long long rs,
                      long long cs, int splits, int montgomery,
                      cudaStream_t stream) {
  if (m < 1 || m > MAXM || splits > 65535 ||
      (long long)splits * SPLIT_CHUNK < k)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    MM_DISPATCH(launch_splitk, a, b, part, n, k, rs, cs, splits, stream)
    long long outs = n * m;
    k_splitk_finish<<<(unsigned)((outs + 127) / 128), 128, 0, stream>>>(
        (const uint32_t*)part, (uint32_t*)out, n, m, splits, montgomery);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
