// K11: the power tables of one or two extension points, and extension-
// coefficient polynomials at the first of them, in one pass over i.
//
// Replaces ethrex_tpu/ops/ext.py:175 `eval_ext_poly_at_ext` (sum_i c_i z^i
// over ext coefficients: the quotient chunks at zeta,
// ethrex_tpu/stark/prover.py:562) and the power tables of ops/ext.py:88
// `ext_powers_blocked` ([1, z, ..., z^(n-1)], (n, 4), for zeta and zeta g,
// that kernel K3 contracts with the trace's coefficients, prover.py:
// 560-561).  The open phase makes both tables, in the column blocks of
// K3's (n, 8) operand, and the B chunk sums in one launch.
//
// Powers.  Thread t of the S = blocks x THREADS threads of a launch takes
// the rows i = t, t + S, t + 2S, ...: it starts from z^t, the product of
// the binary powers z^(2^j) over the bits of t (j = t's bit index: a shift
// and a mask), and steps by z^S, one ext product a row and point.  Each
// block first squares its points into shared memory, one thread a point.
// The powers of one point are unique, so any chain of products gives the
// reference's values, and the host builds no table.
//
// Sums.  c_b[i] z^i adds into a lazy 64-bit sum a chunk and coordinate
// (bb::mad, with W z made once a row for all chunks): four raw products
// a row onto a sum below 2^60, then a bb::fold, and 2^60 + 4 (p - 1)^2 <
// 2^64 (babybear.cuh), so no sum wraps, whatever n.  A thread reduces each
// sum once (bb::redc), the block adds the residues mod p (shuffles, then
// shared memory), and each block adds its residues into 64-bit sums in
// device memory (atomicAdd): below blocks x p < 2^63 for any grid of fewer
// than 2^32 blocks, so exact; the last block to finish reduces them mod
// p.  An integer sum is exact in any order, so the result does not depend
// on the order in which the blocks add.  Overflow bound for every n (2^25
// and beyond): the per-thread sums restart below 2^60 each row, and the
// device sums grow with the blocks, not with n.
//
// Bound on this card: bytes at the path's shapes (B n 16 read, NP n 16
// written); the products, 2 ext products a row for the powers and 16 B
// raw products a row, take about two thirds of that time.  The block
// count is one wave of resident blocks (the occupancy API), so a thread
// takes n / S rows and its start-up (squarings, z^t) is paid once.  A
// thread loads row i + S's chunk words before it computes row i's: with
// one block of 256 threads an SM (the registers of 8 x 4 sums and two
// rows of words), that keeps the loads in flight, where loading each
// chunk's words as it was used left the kernel waiting on them.
#include "babybear.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNKS = 8;      // chunk sums a thread keeps; grid.y takes
                               // the next CHUNKS chunks
constexpr int MAX_BITS = 40;   // binary powers z^(2^j) a block keeps

struct Points {
  uint32_t z[2][4];            // Montgomery
};

// a <- a b (b may not alias a)
__device__ __forceinline__ void mul_into(uint32_t a[4], const uint32_t b[4]) {
  uint32_t c[4];
  bb::ext_mul(a, b, c);
#pragma unroll
  for (int m = 0; m < 4; ++m) a[m] = c[m];
}

// acc += a b in F_p[x]/(x^4 - W), wb = W b: four raw products a
// coordinate, then a fold, so acc enters below 2^60 and leaves below it
__device__ __forceinline__ void ext_mad(const uint32_t a[4],
                                        const uint32_t b[4],
                                        const uint32_t wb[4],
                                        uint64_t acc[4]) {
  acc[0] = bb::fold(bb::mad(a[0], b[0], bb::mad(a[1], wb[3],
           bb::mad(a[2], wb[2], bb::mad(a[3], wb[1], acc[0])))));
  acc[1] = bb::fold(bb::mad(a[0], b[1], bb::mad(a[1], b[0],
           bb::mad(a[2], wb[3], bb::mad(a[3], wb[2], acc[1])))));
  acc[2] = bb::fold(bb::mad(a[0], b[2], bb::mad(a[1], b[1],
           bb::mad(a[2], b[0], bb::mad(a[3], wb[3], acc[2])))));
  acc[3] = bb::fold(bb::mad(a[0], b[3], bb::mad(a[1], b[2],
           bb::mad(a[2], b[1], bb::mad(a[3], b[0], acc[3])))));
}

// chunk words of row i (CHUNKS x 4, the first nb chunks of the group)
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ chunks,
                                         long long rs, long long is,
                                         long long cs, int g0, int nb,
                                         long long i, uint32_t cv[][4]) {
#pragma unroll
  for (int b = 0; b < CHUNKS; ++b) {
    if (b < nb) {
      const uint32_t* c = chunks + (long long)(g0 + b) * rs + i * is;
#pragma unroll
      for (int m = 0; m < 4; ++m) cv[b][m] = __ldg(c + m * cs);
    }
  }
}

// NP points; the table (if any) holds point p's powers in words 4p..4p+3
// of each row; the chunks (nchunks > 0) are evaluated at point 0.
template <int NP>
__global__ void __launch_bounds__(THREADS)
k_open(const Points pts, uint32_t* __restrict__ table, long long tstride,
       long long n, const uint32_t* __restrict__ chunks, long long rs,
       long long is, long long cs, int nchunks,
       unsigned long long* __restrict__ sums, unsigned* __restrict__ done,
       uint32_t* __restrict__ out) {
  __shared__ uint32_t pw[NP][MAX_BITS][4];      // z_p^(2^j)
  __shared__ uint32_t stp[NP][4];               // z_p^S
  __shared__ uint32_t red[THREADS / 32][4 * CHUNKS];
  __shared__ bool last;
  const long long S = (long long)gridDim.x * THREADS;
  const int L = 64 - __clzll(S);                // bits of S: t < S
  if (threadIdx.x < NP) {
    const int p = threadIdx.x;
    uint32_t a[4], s[4] = {bb::MONT_ONE, 0u, 0u, 0u};
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = pts.z[p][m];
    for (int j = 0; j < L; ++j) {
#pragma unroll
      for (int m = 0; m < 4; ++m) pw[p][j][m] = a[m];
      if ((S >> j) & 1) mul_into(s, a);
      if (j + 1 < L) {
        uint32_t b[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) b[m] = a[m];
        mul_into(a, b);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) stp[p][m] = s[m];
  }
  __syncthreads();
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  uint32_t z[NP][4], st[NP][4];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    z[p][0] = bb::MONT_ONE;
    z[p][1] = z[p][2] = z[p][3] = 0u;
#pragma unroll
    for (int m = 0; m < 4; ++m) st[p][m] = stp[p][m];
    for (int j = 0; j < L; ++j)
      if ((t >> j) & 1) mul_into(z[p], pw[p][j]);
  }
  const bool write = table != nullptr && blockIdx.y == 0;
  const int g0 = blockIdx.y * CHUNKS;
  const int nb = min(CHUNKS, nchunks - g0);     // <= 0: no chunks
  uint64_t acc[CHUNKS][4];
#pragma unroll
  for (int b = 0; b < CHUNKS; ++b)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[b][m] = 0;
  // the chunk words of the row in hand; the next row's are loaded before
  // this one's products, so a warp keeps its loads in flight while it
  // computes
  uint32_t cv[CHUNKS][4];
  if (nb > 0 && t < n) load_row(chunks, rs, is, cs, g0, nb, t, cv);
  for (long long i = t; i < n; i += S) {
    uint32_t nx[CHUNKS][4];
    if (nb > 0 && i + S < n) load_row(chunks, rs, is, cs, g0, nb, i + S, nx);
    if (write) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        *reinterpret_cast<uint4*>(table + i * tstride + 4 * p) =
            make_uint4(z[p][0], z[p][1], z[p][2], z[p][3]);
    }
    if (nb > 0) {
      uint32_t wz[4];
      wz[0] = 0u;
#pragma unroll
      for (int m = 1; m < 4; ++m) wz[m] = bb::mul(z[0][m], bb::W_M);
#pragma unroll
      for (int b = 0; b < CHUNKS; ++b)
        if (b < nb) ext_mad(cv[b], z[0], wz, acc[b]);
#pragma unroll
      for (int b = 0; b < CHUNKS; ++b)
#pragma unroll
        for (int m = 0; m < 4; ++m) cv[b][m] = nx[b][m];
    }
    if (i + S < n) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (write || p == 0) mul_into(z[p], st[p]);
    }
  }
  if (nb <= 0) return;
  // the block's sums mod p: lane (b, m) of warp 0 ends with chunk b's
  // coordinate m
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < CHUNKS; ++b) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t v = b < nb ? bb::redc(acc[b][m]) : 0u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v = bb::add(v, __shfl_down_sync(0xffffffffu, v, o));
      if (lane == 0) red[warp][4 * b + m] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t v = 0u;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) v = bb::add(v, red[w][lane]);
    if (lane < 4 * nb) atomicAdd(sums + 4 * g0 + lane, (unsigned long long)v);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int w = threadIdx.x; w < 4 * nchunks; w += THREADS)
    out[w] = (uint32_t)(atomicAdd(sums + w, 0ull) % bb::P);
}

template <int NP>
int launch(const Points& pts, uint32_t* table, long long tstride, long long n,
           const uint32_t* chunks, long long rs, long long is, long long cs,
           int nchunks, unsigned long long* sums, unsigned* done,
           uint32_t* out, cudaStream_t stream) {
  static int wave = 0;          // resident blocks of the card (one device)
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_open<NP>,
                                                  THREADS, 0);
    wave = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long need = (n + THREADS - 1) / THREADS;
  const int gx = (int)(need < wave ? need : wave);
  const int gy = nchunks > CHUNKS ? (nchunks + CHUNKS - 1) / CHUNKS : 1;
  k_open<NP><<<dim3((unsigned)gx, (unsigned)gy), THREADS, 0, stream>>>(
      pts, table, tstride, n, chunks, rs, is, cs, nchunks, sums, done, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// np points z (np x 4 Montgomery words, np = 1 or 2) over rows i < n:
// table (nullable) row i at word i * tstride (a multiple of 4, 16-byte
// aligned) gets z_p^i in words 4p..4p+3; with nchunks > 0, chunk b's
// coefficient (i, k) at b * rs + i * is + k * cs, and out (nchunks, 4)
// gets sum_i c_b[i] z_0^i.  sums (4 nchunks 64-bit words) and done (one
// 32-bit word) are zeroed scratch.
int ext_open(const void* points, int np, void* table, long long tstride,
             long long n, const void* chunks, long long rs, long long is,
             long long cs, int nchunks, void* sums, void* done, void* out,
             cudaStream_t stream) {
  if (np < 1 || np > 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Points pts = {};
  const uint32_t* z = (const uint32_t*)points;
  for (int p = 0; p < np; ++p)
    for (int m = 0; m < 4; ++m) pts.z[p][m] = z[4 * p + m];
  if (np == 2)
    return launch<2>(pts, (uint32_t*)table, tstride, n,
                     (const uint32_t*)chunks, rs, is, cs, nchunks,
                     (unsigned long long*)sums, (unsigned*)done,
                     (uint32_t*)out, stream);
  return launch<1>(pts, (uint32_t*)table, tstride, n,
                   (const uint32_t*)chunks, rs, is, cs, nchunks,
                   (unsigned long long*)sums, (unsigned*)done,
                   (uint32_t*)out, stream);
}

}  // extern "C"
