// K1: batched in-order NTT / iNTT over the last axis of a (rows, n) buffer,
// with the pre-scale, the zero pad and the post-scale of the LDE fused into
// its passes.
//
// Replaces the jax.jit programs ethrex_tpu/ops/ntt.py:51 `ntt`/`intt`,
// :92 `coset_lde`, :115 `coset_intt` and :125 `coset_evals_from_coeffs`.
// The wrapper (ethrex_tpu_torch/ops/ntt.py `scaled_ntt`) launches one
// `ntt_pass` per pass of its plan (`ntt_plan`): two passes up to 2^22
// points, three up to 2^33.  A pass does L <= 11 radix-2 stages of a
// decimation-in-time transform whose input is read in bit-reversed order:
//   pass 1 (S = 0) loads G tiles of 2^L: tile position l of the g-th tile
//     of block b holds input j = rev_L(l) 2^(log n - L) + b G + g, so each
//     run of G neighbouring tiles reads G consecutive input words and the
//     bit reversal happens in shared memory, never as a scattered global
//     gather.  The zero pad is implicit: inputs j >= m_in are zeros that
//     are never read (the LDE reads n words a row and writes 8n), and the
//     pre-scale multiplies each word as it arrives;
//   pass p > 1 (S stages done) loads, for G neighbouring columns c, the
//     2^L elements c + 2^S jj of one block of 2^(S+L) points, multiplies
//     element jj by w_(2^(S+L))^(rev_L(jj) c) (a two-level table: two
//     products a word), transforms the column as a size-2^L DIT with the
//     tile's own roots and writes it back in place, in natural order.
//     The last pass multiplies by the post-scale as it stores.
// Inside a pass the L stages run as register rounds of up to three stages
// (8 words a thread, radix 2^3: the plan's NTT_RADIX_LOG, passed in as
// `radix`), with one shared-memory exchange between rounds; the
// butterflies' roots w_(2^L)^e come from a table of 2^(L-1) words in
// shared memory.  In pass 1 of an LDE (m_in <= n / 8) stages 0-2
// only copy each input to its 8 neighbours, so the load does the copy and
// the rounds start at stage 3.  tests/test_torch_kernel_plans.py runs the
// same indexing in numpy against the JAX package.
//
// Bound on this card: the multiplies the LDE needs (the iNTT's, the
// pre-scale's and the forward transform's after its copy-only stages;
// chip_smoke.py `ntt_bound`).  The kernel also moves 5n + 3N words a row
// (iNTT: two passes over n; forward: n in, N out, then N in and out),
// about 6.9 GB on the state LDE (115 x 2^19 -> 2^22), where the function
// itself needs only n in and N out.  A block loads its tile, transforms
// it, then stores it, so within a block memory and arithmetic do not
// overlap; the kernel runs at about 5x its bound (PERF.md).
#include "babybear.cuh"

namespace {

__device__ __forceinline__ uint32_t rev_bits(uint32_t v, int bits) {
  return bits == 0 ? 0u : (__brev(v) >> (32 - bits));
}

// One register round of stages [sa, sa + R) on unit (g, q) of a tile
// stored as tile[pos * GP + g]: the unit holds positions
// base + (r << sa), r < 2^R, base = q's low sa bits with the rest shifted
// above the round's R bits.  At stage sa + t the butterfly of r (bit t
// clear) takes w_(2^(sa+t+1))^(lo + (r mod 2^t) 2^sa), lo = base mod 2^sa:
// 2^t roots per stage, read once each.
template <int R>
__device__ __forceinline__ void radix_round(uint32_t* __restrict__ tile,
                                            const uint32_t* __restrict__ tw,
                                            int GP, int g, int q, int sa,
                                            int L) {
  constexpr int K = 1 << R;
  const int lo = q & ((1 << sa) - 1);
  const int base = lo | ((q >> sa) << (sa + R));
  uint32_t* p = tile + base * GP + g;
  const int stride = GP << sa;
  uint32_t v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) v[r] = p[r * stride];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int sh = L - 1 - sa - t;
    uint32_t w[K / 2];
#pragma unroll
    for (int j = 0; j < (1 << t); ++j) w[j] = tw[(lo + (j << sa)) << sh];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r & (1 << t)) continue;
      const int r2 = r + (1 << t);
      const uint32_t x = bb::mul(v[r2], w[r & ((1 << t) - 1)]);
      const uint32_t u = v[r];
      v[r] = bb::add(u, x);
      v[r2] = bb::sub(u, x);
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r) p[r * stride] = v[r];
}

__global__ void k_ntt_pass(const uint32_t* __restrict__ in,
                           long long in_stride, long long m_in,
                           uint32_t* __restrict__ out, int log_n, int S,
                           int L, int G, const uint32_t* __restrict__ pre,
                           const uint32_t* __restrict__ post,
                           int post_scalar,
                           const uint32_t* __restrict__ tw_g,
                           const uint32_t* __restrict__ tw_lo,
                           const uint32_t* __restrict__ tw_hi, int h,
                           int spread, int radix, int lg_bpr) {
  extern __shared__ uint32_t sh[];
  const int T = 1 << L;
  const int GP = G + 1;            // odd row stride: no bank conflicts
  const int lgG = __ffs(G) - 1;
  uint32_t* tile = sh;             // T rows of GP words
  uint32_t* tw = sh + T * GP;      // w_(2^L)^e, e < T / 2
  for (int i = threadIdx.x; i < (T >> 1); i += blockDim.x) tw[i] = tw_g[i];
  const long long row = (long long)blockIdx.x >> lg_bpr;
  const long long blk = (long long)blockIdx.x & ((1ll << lg_bpr) - 1);
  uint32_t* orow = out + (row << log_n);
  const int total = T << lgG;
  const long long o = blk << lgG;  // pass 1: first tile (reversed index)
  long long base0 = 0;             // pass p > 1: first element
  uint32_t col0 = 0;
  // spread (pass 1 with m_in <= 2^(log_n - 3), an LDE of blowup 8 or
  // more: `spread_first_pass` in ops/ntt.py): every nonzero input sits at a
  // tile position that is a multiple of 8, so stages 0-2 only copy it to
  // its 8 neighbours; the load does that copy and the register rounds
  // start at stage 3
  if (S == 0) {
    const uint32_t* irow = in + row * in_stride;
    const int lgc = spread ? 3 : 0;
    for (int idx = threadIdx.x; idx < (total >> lgc); idx += blockDim.x) {
      const int g = idx & (G - 1);
      const int l = (idx >> lgG) << lgc;
      const long long j = ((long long)rev_bits(l, L) << (log_n - L)) + o + g;
      uint32_t v = 0u;
      if (j < m_in) {
        v = irow[j];
        if (pre != nullptr) v = bb::mul(v, pre[j]);
      }
      for (int c = 0; c < (1 << lgc); ++c) tile[(l + c) * GP + g] = v;
    }
  } else {
    const int lg_ncg = S - lgG;    // column groups per block of 2^(S+L)
    const long long hiB = blk >> lg_ncg;
    col0 = (uint32_t)(blk & ((1ll << lg_ncg) - 1)) << lgG;
    base0 = (hiB << (S + L)) + col0;
    const uint32_t emask = (1u << (S + L)) - 1u;
    const uint32_t hmask = (1u << h) - 1u;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int g = idx & (G - 1);
      const int jj = idx >> lgG;
      const uint32_t v = orow[base0 + ((long long)jj << S) + g];
      const uint32_t e = (rev_bits(jj, L) * (col0 + g)) & emask;
      const uint32_t w = bb::mul(__ldg(tw_lo + (e & hmask)),
                                 __ldg(tw_hi + (e >> h)));
      tile[jj * GP + g] = bb::mul(v, w);
    }
  }
  __syncthreads();
  for (int sa = spread ? 3 : 0; sa < L; sa += radix) {
    const int R = L - sa < radix ? L - sa : radix;
    const int units = G << (L - R);
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int g = u & (G - 1);
      const int q = u >> lgG;
      if (R == 3)
        radix_round<3>(tile, tw, GP, g, q, sa, L);
      else if (R == 2)
        radix_round<2>(tile, tw, GP, g, q, sa, L);
      else
        radix_round<1>(tile, tw, GP, g, q, sa, L);
    }
    __syncthreads();
  }
  if (S == 0) {
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int k = idx & (T - 1);
      const int g = idx >> L;
      const long long t = rev_bits((uint32_t)(o + g), log_n - L);
      const long long dst = (t << L) + k;
      uint32_t v = tile[k * GP + g];
      if (post != nullptr) v = bb::mul(v, post[post_scalar ? 0 : dst]);
      orow[dst] = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int g = idx & (G - 1);
      const int k = idx >> lgG;
      const long long dst = base0 + ((long long)k << S) + g;
      uint32_t v = tile[k * GP + g];
      if (post != nullptr) v = bb::mul(v, post[post_scalar ? 0 : dst]);
      orow[dst] = v;
    }
  }
}

}  // namespace

extern "C" {

// One pass (S, L, G) of the plan over out (rows, 2^log_n); pass 1 reads
// in (rows, m_in) with row stride in_stride, later passes work in place.
// tw: w_(2^L)^e, e < 2^(L-1); tw_lo / tw_hi: the pre-twiddle table of
// w_(2^(S+L)) split at h bits (unused by pass 1); spread: pass 1 copies
// each input to its 8 neighbours in place of stages 0-2; radix: stages
// per register round (1-3, ops/ntt.py NTT_RADIX_LOG).
int ntt_pass(const void* in, long long in_stride, long long m_in, void* out,
             long long rows, int log_n, int S, int L, int G, const void* pre,
             const void* post, int post_scalar, const void* tw,
             const void* tw_lo, const void* tw_hi, int h, int spread,
             int radix, cudaStream_t stream) {
  if (radix < 1 || radix > 3) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaGetLastError();
  const int T = 1 << L;
  const int lg_bpr = log_n - L - (__builtin_ffs(G) - 1);
  const long long blocks = rows << lg_bpr;
  const int R = L < radix ? L : radix;
  int threads = (G << (L - R));
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const int smem = (T * (G + 1) + (T >> 1)) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k_ntt_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  k_ntt_pass<<<(unsigned)blocks, threads, smem, stream>>>(
      (const uint32_t*)in, in_stride, m_in, (uint32_t*)out, log_n, S, L, G,
      (const uint32_t*)pre, (const uint32_t*)post, post_scalar,
      (const uint32_t*)tw, (const uint32_t*)tw_lo, (const uint32_t*)tw_hi, h,
      spread, radix, lg_bpr);
  return (int)cudaGetLastError();
}

}  // extern "C"
