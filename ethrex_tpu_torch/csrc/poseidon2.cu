// K2: width-16 Poseidon2 over BabyBear (x^7 S-box, 4 + 13 + 4 rounds), as
// the rate-8 leaf sponge and the 2-to-1 Merkle compression.
//
// Replaces the jax.jit programs ethrex_tpu/ops/poseidon2.py:191 `permute`,
// :222 `compress` and :232 `hash_leaves`, and the level loop of
// ethrex_tpu/ops/merkle.py:22-53 (`build_levels_with`/`commit_levels`).
//
// K10 (p2_forest, `k_forest`) is ethrex_tpu/ops/merkle.py:60
// `batched_roots`: the roots of a forest of trees concatenated in one
// digest array, a few levels of every tree a launch (see `k_forest`).
//
// Bound on this card: 32-bit integer multiplies.  One permutation is 772
// Montgomery products (five IMAD issue slots each: see babybear.cuh
// `mul`); the state proof's leaves alone are 63 M permutations.  The
// design keeps everything else off the multiply pipe's back:
//   * every modular add, subtract and REDC tail is an add plus one DPX
//     add-min (babybear.cuh), about 4.1 k ALU instructions a permutation
//     against 2.3 k multiplies, so the ALU pipe no longer outruns the IMAD
//     pipe.  Every add stays reduced: p > 2^30.9, so a sum left below 2p
//     overflows 32 bits at its next add (3p > 2^32) and breaks the
//     product's bound if it is squared (x^2 < p 2^32 needs x < 1.37p), and
//     each linear-layer sum here feeds one or the other; with the add-min
//     the reduction is one instruction, where a lazy sum saves only that;
//   * the S-box is x^2, then x^3 = x^2 x beside x^4 = x^2 x^2, then
//     x^4 x^3 (three products deep, not four);
//   * an internal round sums lanes 1..15 as a tree while lane 0's S-box
//     runs (the two are independent), then adds lane 0 last;
//   * the round loops stay rolled: unrolling the 13 internal rounds or
//     the external ones measured slower on the card (PERF.md), the
//     larger code costing more than the constant-bank operands save.
// One thread holds one 16-lane state in registers for a whole permutation.
// The leaf hash reads its rows through strides (row, column and
// column-group), so the prover hashes the column-major LDE and the paired
// FRI codeword in place, with no transposed copy.
//
// Merkle levels: k_subtree takes S subtrees of 2^k consecutive digests per
// block, compresses k levels in shared memory and writes every level
// (the prover keeps them all for its openings); on a large level each
// thread first compresses its own 8 digests to one node, so the levels
// where a block's busy threads thin out carry 1/8 of the work.  The
// wrapper's plan (ethrex_tpu_torch/ops/merkle.py `subtree_plan`) covers a
// tree of 2^a leaves in ceil(a / 10) launches: 2^22 leaves in 3, not 22.
#include "babybear.cuh"

__constant__ uint32_t c_ext_rc[8][16];
__constant__ uint32_t c_int_rc[13];
__constant__ uint32_t c_mu[16];

namespace {

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = bb::mul(x, x);
  uint32_t x3 = bb::mul(x2, x);
  uint32_t x4 = bb::mul(x2, x2);
  return bb::mul(x4, x3);
}

__device__ __forceinline__ uint32_t dbl(uint32_t x) { return bb::add(x, x); }

// M4 evaluation chain of ethrex_tpu/ops/poseidon2.py `_m4`
__device__ __forceinline__ void m4(uint32_t* x) {
  uint32_t t0 = bb::add(x[0], x[1]);
  uint32_t t1 = bb::add(x[2], x[3]);
  uint32_t t2 = bb::add(dbl(x[1]), t1);
  uint32_t t3 = bb::add(dbl(x[3]), t0);
  uint32_t t4 = bb::add(dbl(dbl(t1)), t3);
  uint32_t t5 = bb::add(dbl(dbl(t0)), t2);
  uint32_t t6 = bb::add(t3, t5);
  uint32_t t7 = bb::add(t2, t4);
  x[0] = t6;
  x[1] = t5;
  x[2] = t7;
  x[3] = t4;
}

__device__ __forceinline__ void external_linear(uint32_t* s) {
#pragma unroll
  for (int b = 0; b < 4; ++b) m4(s + 4 * b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t sum = bb::add(bb::add(s[j], s[4 + j]), bb::add(s[8 + j], s[12 + j]));
#pragma unroll
    for (int b = 0; b < 4; ++b) s[4 * b + j] = bb::add(s[4 * b + j], sum);
  }
}

__device__ __forceinline__ void ext_round(uint32_t* s, int r) {
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = sbox(bb::add(s[j], c_ext_rc[r][j]));
  external_linear(s);
}

__device__ __forceinline__ void internal_round(uint32_t* s, int r) {
  const uint32_t x0 = sbox(bb::add(s[0], c_int_rc[r]));
  // lanes 1..15 summed as a tree, independent of lane 0's S-box chain
  uint32_t a[8];
#pragma unroll
  for (int j = 0; j < 7; ++j) a[j] = bb::add(s[2 * j + 1], s[2 * j + 2]);
  a[7] = s[15];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = bb::add(a[2 * j], a[2 * j + 1]);
  const uint32_t rest = bb::add(bb::add(a[0], a[1]), bb::add(a[2], a[3]));
  const uint32_t tot = bb::add(rest, x0);
  s[0] = bb::add(tot, bb::mul(x0, c_mu[0]));
#pragma unroll
  for (int j = 1; j < 16; ++j) s[j] = bb::add(tot, bb::mul(s[j], c_mu[j]));
}

__device__ __forceinline__ void permute(uint32_t* s) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < 4; ++r) ext_round(s, r);
#pragma unroll 1
  for (int r = 0; r < 13; ++r) internal_round(s, r);
#pragma unroll 1
  for (int r = 4; r < 8; ++r) ext_round(s, r);
}

// element (i, c) of the leaf matrix lives at
//   i*row_stride + (c % inner)*col_stride + (c / inner)*group_stride
__global__ void k_hash_leaves(const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out, long long m, int w,
                              long long row_stride, long long col_stride,
                              int inner, long long group_stride) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint32_t* row = in + i * row_stride;
  uint32_t s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0;
  int cc = 0;                 // c % inner and c / inner, stepped along c
  long long goff = 0;
  for (int c0 = 0; c0 < w; c0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < w) {
        s[j] = bb::add(s[j], row[(long long)cc * col_stride + goff]);
        if (++cc == inner) {
          cc = 0;
          goff += group_stride;
        }
      }
    }
    permute(s);
  }
  uint4* o = reinterpret_cast<uint4*>(out + i * 8);
  o[0] = make_uint4(s[0], s[1], s[2], s[3]);
  o[1] = make_uint4(s[4], s[5], s[6], s[7]);
}

// the parent of the digests at left and right (8 words each) into res[8]
__device__ __forceinline__ void compress_regs(const uint32_t* left,
                                              const uint32_t* right,
                                              uint32_t res[8]) {
  uint32_t s[16];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 a = reinterpret_cast<const uint4*>(left)[q];
    const uint4 b = reinterpret_cast<const uint4*>(right)[q];
    s[4 * q] = a.x;
    s[4 * q + 1] = a.y;
    s[4 * q + 2] = a.z;
    s[4 * q + 3] = a.w;
    s[8 + 4 * q] = b.x;
    s[8 + 4 * q + 1] = b.y;
    s[8 + 4 * q + 2] = b.z;
    s[8 + 4 * q + 3] = b.w;
  }
  uint32_t l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) l[j] = s[j];
  permute(s);
#pragma unroll
  for (int j = 0; j < 8; ++j) res[j] = bb::add(s[j], l[j]);
}

__device__ __forceinline__ void store8(uint32_t* dst, const uint32_t r[8]) {
  uint4* o = reinterpret_cast<uint4*>(dst);
  o[0] = make_uint4(r[0], r[1], r[2], r[3]);
  o[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// k levels of S subtrees per block.  Subtree st (< S) of block b is tree
// = b S + st, the 2^k digests in[tree 2^k ...] (8 words each), loaded into
// shared memory; node i of level j then lives in shared slot i 2^j (the
// left child's slot, which only its own parent reads), and in output level
// j, row tree 2^(k-j) + i (level 1 starts at `out`; level j + 1 right
// after level j, which holds m_in / 2^j rows).
//   Levels 1..c+1 run serially per thread: thread t of a subtree owns the
// 2^(c+1) digests from slot t 2^(c+1) and compresses them to one node,
// 2^(c+1) - 1 compressions with no barrier (every slot it touches is its
// own), so 2^(c+1) - 1 of every 2^(c+1) compressions run with every
// thread busy.  Levels c+2..k run one node per thread, numbered densely
// over the block's subtrees so that the busy threads fill whole warps,
// with a barrier between levels.  c = 0 is one node per thread throughout.
__global__ void k_subtree(const uint32_t* __restrict__ in,
                          uint32_t* __restrict__ out, long long m_in, int k,
                          int S, int c) {
  extern __shared__ uint4 sh4[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(sh4);
  const int lgT = k - c - 1;                       // threads per subtree
  const uint4* src = reinterpret_cast<const uint4*>(
      in + ((long long)blockIdx.x * S << k) * 8);
  const int words4 = (S << k) * 2;                 // uint4s of the block
  for (int i = threadIdx.x; i < words4; i += blockDim.x) sh4[i] = src[i];
  __syncthreads();
  long long level_off = 0;                         // rows before level j
  long long level_rows = m_in >> 1;
  for (int j = 1; j <= k; ++j) {
    const int cnt_log = k - j;                     // nodes per subtree
    if (j <= c + 1) {
      const int st = threadIdx.x >> lgT;
      const int t = threadIdx.x & ((1 << lgT) - 1);
      const long long tree = (long long)blockIdx.x * S + st;
      uint32_t* base = sh + ((long long)st << k) * 8;
      const int per = 1 << (c + 1 - j);            // nodes of this thread
      for (int q = 0; q < per; ++q) {
        const int i = t * per + q;
        uint32_t r[8];
        compress_regs(base + ((2 * i) << (j - 1)) * 8,
                      base + ((2 * i + 1) << (j - 1)) * 8, r);
        store8(base + (i << j) * 8, r);
        store8(out + (level_off + (tree << cnt_log) + i) * 8, r);
      }
    } else {
      __syncthreads();
      const int q = threadIdx.x;
      if (q < (S << cnt_log)) {
        const int st = q >> cnt_log;
        const int i = q & ((1 << cnt_log) - 1);
        const long long tree = (long long)blockIdx.x * S + st;
        uint32_t* base = sh + ((long long)st << k) * 8;
        uint32_t r[8];
        compress_regs(base + ((2 * i) << (j - 1)) * 8,
                      base + ((2 * i + 1) << (j - 1)) * 8, r);
        store8(base + (i << j) * 8, r);
        store8(out + (level_off + (tree << cnt_log) + i) * 8, r);
      }
    }
    level_off += level_rows;
    level_rows >>= 1;
  }
}

// K10.  A launch takes up to FOREST_SEGS segments, each a run of blocks
// over consecutive digests: block b of a segment takes its tiles [b S,
// min((b + 1) S, tiles)), each tile 2^k consecutive digests of one tree
// (several whole trees of one size make one segment), compresses the k
// levels of every tile in shared memory as k_subtree does (the first c + 1
// serially per thread, then one node a thread, numbered densely over the
// block's tiles), and writes only each tile's root, at out row (segment's
// out + tile).  k = 0 copies a finished root through.  The host plan
// (ethrex_tpu_torch/ops/merkle.py `forest_plan`) splits each tree's levels
// evenly over ceil(max log2 size / FOREST_LEVELS) launches and keeps the
// trees' order in every output, so the last one is the roots in tree
// order.  The segments are one __grid_constant__ parameter (in the
// constant bank): no launch uploads a plan.
//
// Bound on this card: the permutations ((leaves - trees) x 772 products,
// as k_subtree's), with the leaves read once and only the roots written.
constexpr int FOREST_SEGS = 48;
constexpr int FOREST_THREADS = 128;
constexpr int FOREST_LEVELS = 10;

struct ForestSeg {
  long long in, out;            // first input and output row
  int first_block, tiles, k, S, c;
};

struct Forest {
  ForestSeg seg[FOREST_SEGS];
  int nseg;
};

__global__ void __launch_bounds__(FOREST_THREADS)
k_forest(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
         const __grid_constant__ Forest f) {
  __shared__ uint4 sh4[2 << FOREST_LEVELS];   // 2^10 digests, 32 KB
  uint32_t* sh = reinterpret_cast<uint32_t*>(sh4);
  int s = 0;
  for (int q = 1; q < f.nseg; ++q)
    if (f.seg[q].first_block <= (int)blockIdx.x) s = q;
  const ForestSeg& g = f.seg[s];
  const int b = (int)blockIdx.x - g.first_block;
  const int k = g.k, c = g.c;
  const int cnt = min(g.S, g.tiles - b * g.S);   // this block's tiles
  const long long tile0 = (long long)b * g.S;
  uint32_t* dst = out + (g.out + tile0) * 8;
  if (k == 0) {
    for (int q = threadIdx.x; q < cnt; q += blockDim.x) {
      const uint4* src = reinterpret_cast<const uint4*>(in + (g.in + tile0 + q) * 8);
      uint4* o = reinterpret_cast<uint4*>(dst + q * 8);
      o[0] = src[0];
      o[1] = src[1];
    }
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(in + ((g.in + (tile0 << k)) * 8));
  const int words4 = (cnt << k) * 2;
  for (int i = threadIdx.x; i < words4; i += blockDim.x) sh4[i] = src[i];
  __syncthreads();
  const int lgT = k - c - 1;                  // threads a tile, serially
  for (int j = 1; j <= k; ++j) {
    const int cnt_log = k - j;                // nodes a tile at level j
    if (j <= c + 1) {
      if ((int)threadIdx.x < (cnt << lgT)) {
        const int st = threadIdx.x >> lgT;
        const int t = threadIdx.x & ((1 << lgT) - 1);
        uint32_t* base = sh + (st << k) * 8;
        const int per = 1 << (c + 1 - j);     // nodes of this thread
        for (int q = 0; q < per; ++q) {
          const int i = t * per + q;
          uint32_t r[8];
          compress_regs(base + ((2 * i) << (j - 1)) * 8,
                        base + ((2 * i + 1) << (j - 1)) * 8, r);
          store8(j == k ? dst + st * 8 : base + (i << j) * 8, r);
        }
      }
    } else {
      __syncthreads();
      const int q = threadIdx.x;
      if (q < (cnt << cnt_log)) {
        const int st = q >> cnt_log;
        const int i = q & ((1 << cnt_log) - 1);
        uint32_t* base = sh + (st << k) * 8;
        uint32_t r[8];
        compress_regs(base + ((2 * i) << (j - 1)) * 8,
                      base + ((2 * i + 1) << (j - 1)) * 8, r);
        store8(j == k ? dst + st * 8 : base + (i << j) * 8, r);
      }
    }
  }
}

}  // namespace

extern "C" {

// Montgomery-form constants from the host (ethrex_tpu_torch/ops/poseidon2):
// ext_rc[8*16], int_rc[13], mu[16].
int p2_set_constants(const void* ext_rc, const void* int_rc, const void* mu) {
  cudaMemcpyToSymbol(c_ext_rc, ext_rc, sizeof(uint32_t) * 8 * 16);
  cudaMemcpyToSymbol(c_int_rc, int_rc, sizeof(uint32_t) * 13);
  cudaMemcpyToSymbol(c_mu, mu, sizeof(uint32_t) * 16);
  return (int)cudaGetLastError();
}

int p2_hash_leaves(const void* in, void* out, long long m, int w,
                   long long row_stride, long long col_stride, int inner,
                   long long group_stride, cudaStream_t stream) {
  if (m > 0) {
    k_hash_leaves<<<(unsigned)((m + 127) / 128), 128, 0, stream>>>(
        (const uint32_t*)in, (uint32_t*)out, m, w, row_stride, col_stride,
        inner, group_stride);
  }
  return (int)cudaGetLastError();
}

// k levels of S subtrees of 2^k digests per block, the first c + 1 of
// them serially per thread: in (m_in, 8) -> levels 1..k written back to
// back from out; m_in a multiple of S 2^k, 0 <= c < k
int p2_merkle_subtree(const void* in, void* out, long long m_in, int k,
                      int S, int c, cudaStream_t stream) {
  if (m_in <= 0 || k <= 0 || c < 0 || c >= k)
    return m_in <= 0 ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
  const long long blocks = m_in / ((long long)S << k);
  const int threads = S << (k - c - 1);
  const int smem = (S << k) * 32;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k_subtree, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  k_subtree<<<(unsigned)blocks, threads, smem, stream>>>(
      (const uint32_t*)in, (uint32_t*)out, m_in, k, S, c);
  return (int)cudaGetLastError();
}

// K10: one launch of `k_forest` over nseg segments (7 words each, as
// ForestSeg's fields: in, out, first block, tiles, k, S, c) and `blocks`
// blocks; in (rows, 8) digests -> out (the segments' output rows, 8)
int p2_forest(const void* in, void* out, const void* segs, int nseg,
              int blocks, cudaStream_t stream) {
  if (nseg < 1 || nseg > FOREST_SEGS || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Forest f = {};
  const long long* w = (const long long*)segs;
  for (int q = 0; q < nseg; ++q, w += 7) {
    f.seg[q] = ForestSeg{w[0], w[1], (int)w[2], (int)w[3], (int)w[4],
                         (int)w[5], (int)w[6]};
    if (f.seg[q].k < 0 || f.seg[q].k > FOREST_LEVELS ||
        (f.seg[q].k > 0 && (f.seg[q].c < 0 || f.seg[q].c >= f.seg[q].k)) ||
        (f.seg[q].S << f.seg[q].k) > (1 << FOREST_LEVELS))
      return (int)cudaErrorInvalidValue;
  }
  f.nseg = nseg;
  k_forest<<<(unsigned)blocks, FOREST_THREADS, 0, stream>>>(
      (const uint32_t*)in, (uint32_t*)out, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
