// Base-field polynomials at one base-field point: rows of Montgomery
// coefficients (rows, n) -> (rows,) values.  A test-only helper of the
// reference: no prover path calls it.
//
// Replaces the jax.jit program ethrex_tpu/ops/ntt.py:166 `eval_poly_at`
// (a Horner scan, sequential in n).  The value of a polynomial at a point
// is unique, so any order of the sum gives it.
//
// Split rows.  Each row is cut into `splits` spans, one block a span, so
// rows x splits blocks fill the card (64 rows of 2^16 make 1,024 blocks).
// A span is `mult` chunks of SPAN coefficients (mult = 1 unless a row
// needs more than MAX_SPLITS spans of one chunk).  Thread t of a block
// takes the quads (four coefficients, one 16-byte load) at 4t, 4t +
// STRIDE, ... of its span; the last chunk's ITERS quads are loaded first,
// so their loads are in flight while the powers are made.
//
// Powers made on the card.  The point comes by value, or by pointer from
// a 0-dim device tensor, so the host reads nothing back and builds no
// table.  Thread 0 squares it into the binary powers x^(2^j) in shared
// memory, and multiplies the block's factor x^(first index of its span)
// from the bits of that index (shift and mask) on the same pass.
//
// Sums, Horner at every level, so no thread makes a power of its own.  A
// quad is c0 + c1 x + c2 x^2 + c3 x^3: four raw products summed lazily
// (bb::mad, c0 times one; at most 4 (p - 1)^2 < 2^64), folded and reduced.
// A thread's quads combine by Horner in x^STRIDE, last first; a warp's
// lanes by a tree of shuffles in which lane l adds lane l + d's value
// times x^(4 d); the warps' sums likewise in warp 0 with x^(128 d); the
// block's sum times its factor.  Thread 0 adds 2^48 plus the block's
// residue into its row's 64-bit word in device memory with one atomicAdd:
// the high 16 bits count the finished blocks and the low 48 bits sum
// their residues (below MAX_SPLITS x p < 2^48, exact in any order), so
// the block that finds the count at splits - 1 reduces the sum mod p with
// no fence (a sum and a count in two words would need one between them).
//
// Bound on this card: one read of the coefficients (the products, about
// 1.3 Montgomery products a coefficient, take less time than the bytes).
#include "babybear.cuh"

namespace {

constexpr int THREADS = 256;              // threads a block
constexpr int ITERS = 4;                  // quads a thread
constexpr int LOG_STRIDE = 10;
constexpr int STRIDE = 1 << LOG_STRIDE;   // coefficients a block's step
constexpr int SPAN = ITERS * STRIDE;      // coefficients a chunk
constexpr int MAX_BITS = 40;              // binary powers a block keeps
constexpr int MAX_SPLITS = 65535;         // blocks a row: a 16-bit count
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(STRIDE == 4 * THREADS, "a step is one quad a thread");

__global__ void __launch_bounds__(THREADS)
k_eval_poly_at(const uint32_t* __restrict__ coeffs, long long row_stride,
               long long n, int splits, int mult, int vec,
               const uint32_t* __restrict__ xp, uint32_t xv,
               unsigned long long* __restrict__ words,
               uint32_t* __restrict__ out) {
  __shared__ uint32_t pw[MAX_BITS];        // x^(2^j)
  __shared__ uint32_t factor;              // x^(first index of the span)
  __shared__ uint32_t red[WARPS];
  const int r = blockIdx.x / splits;
  const int s = blockIdx.x - r * splits;
  const uint32_t* row = coeffs + (long long)r * row_stride;
  const long long first = (long long)s * mult * SPAN;
  uint32_t c[ITERS][4];
  // the ITERS quads of chunk ch
  auto load = [&](int ch) {
    const long long i0 = first + (long long)ch * SPAN + 4 * threadIdx.x;
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const long long i = i0 + (long long)k * STRIDE;
      if (vec && i + 3 < n) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + i));
        c[k][0] = q.x;
        c[k][1] = q.y;
        c[k][2] = q.z;
        c[k][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[k][j] = i + j < n ? __ldg(row + i + j) : 0u;
      }
    }
  };
  load(mult - 1);
  // thread 0: the binary powers x^(2^j) over the bits of the grid's last
  // index (x^STRIDE among them), and on the same pass the block's factor
  // from the bits of its first index
  const int L = max(64 - __clzll((long long)splits * mult * SPAN - 1),
                    LOG_STRIDE + 1);
  if (threadIdx.x == 0) {
    uint32_t a = (xp != nullptr ? *xp : xv) % bb::P, f = bb::MONT_ONE;
    for (int j = 0; j < L; ++j) {
      pw[j] = a;
      if ((first >> j) & 1) f = bb::mul(f, a);
      a = bb::mul(a, a);
    }
    factor = f;
  }
  __syncthreads();
  // the thread's quads by Horner over them, last first: sum_k q_k
  // x^(k STRIDE), each quad q_k = c0 + c1 x + c2 x^2 + c3 x^3 summed lazily
  const uint32_t x1 = pw[0], x2 = pw[1], x3 = bb::mul(x1, x2);
  const uint32_t step = pw[LOG_STRIDE];
  uint32_t v = 0u;
  for (int ch = mult - 1;; --ch) {
#pragma unroll
    for (int k = ITERS - 1; k >= 0; --k) {
      const uint32_t q = bb::redc(bb::fold(bb::mad(c[k][0], bb::MONT_ONE,
          bb::mad(c[k][1], x1, bb::mad(c[k][2], x2,
                                       (uint64_t)c[k][3] * x3)))));
      v = bb::add(bb::mul(v, step), q);
    }
    if (ch == 0) break;
    load(ch - 1);
  }
  // the block's sum at its span's first index: lane l's value weighs
  // x^(4 l) within its warp, warp w's x^(128 w) within the block (trees
  // of shuffles: at distance d, lane l adds lane l + d's value times
  // x^(4 d) or x^(128 d)), and the block's weighs its factor
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16, j = 6; o > 0; o >>= 1, --j)
    v = bb::add(v, bb::mul(__shfl_down_sync(FULL, v, o), pw[j]));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp != 0) return;
  v = lane < WARPS ? red[lane] : 0u;
#pragma unroll
  for (int o = WARPS / 2, j = LOG_STRIDE - 1; o > 0; o >>= 1, --j)
    v = bb::add(v, bb::mul(__shfl_down_sync(FULL, v, o), pw[j]));
  if (lane != 0) return;
  v = bb::mul(v, factor);
  const unsigned long long old = atomicAdd(words + r, (1ull << 48) + v);
  if ((old >> 48) == (unsigned long long)(splits - 1))
    out[r] = (uint32_t)(((old & ((1ull << 48) - 1)) + v) % bb::P);
}

}  // namespace

extern "C" {

// coeffs: element (r, i) at r * row_stride + i, rows r < rows, i < n; vec:
// the rows start 16-byte aligned (quads load as one uint4).  The point:
// *xp when xp is not null (a device word), else xv; Montgomery, as the
// coefficients.  words: rows zeroed 64-bit words (each row's count of
// finished blocks and sum) -> out (rows,) Montgomery
int eval_poly_at(const void* coeffs, long long row_stride, long long n,
                 int rows, const void* xp, unsigned xv, int vec,
                 void* words, void* out, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long chunks = (n + SPAN - 1) / SPAN;
  const long long mult = (chunks + MAX_SPLITS - 1) / MAX_SPLITS;
  const long long splits = (chunks + mult - 1) / mult;
  if (splits * mult * SPAN > (1LL << MAX_BITS) ||
      splits * rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  k_eval_poly_at<<<(unsigned)(splits * rows), THREADS, 0, stream>>>(
      (const uint32_t*)coeffs, row_stride, n, (int)splits, (int)mult, vec,
      (const uint32_t*)xp, xv, (unsigned long long*)words, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
