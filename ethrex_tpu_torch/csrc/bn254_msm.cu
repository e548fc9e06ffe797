// K5: BN254 multi-scalar multiplication over G1 (Fp) and G2 (Fp2), as a
// signed-window bucket (Pippenger) sum over bases pre-shifted per window.
//
// Replaces the jax.jit program ethrex_tpu/ops/bn254_msm.py:308
// `_msm_device` (a double-and-add per point and a tree sum): the Groth16
// wrap's hot loop (crypto/groth16.py `prove`, three G1 MSMs and one G2
// MSM).  The field and point code is csrc/bn254.cuh.
//
// The function: sum_i s_i P_i for Jacobian Montgomery points P_i and
// scalars s_i < 2^255 (the callers pass s mod r).  Each scalar is recoded
// into kWindows signed digits of kWindowBits bits, d in [-(B-1), B] with B
// = kBuckets, carrying into the next window, so
//   sum_i s_i P_i = sum_w S_w,   S_w = sum_{b=1..B} b B_{w,b},
//   B_{w,b} = sum over the points whose digit w is +-b of +-Q_{w,i},
// with Q_{w,i} = 2^(c w) P_i in affine form.  The table Q (`bn254_msm_
// bases`, two launches) depends only on the points: the caller builds it
// once per point table and keeps it (ops/bn254_msm.py caches the wrap's
// four), so no call runs the 248 doublings of a Horner combination in
// one thread.
//   k_shift       a thread per point: Q_{w,i} for every w, c doublings
//                 apart, in Jacobian form;
//   k_affine      a thread per (w, i): X / Z^2, Y / Z^3 (Fermat inverse);
//                 (0, 0) for the point at infinity.
// The MSM itself, six launches:
//   k_digits      a thread per point: its digits (zero for a point at
//                 infinity), and per tile of kTile points and window a
//                 bucket histogram and each point's rank among the tile's
//                 points of its bucket (a loop over shared memory);
//   k_scan        one block: the exclusive scan of the tile histograms in
//                 (window, bucket, tile) order, and each bucket's start;
//   k_scatter     a thread per point: entry (index, sign) of each nonzero
//                 digit at its bucket's start plus the offset of its tile
//                 plus its rank.  A counting sort, so a bucket lists its
//                 points in index order;
//   k_bucket_acc  kChunks consecutive lanes per bucket, each summing a
//                 fixed share of the bucket's list by mixed additions
//                 (the affine base, 11 products; Y negated for a
//                 negative digit), then a shuffle tree over the lanes;
//                 lane 0 writes B_{w,b};
//   k_window_sum  a warp per window: lane s takes the kSegment buckets
//                 (s kSegment, (s + 1) kSegment] and forms their running
//                 sums from the top, T_s = sum B_b and W_s = sum_m
//                 sum_{b >= m} B_b; a suffix scan over the lanes gives U_s
//                 = sum_{s' > s} T_s', and S_w = sum_s (W_s + kSegment
//                 U_s) by a shuffle tree;
//   k_combine     one warp: sum_w S_w by a shuffle tree (lane w holds
//                 S_w), then the result in 16-bit limbs.
// Every sum runs in a fixed order (no atomics in the point sums; the
// histograms' shared-memory counts do not depend on order), so the same
// inputs give the same Jacobian bits run after run.
//
// Bound on this card: operations (264 IMAD slots a product,
// chip_smoke.py).  The bucket method needs about n W 11 products where
// double-and-add needed 254 (7 + 8) a point.  What stays serial is a
// k_window_sum lane's ~20 additions and k_combine's 5; a product's
// latency in one thread (tools/bn254_mul_rate.py: 1,346 cycles, against
// 34e9 products/s over the card) sets them.
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using namespace bn254;

constexpr int kWindowBits = 8;  // c
constexpr int kWindows = 32;    // ceil(255 / c)
constexpr int kBuckets = 128;   // 2^(c - 1): digits +-1 .. +-128
constexpr int kTile = 256;      // points per k_digits block
constexpr int kChunks = 8;      // lanes per bucket in k_bucket_acc
constexpr int kSegment = 4;     // buckets per k_window_sum lane
constexpr int kAccThreads = 128;
static_assert(kWindows * kWindowBits >= 255, "windows cover s < 2^255");
static_assert(kBuckets == 1 << (kWindowBits - 1), "signed digits");
static_assert(kSegment * 32 == kBuckets, "a warp per window");
static_assert(32 % kChunks == 0 && kAccThreads % kChunks == 0, "lanes");
static_assert((kWindows * kBuckets * kChunks) % kAccThreads == 0, "grid");
static_assert(kTile >= kBuckets + 1, "one histogram entry a thread");

static_assert(kWindows == 32, "k_combine: a lane per window");

// packed digit of (point, window): bucket in bits 0-7, sign bit 8, rank
// in its tile's bucket from bit 16
constexpr uint32_t kKeyMask = 0xFFu;
constexpr uint32_t kNegBit = 1u << 8;
// list entry: point index, bit 31 the sign
constexpr uint32_t kEntryIndex = 0x7FFFFFFFu;

// an affine base of the table: (0, 0) is the point at infinity (not on
// either curve, whose b is not 0)
template <class F>
struct Aff {
  F X, Y;
};

template <class F>
__device__ __forceinline__ Pt<F> shfl_down(const Pt<F>& P, int d) {
  Pt<F> o;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&P);
  uint32_t* t = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(Pt<F>) / 4); ++k) {
    t[k] = __shfl_down_sync(0xFFFFFFFFu, s[k], d);
  }
  return o;
}

// bits [c w, c w + c) of the 256-bit scalar s (8 little-endian words)
__device__ __forceinline__ uint32_t window_bits(const uint32_t* s, int w) {
  const int bit = w * kWindowBits;
  const int q = bit >> 5, sh = bit & 31;
  uint32_t v = s[q] >> sh;
  if (sh + kWindowBits > 32 && q + 1 < 8) v |= s[q + 1] << (32 - sh);
  return v & ((1u << kWindowBits) - 1u);
}

constexpr int kBaseThreads = 64;

// jac[w n + i] = 2^(c w) P_i
template <class F>
__global__ void __launch_bounds__(kBaseThreads)
    k_shift(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
            const int32_t* __restrict__ Z, int n, Pt<F>* __restrict__ jac) {
  constexpr int L16 = 2 * (int)(sizeof(F) / 4);
  const long long i = (long long)blockIdx.x * kBaseThreads + threadIdx.x;
  if (i >= n) return;
  Pt<F> P{load16<F>(X + i * L16), load16<F>(Y + i * L16),
          load16<F>(Z + i * L16)};
  jac[i] = P;
#pragma unroll 1
  for (int w = 1; w < kWindows; ++w) {
#pragma unroll 1
    for (int k = 0; k < kWindowBits; ++k) P = pdbl_inline(P);
    jac[(long long)w * n + i] = P;
  }
}

template <class F>
__global__ void __launch_bounds__(kBaseThreads)
    k_affine(const Pt<F>* __restrict__ jac, long long count,
             Aff<F>* __restrict__ bases) {
  const long long k = (long long)blockIdx.x * kBaseThreads + threadIdx.x;
  if (k >= count) return;
  const Pt<F> P = jac[k];
  if (is_zero(P.Z)) {
    bases[k] = Aff<F>{zero_elem<F>(), zero_elem<F>()};
    return;
  }
  const F zi = inv(P.Z);
  const F zi2 = mul(zi, zi);
  bases[k] = Aff<F>{mul(P.X, zi2), mul(P.Y, mul(zi2, zi))};
}

template <class F>
__global__ void __launch_bounds__(kTile)
    k_digits(const int32_t* __restrict__ words,
             const Aff<F>* __restrict__ bases, int n, int n_tiles,
             uint32_t* __restrict__ dig, int32_t* __restrict__ tile_hist) {
  __shared__ int keys[kTile];
  __shared__ int hist[kBuckets + 1];
  const int tile = blockIdx.x, t = threadIdx.x;
  const long long i = (long long)tile * kTile + t;
  uint32_t s[8];
  bool live = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0u;
  if (i < n) {
    live = !is_zero(bases[i].X) || !is_zero(bases[i].Y);
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = (uint32_t)words[i * 8 + k];
  }
  uint32_t carry = 0;
  for (int w = 0; w < kWindows; ++w) {
    const uint32_t raw = window_bits(s, w) + carry;
    int d = (int)raw;
    carry = 0;
    if (raw > (uint32_t)kBuckets) {
      d -= 1 << kWindowBits;
      carry = 1;
    }
    if (!live) d = 0;
    const int key = d < 0 ? -d : d;
    if (t <= kBuckets) hist[t] = 0;
    keys[t] = key;
    __syncthreads();
    int rank = 0;
    if (key) {
      atomicAdd(&hist[key], 1);
      for (int j = 0; j < t; ++j) rank += keys[j] == key;
    }
    __syncthreads();
    if (i < n) {
      dig[(long long)w * n + i] =
          key ? ((uint32_t)rank << 16) | (d < 0 ? kNegBit : 0u) | (uint32_t)key
              : 0u;
    }
    if (t >= 1 && t <= kBuckets) {
      tile_hist[((long long)w * kBuckets + t - 1) * n_tiles + tile] = hist[t];
    }
    __syncthreads();
  }
}

// exclusive scan of the (window, bucket, tile) histogram in place, one
// block; bstart[g] = the first list position of bucket g = w B + b - 1,
// bstart[W B] = the number of entries.  This kernel and k_scatter do not
// read the field; they are templates over it only so that a profile names
// the G1 and the G2 launches apart.
constexpr int kScanThreads = 1024;

template <class F>
__global__ void __launch_bounds__(kScanThreads)
    k_scan(int32_t* __restrict__ hist, int n_tiles,
           int32_t* __restrict__ bstart) {
  __shared__ int part[kScanThreads];
  const int t = threadIdx.x;
  const long long len = (long long)kWindows * kBuckets * n_tiles;
  const long long per = (len + kScanThreads - 1) / kScanThreads;
  const long long lo = t * per < len ? t * per : len;
  const long long hi = lo + per < len ? lo + per : len;
  int sum = 0;
  for (long long k = lo; k < hi; ++k) sum += hist[k];
  part[t] = sum;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {  // inclusive, Hillis-Steele
    int v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;
  for (long long k = lo; k < hi; ++k) {
    const int c = hist[k];
    if (k % n_tiles == 0) bstart[k / n_tiles] = run;
    hist[k] = run;
    run += c;
  }
  if (t == kScanThreads - 1) bstart[kWindows * kBuckets] = part[t];
}

template <class F>
__global__ void __launch_bounds__(kTile)
    k_scatter(const uint32_t* __restrict__ dig,
              const int32_t* __restrict__ offs, int n, int n_tiles,
              uint32_t* __restrict__ list) {
  const int tile = blockIdx.x;
  const long long i = (long long)tile * kTile + threadIdx.x;
  if (i >= n) return;
  for (int w = 0; w < kWindows; ++w) {
    const uint32_t v = dig[(long long)w * n + i];
    const uint32_t key = v & kKeyMask;
    if (!key) continue;
    const long long pos =
        offs[((long long)w * kBuckets + key - 1) * n_tiles + tile] +
        (v >> 16);
    list[pos] = (uint32_t)i | (v & kNegBit ? 1u << 31 : 0u);
  }
}

template <class F>
__global__ void __launch_bounds__(kAccThreads)
    k_bucket_acc(const Aff<F>* __restrict__ bases, int n,
                 const uint32_t* __restrict__ list,
                 const int32_t* __restrict__ bstart, Pt<F>* __restrict__ bsum) {
  const int g = blockIdx.x * kAccThreads + threadIdx.x;
  const int gb = g / kChunks, j = g % kChunks;
  const Aff<F>* table = bases + (long long)(gb / kBuckets) * n;
  const long long s = bstart[gb], len = bstart[gb + 1] - s;
  const long long lo = s + len * j / kChunks;
  const long long hi = s + len * (j + 1) / kChunks;
  Pt<F> acc = infinity<F>();
#pragma unroll 1
  for (long long k = lo; k < hi; ++k) {
    const uint32_t e = list[k];
    const Aff<F> q = table[e & kEntryIndex];
    acc = madd(acc, q.X, e >> 31 ? neg(q.Y) : q.Y);
  }
  // lanes j and j + d of one bucket (kChunks divides the warp)
#pragma unroll 1
  for (int d = kChunks / 2; d >= 1; d >>= 1) {
    acc = padd(acc, shfl_down(acc, d));
  }
  if (j == 0) bsum[gb] = acc;
}

template <class F>
__global__ void __launch_bounds__(32)
    k_window_sum(const Pt<F>* __restrict__ bsum, Pt<F>* __restrict__ wsum) {
  const int w = blockIdx.x, lane = threadIdx.x;
  const Pt<F>* b = bsum + (long long)w * kBuckets + lane * kSegment;
  Pt<F> run = infinity<F>(), acc = infinity<F>();
#pragma unroll 1
  for (int k = kSegment - 1; k >= 0; --k) {  // buckets from the top
    run = padd(run, b[k]);
    acc = padd(acc, run);
  }
  // inclusive suffix sums of T = run over the lanes
  Pt<F> x = run;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Pt<F> y = shfl_down(x, d);
    if (lane + d < 32) x = padd(x, y);
  }
  Pt<F> u = shfl_down(x, 1);  // U_s = sum over the lanes above
  if (lane == 31) u = infinity<F>();
#pragma unroll 1
  for (int k = 1; k < kSegment; k <<= 1) u = pdbl(u);
  Pt<F> v = padd(acc, u);
#pragma unroll 1
  for (int d = 16; d >= 1; d >>= 1) v = padd(v, shfl_down(v, d));
  if (lane == 0) wsum[w] = v;
}

// sum_w S_w: lane w holds S_w, a shuffle tree to lane 0
template <class F>
__global__ void __launch_bounds__(32)
    k_combine(const Pt<F>* __restrict__ wsum, int32_t* __restrict__ out) {
  constexpr int L16 = 2 * (int)(sizeof(F) / 4);
  const int lane = threadIdx.x;
  Pt<F> acc = wsum[lane];
#pragma unroll 1
  for (int d = 16; d >= 1; d >>= 1) acc = padd(acc, shfl_down(acc, d));
  if (lane == 0) {
    store16(acc.X, out);
    store16(acc.Y, out + L16);
    store16(acc.Z, out + 2 * L16);
  }
}

long long align256(long long b) { return (b + 255) / 256 * 256; }

// scratch layout: bucket sums, window sums, digits, tile histograms,
// bucket starts, entry list
template <class F>
struct Scratch {
  Pt<F>* bsum;
  Pt<F>* wsum;
  uint32_t* dig;
  int32_t* hist;
  int32_t* bstart;
  uint32_t* list;
  long long bytes;

  Scratch(char* base, int n) {
    const int n_tiles = (n + kTile - 1) / kTile;
    long long off = 0;
    auto take = [&](long long b) {
      long long at = off;
      off += align256(b);
      return base ? base + at : nullptr;
    };
    bsum = (Pt<F>*)take((long long)kWindows * kBuckets * sizeof(Pt<F>));
    wsum = (Pt<F>*)take((long long)kWindows * sizeof(Pt<F>));
    dig = (uint32_t*)take((long long)kWindows * n * 4);
    hist = (int32_t*)take((long long)kWindows * kBuckets * n_tiles * 4);
    bstart = (int32_t*)take(((long long)kWindows * kBuckets + 1) * 4);
    list = (uint32_t*)take((long long)kWindows * n * 4);
    bytes = off;
  }
};

template <class F>
int run_bases(const int32_t* X, const int32_t* Y, const int32_t* Z, char* jac,
              int n, Aff<F>* bases, cudaStream_t stream) {
  const long long count = (long long)kWindows * n;
  k_shift<F><<<(n + kBaseThreads - 1) / kBaseThreads, kBaseThreads, 0,
               stream>>>(X, Y, Z, n, (Pt<F>*)jac);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_affine<F><<<(int)((count + kBaseThreads - 1) / kBaseThreads),
                kBaseThreads, 0, stream>>>((const Pt<F>*)jac, count, bases);
  return (int)cudaGetLastError();
}

template <class F>
int run_msm(const Aff<F>* bases, const int32_t* words, char* scratch, int n,
            int32_t* out, cudaStream_t stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  Scratch<F> s(scratch, n);
  k_digits<F><<<n_tiles, kTile, 0, stream>>>(words, bases, n, n_tiles, s.dig,
                                             s.hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_scan<F><<<1, kScanThreads, 0, stream>>>(s.hist, n_tiles, s.bstart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k_scatter<F><<<n_tiles, kTile, 0, stream>>>(s.dig, s.hist, n, n_tiles,
                                              s.list);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k_bucket_acc<F><<<kWindows * kBuckets * kChunks / kAccThreads, kAccThreads,
                    0, stream>>>(bases, n, s.list, s.bstart, s.bsum);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k_window_sum<F><<<kWindows, 32, 0, stream>>>(s.bsum, s.wsum);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k_combine<F><<<1, 32, 0, stream>>>(s.wsum, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of the buffers for n points of G1 (fp2 = 0) or G2: which = 0 the
// MSM's scratch, 1 the table of bases, 2 the table's build scratch
long long bn254_msm_bytes(int n, int fp2, int which) {
  const long long count = (long long)kWindows * n;
  if (which == 1) return count * (fp2 ? sizeof(Aff<Fp2>) : sizeof(Aff<Fp>));
  if (which == 2) return count * (fp2 ? sizeof(Pt<Fp2>) : sizeof(Pt<Fp>));
  return fp2 ? Scratch<Fp2>(nullptr, n).bytes : Scratch<Fp>(nullptr, n).bytes;
}

// The table of bases: X, Y, Z (n, 16) int32 limbs for G1 or (n, 2, 16)
// for G2 (fp2 = 1); jac: bn254_msm_bytes(n, fp2, 2) bytes of scratch;
// bases: bn254_msm_bytes(n, fp2, 1) bytes, (kWindows, n) affine points of
// 8 (G2: 16) 32-bit Montgomery words a coordinate.  Two launches.
int bn254_msm_bases(const void* X, const void* Y, const void* Z, void* jac,
                    int n, int fp2, void* bases, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (fp2) {
    return run_bases<Fp2>((const int32_t*)X, (const int32_t*)Y,
                          (const int32_t*)Z, (char*)jac, n,
                          (Aff<Fp2>*)bases, stream);
  }
  return run_bases<Fp>((const int32_t*)X, (const int32_t*)Y,
                       (const int32_t*)Z, (char*)jac, n, (Aff<Fp>*)bases,
                       stream);
}

// The MSM: bases from bn254_msm_bases; words: (n, 8) int32, each
// scalar's 32-bit words, least significant first, the scalar below 2^255;
// scratch: bn254_msm_bytes(n, fp2, 0) bytes; out: (3, 16) or (3, 2, 16)
// int32, the Jacobian sum.  Six launches on `stream`.
int bn254_msm(const void* bases, const void* words, void* scratch, int n,
              int fp2, void* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (fp2) {
    return run_msm<Fp2>((const Aff<Fp2>*)bases, (const int32_t*)words,
                        (char*)scratch, n, (int32_t*)out, stream);
  }
  return run_msm<Fp>((const Aff<Fp>*)bases, (const int32_t*)words,
                     (char*)scratch, n, (int32_t*)out, stream);
}

}  // extern "C"
