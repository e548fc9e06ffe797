// K8: the DEEP composition codeword of a STARK proof, one fused pass over
// the LDE points x:
//
//   F(x) = (S1(x) - c1 + sum_b g_b (Q_b(x) - Q_b(zeta))) / (x - zeta)
//        + (S2(x) - c2) / (x - zeta*g)
//
// Replaces the jax.jit body ethrex_tpu/stark/prover.py:565-585
// (`phase_deep`) with what it calls: ops/ext.py:134 `inv_x_minus_zeta`,
// the ext mul/add/sub of ops/ext.py:33-62 and ops/babybear.py:168
// `sum_mod` over the B quotient chunks.  S1 and S2 are the two halves of
// one K3 product (LDE rows @ both gamma power columns); c1, c2, the gamma
// powers g_b and the chunk openings Q_b(zeta) are per-proof constants
// from the host.  With one opening and no quotient chunks it is the fused
// prove step's DEEP codeword, ethrex_tpu/parallel/core.py:103-108.
//
// 1/(x - z) = conj(x) / N(x): conj(x) = x^3 - s1 x^2 + s2 x - s3 over the
// three other conjugates of z (ext coefficients) and N(x) = x^4 - e1 x^3 +
// e2 x^2 - e3 x + e4 its minimal polynomial (base coefficients); the host
// computes both sets of coefficients per opening point.
//
// Bound on this card: memory, 4 (1 + 8 + 4 nq + 4) bytes a point (x, the
// (N, 8) row of S1 and S2, the nq x 4 chunk words, the (N, 4) result).
// The design keeps the arithmetic under that:
//  * A thread takes PTS points, THREADS apart (so every load and store of
//    a warp is contiguous), and inverts their 2 PTS norms with one
//    inversion by Montgomery's trick: 3 products a norm and 60 / (2 PTS)
//    for the Fermat power, where one power a point took 60.  A zero
//    norm (zeta in the base field on a domain point) is left out of the
//    products and gets 0, as the per-element Fermat power gives it; a
//    point past N is left out the same way.  The inverse is unique, so
//    the result equals the reference's bit for bit.
//  * sum_b g_b Q_b(zeta) is a constant of the proof: the host folds it
//    into c1, so the sum over the chunks is sum_b g_b Q_b(x), taken as
//    raw 64-bit products (bb::mad, with the host's W g_b for the x^4 = W
//    wrap: four products a coordinate a chunk, then a bb::fold) and one
//    bb::redc a coordinate.  The two quotients add into one lazy sum the
//    same way.
//  * The per-proof constants are one kernel parameter (`Consts`, in the
//    constant bank): no thread loads them from global memory.
#include <cstring>

#include "babybear.cuh"

namespace {

constexpr int PTS = 4;          // points a thread
constexpr int THREADS = 128;    // threads a block
constexpr int MAX_NQ = 16;      // quotient chunks the constants can hold

struct Opening {
  uint32_t s1[4], s2[4], s3[4], e[4], c[4];
};

// Montgomery words; c of opening 0 already holds c1 + sum_b g_b Q_b(zeta)
struct Consts {
  Opening o[2];
  uint32_t g[MAX_NQ][4];
  uint32_t wg[MAX_NQ][4];       // W g_b
};

__device__ __forceinline__ uint32_t norm(const Opening& o, uint32_t x) {
  uint32_t n = bb::sub(x, o.e[0]);
  n = bb::add(bb::mul(n, x), o.e[1]);
  n = bb::sub(bb::mul(n, x), o.e[2]);
  return bb::add(bb::mul(n, x), o.e[3]);
}

// iz = conj(x) ninv = 1/(x - z), and wiz = W iz (coordinates 1-3)
__device__ __forceinline__ void inv_x_minus(const Opening& o, uint32_t x,
                                            uint32_t ninv, uint32_t iz[4],
                                            uint32_t wiz[4]) {
  uint32_t acc[4];
  acc[0] = bb::sub(x, o.s1[0]);
#pragma unroll
  for (int m = 1; m < 4; ++m) acc[m] = bb::sub(0u, o.s1[m]);
#pragma unroll
  for (int m = 0; m < 4; ++m) acc[m] = bb::add(bb::mul(acc[m], x), o.s2[m]);
#pragma unroll
  for (int m = 0; m < 4; ++m)
    iz[m] = bb::mul(bb::sub(bb::mul(acc[m], x), o.s3[m]), ninv);
  wiz[0] = 0u;
#pragma unroll
  for (int m = 1; m < 4; ++m) wiz[m] = bb::mul(iz[m], bb::W_M);
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

template <int NO>   // openings: 2 (a proof's DEEP phase) or 1 (fused step)
__global__ void __launch_bounds__(THREADS)
k_deep(const uint32_t* __restrict__ pts, const uint4* __restrict__ s1m,
       const uint4* __restrict__ s2m, const uint32_t* __restrict__ q_lde,
       uint4* __restrict__ out, long long N, int nq, int ss,
       const __grid_constant__ Consts k) {
  const long long base =
      (long long)blockIdx.x * (THREADS * PTS) + threadIdx.x;
  // pass 1: the norms and their running products (zeros left out)
  uint32_t xs[PTS], nrm[PTS][NO], pre[PTS][NO];
  uint32_t run = bb::MONT_ONE;
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const long long i = base + (long long)j * THREADS;
    xs[j] = i < N ? pts[i] : 0u;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const uint32_t v = i < N ? norm(k.o[o], xs[j]) : 0u;
      nrm[j][o] = v;
      pre[j][o] = run;
      if (v != 0u) run = bb::mul(run, v);
    }
  }
  uint32_t inv = bb::mpow(run, bb::P - 2u);
  // pass 2, last norm first: each norm's inverse, then the point's F
#pragma unroll
  for (int j = PTS - 1; j >= 0; --j) {
    uint32_t ninv[NO];
#pragma unroll
    for (int o = NO - 1; o >= 0; --o) {
      const uint32_t v = nrm[j][o];
      ninv[o] = v != 0u ? bb::mul(inv, pre[j][o]) : 0u;
      if (v != 0u) inv = bb::mul(inv, v);
    }
    const long long i = base + (long long)j * THREADS;
    if (i >= N) continue;
    const uint32_t x = xs[j];
    // a = S1 - c1 + sum_b g_b Q_b(x), as a lazy sum
    const uint4 m1 = s1m[i * ss];
    uint64_t acc[4] = {
        bb::mad(bb::sub(m1.x, k.o[0].c[0]), bb::MONT_ONE, 0ull),
        bb::mad(bb::sub(m1.y, k.o[0].c[1]), bb::MONT_ONE, 0ull),
        bb::mad(bb::sub(m1.z, k.o[0].c[2]), bb::MONT_ONE, 0ull),
        bb::mad(bb::sub(m1.w, k.o[0].c[3]), bb::MONT_ONE, 0ull)};
#pragma unroll 4
    for (int b = 0; b < nq; ++b) {
      uint32_t qv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        qv[m] = q_lde[((long long)b * 4 + m) * N + i];
      ext_mad(qv, k.g[b], k.wg[b], acc);
    }
    uint32_t a[4], iz[4], wiz[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = bb::redc(acc[m]);
    // F = a / (x - z0) [+ (S2 - c2) / (x - z1)], one more lazy sum
    uint64_t r[4] = {0ull, 0ull, 0ull, 0ull};
    inv_x_minus(k.o[0], x, ninv[0], iz, wiz);
    ext_mad(a, iz, wiz, r);
    if constexpr (NO == 2) {
      const uint4 m2 = s2m[i * ss];
      const uint32_t d[4] = {
          bb::sub(m2.x, k.o[1].c[0]), bb::sub(m2.y, k.o[1].c[1]),
          bb::sub(m2.z, k.o[1].c[2]), bb::sub(m2.w, k.o[1].c[3])};
      inv_x_minus(k.o[1], x, ninv[1], iz, wiz);
      ext_mad(d, iz, wiz, r);
    }
    out[i] = make_uint4(bb::redc(r[0]), bb::redc(r[1]), bb::redc(r[2]),
                        bb::redc(r[3]));
  }
}

}  // namespace

extern "C" {

// pts (N,), s1m (N, 4), s2m (N, 4) (rows 4 ss words apart: ss = 2 reads
// the two halves of one (N, 8) K3 result in place), q_lde (nq, 4, N),
// consts: `words` host words laid out as `Consts` -> out (N, 4)
int deep_compose(const void* pts, const void* s1m, const void* s2m,
                 const void* q_lde, const void* consts, int words, void* out,
                 long long N, int nq, int two, int ss, cudaStream_t stream) {
  if (words * 4 != (int)sizeof(Consts) || nq < 0 || nq > MAX_NQ)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  Consts k;
  memcpy(&k, consts, sizeof(Consts));
  const unsigned grid = (unsigned)((N + THREADS * PTS - 1) / (THREADS * PTS));
  const uint32_t* p = (const uint32_t*)pts;
  const uint4* a = (const uint4*)s1m;
  const uint4* b = (const uint4*)s2m;
  const uint32_t* q = (const uint32_t*)q_lde;
  if (two) {
    k_deep<2><<<grid, THREADS, 0, stream>>>(p, a, b, q, (uint4*)out, N, nq,
                                             ss, k);
  } else {
    k_deep<1><<<grid, THREADS, 0, stream>>>(p, a, b, q, (uint4*)out, N, nq,
                                             ss, k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
