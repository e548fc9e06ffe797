// K8: the DEEP composition codeword of a STARK proof, one fused pass per
// LDE point x:
//
//   F(x) = (S1(x) - c1 + sum_b g_b (Q_b(x) - Q_b(zeta))) / (x - zeta)
//        + (S2(x) - c2) / (x - zeta*g)
//
// Replaces the jax.jit body ethrex_tpu/stark/prover.py:565-585
// (`phase_deep`) with what it calls: ops/ext.py:134 `inv_x_minus_zeta`,
// the ext mul/add/sub of ops/ext.py:33-62 and ops/babybear.py:168
// `sum_mod` over the B quotient chunks.  S1 and S2 are the two K3 products
// (LDE rows @ gamma powers); c1, c2, the gamma powers g_b and the chunk
// openings Q_b(zeta) are per-proof constants from the host.  With one
// opening and no quotient chunks it is the fused prove step's DEEP
// codeword, ethrex_tpu/parallel/core.py:103-108.
//
// 1/(x - z) = conj(x) / N(x): conj(x) = x^3 - s1 x^2 + s2 x - s3 over the
// three other conjugates of z (ext coefficients) and N(x) = x^4 - e1 x^3 +
// e2 x^2 - e3 x + e4 its minimal polynomial (base coefficients); the host
// computes both sets of coefficients per opening point.  The two norms
// share one Fermat power (Montgomery's trick); the inverse is unique, so
// the result equals the reference's batch inversion bit for bit.
//
// Constant block (uint32, Montgomery), per opening o = 0, 1:
//   [20 o + 0, 12): s1, s2, s3   [20 o + 12, 16): e1..e4   [20 o + 16, 20): c_o
// then g_b (nq x 4) at 40 and Q_b(zeta) (nq x 4) at 40 + 4 nq.
//
// Bound on this card: memory.  Per point it reads x, S1, S2 and the nq x 4
// quotient words and writes 4 words; about 80 + 20 nq Montgomery
// products.
#include "babybear.cuh"

namespace {

struct Opening {
  uint32_t s1[4], s2[4], s3[4], e[4], c[4];
};

__device__ __forceinline__ void load_opening(const uint32_t* k, Opening& o) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o.s1[j] = k[j];
    o.s2[j] = k[4 + j];
    o.s3[j] = k[8 + j];
    o.e[j] = k[12 + j];
    o.c[j] = k[16 + j];
  }
}

// conj(x) (ext) and N(x) (base) for base point x
__device__ __forceinline__ uint32_t conj_norm(const Opening& o, uint32_t x,
                                              uint32_t conj[4]) {
  uint32_t acc[4];
  acc[0] = bb::sub(x, o.s1[0]);
#pragma unroll
  for (int j = 1; j < 4; ++j) acc[j] = bb::sub(0u, o.s1[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = bb::add(bb::mul(acc[j], x), o.s2[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) conj[j] = bb::sub(bb::mul(acc[j], x), o.s3[j]);
  uint32_t n = bb::sub(x, o.e[0]);
  n = bb::add(bb::mul(n, x), o.e[1]);
  n = bb::sub(bb::mul(n, x), o.e[2]);
  return bb::add(bb::mul(n, x), o.e[3]);
}

__global__ void k_deep(const uint32_t* __restrict__ pts,
                       const uint32_t* __restrict__ s1m,
                       const uint32_t* __restrict__ s2m,
                       const uint32_t* __restrict__ q_lde,
                       const uint32_t* __restrict__ kc,
                       uint32_t* __restrict__ out, long long N, int nq,
                       int two) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t x = pts[i];
  Opening o0, o1;
  load_opening(kc, o0);
  uint32_t conj0[4], conj1[4];
  uint32_t n0 = conj_norm(o0, x, conj0);
  uint32_t inv0, inv1 = 0u;
  if (two) {
    load_opening(kc + 20, o1);
    uint32_t n1 = conj_norm(o1, x, conj1);
    uint32_t prod = bb::mul(n0, n1);
    if (prod != 0u) {
      uint32_t inv = bb::mpow(prod, bb::P - 2u);
      inv0 = bb::mul(inv, n1);
      inv1 = bb::mul(inv, n0);
    } else {
      inv0 = bb::mpow(n0, bb::P - 2u);
      inv1 = bb::mpow(n1, bb::P - 2u);
    }
  } else {
    inv0 = bb::mpow(n0, bb::P - 2u);
  }
  uint4 m1 = reinterpret_cast<const uint4*>(s1m)[i];
  uint32_t a[4] = {bb::sub(m1.x, o0.c[0]), bb::sub(m1.y, o0.c[1]),
                   bb::sub(m1.z, o0.c[2]), bb::sub(m1.w, o0.c[3])};
  const uint32_t* gq = kc + 40;
  const uint32_t* qz = kc + 40 + 4 * nq;
  for (int b = 0; b < nq; ++b) {
    uint32_t d[4], t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d[k] = bb::sub(q_lde[((long long)b * 4 + k) * N + i], qz[4 * b + k]);
    bb::ext_mul(d, gq + 4 * b, t);
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = bb::add(a[k], t[k]);
  }
  uint32_t iz[4], r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) iz[k] = bb::mul(conj0[k], inv0);
  bb::ext_mul(a, iz, r);
  if (two) {
    uint4 m2 = reinterpret_cast<const uint4*>(s2m)[i];
    uint32_t c[4] = {bb::sub(m2.x, o1.c[0]), bb::sub(m2.y, o1.c[1]),
                     bb::sub(m2.z, o1.c[2]), bb::sub(m2.w, o1.c[3])};
    uint32_t izg[4], t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) izg[k] = bb::mul(conj1[k], inv1);
    bb::ext_mul(c, izg, t);
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = bb::add(r[k], t[k]);
  }
  reinterpret_cast<uint4*>(out)[i] = make_uint4(r[0], r[1], r[2], r[3]);
}

}  // namespace

extern "C" {

// pts (N,), s1m (N, 4), s2m (N, 4) or null when two == 0, q_lde (nq, 4, N)
// or null when nq == 0, consts as above -> out (N, 4)
int deep_compose(const void* pts, const void* s1m, const void* s2m,
                 const void* q_lde, const void* consts, void* out,
                 long long N, int nq, int two, cudaStream_t stream) {
  if (N > 0) {
    k_deep<<<(unsigned)((N + 255) / 256), 256, 0, stream>>>(
        (const uint32_t*)pts, (const uint32_t*)s1m, (const uint32_t*)s2m,
        (const uint32_t*)q_lde, (const uint32_t*)consts, (uint32_t*)out, N,
        nq, two);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
