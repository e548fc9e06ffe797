// K5: BN254 multi-scalar multiplication over G1 (Fp) and G2 (Fp2).
//
// Replaces the jax.jit program ethrex_tpu/ops/bn254_msm.py:308
// `_msm_device` with its field and curve pieces (`fmul:118`, `fsqr:162`,
// `Fp2Ops:186`, `point_double:222`, `point_add:240`): the Groth16 wrap's
// hot loop (crypto/groth16.py `prove`, three G1 MSMs and one G2 MSM).
//
// Field: Fp in 8 x 32-bit Montgomery limbs (R = 2^256, the radix of the
// reference's 16 x 16-bit limbs, so the Montgomery forms are the same
// numbers), CIOS product with 64-bit partial products; every operation
// returns the canonical residue.  Fp2 = Fp[u]/(u^2 + 1) over the same code,
// with the reference's three-product multiplication.  The point code is
// one template over the field.
//
// Algorithm, as the reference's: one thread per point runs the
// double-and-add over the scalar's bits, LSB first (acc += P where the bit
// is set, then P = 2P), then a tree sum over the accumulators, one launch
// per level, pairing i with i + ceil(m/2) exactly as the reference does, so
// even the Jacobian result is the reference's.  Point addition covers
// infinity on either side (Z = 0), P == -Q (-> infinity) and P == Q (-> the
// doubling), as `point_add` does with selects; here they are branches.
//
// The tensors on the PyTorch side hold the reference's 16-bit limbs in
// int32 ((n, 16) for G1, (n, 2, 16) for G2); the kernels pack two limbs
// per word on load and unpack on the final store.
//
// Bound on this card: operations.  A CIOS product is 128 IMAD.WIDE.U32
// (a_i*b_j and m*p_j) plus 8 IMADs (m), 264 IMAD issue slots; a G1 doubling
// costs 7 products, an addition 16, and G2 three times as many.  The design
// keeps a point per thread (n threads, a few per SM): Pippenger buckets and
// more threads per point are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 8;  // 32-bit words per Fp element
__constant__ uint32_t kP[NW] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du,
                                0x97816a91u, 0x8181585du, 0xb85045b6u,
                                0xe131a029u, 0x30644e72u};
constexpr uint32_t kNP = 0xe4866389u;  // -p^{-1} mod 2^32

struct Fp {
  uint32_t w[NW];
};

struct Fp2 {
  Fp c0, c1;
};

__device__ __forceinline__ bool is_zero(const Fp& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) o |= a.w[i];
  return o == 0u;
}

__device__ __forceinline__ bool is_zero(const Fp2& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}

// t >= p, lexicographic from the top word
__device__ __forceinline__ bool geq_p(const uint32_t* t) {
#pragma unroll
  for (int i = NW - 1; i >= 0; --i) {
    if (t[i] != kP[i]) return t[i] > kP[i];
  }
  return true;
}

__device__ __forceinline__ void sub_p(uint32_t* t) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t d = (uint64_t)t[i] - kP[i] - borrow;
    t[i] = (uint32_t)d;
    borrow = (d >> 63) & 1u;
  }
}

__device__ __forceinline__ Fp add(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)a.w[i] + b.w[i] + carry;
    s.w[i] = (uint32_t)v;
    carry = v >> 32;
  }
  if (carry || geq_p(s.w)) sub_p(s.w);
  return s;
}

__device__ __forceinline__ Fp sub(const Fp& a, const Fp& b) {
  Fp d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 63) & 1u;
  }
  if (borrow) {  // a < b: add p back (the carry out cancels the borrow)
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t v = (uint64_t)d.w[i] + kP[i] + carry;
      d.w[i] = (uint32_t)v;
      carry = v >> 32;
    }
  }
  return d;
}

// Montgomery product a * b * 2^-256 mod p (CIOS), canonical output
__device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.w[i] * b.w[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * kNP;
    s = (uint64_t)t[0] + (uint64_t)m * kP[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * kP[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = t[i];
  if (t[NW] != 0u || geq_p(r.w)) sub_p(r.w);
  return r;
}

__device__ __forceinline__ Fp2 add(const Fp2& a, const Fp2& b) {
  return Fp2{add(a.c0, b.c0), add(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 sub(const Fp2& a, const Fp2& b) {
  return Fp2{sub(a.c0, b.c0), sub(a.c1, b.c1)};
}

// (a0 + a1 u)(b0 + b1 u), u^2 = -1, as ethrex_tpu/ops/bn254_msm.py:196
__device__ __forceinline__ Fp2 mul(const Fp2& a, const Fp2& b) {
  Fp t0 = mul(a.c0, b.c0);
  Fp t1 = mul(a.c1, b.c1);
  Fp mid = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return Fp2{sub(t0, t1), sub(sub(mid, t0), t1)};
}

template <class F>
struct Pt {
  F X, Y, Z;
};

template <class F>
__device__ F zero_elem() {
  F z;
  uint32_t* w = reinterpret_cast<uint32_t*>(&z);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(F) / 4); ++i) w[i] = 0u;
  return z;
}

// Jacobian doubling (a = 0), ethrex_tpu/ops/bn254_msm.py:222
template <class F>
__device__ Pt<F> pdbl(const Pt<F>& P) {
  if (is_zero(P.Z)) return P;
  F A = mul(P.X, P.X);
  F B = mul(P.Y, P.Y);
  F C = mul(B, B);
  F xb = add(P.X, B);
  F t = sub(mul(xb, xb), add(A, C));
  F D = add(t, t);
  F E = add(add(A, A), A);
  F Fq = mul(E, E);
  F X3 = sub(Fq, add(D, D));
  F c4 = add(add(C, C), add(C, C));
  F c8 = add(c4, c4);
  F Y3 = sub(mul(E, sub(D, X3)), c8);
  F Z3 = mul(add(P.Y, P.Y), P.Z);
  return Pt<F>{X3, Y3, Z3};
}

// Jacobian addition, ethrex_tpu/ops/bn254_msm.py:240
template <class F>
__device__ Pt<F> padd(const Pt<F>& P1, const Pt<F>& P2) {
  if (is_zero(P1.Z)) return P2;
  if (is_zero(P2.Z)) return P1;
  F Z1Z1 = mul(P1.Z, P1.Z);
  F Z2Z2 = mul(P2.Z, P2.Z);
  F U1 = mul(P1.X, Z2Z2);
  F U2 = mul(P2.X, Z1Z1);
  F S1 = mul(mul(P1.Y, P2.Z), Z2Z2);
  F S2 = mul(mul(P2.Y, P1.Z), Z1Z1);
  F H = sub(U2, U1);
  F Rr = sub(S2, S1);
  if (is_zero(H)) {
    if (is_zero(Rr)) return pdbl(P1);
    F z = zero_elem<F>();
    return Pt<F>{z, z, z};
  }
  F HH = mul(H, H);
  F HHH = mul(H, HH);
  F V = mul(U1, HH);
  F X3 = sub(sub(mul(Rr, Rr), HHH), add(V, V));
  F Y3 = sub(mul(Rr, sub(V, X3)), mul(S1, HHH));
  F Z3 = mul(mul(P1.Z, P2.Z), H);
  return Pt<F>{X3, Y3, Z3};
}

// 16-bit limbs (int32) <-> 32-bit words
template <class F>
__device__ __forceinline__ F load16(const int32_t* limbs) {
  F v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(F) / 4); ++k) {
    w[k] = ((uint32_t)limbs[2 * k] & 0xFFFFu) |
           (((uint32_t)limbs[2 * k + 1] & 0xFFFFu) << 16);
  }
  return v;
}

template <class F>
__device__ __forceinline__ void store16(const F& v, int32_t* limbs) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(F) / 4); ++k) {
    limbs[2 * k] = (int32_t)(w[k] & 0xFFFFu);
    limbs[2 * k + 1] = (int32_t)(w[k] >> 16);
  }
}

// accumulator array layout: [X | Y | Z], each n elements of F
template <class F>
__device__ __forceinline__ Pt<F> load_acc(const F* acc, int n, int i) {
  return Pt<F>{acc[i], acc[n + i], acc[2 * n + i]};
}

template <class F>
__device__ __forceinline__ void store_acc(F* acc, int n, int i,
                                          const Pt<F>& P) {
  acc[i] = P.X;
  acc[n + i] = P.Y;
  acc[2 * n + i] = P.Z;
}

template <class F>
__global__ void k_double_and_add(const int32_t* __restrict__ X,
                                 const int32_t* __restrict__ Y,
                                 const int32_t* __restrict__ Z,
                                 const int32_t* __restrict__ bits, int n,
                                 int nbits, F* __restrict__ acc) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int L16 = 2 * (int)(sizeof(F) / 4);
  Pt<F> Q{load16<F>(X + (long long)i * L16), load16<F>(Y + (long long)i * L16),
          load16<F>(Z + (long long)i * L16)};
  F z = zero_elem<F>();
  Pt<F> A{z, z, z};
  const int32_t* row = bits + (long long)i * nbits;
  for (int j = 0; j < nbits; ++j) {
    if (row[j]) A = padd(A, Q);
    Q = pdbl(Q);
  }
  store_acc(acc, n, i, A);
}

// one tree level over the first m accumulators: i + half pairs with i
template <class F>
__global__ void k_tree_level(F* __restrict__ acc, int n, int m, int half) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m - half) return;
  store_acc(acc, n, i, padd(load_acc(acc, n, i), load_acc(acc, n, i + half)));
}

template <class F>
__global__ void k_store_result(const F* __restrict__ acc, int n,
                               int32_t* __restrict__ out) {
  constexpr int L16 = 2 * (int)(sizeof(F) / 4);
  Pt<F> P = load_acc(acc, n, 0);
  store16(P.X, out);
  store16(P.Y, out + L16);
  store16(P.Z, out + 2 * L16);
}

constexpr int kThreads = 64;

template <class F>
int run_msm(const int32_t* X, const int32_t* Y, const int32_t* Z,
            const int32_t* bits, F* acc, int n, int nbits, int32_t* out,
            cudaStream_t stream) {
  k_double_and_add<F><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      X, Y, Z, bits, n, nbits, acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int m = n; m > 1;) {
    int half = (m + 1) / 2;
    int pairs = m - half;
    k_tree_level<F><<<(pairs + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(acc, n, m, half);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    m = half;
  }
  k_store_result<F><<<1, 1, 0, stream>>>(acc, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X, Y, Z: (n, 16) int32 limbs for G1 or (n, 2, 16) for G2 (fp2 = 1);
// bits: (n, nbits) int32 0/1, LSB first; acc: scratch of 3 n elements of
// the field (3 n x 32 or 64 bytes); out: (3, 16) or (3, 2, 16) int32.
int bn254_msm(const void* X, const void* Y, const void* Z, const void* bits,
              void* acc, int n, int nbits, int fp2, void* out,
              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (fp2) {
    return run_msm<Fp2>((const int32_t*)X, (const int32_t*)Y,
                        (const int32_t*)Z, (const int32_t*)bits, (Fp2*)acc, n,
                        nbits, (int32_t*)out, stream);
  }
  return run_msm<Fp>((const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z,
                     (const int32_t*)bits, (Fp*)acc, n, nbits, (int32_t*)out,
                     stream);
}

}  // extern "C"
