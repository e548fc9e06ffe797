// BN254 base field Fp, its quadratic extension Fp2 and Jacobian point
// arithmetic, for kernel K5 (csrc/bn254_msm.cu) and
// ethrex_tpu_torch/tools/bn254_mul_rate.py.
//
// Replaces the field and curve pieces of ethrex_tpu/ops/bn254_msm.py
// (`fmul:118`, `fsqr:162`, `Fp2Ops:186`, `point_double:222`,
// `point_add:240`).  Fp travels in 8 x 32-bit Montgomery words (R =
// 2^256, the radix of the reference's 16 x 16-bit limbs, so the Montgomery
// forms are the same numbers); the product is CIOS with 64-bit partial
// products and every operation returns the canonical residue.  Fp2 =
// Fp[u]/(u^2 + 1) over the same code, with the reference's three-product
// multiplication.  The point code is one template over the field; curve a
// = 0 in both groups.
#pragma once

#include <cstdint>

namespace bn254 {

constexpr int NW = 8;  // 32-bit words per Fp element
static __constant__ uint32_t kP[NW] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// 2^256 mod p: the Montgomery form of 1
static __constant__ uint32_t kOne[NW] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
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
__device__ __forceinline__ Fp mul_inline(const Fp& a, const Fp& b) {
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

// The product as every caller uses it: one copy of its code, called.  A
// lone thread runs a point operation's straight-line code at the rate the
// instruction cache feeds it: on an H100 a G1 addition with its 16
// products inlined takes about 57k cycles, with them called about 25k
// (tools/bn254_mul_rate.py), and K5's reductions are such chains.
__device__ __noinline__ Fp mul(Fp a, Fp b) { return mul_inline(a, b); }

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

// a^-1 (Montgomery in, Montgomery out) by Fermat, a^(p - 2): 253
// squarings and a product per set bit below the top; 0 maps to 0
__device__ __forceinline__ Fp inv(const Fp& a) {
  Fp x = a;
#pragma unroll 1
  for (int bit = 252; bit >= 0; --bit) {
    x = mul(x, x);
    const uint32_t e = kP[bit >> 5] - (bit < 32 ? 2u : 0u);
    if ((e >> (bit & 31)) & 1u) x = mul(x, a);
  }
  return x;
}

// (a0 - a1 u) / (a0^2 + a1^2)
__device__ __forceinline__ Fp2 inv(const Fp2& a) {
  const Fp t = inv(add(mul(a.c0, a.c0), mul(a.c1, a.c1)));
  Fp z;
#pragma unroll
  for (int i = 0; i < NW; ++i) z.w[i] = 0u;
  return Fp2{mul(a.c0, t), sub(z, mul(a.c1, t))};
}

template <class F>
__device__ __forceinline__ F zero_elem() {
  F z;
  uint32_t* w = reinterpret_cast<uint32_t*>(&z);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(F) / 4); ++i) w[i] = 0u;
  return z;
}

// the Montgomery form of 1 (Fp2: 1 + 0 u)
template <class F>
__device__ __forceinline__ F one_elem() {
  F o = zero_elem<F>();
  uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = kOne[i];
  return o;
}

template <class F>
__device__ __forceinline__ F neg(const F& a) {
  return sub(zero_elem<F>(), a);
}

template <class F>
struct Pt {
  F X, Y, Z;
};

template <class F>
__device__ __forceinline__ Pt<F> infinity() {
  F z = zero_elem<F>();
  return Pt<F>{z, z, z};
}

// The point operations are not inlined: each is one function per field,
// called from every site.  Inlined, the G2 kernels of K5 took ten
// minutes to compile (every call site of `padd` held its own copy of 48
// Fp products and of `pdbl`), and the rare doubling case of `padd` and
// `madd` swelled their common path.

// Jacobian doubling (a = 0), ethrex_tpu/ops/bn254_msm.py:222; 7
// products.  `pdbl_inline` is the body, for k_shift's loop of doublings;
// `pdbl` below is the called form.
template <class F>
__device__ __forceinline__ Pt<F> pdbl_inline(const Pt<F>& P) {
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

template <class F>
__device__ __noinline__ Pt<F> pdbl(const Pt<F>& P) {
  return pdbl_inline(P);
}

// Jacobian addition, ethrex_tpu/ops/bn254_msm.py:240; 16 products.
// Complete: infinity on either side, P1 == P2 (the doubling) and
// P1 == -P2 (infinity), as `point_add` selects them.
template <class F>
__device__ __noinline__ Pt<F> padd(const Pt<F>& P1, const Pt<F>& P2) {
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
    return infinity<F>();
  }
  F HH = mul(H, H);
  F HHH = mul(H, HH);
  F V = mul(U1, HH);
  F X3 = sub(sub(mul(Rr, Rr), HHH), add(V, V));
  F Y3 = sub(mul(Rr, sub(V, X3)), mul(S1, HHH));
  F Z3 = mul(mul(P1.Z, P2.Z), H);
  return Pt<F>{X3, Y3, Z3};
}

// P1 + (X2, Y2, 1): `padd` with Z2 = 1, 11 products, the same complete
// cases (the affine point is finite)
template <class F>
__device__ __noinline__ Pt<F> madd(const Pt<F>& P1, const F& X2,
                                   const F& Y2) {
  if (is_zero(P1.Z)) return Pt<F>{X2, Y2, one_elem<F>()};
  F Z1Z1 = mul(P1.Z, P1.Z);
  F U2 = mul(X2, Z1Z1);
  F S2 = mul(Y2, mul(P1.Z, Z1Z1));
  F H = sub(U2, P1.X);
  F Rr = sub(S2, P1.Y);
  if (is_zero(H)) {
    if (is_zero(Rr)) return pdbl(P1);
    return infinity<F>();
  }
  F HH = mul(H, H);
  F HHH = mul(H, HH);
  F V = mul(P1.X, HH);
  F X3 = sub(sub(mul(Rr, Rr), HHH), add(V, V));
  F Y3 = sub(mul(Rr, sub(V, X3)), mul(P1.Y, HHH));
  F Z3 = mul(P1.Z, H);
  return Pt<F>{X3, Y3, Z3};
}

// 16-bit limbs (int32, the reference's layout) <-> 32-bit words
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

}  // namespace bn254
