// Native secp256k1 ECDSA public-key recovery: the sender-recovery hot
// path of L1 block import (parity seat: the reference's batched
// recover_transaction_senders ahead of execution; behavioral parity with
// this repo's ethrex_tpu_torch/crypto/secp256k1.py, which remains the
// reference implementation and the differential-fuzz oracle).
//
// Scope: recovery only (the consensus-critical op).  Signing keeps the
// RFC 6979 pure-Python path — it never sits on the import critical path.
//
// Design:
//   * 4x64-limb field arithmetic with __int128 accumulators; reduction
//     exploits the special forms 2^256 = 0x1000003D1 (mod P) and
//     2^256 = NC (mod N, NC 129 bits).
//   * Jacobian coordinates; u1*G + u2*R via Shamir's trick (the same
//     shape as the Python oracle, so edge cases line up 1:1).
//   * No global state, no allocation: every entry point is pure and
//     thread-safe, so ctypes' GIL release during the call gives a
//     Python thread pool real parallelism (the whole point).
//
// Build: gcc -O3 -shared -fPIC -o libsecp256k1.so secp256k1.c
// ctypes binder + availability probe: ethrex_tpu_torch/crypto/native_secp256k1.py

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;

typedef struct { uint64_t d[4]; } u256;  // little-endian limbs

// ---------------------------------------------------------------------------
// constants

// field prime P = 2^256 - 0x1000003D1
static const u256 FIELD_P = {{0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
                              0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL}};
// group order N
static const u256 ORDER_N = {{0xBFD25E8CD0364141ULL, 0xBAAEDCE6AF48A03BULL,
                              0xFFFFFFFFFFFFFFFEULL, 0xFFFFFFFFFFFFFFFFULL}};
// NC = 2^256 - N (129 bits; limb 2 is the 2^128 bit)
static const uint64_t NC0 = 0x402DA1732FC9BEBFULL;
static const uint64_t NC1 = 0x4551231950B75FC4ULL;
static const uint64_t NC2 = 1ULL;
// 2^256 mod P
static const uint64_t PC0 = 0x1000003D1ULL;

static const u256 GEN_X = {{0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL,
                            0x55A06295CE870B07ULL, 0x79BE667EF9DCBBACULL}};
static const u256 GEN_Y = {{0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL,
                            0x5DA4FBFC0E1108A8ULL, 0x483ADA7726A3C465ULL}};

// ---------------------------------------------------------------------------
// 256-bit helpers

static void u256_from_be(u256 *r, const uint8_t b[32]) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = 0;
        for (int j = 0; j < 8; j++)
            v = (v << 8) | b[(3 - i) * 8 + j];
        r->d[i] = v;
    }
}

static void u256_to_be(const u256 *a, uint8_t b[32]) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = a->d[3 - i];
        for (int j = 7; j >= 0; j--) {
            b[i * 8 + j] = (uint8_t)(v & 0xFF);
            v >>= 8;
        }
    }
}

static int u256_is_zero(const u256 *a) {
    return (a->d[0] | a->d[1] | a->d[2] | a->d[3]) == 0;
}

static int u256_cmp(const u256 *a, const u256 *b) {
    for (int i = 3; i >= 0; i--) {
        if (a->d[i] < b->d[i]) return -1;
        if (a->d[i] > b->d[i]) return 1;
    }
    return 0;
}

// r = a - b, returns borrow
static uint64_t u256_sub(u256 *r, const u256 *a, const u256 *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)a->d[i] - b->d[i] - (uint64_t)borrow;
        r->d[i] = (uint64_t)t;
        borrow = (t >> 64) & 1;  // 1 when the subtraction wrapped
    }
    return (uint64_t)borrow;
}

// r = a + b, returns carry
static uint64_t u256_add(u256 *r, const u256 *a, const u256 *b) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)a->d[i] + b->d[i] + (uint64_t)carry;
        r->d[i] = (uint64_t)t;
        carry = t >> 64;
    }
    return (uint64_t)carry;
}

static int u256_bit(const u256 *a, int i) {
    return (int)((a->d[i >> 6] >> (i & 63)) & 1);
}

static int u256_bitlen(const u256 *a) {
    for (int i = 3; i >= 0; i--) {
        if (a->d[i]) {
            int n = 64 * i;
            uint64_t v = a->d[i];
            while (v) { n++; v >>= 1; }
            return n;
        }
    }
    return 0;
}

// 512-bit product a*b -> lo/hi halves
static void u256_mul_wide(const u256 *a, const u256 *b, u256 *lo, u256 *hi) {
    uint64_t w[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)a->d[i] * b->d[j] + w[i + j] + (uint64_t)carry;
            w[i + j] = (uint64_t)t;
            carry = t >> 64;
        }
        w[i + 4] = (uint64_t)carry;
    }
    memcpy(lo->d, w, 32);
    memcpy(hi->d, w + 4, 32);
}

// ---------------------------------------------------------------------------
// arithmetic mod P (2^256 = PC0 mod P)

static void fe_reduce_once(u256 *a) {
    if (u256_cmp(a, &FIELD_P) >= 0)
        u256_sub(a, a, &FIELD_P);
}

static void fe_add(u256 *r, const u256 *a, const u256 *b) {
    uint64_t carry = u256_add(r, a, b);
    if (carry) {
        // r = r + 2^256 mod P = r + PC0
        u256 pc = {{PC0, 0, 0, 0}};
        u256_add(r, r, &pc);  // cannot carry again: r < P after wrap
    }
    fe_reduce_once(r);
}

static void fe_sub(u256 *r, const u256 *a, const u256 *b) {
    uint64_t borrow = u256_sub(r, a, b);
    if (borrow)
        u256_add(r, r, &FIELD_P);
}

static void fe_mul(u256 *r, const u256 *a, const u256 *b) {
    u256 lo, hi;
    u256_mul_wide(a, b, &lo, &hi);
    // fold hi*PC0 into lo: hi*PC0 is at most 289 bits
    uint64_t w[5] = {0};
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)hi.d[i] * PC0 + (uint64_t)carry;
        w[i] = (uint64_t)t;
        carry = t >> 64;
    }
    w[4] = (uint64_t)carry;
    u256 t0 = {{w[0], w[1], w[2], w[3]}};
    uint64_t c2 = u256_add(&t0, &lo, &t0);
    uint64_t top = w[4] + c2;  // < 2^34
    // fold top*2^256 = top*PC0
    u128 t = (u128)top * PC0 + t0.d[0];
    t0.d[0] = (uint64_t)t;
    u128 cc = t >> 64;
    for (int i = 1; i < 4 && cc; i++) {
        t = (u128)t0.d[i] + (uint64_t)cc;
        t0.d[i] = (uint64_t)t;
        cc = t >> 64;
    }
    if (cc) {  // wrapped 2^256 once more
        u256 pc = {{PC0, 0, 0, 0}};
        u256_add(&t0, &t0, &pc);
    }
    fe_reduce_once(&t0);
    *r = t0;
}

static void fe_sqr(u256 *r, const u256 *a) { fe_mul(r, a, a); }

// r = a^e mod P (square-and-multiply)
static void fe_pow(u256 *r, const u256 *a, const u256 *e) {
    u256 acc = {{1, 0, 0, 0}};
    int bits = u256_bitlen(e);
    for (int i = bits - 1; i >= 0; i--) {
        fe_sqr(&acc, &acc);
        if (u256_bit(e, i))
            fe_mul(&acc, &acc, a);
    }
    *r = acc;
}

static void fe_inv(u256 *r, const u256 *a) {
    u256 e = FIELD_P;
    u256 two = {{2, 0, 0, 0}};
    u256_sub(&e, &e, &two);
    fe_pow(r, a, &e);
}

// sqrt via a^((P+1)/4); caller must verify the square
static void fe_sqrt(u256 *r, const u256 *a) {
    // (P+1)/4 = (P - 3)/4 + 1, computed once here by shifting P+1
    u256 e = FIELD_P;
    u256 one = {{1, 0, 0, 0}};
    u256_add(&e, &e, &one);  // P+1 fits: P < 2^256 - 1... (no carry: P ends FC2F)
    for (int s = 0; s < 2; s++) {
        uint64_t carry = 0;
        for (int i = 3; i >= 0; i--) {
            uint64_t nxt = e.d[i] & 1;
            e.d[i] = (e.d[i] >> 1) | (carry << 63);
            carry = nxt;
        }
    }
    fe_pow(r, a, &e);
}

// ---------------------------------------------------------------------------
// arithmetic mod N (2^256 = NC mod N, NC = NC2*2^128 + NC1*2^64 + NC0)

static void sc_reduce_once(u256 *a) {
    if (u256_cmp(a, &ORDER_N) >= 0)
        u256_sub(a, a, &ORDER_N);
}

// w[off..] += a * m, propagating the carry through wlen limbs
static void sc_addmul(uint64_t *w, int wlen, int off, const u256 *a,
                      uint64_t m) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)a->d[i] * m + w[off + i] + (uint64_t)carry;
        w[off + i] = (uint64_t)t;
        carry = t >> 64;
    }
    for (int i = off + 4; i < wlen && carry; i++) {
        u128 t = (u128)w[i] + (uint64_t)carry;
        w[i] = (uint64_t)t;
        carry = t >> 64;
    }
}

// w[0..6] = lo + hi*NC (hi*NC < 2^385, so the accumulator needs 7 limbs)
static void sc_fold(uint64_t w[7], const uint64_t lo[4], const u256 *hi) {
    for (int i = 0; i < 4; i++)
        w[i] = lo[i];
    w[4] = w[5] = w[6] = 0;
    sc_addmul(w, 7, 0, hi, NC0);
    sc_addmul(w, 7, 1, hi, NC1);
    sc_addmul(w, 7, 2, hi, NC2);
}

static void sc_mul(u256 *r, const u256 *a, const u256 *b) {
    u256 lo, hi;
    u256_mul_wide(a, b, &lo, &hi);
    // fold 1: 512 -> <= 386 bits
    uint64_t w[7];
    sc_fold(w, lo.d, &hi);
    // fold 2: the 130-bit overflow limbs fold to <= 260 bits
    u256 hi2 = {{w[4], w[5], w[6], 0}};
    uint64_t v[7];
    sc_fold(v, w, &hi2);
    // fold 3: v[4] is at most a few bits; result < 2^256 + 2^134
    u256 hi3 = {{v[4], v[5], 0, 0}};
    uint64_t u[7];
    sc_fold(u, v, &hi3);
    u256 out = {{u[0], u[1], u[2], u[3]}};
    if (u[4]) {
        // one final wrap: += 2^256 mod N = NC (cannot carry again)
        u256 nc = {{NC0, NC1, NC2, 0}};
        u256_add(&out, &out, &nc);
    }
    sc_reduce_once(&out);
    sc_reduce_once(&out);
    *r = out;
}

static void sc_pow(u256 *r, const u256 *a, const u256 *e) {
    u256 acc = {{1, 0, 0, 0}};
    int bits = u256_bitlen(e);
    for (int i = bits - 1; i >= 0; i--) {
        sc_mul(&acc, &acc, &acc);
        if (u256_bit(e, i))
            sc_mul(&acc, &acc, a);
    }
    *r = acc;
}

static void sc_inv(u256 *r, const u256 *a) {
    u256 e = ORDER_N;
    u256 two = {{2, 0, 0, 0}};
    u256_sub(&e, &e, &two);
    sc_pow(r, a, &e);
}

// ---------------------------------------------------------------------------
// Jacobian point arithmetic mod P

typedef struct { u256 x, y, z; } jpoint;  // z == 0 => infinity

static void jp_set_infinity(jpoint *p) {
    memset(p, 0, sizeof(*p));
    p->y.d[0] = 1;
}

static int jp_is_infinity(const jpoint *p) { return u256_is_zero(&p->z); }

static void jp_from_affine(jpoint *p, const u256 *x, const u256 *y) {
    p->x = *x;
    p->y = *y;
    memset(&p->z, 0, sizeof(u256));
    p->z.d[0] = 1;
}

static void jp_double(jpoint *r, const jpoint *a) {
    if (jp_is_infinity(a) || u256_is_zero(&a->y)) {
        jp_set_infinity(r);
        return;
    }
    u256 s, m, x2, y2, z2, t, y4;
    // S = 4*X*Y^2
    fe_sqr(&t, &a->y);
    fe_mul(&s, &a->x, &t);
    fe_add(&s, &s, &s);
    fe_add(&s, &s, &s);
    // M = 3*X^2 (a = 0)
    fe_sqr(&m, &a->x);
    fe_add(&x2, &m, &m);
    fe_add(&m, &x2, &m);
    // X' = M^2 - 2S
    fe_sqr(&x2, &m);
    fe_sub(&x2, &x2, &s);
    fe_sub(&x2, &x2, &s);
    // Y' = M*(S - X') - 8*Y^4
    fe_sqr(&y4, &t);            // Y^4
    fe_add(&y4, &y4, &y4);
    fe_add(&y4, &y4, &y4);
    fe_add(&y4, &y4, &y4);      // 8*Y^4
    fe_sub(&t, &s, &x2);
    fe_mul(&y2, &m, &t);
    fe_sub(&y2, &y2, &y4);
    // Z' = 2*Y*Z
    fe_mul(&z2, &a->y, &a->z);
    fe_add(&z2, &z2, &z2);
    r->x = x2;
    r->y = y2;
    r->z = z2;
}

static void jp_add(jpoint *r, const jpoint *a, const jpoint *b) {
    if (jp_is_infinity(a)) { *r = *b; return; }
    if (jp_is_infinity(b)) { *r = *a; return; }
    u256 z1z1, z2z2, u1, u2, s1, s2, t;
    fe_sqr(&z1z1, &a->z);
    fe_sqr(&z2z2, &b->z);
    fe_mul(&u1, &a->x, &z2z2);
    fe_mul(&u2, &b->x, &z1z1);
    fe_mul(&t, &a->y, &b->z);
    fe_mul(&s1, &t, &z2z2);
    fe_mul(&t, &b->y, &a->z);
    fe_mul(&s2, &t, &z1z1);
    if (u256_cmp(&u1, &u2) == 0) {
        if (u256_cmp(&s1, &s2) != 0) {
            jp_set_infinity(r);
            return;
        }
        jp_double(r, a);
        return;
    }
    u256 h, rr, hh, hhh, v, x3, y3, z3;
    fe_sub(&h, &u2, &u1);
    fe_sub(&rr, &s2, &s1);
    fe_sqr(&hh, &h);
    fe_mul(&hhh, &hh, &h);
    fe_mul(&v, &u1, &hh);
    fe_sqr(&x3, &rr);
    fe_sub(&x3, &x3, &hhh);
    fe_sub(&x3, &x3, &v);
    fe_sub(&x3, &x3, &v);
    fe_sub(&t, &v, &x3);
    fe_mul(&y3, &rr, &t);
    fe_mul(&t, &s1, &hhh);
    fe_sub(&y3, &y3, &t);
    fe_mul(&t, &h, &a->z);
    fe_mul(&z3, &t, &b->z);
    r->x = x3;
    r->y = y3;
    r->z = z3;
}

static void jp_neg(jpoint *r, const jpoint *a) {
    *r = *a;
    if (!u256_is_zero(&a->y))
        u256_sub(&r->y, &FIELD_P, &a->y);
}

static void u256_shr1(u256 *a) {
    a->d[0] = (a->d[0] >> 1) | (a->d[1] << 63);
    a->d[1] = (a->d[1] >> 1) | (a->d[2] << 63);
    a->d[2] = (a->d[2] >> 1) | (a->d[3] << 63);
    a->d[3] >>= 1;
}

// width-w non-adjacent form: digits[i] is 0 or odd in
// (-2^(w-1), 2^(w-1)); at most one nonzero digit in any w consecutive
// positions, so the add density drops to ~1/(w+1) vs 1/2 for plain
// binary.  Returns the digit count (<= 257 for 256-bit scalars).
static int wnaf_expand(int8_t *digits, const u256 *k, int w) {
    u256 t = *k;
    uint64_t mask = (((uint64_t)1) << w) - 1;
    uint64_t half = ((uint64_t)1) << (w - 1);
    int len = 0;
    while (!u256_is_zero(&t)) {
        int64_t d = 0;
        if (t.d[0] & 1) {
            uint64_t m = t.d[0] & mask;
            if (m >= half) {
                d = (int64_t)m - (int64_t)(mask + 1);
                u256 up = {{(uint64_t)(-d), 0, 0, 0}};
                u256_add(&t, &t, &up);
            } else {
                d = (int64_t)m;
                u256 down = {{m, 0, 0, 0}};
                u256_sub(&t, &t, &down);
            }
        }
        digits[len++] = (int8_t)d;
        u256_shr1(&t);
    }
    return len;
}

// cached odd multiples of G for w=7 wNAF: {1, 3, ..., 63} * G.
// Built once per process (double-checked under a spinlock: recover_batch
// runs concurrently on pool threads); ~32 adds, amortized to nothing.
#define GTAB_W 7
#define GTAB_SIZE 32
#define RTAB_W 4
#define RTAB_SIZE 4
static jpoint G_TAB[GTAB_SIZE];
static int g_tab_ready = 0;
static int g_tab_lock = 0;

static void ensure_g_table(void) {
    if (__atomic_load_n(&g_tab_ready, __ATOMIC_ACQUIRE))
        return;
    while (__atomic_exchange_n(&g_tab_lock, 1, __ATOMIC_ACQUIRE))
        ;
    if (!g_tab_ready) {
        jpoint dbl;
        jp_from_affine(&G_TAB[0], &GEN_X, &GEN_Y);
        jp_double(&dbl, &G_TAB[0]);
        for (int i = 1; i < GTAB_SIZE; i++)
            jp_add(&G_TAB[i], &G_TAB[i - 1], &dbl);
        __atomic_store_n(&g_tab_ready, 1, __ATOMIC_RELEASE);
    }
    __atomic_store_n(&g_tab_lock, 0, __ATOMIC_RELEASE);
}

// k1*G + k2*P2 via interleaved wNAF (one shared doubling ladder, per-
// scalar add tables).  Same result as the oracle's _double_mul; ~1.5x
// fewer field mults than the binary Shamir ladder it replaced.
static void jp_dual_mul(jpoint *r, const u256 *k1, const u256 *k2,
                        const jpoint *p2) {
    ensure_g_table();
    int8_t n1[264], n2[264];
    int l1 = wnaf_expand(n1, k1, GTAB_W);
    int l2 = wnaf_expand(n2, k2, RTAB_W);
    jpoint t2[RTAB_SIZE], dbl;
    t2[0] = *p2;
    jp_double(&dbl, p2);
    for (int i = 1; i < RTAB_SIZE; i++)
        jp_add(&t2[i], &t2[i - 1], &dbl);
    jpoint acc, tmp;
    jp_set_infinity(&acc);
    int len = l1 > l2 ? l1 : l2;
    for (int i = len - 1; i >= 0; i--) {
        jp_double(&acc, &acc);
        int d;
        if (i < l1 && (d = n1[i]) != 0) {
            if (d > 0) {
                jp_add(&acc, &acc, &G_TAB[(d - 1) >> 1]);
            } else {
                jp_neg(&tmp, &G_TAB[(-d - 1) >> 1]);
                jp_add(&acc, &acc, &tmp);
            }
        }
        if (i < l2 && (d = n2[i]) != 0) {
            if (d > 0) {
                jp_add(&acc, &acc, &t2[(d - 1) >> 1]);
            } else {
                jp_neg(&tmp, &t2[(-d - 1) >> 1]);
                jp_add(&acc, &acc, &tmp);
            }
        }
    }
    *r = acc;
}

// affine (x, y) out; returns 0 at infinity
static int jp_to_affine(const jpoint *p, u256 *x, u256 *y) {
    if (jp_is_infinity(p))
        return 0;
    u256 zi, zi2, zi3;
    fe_inv(&zi, &p->z);
    fe_sqr(&zi2, &zi);
    fe_mul(&zi3, &zi2, &zi);
    fe_mul(x, &p->x, &zi2);
    fe_mul(y, &p->y, &zi3);
    return 1;
}

static int is_on_curve(const u256 *x, const u256 *y) {
    u256 lhs, rhs, t;
    fe_sqr(&lhs, y);
    fe_sqr(&t, x);
    fe_mul(&rhs, &t, x);
    u256 seven = {{7, 0, 0, 0}};
    fe_add(&rhs, &rhs, &seven);
    return u256_cmp(&lhs, &rhs) == 0;
}

// ---------------------------------------------------------------------------
// public API

// Recover the public key from (msg32, r, s, rec_id).  Writes 64 bytes
// (x || y, big-endian) to out64.  Returns 1 on success, 0 when the
// signature is invalid — the SAME acceptance set as the Python oracle
// (r, s in [1, N); rec_id in [0, 3]; r + N < P when rec_id >= 2;
// x^3 + 7 a quadratic residue; result not infinity and on the curve).
int secp256k1_recover(const uint8_t msg32[32], const uint8_t r32[32],
                      const uint8_t s32[32], int rec_id,
                      uint8_t out64[64]) {
    if (rec_id < 0 || rec_id > 3)
        return 0;
    u256 r, s, z;
    u256_from_be(&r, r32);
    u256_from_be(&s, s32);
    u256_from_be(&z, msg32);
    if (u256_is_zero(&r) || u256_cmp(&r, &ORDER_N) >= 0)
        return 0;
    if (u256_is_zero(&s) || u256_cmp(&s, &ORDER_N) >= 0)
        return 0;
    sc_reduce_once(&z);  // z < 2^256 < 2N: one conditional subtract
    // x = r (+ N when rec_id >= 2); must stay below P
    u256 x = r;
    if (rec_id >= 2) {
        uint64_t carry = u256_add(&x, &x, &ORDER_N);
        if (carry || u256_cmp(&x, &FIELD_P) >= 0)
            return 0;
    }
    // y from the curve equation; reject non-residues
    u256 y_sq, y, chk;
    u256 seven = {{7, 0, 0, 0}};
    fe_sqr(&y_sq, &x);
    fe_mul(&y_sq, &y_sq, &x);
    fe_add(&y_sq, &y_sq, &seven);
    fe_sqrt(&y, &y_sq);
    fe_sqr(&chk, &y);
    if (u256_cmp(&chk, &y_sq) != 0)
        return 0;
    if ((int)(y.d[0] & 1) != (rec_id & 1))
        u256_sub(&y, &FIELD_P, &y);
    // Q = r^-1 * (s*R - z*G) = u1*G + u2*R with u1 = -z/r, u2 = s/r
    u256 r_inv, u1, u2;
    sc_inv(&r_inv, &r);
    sc_mul(&u2, &s, &r_inv);
    sc_mul(&u1, &z, &r_inv);
    if (!u256_is_zero(&u1))
        u256_sub(&u1, &ORDER_N, &u1);  // negate mod N
    jpoint rp, q;
    jp_from_affine(&rp, &x, &y);
    jp_dual_mul(&q, &u1, &u2, &rp);
    u256 qx, qy;
    if (!jp_to_affine(&q, &qx, &qy))
        return 0;
    if (!is_on_curve(&qx, &qy))
        return 0;
    u256_to_be(&qx, out64);
    u256_to_be(&qy, out64 + 32);
    return 1;
}

// Batched recovery: n independent inputs, each 32-byte msg/r/s plus an
// int32 rec_id; out is n*64 bytes of pubkeys, ok is n result flags.
// Inputs are packed contiguously so one GIL-releasing ctypes call covers
// a whole block; the loop itself is trivially parallel-safe (no shared
// state), so several pool threads can run disjoint batches at once.
int secp256k1_recover_batch(const uint8_t *msgs, const uint8_t *rs,
                            const uint8_t *ss, const int32_t *rec_ids,
                            int n, uint8_t *out, uint8_t *ok) {
    for (int i = 0; i < n; i++)
        ok[i] = (uint8_t)secp256k1_recover(
            msgs + 32 * i, rs + 32 * i, ss + 32 * i, rec_ids[i],
            out + 64 * i);
    return n;
}
