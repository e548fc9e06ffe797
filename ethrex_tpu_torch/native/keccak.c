/* Keccak-256 (original padding 0x01, as used by Ethereum) + keccak-f[1600].
 *
 * Host crypto of ethrex_tpu_torch: C equivalent of the reference's
 * assembly keccak (crates/common/crypto/keccak/keccak1600-*.s) — written
 * from the Keccak specification with plain C and -O3 autovectorization.
 *
 * Exposed via a tiny C ABI for ctypes:
 *   void keccak256(const uint8_t *in, size_t len, uint8_t out[32]);
 *   void keccak256_batch(const uint8_t *in, size_t stride, size_t n,
 *                        size_t len, uint8_t *out);   // n msgs, fixed len
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static void keccak_f1600(uint64_t st[25]) {
    uint64_t bc[5], t;
    for (int round = 0; round < 24; round++) {
        /* theta */
        for (int i = 0; i < 5; i++)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; i++) {
            t = bc[(i + 4) % 5] ^ ROTL64(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5)
                st[j + i] ^= t;
        }
        /* rho + pi */
        static const int rot[24] = {1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2,
                                    14, 27, 41, 56, 8,  25, 43, 62, 18, 39,
                                    61, 20, 44};
        static const int piln[24] = {10, 7,  11, 17, 18, 3,  5,  16, 8, 21,
                                     24, 4,  15, 23, 19, 13, 12, 2,  20, 14,
                                     22, 9,  6,  1};
        t = st[1];
        for (int i = 0; i < 24; i++) {
            int j = piln[i];
            bc[0] = st[j];
            st[j] = ROTL64(t, rot[i]);
            t = bc[0];
        }
        /* chi */
        for (int j = 0; j < 25; j += 5) {
            for (int i = 0; i < 5; i++)
                bc[i] = st[j + i];
            for (int i = 0; i < 5; i++)
                st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
        }
        /* iota */
        st[0] ^= RC[round];
    }
}

void keccak256(const uint8_t *in, size_t len, uint8_t *out) {
    uint64_t st[25];
    memset(st, 0, sizeof(st));
    const size_t rate = 136; /* 1088-bit rate */
    while (len >= rate) {
        for (size_t i = 0; i < rate / 8; i++) {
            uint64_t w;
            memcpy(&w, in + 8 * i, 8);
            st[i] ^= w;
        }
        keccak_f1600(st);
        in += rate;
        len -= rate;
    }
    uint8_t last[136];
    memset(last, 0, sizeof(last));
    memcpy(last, in, len);
    last[len] = 0x01;       /* keccak (pre-SHA3) padding */
    last[rate - 1] |= 0x80;
    for (size_t i = 0; i < rate / 8; i++) {
        uint64_t w;
        memcpy(&w, last + 8 * i, 8);
        st[i] ^= w;
    }
    keccak_f1600(st);
    memcpy(out, st, 32);
}

void keccak256_batch(const uint8_t *in, size_t stride, size_t n, size_t len,
                     uint8_t *out) {
    for (size_t k = 0; k < n; k++)
        keccak256(in + k * stride, len, out + 32 * k);
}
