"""Keccak-256 over numpy uint64 lanes, one message or a batch at once.

The challenger's proof-of-work grinding hashes tens of thousands of
40-byte messages (seed || nonce); `keccak256_batch` runs Keccak-f[1600] on
a whole batch of equal-length messages in numpy, so the search needs no
native extension.  Original Keccak padding (0x01 ... 0x80), rate 136
bytes: the Ethereum keccak256, not SHA3-256.
"""

from __future__ import annotations

import numpy as np

_RATE = 136

_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)

# rotation offsets r[x][y]
_ROT = [[0, 36, 3, 41, 18],
        [1, 44, 10, 45, 2],
        [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56],
        [27, 20, 39, 8, 14]]


def _rotl(v, r: int):
    if r == 0:
        return v
    return (v << np.uint64(r)) | (v >> np.uint64(64 - r))


def _keccak_f(a):
    """a: list of 25 uint64 arrays, lane (x, y) at index x + 5y."""
    for rnd in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y],
                                                         _ROT[x][y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)]
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] = a[0] ^ _RC[rnd]
    return a


def keccak256_batch(msgs: np.ndarray) -> np.ndarray:
    """msgs: (B, L) uint8, equal lengths -> (B, 32) uint8 digests."""
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    nb, length = msgs.shape
    blocks = length // _RATE + 1
    padded = np.zeros((nb, blocks * _RATE), dtype=np.uint8)
    padded[:, :length] = msgs
    padded[:, length] ^= 0x01
    padded[:, -1] ^= 0x80
    lanes = padded.view("<u8").reshape(nb, blocks, _RATE // 8)
    state = [np.zeros(nb, dtype=np.uint64) for _ in range(25)]
    for blk in range(blocks):
        for i in range(_RATE // 8):
            state[i] = state[i] ^ lanes[:, blk, i]
        state = _keccak_f(state)
    out = np.stack(state[:4], axis=1).astype("<u8")
    return out.view(np.uint8).reshape(nb, 32)


def keccak256(data: bytes) -> bytes:
    arr = np.frombuffer(bytes(data), dtype=np.uint8).reshape(1, -1)
    return keccak256_batch(arr)[0].tobytes()
