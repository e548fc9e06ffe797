"""Fiat-Shamir transcript: duplex Poseidon2 sponge over BabyBear (host side).

A copy of `ethrex_tpu/ops/challenger.py`: prover and verifier share this
exact code, which keeps the protocol non-interactive and deterministic.
The proof-of-work search hashes nonces in numpy batches
(`crypto/keccak.keccak256_batch`) and returns the smallest nonce that
passes, the same one the one-at-a-time search finds.
"""

from __future__ import annotations

import numpy as np

from ..crypto.keccak import keccak256, keccak256_batch
from . import babybear as bb
from . import poseidon2 as p2

_GRIND_BATCH = 8192


class Challenger:
    def __init__(self, domain: bytes = b"ethrex-tpu/stark/v1"):
        self._state = [0] * p2.WIDTH
        self._absorb_pos = 0
        self._squeeze_pos = p2.RATE  # force permute before first sample
        seed = p2._sample_field_elems(domain, p2.RATE)
        self.absorb_elems([int(x) for x in seed])

    # -- absorbing ---------------------------------------------------------
    def absorb_elems(self, elems):
        """Absorb canonical base-field ints."""
        for e in elems:
            if self._absorb_pos == p2.RATE:
                self._state = p2.permute_ref(self._state)
                self._absorb_pos = 0
            self._state[self._absorb_pos] = (
                self._state[self._absorb_pos] + int(e)
            ) % bb.P
            self._absorb_pos += 1
        self._squeeze_pos = p2.RATE

    def absorb_digest(self, digest):
        """Absorb a Montgomery Merkle digest (8 limbs, numpy or tensor)."""
        if not isinstance(digest, np.ndarray):
            digest = bb.to_numpy(digest)
        canon = bb.from_mont_host(digest)
        self.absorb_elems(int(x) for x in canon)

    def absorb_ext(self, x):
        self.absorb_elems(x)

    def absorb_int(self, v: int):
        """Absorb an unbounded non-negative int as 27-bit limbs."""
        limbs = []
        v = int(v)
        while True:
            limbs.append(v & ((1 << 27) - 1))
            v >>= 27
            if not v:
                break
        self.absorb_elems([len(limbs)] + limbs)

    # The sponge is the only mutable prover state between device phases,
    # so a phase checkpoint (prover/checkpoint) that snapshots it resumes
    # the transcript mid-proof with every later challenge bit-identical.
    def state(self) -> dict:
        """Plain-data snapshot of the sponge."""
        return {"state": list(self._state),
                "absorb_pos": self._absorb_pos,
                "squeeze_pos": self._squeeze_pos}

    def restore(self, snap: dict) -> None:
        """Resume from a `state()` snapshot."""
        self._state = [int(x) for x in snap["state"]]
        self._absorb_pos = int(snap["absorb_pos"])
        self._squeeze_pos = int(snap["squeeze_pos"])

    # -- sampling ----------------------------------------------------------
    def sample(self) -> int:
        """Sample one canonical base-field element."""
        if self._squeeze_pos >= p2.RATE or self._absorb_pos > 0:
            self._state = p2.permute_ref(self._state)
            self._absorb_pos = 0
            self._squeeze_pos = 0
        out = self._state[self._squeeze_pos]
        self._squeeze_pos += 1
        return out

    def sample_ext(self) -> tuple:
        return tuple(self.sample() for _ in range(4))

    def sample_bits(self, bits: int) -> int:
        """Sample a uniform-ish integer in [0, 2^bits), bits <= 27."""
        assert bits <= 27
        return self.sample() & ((1 << bits) - 1)

    def sample_indices(self, bits: int, n: int) -> list[int]:
        return [self.sample_bits(bits) for _ in range(n)]

    # -- proof-of-work grinding -------------------------------------------
    def _pow_seed(self) -> bytes:
        return b"".join(int(self.sample()).to_bytes(4, "little")
                        for _ in range(8))

    def grind(self, bits: int) -> int:
        """Find, absorb and return the smallest proof-of-work nonce."""
        if bits <= 0:
            return 0
        seed = self._pow_seed()
        nonce = _search_nonce(seed, bits)
        self.absorb_int(nonce)
        return nonce

    def check_grind(self, nonce: int, bits: int) -> bool:
        """Verify a grinding nonce; absorbs any u64 nonce, pass or fail."""
        if bits <= 0:
            return True
        nonce = int(nonce)
        if not (0 <= nonce < 1 << 64):
            return False
        seed = self._pow_seed()
        ok = pow_ok(seed, nonce, bits)
        self.absorb_int(nonce)
        return ok


def pow_ok(seed: bytes, nonce: int, bits: int) -> bool:
    """keccak256(seed || nonce_le8), read big-endian, has `bits` leading
    zero bits."""
    return int.from_bytes(
        keccak256(seed + nonce.to_bytes(8, "little")), "big"
    ) < (1 << (256 - bits))


def _search_nonce(seed: bytes, bits: int) -> int:
    """Smallest nonce with pow_ok(seed, nonce, bits), searched in batches."""
    if bits > 64:
        nonce = 0
        while not pow_ok(seed, nonce, bits):
            nonce += 1
        return nonce
    seed_arr = np.frombuffer(seed, dtype=np.uint8)
    start = 0
    while True:
        nonces = np.arange(start, start + _GRIND_BATCH, dtype=np.uint64)
        msgs = np.empty((_GRIND_BATCH, len(seed) + 8), dtype=np.uint8)
        msgs[:, :len(seed)] = seed_arr
        msgs[:, len(seed):] = nonces.astype("<u8").view(np.uint8).reshape(
            _GRIND_BATCH, 8)
        digests = keccak256_batch(msgs)
        top = digests[:, :8].copy().view(">u8").reshape(-1)
        hits = np.nonzero((top >> np.uint64(64 - bits)) == 0)[0]
        if hits.size:
            return start + int(hits[0])
        start += _GRIND_BATCH
