"""Poseidon2 permutation over BabyBear, width 16, S-box x^7.

Port of `ethrex_tpu/ops/poseidon2.py`: the same SHAKE-256-derived round
constants and internal diagonal (WIDTH 16, RATE 8, 4 + 13 + 4 rounds), the
same external M4 chain and internal J + diag(mu) layer.  `permute_ref` is a
copy of the host reference; `permute` / `compress` are plain PyTorch over
(..., 16) int32 Montgomery tensors.  `hash_leaves`, `compress_level` and
`merkle_subtree` are the wrappers of kernel K2 (`csrc/poseidon2.cu`): on a
CUDA tensor they launch it, on a CPU tensor the first two run the plain
version.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import kernels
from . import babybear as bb

WIDTH = 16
RATE = 8
ROUNDS_F = 8  # external (full) rounds, split 4 + 4
ROUNDS_P = 13  # internal (partial) rounds
_HALF_F = ROUNDS_F // 2

_DOMAIN_TAG = b"ethrex-tpu/poseidon2/babybear/w16/v1"


def _sample_field_elems(tag: bytes, n: int) -> np.ndarray:
    """Deterministic rejection sampling of n elements < p from SHAKE-256."""
    out = np.empty(n, dtype=np.uint32)
    shake = hashlib.shake_256(tag)
    stream = shake.digest(8 * n + 1024)
    pos = 0
    i = 0
    ext = 0
    while i < n:
        if pos + 4 > len(stream):
            ext += 1
            stream = hashlib.shake_256(tag + b"/ext%d" % ext).digest(8 * n + 1024)
            pos = 0
        v = int.from_bytes(stream[pos:pos + 4], "little")
        pos += 4
        if v < bb.P:
            out[i] = v
            i += 1
    return out


def _generate_constants():
    ext = _sample_field_elems(_DOMAIN_TAG + b"/ext-rc", ROUNDS_F * WIDTH)
    ext = ext.reshape(ROUNDS_F, WIDTH)
    internal = _sample_field_elems(_DOMAIN_TAG + b"/int-rc", ROUNDS_P)
    # internal diagonal: resample until J + diag(mu) is invertible
    ctr = 0
    while True:
        mu = _sample_field_elems(_DOMAIN_TAG + b"/diag/%d" % ctr, WIDTH)
        # det(J + diag(mu)) = (prod mu_i) * (1 + sum 1/mu_i)  [det lemma]
        if all(int(m) != 0 for m in mu):
            inv_sum = sum(pow(int(m), bb.P - 2, bb.P) for m in mu) % bb.P
            if (1 + inv_sum) % bb.P != 0:
                break
        ctr += 1
    return ext, internal, mu


EXT_RC, INT_RC, DIAG_MU = _generate_constants()

# Montgomery-form constants (the CUDA kernel's __constant__ tables)
EXT_RC_M = bb.to_mont_host(EXT_RC)
INT_RC_M = bb.to_mont_host(INT_RC)
DIAG_MU_M = bb.to_mont_host(DIAG_MU)


# ---------------------------------------------------------------------------
# Reference implementation (host, Python ints): the challenger and the
# verifier use it
# ---------------------------------------------------------------------------

def _sbox_ref(x: int) -> int:
    x2 = (x * x) % bb.P
    x4 = (x2 * x2) % bb.P
    return (x4 * x2 % bb.P) * x % bb.P


def _m4_ref(x):
    t0 = (x[0] + x[1]) % bb.P
    t1 = (x[2] + x[3]) % bb.P
    t2 = (2 * x[1] + t1) % bb.P
    t3 = (2 * x[3] + t0) % bb.P
    t4 = (4 * t1 + t3) % bb.P
    t5 = (4 * t0 + t2) % bb.P
    t6 = (t3 + t5) % bb.P
    t7 = (t2 + t4) % bb.P
    return [t6, t5, t7, t4]


def _external_linear_ref(state):
    blocks = [_m4_ref(state[i:i + 4]) for i in range(0, WIDTH, 4)]
    sums = [sum(b[j] for b in blocks) % bb.P for j in range(4)]
    out = []
    for b in blocks:
        out.extend((b[j] + sums[j]) % bb.P for j in range(4))
    return out


_EXT_RC_INT = [[int(c) for c in row] for row in EXT_RC]
_INT_RC_INT = [int(c) for c in INT_RC]
_MU_INT = [int(m) for m in DIAG_MU]


def _ext_linear_int(s):
    """M_E on 16 Python ints of any size, reduced mod p on the way
    out."""
    p = bb.P
    t = []
    for i in (0, 4, 8, 12):
        x0, x1, x2, x3 = s[i], s[i + 1], s[i + 2], s[i + 3]
        t0 = x0 + x1
        t1 = x2 + x3
        t2 = x1 + x1 + t1
        t3 = x3 + x3 + t0
        t4 = 4 * t1 + t3
        t5 = 4 * t0 + t2
        t += (t3 + t5, t5, t2 + t4, t4)
    s0 = t[0] + t[4] + t[8] + t[12]
    s1 = t[1] + t[5] + t[9] + t[13]
    s2 = t[2] + t[6] + t[10] + t[14]
    s3 = t[3] + t[7] + t[11] + t[15]
    return [(t[0] + s0) % p, (t[1] + s1) % p, (t[2] + s2) % p,
            (t[3] + s3) % p, (t[4] + s0) % p, (t[5] + s1) % p,
            (t[6] + s2) % p, (t[7] + s3) % p, (t[8] + s0) % p,
            (t[9] + s1) % p, (t[10] + s2) % p, (t[11] + s3) % p,
            (t[12] + s0) % p, (t[13] + s1) % p, (t[14] + s2) % p,
            (t[15] + s3) % p]


def _full_round_int(s, rc):
    """A full round's S-boxes on canonical ints: (x + c)^7 mod p, the
    sum x + c left unreduced (below 2p)."""
    p = bb.P
    out = []
    for x, c in zip(s, rc):
        x += c
        x2 = x * x % p
        out.append(x2 * x2 % p * x2 * x % p)
    return out


def _partial_round_int(s, rc):
    """A partial round on canonical ints: the S-box on s[0] (in place),
    then the internal diagonal layer."""
    p = bb.P
    x = s[0] + rc
    x2 = x * x % p
    s[0] = x2 * x2 % p * x2 * x % p
    tot = sum(s)
    return [(tot + m * x) % p for x, m in zip(s, _MU_INT)]


def permute_ref(state):
    """Reference Poseidon2 on a length-16 list/array of canonical ints."""
    s = [int(x) % bb.P for x in state]
    assert len(s) == WIDTH
    s = _ext_linear_int(s)
    for r in range(_HALF_F):
        s = _ext_linear_int(_full_round_int(s, _EXT_RC_INT[r]))
    for r in range(ROUNDS_P):
        s = _partial_round_int(s, _INT_RC_INT[r])
    for r in range(_HALF_F, ROUNDS_F):
        s = _ext_linear_int(_full_round_int(s, _EXT_RC_INT[r]))
    return s


# ---------------------------------------------------------------------------
# Plain PyTorch implementation: batched states, Montgomery form
# ---------------------------------------------------------------------------

# The plain permutation runs its rounds on canonical residues in int64
# (a product of two residues stays below 2^62, so one reduction a product
# and one a linear layer), converting from and back to Montgomery form
# once; the residues, and so the Montgomery words returned, are the same.

def _sbox(x):
    """x^7 mod p on canonical int64 residues."""
    x2 = x * x % bb.P
    x4 = x2 * x2 % bb.P
    return x4 * x2 % bb.P * x % bb.P


def _external_linear(s):
    """s: (..., 16) canonical int64 -> (..., 16): M4 on each block of 4,
    plus the block sums (the circulant 2*M4, M4, ... layout)."""
    x0, x1, x2, x3 = s.reshape(s.shape[:-1] + (4, 4)).unbind(-1)
    t0 = x0 + x1
    t1 = x2 + x3
    t2 = 2 * x1 + t1
    t3 = 2 * x3 + t0
    t4 = 4 * t1 + t3
    t5 = 4 * t0 + t2
    b = torch.stack((t3 + t5, t5, t2 + t4, t4), dim=-1)
    return ((b + b.sum(dim=-2, keepdim=True)) % bb.P).reshape(s.shape)


_CONSTS: dict = {}


def _consts(device):
    """The round constants and the internal diagonal, canonical int64."""
    key = str(device)
    if key not in _CONSTS:
        _CONSTS[key] = tuple(
            torch.from_numpy(np.asarray(c, dtype=np.int64)).to(device)
            for c in (EXT_RC, INT_RC, DIAG_MU))
    return _CONSTS[key]


def permute(state):
    """Poseidon2 permutation. state: (..., 16) int32 Montgomery."""
    ext_rc, int_rc, mu = _consts(state.device)
    s = _external_linear(bb.from_mont(state).to(torch.int64))
    for r in range(_HALF_F):
        s = _external_linear(_sbox((s + ext_rc[r]) % bb.P))
    for r in range(ROUNDS_P):
        s0 = _sbox((s[..., :1] + int_rc[r]) % bb.P)
        s = torch.cat([s0, s[..., 1:]], dim=-1)
        s = (s.sum(dim=-1, keepdim=True) + s * mu) % bb.P
    for r in range(_HALF_F, ROUNDS_F):
        s = _external_linear(_sbox((s + ext_rc[r]) % bb.P))
    return bb.to_mont(s.to(bb.I32))


def compress(left, right):
    """2-to-1 compression on 8-limb digests (truncated Davies-Meyer)."""
    x = torch.cat([left, right], dim=-1)
    return bb.add(permute(x)[..., :RATE], left)


def _hash_rows_plain(rows):
    """Plain sponge over the rows of a (m, w) tensor."""
    m, w = rows.shape
    pad = (-w) % RATE
    if pad:
        rows = torch.cat([rows, torch.zeros((m, pad), dtype=bb.I32,
                                            device=rows.device)], dim=1)
        w += pad
    s = torch.zeros((m, WIDTH), dtype=bb.I32, device=rows.device)
    for i in range(0, w, RATE):
        s = torch.cat([bb.add(s[:, :RATE], rows[:, i:i + RATE]),
                       s[:, RATE:]], dim=1)
        s = permute(s)
    return s[:, :RATE].contiguous()


def hash_leaves_plain(leaves):
    """Plain PyTorch version of `hash_leaves` (same arguments)."""
    if leaves.dim() == 2:
        leaves = leaves.unsqueeze(0)
    g, m, inner = leaves.shape
    return _hash_rows_plain(leaves.permute(1, 0, 2).reshape(m, g * inner))


def compress_level_plain(level):
    """Plain PyTorch version of `compress_level`."""
    return compress(level[0::2], level[1::2])


_constants_on: set = set()


def _upload_constants(device) -> None:
    """Copy the round constants and mu into the kernel's constant memory
    (once per device, before its first launch there)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx in _constants_on:
        return
    ext = np.ascontiguousarray(EXT_RC_M, dtype=np.uint32)
    intr = np.ascontiguousarray(INT_RC_M, dtype=np.uint32)
    mu = np.ascontiguousarray(DIAG_MU_M, dtype=np.uint32)
    with torch.cuda.device(idx):
        kernels.check(kernels.lib().p2_set_constants(
            ext.ctypes.data, intr.ctypes.data, mu.ctypes.data),
            "p2_set_constants")
    _constants_on.add(idx)


def hash_leaves(leaves, out=None):
    """Sponge-hash rows of field elements to 8-limb digests.

    leaves: (m, w) int32 Montgomery, any strides; or (G, m, c), whose row
    i is the concatenation over g of leaves[g, i, :] (the FRI layer's
    lo/hi pairing read in place).  Rows are zero-padded to a multiple of
    RATE.  Returns (m, 8) contiguous, written into `out` when given (a
    contiguous (m, 8) tensor, e.g. the leaf level of a Merkle buffer).
    Kernel K2 on a CUDA tensor."""
    if leaves.device.type != "cuda":
        res = hash_leaves_plain(leaves)
        if out is None:
            return res
        out.copy_(res)
        return out
    if leaves.dim() == 2:
        leaves = leaves.unsqueeze(0)
    g, m, inner = leaves.shape
    w = g * inner
    kernels.require_int32_cuda(leaves, "hash_leaves")
    if out is None:
        out = torch.empty((m, RATE), dtype=bb.I32, device=leaves.device)
    elif out.shape != (m, RATE) or not out.is_contiguous():
        raise ValueError("out must be a contiguous (m, 8) tensor")
    _upload_constants(leaves.device)
    kernels.call("p2_hash_leaves", leaves.device, kernels.ptr(leaves),
                 kernels.ptr(out), m, w, leaves.stride(1), leaves.stride(2),
                 inner, leaves.stride(0))
    kernels.count("poseidon2_hash_leaves")
    return out


# levels a subtree launch covers at most (a block's 2^k digests, k <= 10),
# the threads a block aims for, and the levels each thread compresses
# serially on a level of at least SUBTREE_SERIAL_MIN digests (c + 1 = 3:
# its own 8 digests to one node)
SUBTREE_MAX_LEVELS = 10
SUBTREE_THREADS = 128
SUBTREE_SERIAL = 2
SUBTREE_SERIAL_MIN = 1 << 20


def subtree_serial(m_in: int, k: int) -> int:
    """c of a k-level launch over m_in digests: SUBTREE_SERIAL on a
    level large enough to fill the card with blocks, else 0."""
    return SUBTREE_SERIAL if m_in >= SUBTREE_SERIAL_MIN and \
        k > SUBTREE_SERIAL else 0


def subtree_width(m_in: int, k: int, c: int = 0) -> int:
    """Subtrees per block of a k-level launch over m_in digests (2^(k-c-1)
    threads each): enough for SUBTREE_THREADS threads, a power of two
    dividing m_in / 2^k."""
    span = m_in >> k
    S = max(1, SUBTREE_THREADS >> (k - c - 1))
    while S > 1 and (span % S or S > span):
        S >>= 1
    return S


def merkle_subtree(level, out, k: int, S: int | None = None,
                   c: int = 0) -> None:
    """Compress k Merkle levels above `level` ((m_in, 8), m_in a multiple
    of 2^k) into `out`: a contiguous buffer of m_in/2 + ... + m_in/2^k
    rows, level 1 first; S subtrees per block (default `subtree_width`),
    the first c + 1 levels serially per thread.  Kernel K2 (`k_subtree`);
    CUDA tensors only."""
    kernels.require_int32_cuda(level, "merkle_subtree level")
    kernels.require_int32_cuda(out, "merkle_subtree out")
    m_in = level.shape[0]
    if not 1 <= k <= SUBTREE_MAX_LEVELS or m_in % (1 << k) or \
            not 0 <= c < k:
        raise ValueError(f"cannot compress {k} levels above {m_in} digests "
                         f"({c + 1} serially)")
    rows = sum(m_in >> j for j in range(1, k + 1))
    if out.shape[0] < rows or not (level.is_contiguous()
                                   and out.is_contiguous()):
        raise ValueError("subtree buffers must be contiguous and hold "
                         f"{rows} output rows")
    S = subtree_width(m_in, k, c) if S is None else S
    if S < 1 or (m_in >> k) % S:
        raise ValueError(f"{S} subtrees per block do not tile {m_in} digests")
    _upload_constants(level.device)
    kernels.call("p2_merkle_subtree", level.device, kernels.ptr(level),
                 kernels.ptr(out), m_in, k, S, c)
    kernels.count("poseidon2_merkle_subtree")


def compress_level(level):
    """One Merkle level: (2m, 8) digests -> (m, 8) parents.
    Kernel K2 (a one-level subtree launch) on a CUDA tensor."""
    if level.shape[0] % 2 or level.shape[-1] != RATE:
        raise ValueError("a level needs an even number of 8-limb digests")
    if level.device.type != "cuda":
        return compress_level_plain(level)
    level = level.contiguous()
    out = torch.empty((level.shape[0] // 2, RATE), dtype=bb.I32,
                      device=level.device)
    merkle_subtree(level, out, 1)
    return out
