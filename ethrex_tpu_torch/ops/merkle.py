"""Poseidon2 Merkle tree commitment over BabyBear vectors.

Port of `ethrex_tpu/ops/merkle.py`.  `commit_levels` builds every level
on the device and keeps them all, since the query openings read siblings
from every level: kernel K2 hashes the leaves into one buffer that holds
every level, then compresses up to 10 levels per launch
(`poseidon2.merkle_subtree`, planned by `subtree_plan`).  `batched_roots`
builds the roots of many trees at once (the fused prove step's FRI
layers) with kernel K10, up to 10 levels of every tree a launch
(planned by `forest_plan`).  The host helpers
(`compress_ref`, `hash_leaf_ref`, `verify_opening`, ...) are copies of the
JAX package's canonical-integer reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import babybear as bb
from . import poseidon2 as p2

DIGEST_WIDTH = p2.RATE  # 8 limbs


def level_offsets(m: int) -> list[int]:
    """Row offset of each level of a tree over m leaves in the one buffer
    `commit_levels` fills: level l (m / 2^l rows) at sum_{i<l} m / 2^i."""
    offs, off = [], 0
    while True:
        offs.append(off)
        if m == 1:
            return offs
        off += m
        m //= 2


def subtree_plan(m: int) -> list[tuple[int, int, int, int]]:
    """The subtree launches of a tree over m = 2^a leaves: (level in, k
    levels, subtrees per block, c) each, ceil(a / 10) launches that split
    the a levels as evenly as possible (2^22 leaves: 8, 7, 7); c + 1 of a
    launch's levels run serially per thread (`poseidon2.subtree_serial`)."""
    a = m.bit_length() - 1
    if a <= 0:
        return []
    launches = -(-a // p2.SUBTREE_MAX_LEVELS)
    plan, level = [], 0
    for i in range(launches):
        k = -(-(a - level) // (launches - i))
        c = p2.subtree_serial(m >> level, k)
        plan.append((level, k, p2.subtree_width(m >> level, k, c), c))
        level += k
    return plan


def commit_levels(leaves) -> list:
    """Merkle tree over the rows of `leaves` ((m, w) view, or the grouped
    (G, m, c) form of `poseidon2.hash_leaves`); m a power of two.

    Returns [level_0 (m, 8), ..., root (1, 8)] int32 Montgomery tensors:
    on the card, views of one (2m - 1, 8) buffer."""
    m = leaves.shape[-2]
    if m & (m - 1):
        raise ValueError("leaf count must be a power of two")
    if leaves.device.type != "cuda":
        digests = p2.hash_leaves(leaves)
        levels = [digests]
        while digests.shape[0] > 1:
            digests = p2.compress_level(digests)
            levels.append(digests)
        return levels
    buf = torch.empty((2 * m - 1, DIGEST_WIDTH), dtype=bb.I32,
                      device=leaves.device)
    p2.hash_leaves(leaves, out=buf[:m])
    return levels_above(buf, m)


def levels_above(buf, m: int) -> list:
    """Fill the levels of a tree over m = 2^a leaf digests in one (2m - 1,
    8) CUDA buffer whose rows [0, m) hold the digests (level l at
    `level_offsets(m)[l]`), one subtree launch per `subtree_plan` entry.
    Returns the level views, leaves first."""
    offs = level_offsets(m)
    for level, k, S, c in subtree_plan(m):
        p2.merkle_subtree(buf[offs[level]:offs[level + 1]],
                          buf[offs[level + 1]:], k, S, c)
    return [buf[off:off + (m >> lv)] for lv, off in enumerate(offs)]


def _check_sizes(sizes) -> list[int]:
    sizes = [int(s) for s in sizes]
    for s in sizes:
        if s < 1 or s & (s - 1):
            raise ValueError("tree sizes must be powers of two")
    return sizes


def batched_roots_plain(digests, sizes) -> list:
    """Plain version of `batched_roots` (the reference's gathers, one
    compression per level and the reassembly in tree order)."""
    cur = _check_sizes(sizes)
    state = digests
    dev = digests.device
    while any(s > 1 for s in cur):
        left, right, parts, off, c_off = [], [], [], 0, 0
        for s in cur:
            if s > 1:
                left.extend(range(off, off + s, 2))
                right.extend(range(off + 1, off + s, 2))
                parts.append(("c", c_off, s // 2))
                c_off += s // 2
            else:
                parts.append(("p", off, 1))
            off += s
        li = torch.tensor(left, dtype=torch.long, device=dev)
        ri = torch.tensor(right, dtype=torch.long, device=dev)
        compressed = p2.compress(state[li], state[ri])
        state = torch.cat([compressed[a:a + k] if kind == "c"
                           else state[a:a + 1] for kind, a, k in parts])
        cur = [s // 2 if s > 1 else 1 for s in cur]
    return [state[i] for i in range(len(cur))]


# K10 (csrc/poseidon2.cu `k_forest`): levels a launch compresses at most
# (a block's 2^10 digests fill 32 KB of shared memory), threads a block,
# and the segments one launch's parameter holds.  A round over at least
# p2.SUBTREE_SERIAL_MIN digests runs its first c + 1 = 3 levels serially
# per thread, as k_subtree does, so the levels where a block thins out
# carry 1/8 of its work; a smaller round, where the chain of levels and
# not the products sets the time, runs one node a thread (c = 0) unless
# a tile of 2^k digests needs more (c >= k - 8 with 128 threads)
FOREST_LEVELS = 10
FOREST_THREADS = 128
FOREST_SEGS = 48


@functools.lru_cache(maxsize=64)
def forest_plan(sizes: tuple) -> tuple:
    """Kernel K10's plan for trees of `sizes` (powers of two,
    concatenated in order): each tree's log2 size levels split as evenly
    as possible over R = ceil(max log2 size / FOREST_LEVELS) rounds.  A
    round's output holds each tree's nodes after it, in tree order (one
    root per tile of 2^k digests; a finished tree's root copied, k = 0),
    so round R's output is the roots.  Consecutive trees of one size
    make one segment.  Returns per round (launches, rows out), a launch
    (segments, blocks) with a segment (in row, out row, first block,
    tiles, k, S, c) as the kernel reads it: S tiles a block, the first
    c + 1 levels serially per thread.  A round of more than FOREST_SEGS
    segments takes several launches."""
    cur = [int(s) for s in sizes]
    rem = [s.bit_length() - 1 for s in cur]
    rounds = -(-max(rem, default=0) // FOREST_LEVELS)
    plan = []
    for r in range(rounds):
        segs, in_off, out_off, prev = [], 0, 0, None
        serial = p2.SUBTREE_SERIAL if sum(cur) >= p2.SUBTREE_SERIAL_MIN \
            else 0
        for t, s in enumerate(cur):
            k = -(-rem[t] // (rounds - r))
            tiles = s >> k
            if s == prev:
                segs[-1][3] += tiles      # one more whole tree of this size
            else:
                c = min(max(serial, k - 8), k - 1) if k else 0
                cap = FOREST_THREADS << (c + 1) if k else FOREST_THREADS
                segs.append([in_off, out_off, 0, tiles, k, cap >> k, c])
            prev = s
            in_off += s
            out_off += tiles
            cur[t], rem[t] = tiles, rem[t] - k
        launches = []
        for lo in range(0, len(segs), FOREST_SEGS):
            blocks = 0
            for seg in segs[lo:lo + FOREST_SEGS]:
                seg[5] = min(seg[5], seg[3])
                seg[2] = blocks
                blocks += -(-seg[3] // seg[5])
            launches.append((np.array(segs[lo:lo + FOREST_SEGS],
                                      dtype=np.int64), blocks))
        plan.append((tuple(launches), out_off))
    return tuple(plan)


def batched_roots(digests, sizes) -> list:
    """Roots of many Merkle trees from one flat digest array.

    digests: (sum(sizes), 8) leaf digests, trees concatenated in order;
    every size a power of two (a tree of size 1 is its own root).
    Kernel K10 on a CUDA tensor: up to FOREST_LEVELS levels of every tree
    a launch, in shared memory, only the roots written (`forest_plan`).
    Returns a list of (8,) root digests, one per tree."""
    if digests.device.type != "cuda":
        return batched_roots_plain(digests, sizes)
    cur = tuple(_check_sizes(sizes))
    if digests.shape != (sum(cur), DIGEST_WIDTH):
        raise ValueError("digests must be (sum(sizes), 8)")
    kernels.require_int32_cuda(digests, "batched_roots")
    dev = digests.device
    state = digests.contiguous()
    p2._upload_constants(dev)
    for launches, rows in forest_plan(cur):
        out = torch.empty((rows, DIGEST_WIDTH), dtype=bb.I32, device=dev)
        for segs, blocks in launches:
            kernels.call("p2_forest", dev, kernels.ptr(state),
                         kernels.ptr(out), segs.ctypes.data, len(segs),
                         blocks)
            kernels.count("merkle_batched_level")
        state = out
    return [state[i] for i in range(len(cur))]


def open_paths(levels, indices) -> list[list[list[int]]]:
    """Canonical sibling paths (bottom-up) for several leaf indices, read
    from device levels with one gather per level."""
    idx = np.asarray(indices, dtype=np.int64)
    per_level = []
    for level in levels[:-1]:
        sib = torch.from_numpy(idx ^ 1).to(level.device)
        per_level.append(bb.from_mont_host(bb.to_numpy(level[sib])))
        idx = idx >> 1
    return [[[int(x) for x in per_level[d][q]] for d in range(len(per_level))]
            for q in range(len(indices))]


def compress_ref(left, right) -> list[int]:
    """Canonical host 2-to-1 compression (matches p2.compress)."""
    state = p2.permute_ref(list(left) + list(right))
    return [(state[i] + left[i]) % bb.P for i in range(DIGEST_WIDTH)]


def fold_path_canonical(index: int, leaf_digest, path):
    """Fold a canonical leaf digest up a canonical path to a root digest."""
    cur = list(leaf_digest)
    idx = index
    for sib in path:
        sib = [int(x) for x in sib]
        if idx & 1:
            cur = compress_ref(sib, cur)
        else:
            cur = compress_ref(cur, sib)
        idx >>= 1
    return cur


def verify_opening(root_c, index: int, leaf_values_c, path_c, depth: int) -> bool:
    """Fully canonical opening check: hash leaf values, fold, compare.
    Malformed input returns False, never raises."""
    try:
        if len(path_c) != depth or len(root_c) != DIGEST_WIDTH:
            return False
        if any(len(sib) != DIGEST_WIDTH for sib in path_c):
            return False
        digest = hash_leaf_ref(leaf_values_c)
        folded = fold_path_canonical(index, digest, path_c)
        return folded == [int(x) % bb.P for x in root_c]
    except (TypeError, ValueError):
        return False


def hash_leaf_ref(leaf) -> list[int]:
    """Canonical reference of p2.hash_leaves for a single row."""
    vals = [int(x) % bb.P for x in leaf]
    pad = (-len(vals)) % p2.RATE
    vals = vals + [0] * pad
    state = [0] * p2.WIDTH
    for i in range(0, len(vals), p2.RATE):
        for j in range(p2.RATE):
            state[j] = (state[j] + vals[i + j]) % bb.P
        state = p2.permute_ref(state)
    return state[:p2.RATE]
