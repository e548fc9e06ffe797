"""Poseidon2 Merkle tree commitment over BabyBear vectors.

Port of `ethrex_tpu/ops/merkle.py`.  `commit_levels` builds every level
on the device (kernel K2 through `poseidon2.hash_leaves` and one
`poseidon2.compress_level` launch per level) and keeps them all, since the
query openings read siblings from every level.  The host helpers
(`compress_ref`, `hash_leaf_ref`, `verify_opening`, ...) are copies of the
JAX package's canonical-integer reference.
"""

from __future__ import annotations

import numpy as np
import torch

from . import babybear as bb
from . import poseidon2 as p2

DIGEST_WIDTH = p2.RATE  # 8 limbs


def commit_levels(leaves) -> list:
    """Merkle tree over the rows of `leaves` ((m, w) view, or the grouped
    (G, m, c) form of `poseidon2.hash_leaves`); m a power of two.

    Returns [level_0 (m, 8), ..., root (1, 8)] int32 Montgomery tensors."""
    m = leaves.shape[-2]
    if m & (m - 1):
        raise ValueError("leaf count must be a power of two")
    digests = p2.hash_leaves(leaves)
    levels = [digests]
    while digests.shape[0] > 1:
        digests = p2.compress_level(digests)
        levels.append(digests)
    return levels


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
