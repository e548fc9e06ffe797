"""The port's Poseidon2 and Merkle modules (the plain versions of kernel K2)
against the JAX package and its host reference.

Bar: bit-equality of every digest and of every Merkle level; no tolerance
applies.  Inputs come from numpy.random.default_rng.
"""

import numpy as np
import pytest
import torch

from ethrex_tpu.ops import babybear as jbb
from ethrex_tpu.ops import merkle as jmerkle
from ethrex_tpu.ops import poseidon2 as jp2
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import fri
from ethrex_tpu_torch.ops import merkle
from ethrex_tpu_torch.ops import poseidon2 as p2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _field(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return bb.from_numpy(a, "cpu")


def test_constants_equal_the_reference():
    assert np.array_equal(p2.EXT_RC, jp2.EXT_RC)
    assert np.array_equal(p2.INT_RC, jp2.INT_RC)
    assert np.array_equal(p2.DIAG_MU, jp2.DIAG_MU)


def test_permute_ref_copy_matches():
    for seed in range(3):
        s = [int(v) for v in _field(seed, (16,))]
        assert p2.permute_ref(s) == jp2.permute_ref(s)


def test_permute_matches_reference_and_jax():
    states_c = _field(10, (12, 16))
    states_c[0] = 0
    states_c[1] = bb.P - 1
    states = bb.to_mont_host(states_c)
    got = bb.to_numpy(p2.permute(_t(states)))
    assert np.array_equal(got, np.asarray(jp2.permute(states)))
    for row_c, row in zip(states_c, got):
        assert [int(v) for v in bb.from_mont_host(row)] == \
            jp2.permute_ref([int(v) for v in row_c])


def test_compress_bit_equal():
    left, right = _field(11, (9, 8)), _field(12, (9, 8))
    got = bb.to_numpy(p2.compress(_t(left), _t(right)))
    assert np.array_equal(got, np.asarray(jp2.compress(left, right)))


@pytest.mark.parametrize("w", [8, 24, 32, 115])
def test_hash_leaves_bit_equal(w):
    leaves = _field(20 + w, (16, w))  # 16 rows: the shape of the tree test
    got = bb.to_numpy(p2.hash_leaves(_t(leaves)))
    assert np.array_equal(got, np.asarray(jp2.hash_leaves(leaves)))
    # the canonical host rule gives the same digest for one row
    row_c = [int(v) for v in bb.from_mont_host(leaves[3])]
    assert [int(v) for v in bb.from_mont_host(got[3])] == \
        jmerkle.hash_leaf_ref(row_c) == merkle.hash_leaf_ref(row_c)


def test_hash_leaves_reads_columns_in_place():
    cols = _field(30, (115, 16))            # column-major LDE layout
    got = bb.to_numpy(p2.hash_leaves(_t(cols).T))
    assert np.array_equal(got, np.asarray(jp2.hash_leaves(cols.T.copy())))


@pytest.mark.parametrize("m,w", [(16, 115), (8, 8)])
def test_commit_levels_every_level_equal(m, w):
    leaves = _field(40 + m, (m, w))
    ours = merkle.commit_levels(_t(leaves))
    ref = jmerkle.commit_levels(leaves)
    assert len(ours) == len(ref)
    for lo, lr in zip(ours, ref):
        assert np.array_equal(bb.to_numpy(lo), np.asarray(lr))


def test_paired_fri_leaves_equal_the_jax_pairing():
    cw = _field(50, (64, 4))
    ours = merkle.commit_levels(fri.pair_leaves(_t(cw)))
    from ethrex_tpu.ops import fri as jfri

    ref = jmerkle.commit_levels(jfri._pair_leaves(cw))
    for lo, lr in zip(ours, ref):
        assert np.array_equal(bb.to_numpy(lo), np.asarray(lr))


def test_open_paths_and_host_helpers_match():
    leaves = _field(60, (32, 24))
    levels = merkle.commit_levels(_t(leaves))
    levels_c = [jbb.from_mont_host(np.asarray(lv)) for lv in
                jmerkle.commit_levels(leaves)]
    idx = [0, 5, 31, 17]
    paths = merkle.open_paths(levels, idx)
    root_c = [int(v) for v in levels_c[-1][0]]
    for i, path in zip(idx, paths):
        assert path == jmerkle.open_path_canonical(levels_c, i)
        row_c = [int(v) for v in bb.from_mont_host(leaves[i])]
        assert merkle.verify_opening(root_c, i, row_c, path, 5)
        assert jmerkle.verify_opening(root_c, i, row_c, path, 5)
        assert not merkle.verify_opening(root_c, i ^ 1, row_c, path, 5)
    assert merkle.compress_ref(root_c, root_c) == \
        jmerkle.compress_ref(root_c, root_c)
