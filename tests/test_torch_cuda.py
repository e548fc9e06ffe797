"""The CUDA kernels K1-K4 against their plain PyTorch versions on the card,
at small and ragged shapes (chip_smoke.py covers the full-size ones).

Bar: bit-equality (torch.equal); all arithmetic is exact.  Every test
skips, saying so, when torch.cuda.is_available() is False; a kernel that
fails to build on a CUDA host fails its test.  This file imports neither
JAX nor the JAX package, so on a machine without JAX it runs as
`python -m pytest --noconftest tests/test_torch_cuda.py -q`.
"""

import numpy as np
import pytest
import torch

from ethrex_tpu_torch import kernels
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import fri
from ethrex_tpu_torch.ops import ntt
from ethrex_tpu_torch.ops import poseidon2 as p2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda.is_available() is False: the CUDA kernels "
                    "need a card")
    kernels.lib()
    return torch.device("cuda", 0)


def _field(seed, shape, device):
    rng = np.random.default_rng(seed)
    return bb.from_numpy(
        rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(np.uint32),
        device)


@pytest.mark.parametrize("log_n", [1, 2, 5, 10, 11, 12, 14])
def test_ntt_kernel_equals_plain(dev, log_n):
    x = _field(log_n, (3, 1 << log_n), dev)
    pre = _field(100 + log_n, (1 << log_n,), dev)
    post = _field(200 + log_n, (2 << log_n,), dev)
    for kw in (dict(), dict(inverse=True), dict(n_out=2 << log_n, pre=pre),
               dict(inverse=True, n_out=2 << log_n, post=post)):
        got = ntt.scaled_ntt(x, **kw)
        assert torch.equal(got, ntt.scaled_ntt_plain(x, **kw)), kw


@pytest.mark.parametrize("w", [1, 8, 13, 24, 115])
def test_hash_leaves_kernel_equals_plain(dev, w):
    cols = _field(w, (w, 96), dev)
    assert torch.equal(p2.hash_leaves(cols.T), p2.hash_leaves_plain(cols.T))
    rows = cols.T.contiguous()
    assert torch.equal(p2.hash_leaves(rows), p2.hash_leaves_plain(rows))


def test_paired_leaves_and_compress_kernel_equal_plain(dev):
    cw = _field(1, (256, 4), dev)
    pairs = fri.pair_leaves(cw)
    assert torch.equal(p2.hash_leaves(pairs), p2.hash_leaves_plain(pairs))
    level = _field(2, (64, 8), dev)
    assert torch.equal(p2.compress_level(level),
                       p2.compress_level_plain(level))


@pytest.mark.parametrize("n,k", [(33, 1), (5000, 159), (115, 9000),
                                 (7, 70000)])
def test_mod_matmul_kernel_equals_plain(dev, n, k):
    a = _field(n + k, (n, k), dev)
    b = _field(k, (k, 4), dev)
    a[0] = bb.P - 1
    b[:, 1] = bb.P - 1
    for mont in (True, False):
        assert torch.equal(bb.mod_matmul(a, b, mont),
                           bb.mod_matmul_plain(a, b, mont))
    at = a.T.contiguous().T                 # column-major operand
    assert torch.equal(bb.mod_matmul(at, b), bb.mod_matmul_plain(a, b))


def test_fold_kernel_equals_plain(dev):
    cw = _field(3, (512, 4), dev)
    beta = _field(4, (4,), dev)
    inv_pts = bb.from_numpy(fri._fold_inv_points_np(9, 31), dev)
    inv2 = bb.from_numpy(bb.to_mont_host(np.array([fri._INV2])), dev)
    assert torch.equal(fri.fold(cw, beta, inv_pts, inv2),
                       fri.fold_plain(cw, beta, inv_pts, inv2))


def test_launches_are_counted_only_on_the_card(dev):
    kernels.reset_launches()
    x = _field(5, (2, 64), dev)
    ntt.ntt(x)
    ntt.ntt(x.cpu())
    assert kernels.LAUNCHES["ntt"] == 1
