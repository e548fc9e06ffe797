"""The port's BabyBear field ops and modular matmul against the JAX package.

Bar: bit-equality.  All arithmetic is exact, so every result must equal the
JAX function's uint32 residues exactly; no tolerance applies.  Inputs come
from numpy.random.default_rng; the JAX functions run as jitted programs on
the CPU, the port's as its plain PyTorch versions (CPU tensors).
"""

import numpy as np
import pytest
import torch

from ethrex_tpu.ops import babybear as jbb
from ethrex_tpu_torch import kernels
from ethrex_tpu_torch.ops import babybear as bb

P = bb.P
EDGE = np.array([0, 1, P - 1, bb._R, 2, P - 2], dtype=np.uint32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _field(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return bb.from_numpy(a, "cpu")


def _np(t):
    return bb.to_numpy(t)


def _operands(seed):
    rng = np.random.default_rng(seed)
    a = np.concatenate([_field(rng, 500), np.repeat(EDGE, len(EDGE))])
    b = np.concatenate([_field(rng, 500), np.tile(EDGE, len(EDGE))])
    return a, b


def test_constants_match():
    assert bb.P == jbb.P and bb._R == jbb._R and bb._NP == jbb._NP
    assert bb._R2 == jbb._R2 and bb.MONT_ONE == int(jbb.MONT_ONE)
    for log_n in (0, 1, 5, 22, 27):
        assert bb.root_of_unity(log_n) == jbb.root_of_unity(log_n)
    assert (bb.powers_host(7, 1000) == jbb.powers_host(7, 1000)).all()


@pytest.mark.parametrize("name", ["add", "sub", "mont_mul"])
def test_binary_ops_bit_equal(name):
    a, b = _operands(1)
    got = _np(getattr(bb, name)(_t(a), _t(b)))
    want = np.asarray(getattr(jbb, name)(a, b))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["neg", "to_mont", "from_mont", "mont_inv"])
def test_unary_ops_bit_equal(name):
    a, _ = _operands(2)
    if name == "mont_inv":
        a = a[a != 0]
    got = _np(getattr(bb, name)(_t(a)))
    want = np.asarray(getattr(jbb, name)(a))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("e", [0, 1, 7, 2**20 + 3])
def test_mont_pow_bit_equal(e):
    a, _ = _operands(3)
    assert np.array_equal(_np(bb.mont_pow(_t(a), e)),
                          np.asarray(jbb.mont_pow(a, e)))


def test_host_conversions_match():
    a, _ = _operands(4)
    assert np.array_equal(bb.to_mont_host(a), jbb.to_mont_host(a))
    assert np.array_equal(bb.from_mont_host(a), jbb.from_mont_host(a))
    assert np.array_equal(bb.from_mont_host(a.view(np.int32)),
                          jbb.from_mont_host(a))


@pytest.mark.parametrize("shape,axis", [((37,), -1), ((5, 115), -1),
                                        ((16, 9), 0)])
def test_sum_mod_bit_equal(shape, axis):
    x = _field(np.random.default_rng(5), shape)
    assert np.array_equal(_np(bb.sum_mod(_t(x), dim=axis)),
                          np.asarray(jbb.sum_mod(x, axis=axis)))


def test_batch_mont_inv_bit_equal():
    a = _field(np.random.default_rng(6), (3, 41))
    a[a == 0] = 1
    assert np.array_equal(_np(bb.batch_mont_inv(_t(a))),
                          np.asarray(jbb.batch_mont_inv(a)))


def test_batch_mont_inv_large_and_zero():
    """The divisor-table size class (tens of thousands of elements), with
    the edge values; the plain version (the Fermat power, what runs on the
    CPU and what kernel K7 is held to) maps 0 to 0."""
    a = _field(np.random.default_rng(16), (40000,))
    a[:len(EDGE)] = EDGE
    nz = a != 0
    got = _np(bb.batch_mont_inv(_t(a)))
    assert np.array_equal(got[nz], np.asarray(jbb.batch_mont_inv(a[nz])))
    assert np.all(got[~nz] == 0)
    assert np.array_equal(got, _np(bb.batch_mont_inv_plain(_t(a))))


@pytest.mark.parametrize("montgomery", [True, False])
@pytest.mark.parametrize("k", [1, 115, 128, 159, 9000])
def test_mod_matmul_bit_equal(k, montgomery):
    rng = np.random.default_rng(k)
    n = 33 if k < 9000 else 5
    a = _field(rng, (n, k))
    b = _field(rng, (k, 4))
    a[0, :] = P - 1          # the largest products
    b[:, 0] = P - 1
    got = _np(bb.mod_matmul(_t(a), _t(b), montgomery=montgomery))
    want = np.asarray(jbb.mod_matmul(a, b, montgomery=montgomery))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("montgomery", [True, False])
@pytest.mark.parametrize("n,k", [(33, 115), (70, 354), (5, 9000)])
def test_mod_matmul_m8_equals_two_jax_calls(n, k, montgomery):
    """Two right-hand sides side by side (the deep and open phases' pairs)
    give the two JAX products as columns 0-3 and 4-7."""
    rng = np.random.default_rng(n + k)
    a = _field(rng, (k, n)).T            # column-major, as the LDE rows
    b1, b2 = _field(rng, (k, 4)), _field(rng, (k, 4))
    a[0, :] = P - 1
    b2[:, 3] = P - 1
    got = _np(bb.mod_matmul(_t(np.ascontiguousarray(a.T)).T,
                            _t(np.concatenate([b1, b2], axis=1)),
                            montgomery=montgomery))
    assert got.shape == (n, 8)
    a = np.ascontiguousarray(a)
    assert np.array_equal(got[:, :4], np.asarray(
        jbb.mod_matmul(a, b1, montgomery=montgomery)))
    assert np.array_equal(got[:, 4:], np.asarray(
        jbb.mod_matmul(a, b2, montgomery=montgomery)))


def test_mod_matmul_reads_strided_operand():
    rng = np.random.default_rng(8)
    a = _field(rng, (159, 64))       # (K, N) stack, used transposed
    b = _field(rng, (159, 4))
    got = _np(bb.mod_matmul(_t(a).T, _t(b)))
    assert np.array_equal(got, np.asarray(jbb.mod_matmul(a.T.copy(), b)))


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    kernels.reset_launches()
    a = _t(_field(np.random.default_rng(9), (8, 16)))
    bb.mod_matmul(a, _t(_field(np.random.default_rng(10), (16, 4))))
    bb.batch_mont_inv(a)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert kernels._lib is None      # importing and CPU use build nothing
