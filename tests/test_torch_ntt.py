"""The port's NTT module (the plain version of kernel K1) against the JAX
package's jitted NTT programs.

Bar: bit-equality; an in-order DFT has exactly one right answer, so no
tolerance applies.  Inputs come from numpy.random.default_rng.
"""

import numpy as np
import pytest
import torch

from ethrex_tpu.ops import ntt as jntt
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import ntt


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


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", list(range(1, 13)))
def test_ntt_bit_equal(log_n, inverse):
    x = _field(log_n, (3, 1 << log_n))       # leading batch axis
    got = bb.to_numpy(ntt.ntt(_t(x), inverse=inverse))
    want = np.asarray(jntt.ntt(x, inverse=inverse))
    assert np.array_equal(got, want)


def test_intt_inverts_ntt():
    x = _field(20, (2, 64))
    assert np.array_equal(bb.to_numpy(ntt.intt(ntt.ntt(_t(x)))), x)


@pytest.mark.parametrize("log_blowup", [1, 2, 3])
def test_coset_lde_bit_equal(log_blowup):
    x = _field(30 + log_blowup, (4, 64))
    got = bb.to_numpy(ntt.coset_lde(_t(x), log_blowup))
    want = np.asarray(jntt.coset_lde(x, log_blowup))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shift", [bb.GENERATOR, 7])
def test_coset_intt_bit_equal(shift):
    x = _field(40, (4, 128))
    got = bb.to_numpy(ntt.coset_intt(_t(x), shift=shift))
    want = np.asarray(jntt.coset_intt(x, shift=shift))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("m,n_out", [(16, 16), (32, 256), (64, 512)])
def test_coset_evals_from_coeffs_bit_equal(m, n_out):
    c = _field(50 + m, (2, 4, m))
    got = bb.to_numpy(ntt.coset_evals_from_coeffs(_t(c), n_out))
    want = np.asarray(jntt.coset_evals_from_coeffs(c, n_out))
    assert np.array_equal(got, want)


def test_non_contiguous_input_matches():
    x = _field(60, (64, 5))                  # transform the columns
    got = bb.to_numpy(ntt.coset_lde(_t(x).T, 2))
    want = np.asarray(jntt.coset_lde(x.T.copy(), 2))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("log_p", [0, 1, 5, 9])
def test_host_interpolation_and_domain_points_match(log_p):
    vals = _field(70 + log_p, (1 << log_p,))
    assert np.array_equal(ntt.interpolate_host(vals),
                          jntt.interpolate_host(vals))
    assert np.array_equal(ntt.domain_points(log_p + 2, 31),
                          jntt.domain_points(log_p + 2, 31))


@pytest.mark.parametrize("shape", [(1,), (33,), (3, 64), (2, 4, 1000)])
def test_eval_poly_at_bit_equal(shape):
    c = _field(80 + shape[-1], shape)
    pt = int(bb.to_mont_host(np.array([123456789 + shape[-1]]))[0])
    got = bb.to_numpy(ntt.eval_poly_at(_t(c), pt)).reshape(shape[:-1])
    want = np.asarray(jntt.eval_poly_at(c, np.uint32(pt)))
    assert np.array_equal(got, want)
    # a 0-dim Montgomery tensor names the same point
    got_t = ntt.eval_poly_at(_t(c), bb.from_numpy(np.uint32(pt), "cpu"))
    assert np.array_equal(bb.to_numpy(got_t).reshape(shape[:-1]), want)


@pytest.mark.parametrize("n,w", [(1, 1), (5, 3), (64, 1), (70, 33)])
def test_to_mont_cols_equals_the_reference_upload(n, w):
    from ethrex_tpu.ops import babybear as jbb

    trace = _field(90 + w, (n, w))
    got = bb.to_numpy(bb.to_mont_cols(_t(trace)))
    want = np.asarray(jbb.to_mont(trace.T.copy()))       # prover.py:754
    assert got.shape == (w, n) and np.array_equal(got, want)
