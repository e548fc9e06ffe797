"""The port's quartic-extension ops, challenger and FRI (the plain version
of kernel K4, and K2 on paired leaves) against the JAX package.

Bar: bit-equality of every residue, and equality of the whole FriProof and
query indices on the same codeword and transcript; no tolerance applies.
Inputs come from numpy.random.default_rng.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ethrex_tpu.ops import babybear as jbb
from ethrex_tpu.ops import challenger as jch
from ethrex_tpu.ops import ext as jext
from ethrex_tpu.ops import fri as jfri
from ethrex_tpu.ops import ntt as jntt
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import challenger as ch
from ethrex_tpu_torch.ops import ext
from ethrex_tpu_torch.ops import fri


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


def _eq(t, arr):
    return np.array_equal(bb.to_numpy(t), np.asarray(arr))


@pytest.mark.parametrize("n", [1, 33, 200])
def test_ext_inv_device_and_batch_inv_bit_equal(n):
    a = _field(300 + n, (n, 4))
    a[a.sum(axis=1) == 0, 0] = 1            # the reference needs nonzero
    want = np.asarray(jext.batch_inv(a))
    assert _eq(ext.batch_inv(_t(a)), want)
    assert _eq(ext.ext_inv_device(_t(a)), np.asarray(jext.ext_inv_device(a)))
    assert _eq(ext.ext_inv_device(_t(a)), want)
    # leading axes are kept, as the reference keeps them
    a3 = a[: (n // 2) * 2].reshape(-1, 2, 4) if n > 1 else a.reshape(1, 4)
    assert _eq(ext.batch_inv(_t(a3)), np.asarray(jext.batch_inv(a3)))


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_ext_binary_ops_bit_equal(name):
    a, b = _field(1, (50, 4)), _field(2, (50, 4))
    assert _eq(getattr(ext, name)(_t(a), _t(b)), getattr(jext, name)(a, b))


def test_ext_scalar_mul_frobenius_from_base_bit_equal():
    a, s = _field(3, (50, 4)), _field(4, (50,))
    assert _eq(ext.scalar_mul(_t(a), _t(s)), jext.scalar_mul(a, s))
    assert _eq(ext.from_base(_t(s)), jext.from_base(s))
    for k in (1, 2, 3):
        assert _eq(ext.frobenius(_t(a), k), jext.frobenius(a, k))


@pytest.mark.parametrize("n", [5, 130])
def test_ext_powers_bit_equal(n):
    z = _field(5, (4,))
    assert _eq(ext.ext_powers(_t(z), n), jext.ext_powers(z, n))
    assert _eq(ext.ext_powers_blocked(_t(z), n),
               jext.ext_powers_blocked(z, n))


@pytest.mark.parametrize("n", [64, 1000])
def test_eval_base_poly_at_ext_bit_equal(n):
    coeffs, z = _field(6, (3, n)), _field(7, (4,))
    assert _eq(ext.eval_base_poly_at_ext(_t(coeffs), _t(z)),
               jext.eval_base_poly_at_ext(coeffs, z))


@pytest.mark.parametrize("n", [64, 1000, 1 << 13])
def test_eval_base_poly_at_two_points_equals_two_jax_calls(n):
    """The open phase's two points in one pass (K3 at m = 8) equal two
    calls of the JAX function; above 4,096 coefficients the card takes
    the split-k kernel, so the CPU runs the same wrapper at that size."""
    coeffs, z1, z2 = _field(8, (5, n)), _field(9, (4,)), _field(10, (4,))
    got1, got2 = ext.eval_base_poly_at_ext(_t(coeffs), _t(z1), _t(z2))
    assert got1.shape == got2.shape == (5, 4)
    assert _eq(got1, jext.eval_base_poly_at_ext(coeffs, z1))
    assert _eq(got2, jext.eval_base_poly_at_ext(coeffs, z2))


def test_eval_ext_poly_at_ext_bit_equal():
    coeffs, z = _field(8, (8, 64, 4)), _field(9, (4,))
    assert _eq(ext.eval_ext_poly_at_ext(_t(coeffs), _t(z)),
               jext.eval_ext_poly_at_ext(coeffs, z))


@pytest.mark.parametrize("log_n", [0, 3, 10])
def test_open_powers_and_phase_open_equal_the_reference(log_n):
    """The open phase's fused entry (`ext.open_powers`, run through its
    plain version here) and the port's `phase_open` built on it give the
    reference's t_z, t_zg and q_z (ethrex_tpu/stark/prover.py:560-562):
    the trace (w, n) and the B quotient chunks, a (B, n, 4) view of (B,
    4, n) coefficients, at zeta and zeta g."""
    from ethrex_tpu_torch.stark import prover

    n, w, B = 1 << log_n, 6, 8
    cols = jbb.to_mont_host(_field(20 + log_n, (w, n)))
    chunks = np.moveaxis(_field(30 + log_n, (B, 4, n)), 1, 2)  # (B, n, 4)
    rng = np.random.default_rng(log_n)
    zeta = tuple(int(v) for v in rng.integers(0, bb.P, 4))
    zeta_g = ext.h_mul(zeta, ext.h_from_base(bb.root_of_unity(log_n)))

    def zm(z):
        return jbb.to_mont_host(np.array(z, dtype=np.uint64))

    tcoeffs = jntt.intt(cols)
    want = (jext.eval_base_poly_at_ext(tcoeffs, zm(zeta)),
            jext.eval_base_poly_at_ext(tcoeffs, zm(zeta_g)),
            jext.eval_ext_poly_at_ext(chunks, zm(zeta)))
    chunks_t = _t(np.ascontiguousarray(np.moveaxis(chunks, 2, 1))
                  ).permute(0, 2, 1)
    got = prover.phase_open(_t(cols), chunks_t, zeta, zeta_g)
    for g, wv in zip(got, want):
        assert _eq(g, wv)
    table, sums = ext.open_powers((zeta, zeta_g), n, chunks_t)
    assert _eq(sums, want[2])
    assert _eq(table[:, :4], jext.ext_powers_blocked(zm(zeta), n))
    assert _eq(table[:, 4:], jext.ext_powers_blocked(zm(zeta_g), n))


def test_inv_x_minus_zeta_bit_equal():
    x, z = _field(10, (256,)), _field(11, (4,))
    got = ext.inv_x_minus_zeta(_t(x), _t(z))
    assert _eq(got, jext.inv_x_minus_zeta(x, z))
    # and it is the inverse: (x - z) * got == 1
    diff = ext.sub(ext.from_base(_t(x)), _t(z).expand(256, 4))
    one = bb.to_numpy(ext.mul(diff, got))
    assert (one[:, 0] == bb.MONT_ONE).all() and (one[:, 1:] == 0).all()


def test_host_ext_ops_match():
    a = tuple(int(v) for v in _field(12, (4,)))
    b = tuple(int(v) for v in _field(13, (4,)))
    assert ext.h_mul(a, b) == jext.h_mul(a, b)
    assert ext.h_inv(a) == jext.h_inv(a)
    assert ext.h_pow(a, 12345) == jext.h_pow(a, 12345)
    assert ext.to_host(ext.to_device(a, "cpu")) == a


def test_fold_bit_equal():
    cw, beta = _field(14, (128, 4)), _field(15, (4,))
    inv_pts = jfri._fold_inv_points(7, 31)
    inv2 = np.uint32(int(jbb.to_mont_host(jfri._INV2)))
    assert np.array_equal(fri._fold_inv_points_np(7, 31), inv_pts)
    got = fri.fold(_t(cw), _t(beta), _t(inv_pts), _t(np.array([inv2])))
    assert _eq(got, jfri._fold(cw, beta, inv_pts, inv2))


def test_challenger_transcript_and_grinding_match():
    ours, ref = ch.Challenger(), jch.Challenger()
    for c in (ours, ref):
        c.absorb_elems([1, 2, 3, bb.P - 1])
        c.absorb_int(2**40 + 5)
    assert ours.sample_ext() == ref.sample_ext()
    for bits in (6, 10):
        assert ours.grind(bits) == ref.grind(bits)
        assert ours.sample_indices(12, 5) == ref.sample_indices(12, 5)
    assert ours.state() == ref.state()


def _low_degree_codeword(log_n, log_blowup, seed):
    """Evaluations of a random ext poly of degree < N/blowup on the coset."""
    n = 1 << log_n
    coeffs = _field(seed, (4, n >> log_blowup))
    return np.asarray(jntt.coset_evals_from_coeffs(coeffs, n)).T.copy()


def test_fri_prove_equals_jax():
    params = dict(log_blowup=2, num_queries=6, log_final_size=3,
                  grinding_bits=4)
    cw = _low_degree_codeword(7, 2, 16)
    ref_proof, ref_idx = jfri.FriProver(jfri.FriParams(**params)).prove(
        cw, jch.Challenger())
    our_ch = ch.Challenger()
    our_proof, our_idx = fri.FriProver(fri.FriParams(**params)).prove(
        _t(cw), our_ch)
    assert our_idx == ref_idx
    assert dataclasses.asdict(our_proof) == dataclasses.asdict(ref_proof)
    # both verifiers accept it
    fp = fri.FriParams(**params)
    fri.verify(our_proof, 7, ch.Challenger(), fp)
    jfri.verify(ref_proof, 7, jch.Challenger(), jfri.FriParams(**params))
