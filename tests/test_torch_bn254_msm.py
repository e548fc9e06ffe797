"""The port's BN254 limb arithmetic and MSM (`ethrex_tpu_torch.ops.
bn254_msm`, plain versions on the CPU) against the reference's
(`ethrex_tpu.ops.bn254_msm`, whose `msm`/`g2_msm` run the numpy substrate
`_np_msm` on a CPU backend).

Bar: bit-equality of limbs and of the affine results; all arithmetic is
exact.  Inputs are seeded numpy; points and scalars are Python ints, which
both packages take as they are.  The edge cases are those of
tests/test_bn254_msm.py.
"""

import numpy as np
import pytest
import torch

from ethrex_tpu.crypto import bn254 as jbn254
from ethrex_tpu.crypto import groth16 as jgroth16
from ethrex_tpu.ops import bn254_msm as jmsm
from ethrex_tpu_torch import convert
from ethrex_tpu_torch.crypto import bn254
from ethrex_tpu_torch.ops import bn254_msm as msm

G1 = (1, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand_fp(rng, n):
    return [int.from_bytes(rng.bytes(40), "big") % bn254.P for _ in range(n)]


def _limbs(vals):
    return np.stack([jmsm.to_mont_host(v) for v in vals])


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def test_constants_and_limb_conversions_match():
    assert (msm.P_INT, msm.R_INT, msm.R2_INT, msm.NP_INT) == (
        jmsm.P_INT, jmsm.R_INT, jmsm.R2_INT, jmsm.NP_INT)
    assert np.array_equal(msm.P_LIMBS, jmsm.P_LIMBS)
    rng = np.random.default_rng(1)
    for v in _rand_fp(rng, 20) + [0, 1, bn254.P - 1]:
        assert np.array_equal(msm.to_mont_host(v), jmsm.to_mont_host(v))
        assert msm.from_mont_host(msm.to_mont_host(v)) == v
    scalars = [int.from_bytes(rng.bytes(40), "big") for _ in range(9)]
    scalars += [0, 1, bn254.R - 1, bn254.R, bn254.R + 5]
    for bits in (1, 7, 64, 254, 256):
        assert np.array_equal(msm.scalars_to_bits(scalars, bits),
                              jmsm.scalars_to_bits(scalars, bits))


def test_field_ops_match_numpy_substrate():
    rng = np.random.default_rng(2)
    a = _rand_fp(rng, 64) + [0, 0, bn254.P - 1, 1]
    b = _rand_fp(rng, 64) + [0, bn254.P - 1, bn254.P - 1, bn254.P - 1]
    am, bm = _limbs(a).astype(np.uint64), _limbs(b).astype(np.uint64)
    at, bt = _t(am), _t(bm)
    for ours, theirs in ((msm.fadd, jmsm.np_fadd), (msm.fsub, jmsm.np_fsub),
                         (msm.fmul, jmsm.np_fmul)):
        got = ours(at, bt).numpy()
        assert np.array_equal(got, theirs(am, bm).astype(np.int64)), ours
    # Fp2 products (the G2 path)
    a2 = np.stack([am[:32], am[32:64]], axis=1)
    b2 = np.stack([bm[:32], bm[32:64]], axis=1)
    assert np.array_equal(msm.Fp2Ops.mul(_t(a2), _t(b2)).numpy(),
                          jmsm.NpFp2Ops.mul(a2, b2).astype(np.int64))


def test_point_ops_match_numpy_substrate():
    pts = [jbn254.g1_mul(G1, k) for k in (1, 2, 5, 77, 123456789)]
    X, Y, Z = (np.asarray(v, dtype=np.uint64) for v in
               jmsm.points_to_device(pts))
    want_d = jmsm._np_point_double(X, Y, Z, jmsm.NpFpOps)
    got_d = msm.point_double(_t(X), _t(Y), _t(Z))
    rev = (X[::-1].copy(), Y[::-1].copy(), Z[::-1].copy())
    want_a = jmsm._np_point_add(X, Y, Z, *rev, jmsm.NpFpOps)
    got_a = msm.point_add(_t(X), _t(Y), _t(Z), *(_t(v) for v in rev))
    for g, w in zip(got_d + got_a, want_d + want_a):
        assert np.array_equal(g.numpy(), w.astype(np.int64))
    # the port's tensors hold the reference's limbs
    for ours, theirs in zip(msm.points_to_device(pts),
                            jmsm.points_to_device(pts)):
        assert np.array_equal(ours.numpy().view(np.uint32),
                              np.asarray(theirs))


def test_msm_matches_reference():
    rng = np.random.default_rng(5)
    n = 8
    pts = [jbn254.g1_mul(G1, int(rng.integers(1, 1 << 30)))
           for _ in range(n)]
    scalars = [int.from_bytes(rng.bytes(40), "big") % bn254.R
               for _ in range(n)]
    got = msm.msm(pts, scalars, device="cpu")
    assert got == jmsm.msm(pts, scalars)
    host = None
    for pt, s in zip(pts, scalars):
        host = bn254.g1_add(host, bn254.g1_mul(pt, s))
    assert got == host


def test_msm_edge_cases_match_reference():
    cases = [
        ([G1, jbn254.g1_mul(G1, 7)], [0, 0]),        # -> infinity
        ([G1, G1], [5, bn254.R - 5]),                # P == -Q in the sum
        ([None, G1], [3, 2]),                        # infinity ignored
        ([G1, G1, G1], [3, 3, 1]),                   # P == Q in the sum
        ([jbn254.g1_mul(G1, 9)], [bn254.R + 4]),     # scalar reduced mod r
    ]
    got = [msm.msm(pts, sc, device="cpu") for pts, sc in cases]
    for (pts, sc), g in zip(cases, got):
        assert g == jmsm.msm(pts, sc), (pts, sc)
    assert got[0] is None and got[1] is None
    assert got[2] == bn254.g1_mul(G1, 2)
    assert got[3] == bn254.g1_mul(G1, 7)
    assert msm.msm([], [], device="cpu") is None
    with pytest.raises(ValueError):
        msm.msm([G1], [1, 2], device="cpu")


def test_g2_msm_matches_reference():
    rng = np.random.default_rng(7)
    pts = [jbn254.g2_mul(jgroth16.G2, int(rng.integers(1, 1 << 20)))
           for _ in range(7)] + [None]
    scalars = [int.from_bytes(rng.bytes(16), "big") for _ in range(8)]
    got = msm.g2_msm([convert.g2_point(p) for p in pts], scalars,
                     device="cpu")
    want = jmsm.g2_msm(pts, scalars)
    assert got == convert.g2_point(want)
    # P == -Q cancels to infinity on G2 too
    q = pts[0]
    neg = jbn254.g2_neg(q)
    assert msm.g2_msm([convert.g2_point(q), convert.g2_point(neg)], [3, 3],
                      device="cpu") is None


def test_msm_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        msm.msm([G1], [1])
