"""The CUDA kernels K1-K7 against their plain PyTorch versions on the card,
at small and ragged shapes (chip_smoke.py covers the full-size ones), and
a small aggregate proof made on the card against the same proof made on
the CPU.

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
from ethrex_tpu_torch.crypto import bn254
from ethrex_tpu_torch.models import fri_verifier_air as fva
from ethrex_tpu_torch.models import poseidon2_air as pair
from ethrex_tpu_torch.models import state_update_air as sua
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import bn254_msm as msm_ops
from ethrex_tpu_torch.ops import ext
from ethrex_tpu_torch.ops import fri
from ethrex_tpu_torch.ops import ntt
from ethrex_tpu_torch.ops import poseidon2 as p2
from ethrex_tpu_torch.stark import aggregate
from ethrex_tpu_torch.stark import air_codegen
from ethrex_tpu_torch.stark import prover


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


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 100003])
def test_batch_inv_kernel_equals_plain(dev, n):
    a = _field(n, (n,), dev)
    a[:: max(1, n // 7)] = 0            # zeros map to zero in both
    got = bb.batch_mont_inv(a)
    assert torch.equal(got, bb.batch_mont_inv_plain(a))
    nz = a != 0
    assert torch.all(bb.mont_mul(got[nz], a[nz]) == bb.MONT_ONE)


def test_inv_x_minus_zeta_on_the_card_equals_cpu(dev):
    x = _field(9, (4096,), dev)
    zeta = ext.to_device((5, 7, 11, 13), dev)
    assert torch.equal(ext.inv_x_minus_zeta(x, zeta).cpu(),
                       ext.inv_x_minus_zeta(x.cpu(), zeta.cpu()))


@pytest.mark.parametrize("air", [
    sua.StateUpdateAir(2, seg_periods=8), pair.Poseidon2SpongeAir(3),
    fva.FriVerifyAir(7, 16)], ids=lambda a: type(a).__name__)
def test_air_kernel_equals_plain(dev, air):
    N, B = 1 << 12, 8
    lde = _field(air.width, (air.width, N), dev)
    per = _field(air.num_periodic + 1, (air.num_periodic, N), dev)
    got = air_codegen.evaluate(air, lde, per, B)
    assert got.shape == (air.num_constraints, N)
    assert torch.equal(got, air_codegen.evaluate_plain(air, lde, per, B))
    graph = air_codegen.record(air)
    assert torch.equal(got, air_codegen.interpret(graph, lde, per, B))


def _g1_points(rng, n):
    return [bn254.g1_mul(bn254.G1, int(rng.integers(1, 1 << 40)))
            for _ in range(n)]


def _scalars(rng, n, nbytes=40):
    return [int.from_bytes(rng.bytes(nbytes), "big") % bn254.R
            for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 37])
def test_msm_g1_kernel_equals_plain(dev, n):
    rng = np.random.default_rng(n)
    pts = _g1_points(rng, n)
    sc = _scalars(rng, n)
    X, Y, Z = msm_ops.points_to_device(pts, dev)
    bits = torch.from_numpy(msm_ops.scalars_to_bits(sc, 254).view(
        np.int32)).to(dev)
    got = msm_ops.msm_device(X, Y, Z, bits)
    want = msm_ops.msm_device_plain(X, Y, Z, bits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    host = None
    for pt, s in zip(pts, sc):
        host = bn254.g1_add(host, bn254.g1_mul(pt, s))
    assert msm_ops.msm(pts, sc, device=dev) == host


def test_msm_edge_cases_on_the_card(dev):
    g = bn254.G1
    assert msm_ops.msm([g, bn254.g1_mul(g, 7)], [0, 0], device=dev) is None
    assert msm_ops.msm([g, g], [5, bn254.R - 5], device=dev) is None
    assert msm_ops.msm([None, g], [3, 2], device=dev) == bn254.g1_mul(g, 2)
    assert msm_ops.msm([g, g, g], [3, 3, 1], device=dev) == \
        bn254.g1_mul(g, 7)


def test_msm_g2_kernel_equals_plain(dev):
    rng = np.random.default_rng(2)
    pts = [bn254.g2_mul(bn254.G2, int(rng.integers(1, 1 << 20)))
           for _ in range(5)] + [None]
    sc = _scalars(rng, 6)
    X, Y, Z = msm_ops.g2_points_to_device(pts, dev)
    bits = torch.from_numpy(msm_ops.scalars_to_bits(sc, 254).view(
        np.int32)).to(dev)
    got = msm_ops.msm_device(X, Y, Z, bits, fp2=True)
    want = msm_ops.msm_device_plain(X, Y, Z, bits, fp2=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    host = None
    for pt, s in zip(pts, sc):
        host = bn254.g2_add(host, bn254.g2_mul(pt, s) if pt else None)
    got_aff = msm_ops.g2_msm(pts, sc, device=dev)
    assert got_aff[0] == host[0] and got_aff[1] == host[1]


def test_small_aggregate_on_the_card_equals_cpu(dev):
    params = prover.StarkParams(log_blowup=3, num_queries=1,
                                log_final_size=6)
    outer = prover.StarkParams(log_blowup=3, num_queries=2,
                               log_final_size=4)
    rng = np.random.default_rng(3)
    airs, proofs = [], []
    for limbs in (5, 13):
        msg = [int(v) for v in rng.integers(0, bb.P, limbs)]
        air = pair.Poseidon2SpongeAir(len(pair.pad_message_limbs(msg)) // 8)
        proofs.append(prover.prove(air, pair.generate_sponge_trace(msg),
                                   pair.sponge_public_inputs(msg), params,
                                   device="cpu"))
        airs.append(air)
    on_card = aggregate.aggregate(airs, proofs, params, outer, device=dev)
    on_cpu = aggregate.aggregate(airs, proofs, params, outer, device="cpu")
    assert on_card == on_cpu
    assert aggregate.verify_aggregated(airs, on_card, params, outer)
