"""The CUDA kernels K1-K11 against their plain PyTorch versions on the
card, at small and ragged shapes (chip_smoke.py covers the full-size
ones); a small aggregate proof, a small VM-mode batch's stage proofs and
the fused prove step made on the card against the same made on the CPU.

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
from ethrex_tpu_torch.models import bytecode_air as bca
from ethrex_tpu_torch.models import fri_verifier_air as fva
from ethrex_tpu_torch.models import token_air as tka
from ethrex_tpu_torch.models import transfer_air as ta
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
    fva.FriVerifyAir(7, 16), ta.TransferAir(), tka.TokenAir(),
    bca.BytecodeAir()], ids=lambda a: type(a).__name__)
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


def _ext_point(seed):
    rng = np.random.default_rng(seed)
    return tuple(int(v) for v in rng.integers(0, bb.P, 4))


@pytest.mark.parametrize("n", [1, 5, 128, 129, 4096, 70000])
def test_powers_table_kernel_equals_plain(dev, n):
    z = _ext_point(n)
    got = ext.powers_table(z, n, dev)
    assert torch.equal(got, ext.ext_powers_blocked(z, n, device=dev))


@pytest.mark.parametrize("rows,n", [(1, 3), (8, 1000), (4, 1 << 15)])
def test_ext_poly_eval_kernel_equals_plain(dev, rows, n):
    # the prover's chunks: a (rows, n, 4) view of a (rows, 4, n) block
    c = _field(rows + n, (rows, 4, n), dev).permute(0, 2, 1)
    z = _ext_point(rows)
    got = ext.eval_ext_poly_at_ext(c, z)
    assert torch.equal(got, ext.eval_ext_poly_at_ext_plain(c, z))
    assert torch.equal(ext.eval_ext_poly_at_ext(c.contiguous(), z), got)


@pytest.mark.parametrize("nb", [0, 1, 9])
def test_quotient_combine_kernel_equals_plain(dev, nb):
    N, B, w = 1 << 12, 8, 5
    acc = _field(1, (N, 4), dev)
    xm = _field(2, (N,), dev)
    inv = _field(3, (B + N + nb * N,), dev)
    lde = _field(4, (w, N), dev)
    cols = [j % w for j in range(nb)]
    bvals = _field(5, (nb,), dev)
    apb = _field(6, (nb, 4), dev)
    got = ext.quotient_combine(acc, xm, inv, lde, cols, bvals, apb, B)
    assert torch.equal(got, ext.quotient_combine_plain(
        acc, xm, inv, lde, cols, bvals, apb, B))


@pytest.mark.parametrize("two,nq", [(True, 8), (True, 0), (False, 0)])
def test_deep_compose_kernel_equals_plain(dev, two, nq):
    N, w = 1 << 12, 7
    pts = _field(1, (N,), dev)
    opens = [(_ext_point(10 + o), _field(20 + o, (N, 4), dev),
              _field(30 + o, (w, 4), dev), _field(40 + o, (w, 4), dev))
             for o in range(2 if two else 1)]
    q = dict(q_lde=_field(5, (nq, 4, N), dev), q_z=_field(6, (nq, 4), dev),
             gq=_field(7, (nq, 4), dev)) if nq else {}
    got = ext.deep_compose(pts, opens, **q)
    assert torch.equal(got, ext.deep_compose_plain(pts, opens, **q))


@pytest.mark.parametrize("sizes", [(1,), (4, 1, 2), (64, 32, 1, 16, 8, 1),
                                   (1 << 12, 1 << 11, 2, 1)])
def test_batched_roots_kernel_equals_plain(dev, sizes):
    from ethrex_tpu_torch.ops import merkle

    d = _field(len(sizes), (sum(sizes), 8), dev)
    got = merkle.batched_roots(d, sizes)
    want = merkle.batched_roots_plain(d, sizes)
    assert len(got) == len(sizes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fused_step_on_the_card_equals_cpu(dev):
    from ethrex_tpu_torch.parallel.core import build_prove_step

    step_d, args_d = build_prove_step(8, 8, 2, 4, device=dev)
    step_c, args_c = build_prove_step(8, 8, 2, 4, device="cpu")
    kernels.reset_launches()
    troot, roots, cw = step_d(*args_d)
    want = step_c(*args_c)
    assert torch.equal(troot.cpu(), want[0])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(roots, want[1]))
    assert torch.equal(cw.cpu(), want[2])
    for name in ("ntt", "poseidon2_hash_leaves", "mod_matmul", "fri_fold",
                 "deep_compose", "merkle_batched_level", "ext_poly_eval"):
        assert kernels.LAUNCHES[name] > 0, name


def test_small_vm_stages_on_the_card_equal_cpu(dev):
    """A VM-mode batch (2 transfer segments, 2 token segments, one
    bytecode call): the stage proofs made on the card equal the CPU's."""
    from ethrex_tpu_torch.guest import bytecode_vm as bv
    from ethrex_tpu_torch.guest.transfer_log import BcCall, TokSeg, VmBatch
    from ethrex_tpu_torch.primitives.account import AccountState
    from ethrex_tpu_torch.prover import gpu_backend
    from ethrex_tpu_torch.stark import state_tree

    s_old = AccountState(nonce=4, balance=10**18)
    s_new = AccountState(nonce=5, balance=10**18 - 1000 - 147000)
    segs = [ta.TxSeg(b"\x11" * 20, b"\x22" * 20, s_old, s_new,
                     AccountState(1, 500), AccountState(1, 1500), 1000,
                     147000, 42000, r_created=False, r_noop=False),
            ta.CbSeg(b"\x33" * 20, AccountState(0, 77),
                     AccountState(0, 77 + 42000), 42000, created=False,
                     noop=False)]
    toks = [TokSeg(12345, 7, 10**6, 10**6 - 12345, 9, 500, 500 + 12345),
            TokSeg(0, 0, 0, 0, 0, 0, 0, noop=True)]
    code = bytes([0x60, 0x01, 0x60, 0x02, 0x01, 0x5F, 0x55, 0x00])
    steps, snaps, _ = bv.run_trace(code, b"", b"\xaa" * 20, 0, lambda s: 0,
                                   address=b"\xbb" * 20)
    batch = VmBatch([], segs, toks, [], [BcCall(steps, snaps)])
    rng = np.random.default_rng(5)
    entries = {bytes(rng.integers(0, 256, 32, dtype=np.uint8)):
               bytes(rng.integers(0, 256, 32, dtype=np.uint8))
               for _ in range(4)}
    tree = state_tree.TouchedStateTree(entries, 2)
    r_pre = tree.root
    keys = sorted(entries)
    records = [tree.update(keys[i], bytes([i]) * 32) for i in range(3)]
    params = prover.StarkParams(3, 8, 4)
    args = (records, r_pre, tree.root, 2, b"\x01" * 40, batch, "stark")
    kernels.reset_launches()
    on_card, _, _ = gpu_backend.prove_vm_stages(*args, device=dev,
                                               params=params)
    for name in ("air_constraints", "quotient_combine", "deep_compose",
                 "ext_poly_eval"):
        assert kernels.LAUNCHES[name] > 0, name
    on_cpu, _, _ = gpu_backend.prove_vm_stages(*args, device="cpu",
                                              params=params)
    assert on_card == on_cpu
