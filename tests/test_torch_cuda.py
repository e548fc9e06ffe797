"""The CUDA kernels K1-K11 (K6 in both its modes: the constraint block
and its fused alpha combination; K7 with its divisor entry; K11 as the
open phase calls it and in its single-point forms) and the four
slice-4 kernels (ext_inv,
ext_batch_inv, eval_poly_at, to_mont_cols) against their plain PyTorch
versions on the card, at small and ragged shapes that reach every branch
of the NTT's pass plan and the Merkle subtree plan (chip_smoke.py covers
the full-size ones); a small aggregate proof, a small VM-mode batch's stage proofs and
the fused prove step made on the card against the same made on the CPU,
and `GpuBackend` proving a committed ProgramInput on the card against
the same proof made on the CPU.

Bar: bit-equality (torch.equal); all arithmetic is exact.  K5 (the BN254
MSM) sums in another order than its plain double-and-add, so its Jacobian
result is held equal to the plain one as a group element
(`bn254_msm.same_point`), and its affine result equal to the host sum.
Every test
skips, saying so, when torch.cuda.is_available() is False; a kernel that
fails to build on a CUDA host fails its test.  This file imports neither
JAX nor the JAX package, so on a machine without JAX it runs as
`python -m pytest --noconftest tests/test_torch_cuda.py -q`.
"""

import re

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


@pytest.mark.parametrize("log_n", [0, 1, 2, 5, 10, 11, 12, 14, 20, 23])
def test_ntt_kernel_equals_plain(dev, log_n):
    # one pass up to 2^11 (G = 1), two (G = 32, 16, 8 by size), three
    # from 2^23; ragged inputs (m < n_out, odd row counts, scalar post)
    rows = 3 if log_n < 20 else 1
    x = _field(log_n, (rows, 1 << log_n), dev)
    pre = _field(100 + log_n, (1 << log_n,), dev)
    post = _field(200 + log_n, (2 << log_n,), dev)
    one = _field(300 + log_n, (1,), dev)
    for kw in (dict(), dict(inverse=True), dict(n_out=2 << log_n, pre=pre),
               dict(inverse=True, n_out=2 << log_n, post=post),
               dict(n_out=8 << log_n), dict(inverse=True, post=one)):
        got = ntt.scaled_ntt(x, **kw)
        assert torch.equal(got, ntt.scaled_ntt_plain(x, **kw)), kw


@pytest.mark.parametrize("m,n_out", [(3, 8), (5, 64), (100, 4096),
                                     (3000, 1 << 15)])
def test_ntt_kernel_ragged_zero_pad(dev, m, n_out):
    x = _field(m, (2, 7, m), dev)[:, 1:6]          # strided rows
    pre = _field(m + 1, (m,), dev)
    got = ntt.scaled_ntt(x, n_out=n_out, pre=pre)
    assert torch.equal(got, ntt.scaled_ntt_plain(x, n_out=n_out, pre=pre))


@pytest.mark.parametrize("log_m", [0, 1, 3, 10, 11, 12, 17, 21])
def test_commit_levels_on_the_card_equal_plain(dev, log_m):
    from ethrex_tpu_torch.ops import merkle

    cols = _field(log_m, (5, 1 << log_m), dev)
    got = merkle.commit_levels(cols.T)
    want = [p2.hash_leaves_plain(cols.T)]
    while want[-1].shape[0] > 1:
        want.append(p2.compress_level_plain(want[-1]))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if log_m == 21:
        kernels.reset_launches()
        merkle.commit_levels(cols.T)
        assert kernels.LAUNCHES["poseidon2_merkle_subtree"] <= 3


@pytest.mark.parametrize("m", [2, 6, 128, 1000, 4096])
def test_compress_level_kernel_equals_plain(dev, m):
    level = _field(m, (m, 8), dev)
    assert torch.equal(p2.compress_level(level),
                       p2.compress_level_plain(level))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 4097])
def test_ext_inverse_kernels_equal_plain(dev, n):
    a = _field(n, (n, 4), dev)
    a[:: max(1, n // 5)] = 0               # zeros map to zero in both
    assert torch.equal(ext.ext_inv_device(a), ext.ext_inv_device_plain(a))
    got = ext.batch_inv(a)
    assert torch.equal(got, ext.batch_inv_plain(a))
    nz = a.abs().sum(dim=1) != 0
    one = torch.zeros(4, dtype=torch.int32, device=dev)
    one[0] = bb.MONT_ONE
    assert torch.equal(ext.mul(got[nz], a[nz]), one.expand(int(nz.sum()), 4))


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 7), (64, 1 << 12),
                                    (2, 100003)])
def test_eval_poly_at_kernel_equals_plain(dev, rows, n):
    c = _field(rows + n, (rows, n), dev)
    pt = int(bb.to_mont_host(np.array([987654321]))[0])
    assert torch.equal(ntt.eval_poly_at(c, pt), ntt.eval_poly_at_plain(c, pt))


def test_eval_poly_at_counts_only_its_launches(dev):
    kernels.reset_launches()
    assert ntt.eval_poly_at(_field(0, (0, 16), dev), 5).shape == (0,)
    assert kernels.LAUNCHES["eval_poly_at"] == 0
    ntt.eval_poly_at(_field(1, (1, 16), dev), 5)
    assert kernels.LAUNCHES["eval_poly_at"] == 1


@pytest.mark.parametrize("n,w", [(1, 1), (31, 33), (64, 1), (1000, 278)])
def test_to_mont_cols_kernel_equals_plain(dev, n, w):
    a = _field(n * w, (n, w), dev)
    assert torch.equal(bb.to_mont_cols(a), bb.to_mont_cols_plain(a))


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


@pytest.mark.parametrize("n,k", [(1, 1), (33, 9), (5000, 278), (300, 257),
                                 (115, 9000), (354, 4097), (7, 70000)])
def test_mod_matmul_m8_kernel_equals_plain(dev, n, k):
    """m = 4 and m = 8 (the deep and open phases' pairs), both modes, the
    operand read in place column-major (the LDE rows) and row-major (the
    coefficients: split-k above 4,096); worst-case rows and columns."""
    a = _field(n * k, (k, n), dev).T        # column-major view
    a[0] = bb.P - 1
    for m in (4, 8):
        b = _field(k + m, (k, m), dev)
        b[:, -1] = bb.P - 1
        for mont in (True, False):
            want = bb.mod_matmul_plain(a, b, mont)
            assert torch.equal(bb.mod_matmul(a, b, mont), want)
            assert torch.equal(bb.mod_matmul(a.contiguous(), b, mont), want)


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


def _cu_int(src: str, name: str) -> int:
    """A `constexpr int` of a kernel source."""
    text = (kernels.CSRC / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# K7's block: THREADS x CHUNK elements
_K7_THREADS = _cu_int("batch_inv.cu", "THREADS")
_K7_CHUNK = _cu_int("batch_inv.cu", "CHUNK")
_K7_BLOCK = _K7_THREADS * _K7_CHUNK


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, _K7_BLOCK - 1,
                               _K7_BLOCK, _K7_BLOCK + 1, 100003,
                               3 * _K7_BLOCK + 17])
def test_batch_inv_kernel_equals_plain(dev, n):
    a = _field(n, (n,), dev)
    a[:: max(1, n // 7)] = 0            # zeros map to zero in both
    got = bb.batch_mont_inv(a)
    assert torch.equal(got, bb.batch_mont_inv_plain(a))
    nz = a != 0
    assert torch.all(bb.mont_mul(got[nz], a[nz]) == bb.MONT_ONE)


def test_batch_inv_kernel_zero_chunks_warps_and_blocks(dev):
    """Zeros at a thread's chunk, a warp and a whole block, and at the
    edges between them, next to nonzero elements."""
    n = 4 * _K7_BLOCK + 5
    a = _field(77, (n,), dev)
    a[_K7_BLOCK:2 * _K7_BLOCK] = 0                 # a whole block
    for c in range(_K7_CHUNK):
        w0 = 2 * _K7_BLOCK + _K7_THREADS * c
        a[w0:w0 + 32] = 0                          # warp 0
        a[3 * _K7_BLOCK + 3 + _K7_THREADS * c] = 0  # thread 3's chunk
    a[_K7_BLOCK - 1] = a[4 * _K7_BLOCK] = a[-1] = 0
    got = bb.batch_mont_inv(a)
    assert torch.equal(got, bb.batch_mont_inv_plain(a))
    assert torch.equal(bb.batch_mont_inv(torch.zeros_like(a)),
                       torch.zeros_like(a))


@pytest.mark.parametrize("N,nd", [(1, 1), (100, 3), (_K7_BLOCK + 1, 11),
                                  (1 << 15, 25)])
def test_divisor_stack_inv_kernel_equals_plain(dev, N, nd):
    pts = _field(N, (N,), dev)
    rng = np.random.default_rng(N)
    consts = [int(v) for v in rng.integers(0, bb.P, nd)]
    # a constant on a domain point: that difference is 0 and maps to 0
    consts[-1] = int(bb.from_mont_host(bb.to_numpy(pts[N // 2:N // 2 + 1]))
                     [0])
    head = [int(v) for v in rng.integers(1, bb.P, 8)]
    kernels.reset_launches()
    got = bb.divisor_stack_inv(pts, head, consts)
    assert kernels.LAUNCHES["divisor_inv"] == 1
    assert kernels.LAUNCHES["batch_inv"] == 1
    assert torch.equal(got, bb.divisor_stack_inv_plain(pts, head, consts))
    assert int(got[8 + (nd - 1) * N + N // 2]) == 0


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


@pytest.mark.parametrize("air", [
    sua.StateUpdateAir(2, seg_periods=8), pair.Poseidon2SpongeAir(3),
    fva.FriVerifyAir(7, 16), ta.TransferAir(), tka.TokenAir(),
    bca.BytecodeAir()], ids=lambda a: type(a).__name__)
def test_air_combine_kernel_equals_plain(dev, air):
    """K6 with the alpha combination fused in, against `combine_plain`
    and against K3 over the evaluate form's block."""
    N, B = 1 << 12, 8
    K = air.num_constraints
    lde = _field(air.width + 7, (air.width, N), dev)
    per = _field(air.num_periodic + 8, (air.num_periodic, N), dev)
    lde[:, ::9] = bb.P - 1
    apow = _field(K, (K + 2, 4), dev)
    apow[::5] = bb.P - 1
    kernels.reset_launches()
    got = air_codegen.combine(air, lde, per, B, apow)
    assert kernels.LAUNCHES["air_combine"] == len(air_codegen.groups(
        air_codegen.record(air)))
    assert kernels.LAUNCHES["air_constraints"] == 0
    assert got.shape == (N, 4)
    assert torch.equal(got, air_codegen.combine_plain(air, lde, per, B,
                                                      apow))
    assert torch.equal(got, bb.mod_matmul(
        air_codegen.evaluate(air, lde, per, B).T, apow[:K]))
    # apow may come from the host, as the prover passes it
    assert torch.equal(air_codegen.combine(air, lde, per, B, apow.cpu()),
                       got)


def test_deep_compose_reads_paired_halves(dev):
    """K8 reads the two openings' sums as the halves of one (N, 8) K3
    result in place; the same as from contiguous copies."""
    N, w = 1 << 12, 7
    pts = _field(1, (N,), dev)
    s12 = _field(2, (N, 8), dev)
    opens = [(_ext_point(10 + o), s12[:, 4 * o:4 * o + 4],
              _field(30 + o, (w, 4), dev), _field(40 + o, (w, 4), dev))
             for o in range(2)]
    q = dict(q_lde=_field(5, (8, 4, N), dev), q_z=_field(6, (8, 4), dev),
             gq=_field(7, (8, 4), dev))
    got = ext.deep_compose(pts, opens, **q)
    flat = [(z, S.contiguous(), t, g) for z, S, t, g in opens]
    assert torch.equal(got, ext.deep_compose(pts, flat, **q))
    assert torch.equal(got, ext.deep_compose_plain(pts, opens, **q))


def _g1_points(rng, n):
    return [bn254.g1_mul(bn254.G1, int(rng.integers(1, 1 << 40)))
            for _ in range(n)]


def _scalars(rng, n, nbytes=40):
    return [int.from_bytes(rng.bytes(nbytes), "big") % bn254.R
            for _ in range(n)]


def _words(sc, dev):
    return torch.from_numpy(msm_ops.scalars_to_words(sc).view(np.int32)).to(
        dev)


@pytest.mark.parametrize("n", [1, 2, 37, 2897])
def test_msm_g1_kernel_equals_plain(dev, n):
    # the kernel sums in another order than the plain double-and-add, so
    # the two Jacobian results are held equal as group elements
    rng = np.random.default_rng(n)
    pts = _g1_points(rng, n)
    sc = _scalars(rng, n)
    X, Y, Z = msm_ops.points_to_device(pts, dev)
    words = _words(sc, dev)
    got = msm_ops.msm_device(X, Y, Z, words)
    want = msm_ops.msm_device_plain(X, Y, Z, words)
    assert msm_ops.same_point(got, want)
    host = None
    for pt, s in zip(pts, sc):
        host = bn254.g1_add(host, bn254.g1_mul(pt, s))
    assert msm_ops.msm(pts, sc, device=dev) == host


def _edge_cases():
    g = bn254.G1
    neg_g = (g[0], bn254.P - g[1])
    r = bn254.R
    top = (1 << 253) | (0xFF << 240)       # window 30 carries into 31
    many = [bn254.g1_mul(g, k) for k in range(1, 11)]
    return {
        "zeros": ([g, bn254.g1_mul(g, 7)], [0, 0]),
        "r_minus_1": ([g, bn254.g1_mul(g, 3)], [r - 1, r - 1]),
        "top_carry": ([g, g, many[2]], [top, r - 2, top - 1]),
        "duplicates": ([g] * 5 + [many[4]] * 4, [3, 3, 3, 5, 3, 3, 3, 3, 7]),
        "p_and_minus_p": ([g, many[1], neg_g], [5, 9, 5]),
        "cancel": ([g, g], [5, r - 5]),
        "none": ([None, g, None], [3, 2, 9]),
        "all_none": ([None, None], [3, 2]),
        "n_above_2c": ([many[k % 10] for k in range(300)],
                       [(k * 7919) % 256 for k in range(300)]),
    }


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_msm_edge_cases_on_the_card(dev, case):
    pts, sc = _edge_cases()[case]
    X, Y, Z = msm_ops.points_to_device(pts, dev)
    words = _words(sc, dev)
    assert msm_ops.same_point(msm_ops.msm_device(X, Y, Z, words),
                              msm_ops.msm_device_plain(X, Y, Z, words))
    host = None
    for pt, s in zip(pts, sc):
        if pt is not None:
            host = bn254.g1_add(host, bn254.g1_mul(pt, s % bn254.R))
    assert msm_ops.msm(pts, sc, device=dev) == host


def test_msm_g2_kernel_equals_plain(dev):
    rng = np.random.default_rng(2)
    pts = [bn254.g2_mul(bn254.G2, int(rng.integers(1, 1 << 20)))
           for _ in range(5)] + [None]
    sc = _scalars(rng, 6)
    X, Y, Z = msm_ops.g2_points_to_device(pts, dev)
    words = _words(sc, dev)
    got = msm_ops.msm_device(X, Y, Z, words, fp2=True)
    want = msm_ops.msm_device_plain(X, Y, Z, words, fp2=True)
    assert msm_ops.same_point(got, want, fp2=True)
    host = None
    for pt, s in zip(pts, sc):
        host = bn254.g2_add(host, bn254.g2_mul(pt, s) if pt else None)
    got_aff = msm_ops.g2_msm(pts, sc, device=dev)
    assert got_aff[0] == host[0] and got_aff[1] == host[1]
    # P and -P in one bucket cancel on G2 too
    q = pts[0]
    assert msm_ops.g2_msm([q, (q[0], -q[1])], [3, 3], device=dev) is None


@pytest.mark.parametrize("n,fp2", [(1, False), (37, False), (300, False),
                                   (6, True)])
def test_msm_bases_kernel_equals_plain(dev, n, fp2):
    # the table of bases is affine, so kernel and plain are bit-equal
    rng = np.random.default_rng(40 + n)
    if fp2:
        pts = [bn254.g2_mul(bn254.G2, int(rng.integers(1, 1 << 20)))
               for _ in range(n - 1)] + [None]
        X, Y, Z = msm_ops.g2_points_to_device(pts, dev)
    else:
        pts = _g1_points(rng, n)
        pts[n // 2] = None
        X, Y, Z = msm_ops.points_to_device(pts, dev)
    assert torch.equal(msm_ops.msm_bases(X, Y, Z, fp2),
                       msm_ops.msm_bases_plain(X, Y, Z, fp2))


def test_msm_over_a_kept_table_builds_it_once(dev):
    rng = np.random.default_rng(41)
    pts = _g1_points(rng, 50)
    sc1, sc2 = _scalars(rng, 50), _scalars(rng, 50)
    kernels.reset_launches()
    bases = msm_ops.point_bases(pts, False, dev)
    first = msm_ops.msm(pts, sc1, device=dev, bases=bases)
    second = msm_ops.msm(pts, sc2, device=dev, bases=bases)
    assert first != second
    assert kernels.LAUNCHES["bn254_msm_bases"] == 1
    assert kernels.LAUNCHES["bn254_msm_g1"] == 2
    # without a table each call builds its own
    assert msm_ops.msm(pts, sc1, device=dev) == first
    assert kernels.LAUNCHES["bn254_msm_bases"] == 2


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


@pytest.mark.parametrize("n", [5, 4096, 70000])
def test_powers_table_kernel_fills_column_blocks(dev, n):
    # two points' tables in the column blocks of one (n, 8) table, as the
    # open phase's two-point evaluation lays them out
    z1, z2 = _ext_point(n), _ext_point(n + 1)
    pows = torch.zeros((n, 8), dtype=torch.int32, device=dev)
    ext.powers_table(z1, n, out=pows[:, :4])
    ext.powers_table(z2, n, out=pows[:, 4:])
    assert torch.equal(pows[:, :4], ext.ext_powers_blocked(z1, n, device=dev))
    assert torch.equal(pows[:, 4:], ext.ext_powers_blocked(z2, n, device=dev))


@pytest.mark.parametrize("rows,n", [(1, 3), (8, 1000), (4, 1 << 15)])
def test_ext_poly_eval_kernel_equals_plain(dev, rows, n):
    # the prover's chunks: a (rows, n, 4) view of a (rows, 4, n) block
    c = _field(rows + n, (rows, 4, n), dev).permute(0, 2, 1)
    z = _ext_point(rows)
    got = ext.eval_ext_poly_at_ext(c, z)
    assert torch.equal(got, ext.eval_ext_poly_at_ext_plain(c, z))
    assert torch.equal(ext.eval_ext_poly_at_ext(c.contiguous(), z), got)


@pytest.mark.parametrize("n,B", [(1, 8), (7, 8), (1023, 8), (70001, 8),
                                 (4099, 16), (3, 9), (5000, 0)])
def test_open_powers_kernel_equals_plain(dev, n, B):
    # the open phase's call: both points' tables and the chunks, a (B, n,
    # 4) view of (B, 4, n) coefficients, at the first point; odd n, more
    # chunks than a thread keeps (9, 16), and no chunks
    z = (_ext_point(n), _ext_point(n + 7))
    chunks = _field(n + B, (B, 4, n), dev).permute(0, 2, 1) if B else None
    table, sums = ext.open_powers(z, n, chunks)
    want_t, want_s = ext.open_powers_plain(z, n, chunks)
    assert torch.equal(table, want_t)
    if B:
        assert torch.equal(sums, want_s)
        assert torch.equal(ext.open_powers(z, n, chunks.contiguous())[1],
                           want_s)
    else:
        assert sums is None


def test_open_powers_into_a_column_block(dev):
    # written into columns 4-11 of a wider table (rows 48 bytes apart),
    # the columns around them untouched
    n = 4097
    z = (_ext_point(1), _ext_point(2))
    chunks = _field(3, (8, 4, n), dev).permute(0, 2, 1)
    wide = torch.zeros((n, 12), dtype=torch.int32, device=dev)
    _, sums = ext.open_powers(z, n, chunks, out=wide[:, 4:])
    want_t, want_s = ext.open_powers_plain(z, n, chunks)
    assert torch.equal(wide[:, 4:], want_t) and torch.equal(sums, want_s)
    assert not wide[:, :4].any()
    with pytest.raises(ValueError):
        ext.open_powers(z, n, chunks, out=wide[:, 2:10])


def test_phase_open_kernel_equals_cpu(dev):
    # the prover's open phase on the card against the same on the CPU
    n, w, B = 1 << 10, 5, 8
    cols = _field(4, (w, n), dev)
    chunks = _field(5, (B, 4, n), dev).permute(0, 2, 1)
    z = _ext_point(6)
    zg = ext.h_mul(z, ext.h_from_base(bb.root_of_unity(10)))
    kernels.reset_launches()
    got = prover.phase_open(cols, chunks, z, zg)
    assert kernels.LAUNCHES["ext_poly_eval"] == 1
    want = prover.phase_open(cols.cpu(), chunks.cpu(), z, zg)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


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


# K8's block of points: THREADS x PTS
_K8_BLOCK = (_cu_int("deep_compose.cu", "THREADS")
             * _cu_int("deep_compose.cu", "PTS"))


@pytest.mark.parametrize("two,nq,N", [
    (True, 8, 1 << 12), (True, 0, 1 << 12), (False, 0, 1 << 12),
    (True, 8, 1), (True, 8, _K8_BLOCK + 1), (True, 4, 3 * _K8_BLOCK - 5),
    (False, 0, _K8_BLOCK + 9), (True, 16, 4099)])
def test_deep_compose_kernel_equals_plain(dev, two, nq, N):
    w = 7
    pts = _field(1, (N,), dev)
    opens = [(_ext_point(10 + o), _field(20 + o, (N, 4), dev),
              _field(30 + o, (w, 4), dev), _field(40 + o, (w, 4), dev))
             for o in range(2 if two else 1)]
    q = dict(q_lde=_field(5, (nq, 4, N), dev), q_z=_field(6, (nq, 4), dev),
             gq=_field(7, (nq, 4), dev)) if nq else {}
    got = ext.deep_compose(pts, opens, **q)
    assert torch.equal(got, ext.deep_compose_plain(pts, opens, **q))


@pytest.mark.parametrize("two", [True, False])
def test_deep_compose_zero_norm(dev, two):
    """zeta in the base field on a domain point: its norm is 0 there, so
    1/(x - zeta) maps to 0 at that point alone and its neighbours in the
    same inversion are unharmed."""
    N, w = _K8_BLOCK + 3, 5
    pts = _field(2, (N,), dev)
    z = int(bb.from_mont_host(bb.to_numpy(pts[9:10]))[0])
    opens = [((z, 0, 0, 0), _field(21, (N, 4), dev), _field(31, (w, 4), dev),
              _field(41, (w, 4), dev))]
    if two:
        opens.append((_ext_point(12), _field(22, (N, 4), dev),
                      _field(32, (w, 4), dev), _field(42, (w, 4), dev)))
    q = dict(q_lde=_field(5, (8, 4, N), dev), q_z=_field(6, (8, 4), dev),
             gq=_field(7, (8, 4), dev))
    got = ext.deep_compose(pts, opens, **q)
    assert torch.equal(got, ext.deep_compose_plain(pts, opens, **q))
    if not two:
        assert not got[9].any() and got[8].any() and got[10].any()


def test_deep_compose_fused_step_shape(dev):
    """The fused step's one-opening form at the smoke's log_n 15 (width 64,
    blowup 4: 2^17 points), no quotient chunks."""
    N, w = 1 << 17, 64
    pts = _field(3, (N,), dev)
    opens = [(_ext_point(13), _field(23, (N, 4), dev),
              _field(33, (w, 4), dev), _field(43, (w, 4), dev))]
    got = ext.deep_compose(pts, opens)
    assert torch.equal(got, ext.deep_compose_plain(pts, opens))


@pytest.mark.parametrize("sizes", [(1,), (4, 1, 2), (64, 32, 1, 16, 8, 1),
                                   (1 << 12, 1 << 11, 2, 1)])
def test_batched_roots_kernel_equals_plain(dev, sizes):
    from ethrex_tpu_torch.ops import merkle

    d = _field(len(sizes), (sum(sizes), 8), dev)
    got = merkle.batched_roots(d, sizes)
    want = merkle.batched_roots_plain(d, sizes)
    assert len(got) == len(sizes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sizes", [
    (1, 1, 1), (2, 1) * 30 + (256,), (1 << 11,) * 3 + (4,),
    (1, 2, 4, 8, 16, 32, 64, 128) * 7,
    tuple(1 << (13 - k) for k in range(9))])
def test_batched_roots_forest_equals_plain(dev, sizes):
    # trees of size 1, runs of equal sizes (one segment), more segments
    # than one launch holds, and the fused step's chain of sizes; each in
    # ceil(max log2 size / 10) rounds
    from ethrex_tpu_torch.ops import merkle

    d = _field(sum(sizes), (sum(sizes), 8), dev)
    kernels.reset_launches()
    got = merkle.batched_roots(d, sizes)
    want = merkle.batched_roots_plain(d, sizes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plan = merkle.forest_plan(tuple(sizes))
    rounds = -(-(max(sizes).bit_length() - 1) // merkle.FOREST_LEVELS)
    assert len(plan) == rounds
    assert kernels.LAUNCHES["merkle_batched_level"] == \
        sum(len(launches) for launches, _ in plan)


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
    for name in ("ntt", "poseidon2_hash_leaves", "poseidon2_merkle_subtree",
                 "mod_matmul", "fri_fold", "deep_compose",
                 "merkle_batched_level", "ext_poly_eval"):
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
    for name in ("air_combine", "quotient_combine", "deep_compose",
                 "ext_poly_eval", "to_mont_cols", "poseidon2_merkle_subtree",
                 "mod_matmul"):
        assert kernels.LAUNCHES[name] > 0, name
    assert kernels.LAUNCHES["air_constraints"] == 0
    on_cpu, _, _ = gpu_backend.prove_vm_stages(*args, device="cpu",
                                              params=params)
    assert on_card == on_cpu


def test_gpu_backend_on_the_card_equals_cpu():
    """`GpuBackend()` (the card by default) proves the committed mixed
    batch (one block of two ETH transfers and two token calls) from its
    ProgramInput, through its kernels, equal to the same proof made with
    the plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA is absent (torch.cuda.is_available() is False): "
                    "GpuBackend proves on the card only")
    import json

    from ethrex_tpu_torch import fixtures
    from ethrex_tpu_torch.prover.gpu_backend import GpuBackend

    kernels.lib()
    kernels.reset_launches()
    on_card = GpuBackend().prove(fixtures.load_program_input("mixed"),
                                 "stark")
    for name in ("ntt", "air_combine", "deep_compose", "ext_poly_eval",
                 "to_mont_cols", "poseidon2_merkle_subtree", "fri_fold"):
        assert kernels.LAUNCHES[name] > 0, name
    on_cpu = GpuBackend(device="cpu").prove(
        fixtures.load_program_input("mixed"), "stark")
    assert on_card["vm"]["mode"] == "token"
    assert json.dumps(on_card, sort_keys=True) == json.dumps(
        on_cpu, sort_keys=True)
