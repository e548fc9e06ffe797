"""The index math of kernels K1 (NTT) and K2 (Merkle subtrees), the
lazy 64-bit sums of K3 (modular matmul) and K6 (the AIR constraints'
alpha combination), the batched inversions of K7 (with its divisor
entry) and K8 (the DEEP codeword, with its lazy sums), K11's power
chains and chunk sums, K10's forest plan, and the test-only
`ext_batch_inv` (K7's block scan in the extension) and `eval_poly_at`
(split rows, powers made on the card), rehearsed on the CPU.

The CUDA kernels take their pass plans from the Python wrappers
(`ntt.ntt_plan`, `ntt.radix_rounds`, the twiddle tables, and
`merkle.subtree_plan` with `merkle.level_offsets`).  The numpy models
below index exactly as the kernels do: pass 1's grouped bit-reversed
loads, the pre-twiddle of later passes, the register rounds of the
in-tile DIT, the post-scale at the last store; the subtree levels in
shared memory and their offsets in the one level buffer.  Each model runs
its plan and is held against the JAX package: `ethrex_tpu.ops.ntt`
(`ntt`, `coset_lde`, `coset_intt`, `coset_evals_from_coeffs`) and
`ethrex_tpu.ops.merkle.commit_levels`.

Bar: bit-equality; all arithmetic is exact.  Shapes stay small (log n <=
12, trees of at most 2^12 leaves).
"""

import re

import numpy as np
import pytest
import torch

from ethrex_tpu.ops import babybear as jbb
from ethrex_tpu.ops import merkle as jmerkle
from ethrex_tpu.ops import ntt as jntt
from ethrex_tpu_torch import kernels
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import merkle
from ethrex_tpu_torch.ops import ntt
from ethrex_tpu_torch.ops import poseidon2 as p2
from ethrex_tpu_torch.stark import air_codegen as cg

P = np.uint64(bb.P)


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


def _canon(t) -> np.ndarray:
    """A Montgomery tensor of the port -> canonical uint64 numpy."""
    return bb.from_mont_host(bb.to_numpy(t)).astype(np.uint64)


def _rev(v, bits: int):
    v = np.asarray(v, dtype=np.int64)
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


# ---------------------------------------------------------------------------
# K1: the NTT passes
# ---------------------------------------------------------------------------

def _local_dit(tile, L: int, tw, start: int = 0):
    """In-tile bit-reversed-input DIT over axis -2 of tile (..., 2^L, G),
    one register round at a time from stage `start`, as `k_ntt_pass`
    does: unit q of round (sa, R) holds positions base(q) + (r << sa),
    r < 2^R."""
    for sa, R in ntt.radix_rounds(L, start):
        q = np.arange(1 << (L - R))
        base = (q & ((1 << sa) - 1)) | ((q >> sa) << (sa + R))
        pos = base[:, None] + (np.arange(1 << R)[None, :] << sa)
        v = tile[..., pos, :]                       # (..., units, 2^R, G)
        for t in range(R):
            s = sa + t
            for r in range(1 << R):
                if r >> t & 1:
                    continue
                r2 = r + (1 << t)
                e = (pos[:, r] & ((1 << s) - 1)) << (L - 1 - s)
                w = tw[e][:, None]
                u = v[..., :, r, :].copy()
                x = v[..., :, r2, :] * w % P
                v[..., :, r, :] = (u + x) % P
                v[..., :, r2, :] = (u + P - x) % P
        tile[..., pos, :] = v
    return tile


def model_scaled_ntt(x, inverse=False, n_out=None, pre=None, post=None):
    """K1 as the kernel computes it, on canonical uint64 rows x (rows, m);
    pre/post canonical or None.  Returns (rows, n_out)."""
    rows, m = x.shape
    n = m if n_out is None else n_out
    log_n = n.bit_length() - 1
    out = np.zeros((rows, n), dtype=np.uint64)
    plan = ntt.ntt_plan(log_n)
    for i, (S, L, G) in enumerate(plan):
        first, last = i == 0, i == len(plan) - 1
        tw = _canon(ntt._local_twiddles(L, inverse, "cpu"))
        T = 1 << L
        if first:
            nblk = (1 << (log_n - L)) // G
            spread = ntt.spread_first_pass(m, log_n, L)
            c = 8 if spread else 1
            o = (np.arange(nblk) * G)[:, None, None]
            ls = np.arange(0, T, c)                      # loaded positions
            j = (_rev(ls, L) << (log_n - L))[None, :, None] + o \
                + np.arange(G)[None, None, :]           # (nblk, T / c, G)
            ok = j < m
            jj = np.where(ok, j, 0)
            loaded = np.where(ok[None], x[:, jj], 0).astype(np.uint64)
            if pre is not None:
                loaded = loaded * np.where(ok, pre[jj], 0)[None] % P
            tile = np.repeat(loaded, c, axis=-2)        # copy to neighbours
            tile = _local_dit(tile, L, tw, 3 if spread else 0)
            tiles = _rev(np.arange(nblk)[:, None] * G + np.arange(G)[None],
                         log_n - L)                      # (nblk, G)
            dst = (tiles[:, None, :] << L) + np.arange(T)[None, :, None]
        else:
            lo, hi = (_canon(t) for t in ntt._pretwiddle_tables(
                S + L, inverse, "cpu")[:2])
            h = ntt.pretwiddle_split(S + L)
            ncg = (1 << S) // G
            nB = 1 << (log_n - S - L)
            blk = np.arange(nB * ncg)
            hiB, cg = blk // ncg, blk % ncg
            col = (cg * G)[:, None, None] + np.arange(G)[None, None, :]
            dst = (hiB << (S + L))[:, None, None] \
                + (np.arange(T) << S)[None, :, None] + col
            e = (_rev(np.arange(T), L)[None, :, None] * col) \
                % (1 << (S + L))
            w = lo[e & ((1 << h) - 1)] * hi[e >> h] % P
            tile = out[:, dst] * w[None] % P
            tile = _local_dit(tile, L, tw)
        if last and post is not None:
            f = post[0] if len(post) == 1 else post[dst]
            tile = tile * f % P
        out[:, dst] = tile
    return out


def _to_jax(x_c):
    return jbb.to_mont_host(x_c.astype(np.uint32))


def _from_jax(y):
    return jbb.from_mont_host(np.asarray(y)).astype(np.uint64)


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("log_n", list(range(1, 13)))
def test_ntt_plan_model_equals_jax_ntt(log_n, rows):
    x = _field(log_n * 10 + rows, (rows, 1 << log_n)).astype(np.uint64)
    for inverse in (False, True):
        n_inv = bb.inv_host(1 << log_n) if inverse else None
        got = model_scaled_ntt(x, inverse=inverse, post=None if n_inv is None
                               else np.array([n_inv], dtype=np.uint64))
        want = _from_jax(jntt.ntt(_to_jax(x), inverse=inverse))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("log_n", [1, 2, 4, 7, 9, 11, 12])
def test_ntt_plan_model_equals_jax_lde_and_cosets(log_n, rows):
    n = 1 << log_n
    shift = bb.GENERATOR
    x = _field(100 + log_n + rows, (rows, n)).astype(np.uint64)
    # coset LDE at n_out = 8n, as the port composes it: iNTT, then the
    # forward transform with pre = shift^j / n and the implicit zero pad
    coeffs = model_scaled_ntt(x, inverse=True)
    pre = (bb.powers_host(shift, n).astype(np.uint64)
           * np.uint64(bb.inv_host(n))) % P
    got = model_scaled_ntt(coeffs, n_out=8 * n, pre=pre)
    want = _from_jax(jntt.coset_lde(_to_jax(x), 3, shift=shift))
    np.testing.assert_array_equal(got, want)
    # coset iNTT: post = shift^-k / n over n_out = n
    post = (bb.powers_host(bb.inv_host(shift), n).astype(np.uint64)
            * np.uint64(bb.inv_host(n))) % P
    got = model_scaled_ntt(x, inverse=True, post=post)
    want = _from_jax(jntt.coset_intt(_to_jax(x), shift=shift))
    np.testing.assert_array_equal(got, want)
    # evaluations from coefficients on a coset 8x as large, and n_out = n
    for n_out in (n, 8 * n):
        pre = bb.powers_host(shift, n_out)[:n].astype(np.uint64)
        got = model_scaled_ntt(x, n_out=n_out, pre=pre)
        want = _from_jax(jntt.coset_evals_from_coeffs(_to_jax(x), n_out,
                                                      shift=shift))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", list(range(0, 34)))
def test_ntt_plan_covers_every_stage_within_the_tile_budget(log_n):
    plan = ntt.ntt_plan(log_n)
    S = 0
    for i, (s0, L, G) in enumerate(plan):
        assert s0 == S and 0 <= L <= ntt.NTT_MAX_L
        assert G * (1 << L) <= ntt.NTT_TILE_ELEMS and 1 <= G <= ntt.NTT_MAX_G
        # a block's G columns (tiles in pass 1) exist and tile the rows
        assert G <= (1 << (log_n - L) if i == 0 else 1 << S)
        assert sum(R for _, R in ntt.radix_rounds(L)) == L
        S += L
    assert S == log_n
    assert len(plan) == max(1, -(-log_n // ntt.NTT_MAX_L))


# ---------------------------------------------------------------------------
# K2: the Merkle subtree launches
# ---------------------------------------------------------------------------

def model_commit_levels(digests):
    """K2's levels as `commit_levels` fills its one buffer.  Each subtree
    launch (l0, k, S, c) of the plan reads level l0; subtree st of block b
    (tree b S + st) holds its 2^k digests in shared slots, and node i of
    level j is the compression of slots (2i) 2^(j-1) and (2i+1) 2^(j-1),
    stored in slot i 2^j and in output row tree 2^(k-j) + i of level j
    (level j + 1 right after level j).  Levels 1..c+1 are computed by
    thread t of the subtree for its nodes t 2^(c+1-j) + q, whose slots
    must lie in its own 2^(c+1) (no barrier); later levels by one thread
    per node, numbered densely over the block's subtrees."""
    m = digests.shape[0]
    offs = merkle.level_offsets(m)
    buf = torch.zeros((2 * m - 1, 8), dtype=bb.I32)
    buf[:m] = digests
    for l0, k, S, c in merkle.subtree_plan(m):
        m_in = m >> l0
        blocks = m_in // (S << k)
        assert blocks * (S << k) == m_in and 0 <= c < k
        lgT = k - c - 1
        sh = buf[offs[l0]:offs[l0] + m_in].reshape(blocks, S, 1 << k, 8)
        sh = sh.clone()
        level_off, level_rows = 0, m_in >> 1
        for j in range(1, k + 1):
            cnt_log = k - j
            if j <= c + 1:
                per = 1 << (c + 1 - j)
                t = np.repeat(np.arange(1 << lgT), per)
                i = t * per + np.tile(np.arange(per), 1 << lgT)
                own = t << (c + 1)            # the thread's first slot
                for slot in ((2 * i) << (j - 1), (2 * i + 1) << (j - 1),
                             i << j):
                    assert np.all((slot >= own)
                                  & (slot < own + (1 << (c + 1))))
                st_i = [(st, i) for st in range(S)]
            else:
                q = np.arange(S << cnt_log)   # thread q of the block
                st_i = [(st, q[q >> cnt_log == st] & ((1 << cnt_log) - 1))
                        for st in range(S)]
            for st, i in st_i:
                i = torch.from_numpy(np.asarray(i, dtype=np.int64))
                left = sh[:, st, (2 * i) << (j - 1)]
                right = sh[:, st, (2 * i + 1) << (j - 1)]
                res = p2.compress(left, right)            # (blocks, n, 8)
                sh[:, st, i << j] = res
                tree = torch.arange(blocks)[:, None] * S + st
                rows = offs[l0 + 1] + level_off + (tree << cnt_log) + i
                buf[rows.reshape(-1)] = res.reshape(-1, 8)
            level_off += level_rows
            level_rows >>= 1
    return [buf[o:o + (m >> lv)] for lv, o in enumerate(offs)]


@pytest.mark.parametrize("serial_min", [p2.SUBTREE_SERIAL_MIN, 1])
@pytest.mark.parametrize("log_m", list(range(1, 13)))
def test_subtree_plan_model_equals_jax_commit_levels(log_m, serial_min,
                                                     monkeypatch):
    # serial_min = 1 puts every launch of k > 2 levels on the serial path
    # (c = 2) that the card takes from 2^20 digests on
    monkeypatch.setattr(p2, "SUBTREE_SERIAL_MIN", serial_min)
    m = 1 << log_m
    leaves = _field(log_m, (m, 11))
    want = jmerkle.commit_levels(jbb.to_mont_host(leaves))
    digests = p2.hash_leaves(bb.from_numpy(bb.to_mont_host(leaves), "cpu"))
    got = model_commit_levels(digests)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bb.to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("log_m", list(range(0, 31)))
def test_subtree_plan_covers_every_level(log_m):
    m = 1 << log_m
    plan = merkle.subtree_plan(m)
    level = 0
    for l0, k, S, c in plan:
        assert l0 == level and 1 <= k <= p2.SUBTREE_MAX_LEVELS
        assert ((m >> l0) >> k) % S == 0 and 0 <= c < k
        assert c == (p2.SUBTREE_SERIAL if (m >> l0) >= p2.SUBTREE_SERIAL_MIN
                     and k > p2.SUBTREE_SERIAL else 0)
        assert (S << (k - c - 1)) <= 1024      # threads of a block
        assert (S << k) * 32 <= 227 * 1024     # shared memory of a block
        level += k
    assert level == log_m
    assert len(plan) == -(-log_m // p2.SUBTREE_MAX_LEVELS)
    if log_m == 22:
        assert len(plan) <= 3
    offs = merkle.level_offsets(m)
    assert len(offs) == log_m + 1 and offs[-1] == 2 * m - 2


# ---------------------------------------------------------------------------
# K3 and K6: the lazy 64-bit sums of raw products
# ---------------------------------------------------------------------------
#
# Both kernels add raw products (a * b < p^2) into 64-bit accumulators
# with one multiply-add each (bb::mad), fold an accumulator below 2^60
# after every fourth term (bb::fold) and reduce it once (bb::redc).  The
# models below do the same steps in the same order in numpy uint64 and
# fail on any wrap of 2^64 (where the kernel would lose a carry); each is
# held against `ethrex_tpu.ops.babybear.mod_matmul`, on random inputs and
# on the worst case (every value p - 1).

_MASK = np.uint64(0xFFFFFFFF)
_PINV = np.uint64(pow(bb.P, -1, 1 << 32))
_R2 = np.uint64(bb._R2)


def _cu_constants(name: str) -> dict:
    """The `constexpr int` constants of a kernel source."""
    src = (kernels.CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}


def _mad(acc, a, b):
    out = acc + a.astype(np.uint64) * b.astype(np.uint64)
    assert (out >= acc).all(), "64-bit accumulator wrapped"
    return out


def _fold(x):
    return (x >> np.uint64(32)) * np.uint64(bb.MONT_ONE) + (x & _MASK)


def _redc(x):
    assert (x < P << np.uint64(32)).all(), "redc input not below p 2^32"
    m = ((x & _MASK) * _PINV) & _MASK
    t = (x >> np.uint64(32)).astype(np.int64) - (
        (m * P) >> np.uint64(32)).astype(np.int64)
    return np.where(t < 0, t + int(P), t).astype(np.uint64)


def _finish(acc, montgomery):
    r = _redc(_fold(acc))
    return r if montgomery else _redc(r * _R2)


def model_k_rows(a, b, montgomery=True):
    """`k_rows`: per row, b in tiles of KTILE rows, ROWS_UNROLL terms a
    step with a fold after every fourth, the tile's tail folded after
    each term."""
    c = _cu_constants("mod_matmul.cu")
    tile, unroll = c["KTILE"], c["ROWS_UNROLL"]
    n, k = a.shape
    acc = np.zeros((n, b.shape[1]), dtype=np.uint64)
    for k0 in range(0, k, tile):
        kt = min(tile, k - k0)
        kk = 0
        while kk + unroll <= kt:
            for u in range(unroll):
                j = k0 + kk + u
                acc = _mad(acc, a[:, j, None], b[None, j])
                if u % 4 == 3:
                    acc = _fold(acc)
            kk += unroll
        for j in range(k0 + kk, k0 + kt):
            acc = _fold(_mad(acc, a[:, j, None], b[None, j]))
    return _finish(acc, montgomery)


def model_k_splitk(a, b, montgomery=True):
    """`k_splitk` then `k_splitk_finish`: thread t of slice s takes
    positions s CHUNK + u THREADS + t (u < UNROLL, a fold after every
    fourth), reduces its sum, and the block and then the slices add the
    residues."""
    c = _cu_constants("mod_matmul.cu")
    threads, unroll = c["SPLIT_THREADS"], c["SPLIT_UNROLL"]
    chunk = threads * unroll
    n, k = a.shape
    splits = -(-k // chunk)
    part = np.zeros((n, splits, b.shape[1]), dtype=np.uint64)
    for s in range(splits):
        acc = np.zeros((n, threads, b.shape[1]), dtype=np.uint64)
        for u in range(unroll):
            kk = s * chunk + u * threads + np.arange(threads)
            ok = kk < k
            kc = np.where(ok, kk, 0)
            av = np.where(ok[None], a[:, kc], 0).astype(np.uint64)
            bv = np.where(ok[:, None], b[kc], 0).astype(np.uint64)
            acc = _mad(acc, av[:, :, None], bv[None])
            if u % 4 == 3:
                acc = _fold(acc)
        part[:, s] = _redc(_fold(acc)).sum(axis=1) % P
    r = part.sum(axis=1) % P
    return r if montgomery else _redc(r * _R2)


@pytest.mark.parametrize("worst", [False, True])
@pytest.mark.parametrize("montgomery", [True, False])
@pytest.mark.parametrize("k,m", [(1, 4), (7, 8), (8, 4), (9, 8), (255, 4),
                                 (257, 8), (924, 4), (4101, 8)])
def test_k3_rows_model_equals_jax_mod_matmul(k, m, montgomery, worst):
    n = 5
    a, b = _field(k, (n, k)), _field(k + 1, (k, m))
    if worst:
        a[:], b[:] = bb.P - 1, bb.P - 1
    got = model_k_rows(a.astype(np.uint64), b.astype(np.uint64), montgomery)
    want = np.asarray(jbb.mod_matmul(a, b, montgomery=montgomery))
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("worst", [False, True])
@pytest.mark.parametrize("montgomery", [True, False])
@pytest.mark.parametrize("k,m", [(4097, 4), (9000, 8)])
def test_k3_splitk_model_equals_jax_mod_matmul(k, m, montgomery, worst):
    n = 3
    a, b = _field(k, (n, k)), _field(k + 1, (k, m))
    if worst:
        a[:], b[:] = bb.P - 1, bb.P - 1
    got = model_k_splitk(a.astype(np.uint64), b.astype(np.uint64),
                         montgomery)
    want = np.asarray(jbb.mod_matmul(a, b, montgomery=montgomery))
    assert np.array_equal(got.astype(np.uint32), want)


_MAD_LINE = re.compile(r"c(\d) = bb::mad\(v(\d+), ap\.w\[(\d+)\], c\1\);")


def model_combine(graph, cons, apow):
    """K6 in combine mode as generated: per group kernel, the events of
    its source in order (a mad line adds v_k apow[k] to the four sums, a
    fold line folds them), one fold and redc at the end, and each later
    group's result added mod p to the earlier ones'.  cons (K, N), apow
    (K, 4) uint64 Montgomery."""
    text, nk = cg.cuda_source(graph, mode="combine")
    parts = cg.groups(graph)
    bodies = text.split("__global__")[1:]
    assert len(bodies) == len(parts) == nk
    out = None
    for gi, (cids, body) in enumerate(zip(parts, bodies)):
        acc = np.zeros((cons.shape[1], 4), dtype=np.uint64)
        seen = []
        for line in body.splitlines():
            mads = _MAD_LINE.findall(line)
            if mads:
                w0 = int(mads[0][2])
                assert [(int(j), int(v), int(w)) for j, v, w in mads] == [
                    (j, int(mads[0][1]), w0 + j) for j in range(4)]
                kc = cids[0] + w0 // 4
                assert graph.outputs[kc] == int(mads[0][1])
                seen.append(kc)
                acc = _mad(acc, cons[kc][:, None], apow[kc][None])
            elif "c0 = bb::fold(c0);" in line:
                acc = _fold(acc)
        assert sorted(seen) == list(cids)      # every constraint once
        assert ("const uint4 q = *o;" in body) == (gi > 0)
        r = _redc(_fold(acc))
        out = r if gi == 0 else (out + r) % P
    return out


PATH_AIRS = {
    "StateUpdateAir": lambda: _air("state_update_air").StateUpdateAir(
        10, seg_periods=16),
    "TransferAir": lambda: _air("transfer_air").TransferAir(),
    "TokenAir": lambda: _air("token_air").TokenAir(),
    "BytecodeAir": lambda: _air("bytecode_air").BytecodeAir(),
    "Poseidon2SpongeAir": lambda: _air("poseidon2_air").Poseidon2SpongeAir(
        10),
    "FriVerifyAir": lambda: _air("fri_verifier_air").FriVerifyAir(22),
}


def _air(module: str):
    import importlib

    return importlib.import_module(f"ethrex_tpu_torch.models.{module}")


@pytest.mark.parametrize("name", sorted(PATH_AIRS))
def test_combine_model_equals_jax_mod_matmul(name):
    """The path's AIRs at their full structure, random constraint values
    and alpha powers (the model takes the values; the kernel's order
    comes from its source)."""
    graph = cg.record(PATH_AIRS[name]())
    K = graph.num_constraints
    cons, apow = _field(K, (K, 16)), _field(K + 1, (K, 4))
    got = model_combine(graph, cons.astype(np.uint64),
                        apow.astype(np.uint64))
    want = np.asarray(jbb.mod_matmul(cons.T.copy(), apow))
    assert np.array_equal(got.astype(np.uint32), want)


def test_combine_model_worst_case_at_the_largest_air():
    """Every constraint value and alpha power p - 1, in the generated
    order of the path's AIR with the most constraints."""
    graphs = [cg.record(make()) for make in PATH_AIRS.values()]
    graph = max(graphs, key=lambda g: g.num_constraints)
    K = graph.num_constraints
    assert K >= 924
    cons = np.full((K, 4), bb.P - 1, dtype=np.uint32)
    apow = np.full((K, 4), bb.P - 1, dtype=np.uint32)
    got = model_combine(graph, cons.astype(np.uint64),
                        apow.astype(np.uint64))
    want = np.asarray(jbb.mod_matmul(cons.T.copy(), apow))
    assert np.array_equal(got.astype(np.uint32), want)


# ---------------------------------------------------------------------------
# K7 (batch inversion, csrc/batch_inv.cu) and K8 (the DEEP codeword,
# csrc/deep_compose.cu)
# ---------------------------------------------------------------------------
#
# Both kernels invert many values with one inversion (Montgomery's trick)
# and K8 sums raw products lazily.  The models below run the kernels'
# plans in numpy uint64, with their sizes read from the sources: which
# values share an inversion, the order of the running products, the
# shuffle scans, and every bb::mad and bb::fold (`_mad` fails on a wrap
# of 2^64).


def _mont(a, b):
    return _redc(np.asarray(a, dtype=np.uint64) * np.asarray(b, np.uint64))


def _add(a, b):
    s = np.asarray(a, np.uint64) + np.asarray(b, np.uint64)
    return np.where(s >= P, s - P, s)


def _sub(a, b):
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    return np.where(a >= b, a - b, a + P - b)


def _mpow(a, e: int):
    """`bb::mpow`: a^e by square and multiply."""
    r = np.full_like(np.asarray(a, np.uint64), bb.MONT_ONE)
    while e:
        if e & 1:
            r = _mont(r, a)
        a = _mont(a, a)
        e >>= 1
    return r


_ONE = np.uint64(bb.MONT_ONE)


def _shfl_scan(v, axis_len, up: bool, steps):
    """The kernels' Hillis-Steele shuffle scan of products along the last
    axis (32 lanes): lane l takes lane l -/+ d's value for d in steps,
    when that lane exists."""
    v = v.copy()
    lanes = np.arange(axis_len)
    for d in steps:
        if up:
            src = np.concatenate([v[..., :1].repeat(d, -1), v[..., :-d]],
                                 -1)
            ok = lanes >= d
        else:
            src = np.concatenate([v[..., d:], v[..., -1:].repeat(d, -1)],
                                 -1)
            ok = lanes + d < axis_len
        v = np.where(ok, _mont(v, src), v)
    return v


def model_block_inv(v):
    """csrc/batch_inv.cu `block_inv` over v (blocks, THREADS, CHUNK)
    uint64 Montgomery (thread t's element c at [., t, c]): returns the
    inverses, 0 for 0."""
    c = _cu_constants("batch_inv.cu")
    threads, chunk = c["THREADS"], c["CHUNK"]
    warps = threads // 32
    nb = v.shape[0]
    assert v.shape == (nb, threads, chunk)
    pre = np.empty_like(v)
    run = np.full((nb, threads), _ONE, dtype=np.uint64)
    for k in range(chunk):
        pre[..., k] = run
        run = np.where(v[..., k] != 0, _mont(run, v[..., k]), run)
    lanes = run.reshape(nb, warps, 32)
    steps = [1 << s for s in range(5)]
    inc = _shfl_scan(lanes, 32, True, steps)
    suf = _shfl_scan(lanes, 32, False, steps)
    before = np.concatenate([np.full((nb, warps, 1), _ONE), inc[..., :-1]],
                            -1)
    after = np.concatenate([suf[..., 1:], np.full((nb, warps, 1), _ONE)],
                           -1)
    # warp 0: the warps' products on its first lanes, one elsewhere
    wt = np.full((nb, 32), _ONE, dtype=np.uint64)
    wt[:, :warps] = inc[..., 31]
    wsteps = [d for d in steps if d < warps]
    wi = _shfl_scan(wt, 32, True, wsteps)
    ws = _shfl_scan(wt, 32, False, wsteps)
    wb = np.concatenate([np.full((nb, 1), _ONE), wi[:, :-1]], -1)
    wa = np.concatenate([ws[:, 1:], ws[:, -1:]], -1)
    total_inv = _mpow(wi[:, warps - 1], bb.P - 2)
    factor = _mont(total_inv[:, None], _mont(wb, wa))[:, :warps]
    inv = _mont(factor[..., None], _mont(before, after)).reshape(nb, threads)
    out = np.zeros_like(v)
    for k in range(chunk - 1, -1, -1):
        x = v[..., k]
        out[..., k] = np.where(x != 0, _mont(inv, pre[..., k]), 0)
        inv = np.where(x != 0, _mont(inv, x), inv)
    return out


def _blocks(a, pad=0):
    """(n,) -> (blocks, THREADS, CHUNK) as K7 places it: element
    block * THREADS * CHUNK + c * THREADS + t at [block, t, c]; the tail
    padded with `pad` (a value the kernel leaves out)."""
    c = _cu_constants("batch_inv.cu")
    threads, chunk = c["THREADS"], c["CHUNK"]
    per = threads * chunk
    nbk = -(-a.shape[0] // per)
    full = np.full(nbk * per, pad, dtype=np.uint64)
    full[:a.shape[0]] = a
    return full.reshape(nbk, chunk, threads).transpose(0, 2, 1)


def _unblocks(v, n):
    return v.transpose(0, 2, 1).reshape(-1)[:n]


def model_k_batch_inv(a):
    return _unblocks(model_block_inv(_blocks(a)), a.shape[0])


_K7_CONST = _cu_constants("batch_inv.cu")
_K7_BLOCK = _K7_CONST["THREADS"] * _K7_CONST["CHUNK"]


@pytest.mark.parametrize("n", [1, 31, 33, _K7_BLOCK + 1])
def test_k7_model_equals_jax_batch_mont_inv(n):
    a = _field(n, (n,)).astype(np.uint64)
    a[a == 0] = bb.MONT_ONE
    got = model_k_batch_inv(a)
    want = np.asarray(jbb.batch_mont_inv(a.astype(np.uint32)))
    assert np.array_equal(got.astype(np.uint32), want)


def _with_zeros(n, seed):
    a = _field(seed, (n,)).astype(np.uint64)
    t = _K7_CONST["THREADS"]
    blk = _K7_BLOCK
    a[::max(1, n // 5)] = 0
    if n > blk:
        a[blk - 1] = a[blk] = 0                    # a block's edge
    if n > 2 * blk:
        for c in range(_K7_CONST["CHUNK"]):
            a[blk + c * t:blk + c * t + 32] = 0    # warp 0 of block 1
            a[blk + c * t + 33] = 0                # thread 33's chunk
        a[2 * blk:3 * blk] = 0                     # a whole block
    a[min(31, n - 1)] = a[min(32, n - 1)] = 0      # a warp's edge
    return a


@pytest.mark.parametrize("n", [1, 31, 33, _K7_BLOCK + 1,
                               3 * _K7_BLOCK + 1])
def test_k7_model_with_zeros_equals_fermat(n):
    """Zeros (left out of the products, mapped to 0) at chunk, warp and
    block edges and a whole block of zeros: each element as the
    per-element Fermat power of the JAX package gives it."""
    a = _with_zeros(n, n + 5)
    got = model_k_batch_inv(a)
    want = np.asarray(jbb.mont_inv(a.astype(np.uint32)))
    assert np.array_equal(got.astype(np.uint32), want)
    assert not got[a == 0].any()


def model_k_divisor_inv(pts_m, cm):
    """`k_divisor_inv`: each block's domain points once, then `block_inv`
    of x - c_j for each constant in turn -> (nd, N)."""
    N = pts_m.shape[0]
    x = _blocks(pts_m)
    valid = _blocks(np.ones(N, dtype=np.uint64)) != 0
    return np.stack([_unblocks(model_block_inv(
        np.where(valid, _sub(x, c), 0)), N) for c in cm])


def _reference_stack(air, log_n, lb, shift):
    """The reference's inverted divisor stack (ethrex_tpu/stark/
    prover.py:488-518), read from its quotient phase's closure."""
    from ethrex_tpu.stark import prover as jprover

    bodies, _ = jprover._build_phases(air, log_n, lb, shift)
    quotient = bodies[1]
    cells = dict(zip(quotient.__code__.co_freevars, quotient.__closure__))
    return np.asarray(cells["inv_stack_np"].cell_contents)


def test_k7_divisor_model_equals_jax_stack():
    """K7's divisor entry, as `prover._tables` calls it (the B coset-class
    entries by K7, the rest from the domain points), for a small AIR with
    boundaries: equal to the reference's inverted stack."""
    from ethrex_tpu.models import state_update_air as jsua
    from ethrex_tpu_torch.models import state_update_air as sua
    from ethrex_tpu_torch.stark import prover

    log_n, lb, shift = 8, 3, bb.GENERATOR
    want = _reference_stack(jsua.StateUpdateAir(2, seg_periods=8), log_n,
                            lb, shift)
    air = sua.StateUpdateAir(2, seg_periods=8)
    n, B = 1 << log_n, 1 << lb
    tb = prover._tables(air, log_n, lb, shift, "cpu")
    g_n = bb.root_of_unity(log_n)
    consts = [pow(g_n, n - 1, bb.P)] + [pow(g_n, r, bb.P)
                                        for r, _ in tb.bounds_struct]
    pts_m = bb.to_numpy(tb.pts_m).astype(np.uint64)
    cm = bb.to_mont_host(np.array(consts, dtype=np.uint64)).astype(
        np.uint64)
    s_n, uB = pow(shift, n, bb.P), pow(bb.root_of_unity(log_n + lb), n, bb.P)
    head = bb.to_mont_host(np.array(
        [(s_n * pow(uB, i, bb.P) - 1) % bb.P for i in range(B)],
        dtype=np.uint64)).astype(np.uint64)
    got = np.concatenate([model_k_batch_inv(head),
                          model_k_divisor_inv(pts_m, cm).reshape(-1)])
    assert len(tb.bounds_struct) > 0
    assert np.array_equal(got.astype(np.uint32), want)
    assert np.array_equal(bb.to_numpy(tb.inv_stack), want)


_K8_CONST = _cu_constants("deep_compose.cu")


def _k8_ext_mad(a, b, wb, acc):
    """`ext_mad` of csrc/deep_compose.cu: per coordinate its four raw
    products in the source's order (innermost first), then a fold."""
    terms = ([(3, wb[1]), (2, wb[2]), (1, wb[3]), (0, b[0])],
             [(3, wb[2]), (2, wb[3]), (1, b[0]), (0, b[1])],
             [(3, wb[3]), (2, b[0]), (1, b[1]), (0, b[2])],
             [(3, b[0]), (2, b[1]), (1, b[2]), (0, b[3])])
    out = []
    for m in range(4):
        x = acc[m]
        for k, bv in terms[m]:
            x = _mad(x, a[k], bv)
        out.append(_fold(x))
    return out


def _k8_norm(o, x):
    n = _sub(x, o["e"][0])
    n = _add(_mont(n, x), o["e"][1])
    n = _sub(_mont(n, x), o["e"][2])
    return _add(_mont(n, x), o["e"][3])


def _k8_inv_x_minus(o, x, ninv):
    acc = [_sub(x, o["s1"][0])] + [_sub(np.zeros_like(x), o["s1"][m])
                                   for m in (1, 2, 3)]
    acc = [_add(_mont(acc[m], x), o["s2"][m]) for m in range(4)]
    iz = [_mont(_sub(_mont(acc[m], x), o["s3"][m]), ninv) for m in range(4)]
    wiz = [None] + [_mont(iz[m], np.uint64(bb.to_mont_host(11)))
                    for m in (1, 2, 3)]
    return iz, wiz


def model_k_deep(pts, s1, s2, q, kc, nq):
    """`k_deep` over pts (N,), s1 and s2 (N, 4) (s2 None: one opening),
    q (nq, 4, N), kc the parameter words (uint64 Montgomery): thread t of
    block b takes the points b THREADS PTS + j THREADS + t."""
    pts_per, threads, maxq = (_K8_CONST["PTS"], _K8_CONST["THREADS"],
                              _K8_CONST["MAX_NQ"])
    NO = 1 if s2 is None else 2
    N = pts.shape[0]
    nblk = -(-N // (threads * pts_per))
    idx = (np.arange(nblk)[:, None, None] * threads * pts_per
           + np.arange(pts_per)[None, None, :] * threads
           + np.arange(threads)[None, :, None]).reshape(-1, pts_per)
    valid = idx < N
    x = np.where(valid, pts[np.where(valid, idx, 0)], 0)
    op = [dict(s1=kc[20 * o:20 * o + 4], s2=kc[20 * o + 4:20 * o + 8],
               s3=kc[20 * o + 8:20 * o + 12], e=kc[20 * o + 12:20 * o + 16],
               c=kc[20 * o + 16:20 * o + 20]) for o in range(2)]
    g = kc[40:40 + 4 * maxq].reshape(maxq, 4)
    wg = kc[40 + 4 * maxq:40 + 8 * maxq].reshape(maxq, 4)
    nt = idx.shape[0]
    run = np.full(nt, _ONE, dtype=np.uint64)
    nrm = np.zeros((nt, pts_per, NO), dtype=np.uint64)
    pre = np.zeros_like(nrm)
    for j in range(pts_per):
        for o in range(NO):
            v = np.where(valid[:, j], _k8_norm(op[o], x[:, j]), 0)
            nrm[:, j, o], pre[:, j, o] = v, run
            run = np.where(v != 0, _mont(run, v), run)
    inv = _mpow(run, bb.P - 2)
    out = np.zeros((N, 4), dtype=np.uint64)
    for j in range(pts_per - 1, -1, -1):
        ninv = [None] * NO
        for o in range(NO - 1, -1, -1):
            v = nrm[:, j, o]
            ninv[o] = np.where(v != 0, _mont(inv, pre[:, j, o]), 0)
            inv = np.where(v != 0, _mont(inv, v), inv)
        sel = valid[:, j]
        i, xx = idx[sel, j], x[sel, j]
        acc = [_mad(np.zeros(len(i), np.uint64), _sub(s1[i, m], op[0]["c"][m]),
                    _ONE) for m in range(4)]
        for b in range(nq):
            acc = _k8_ext_mad([q[b, m, i] for m in range(4)], g[b], wg[b],
                              acc)
        a = [_redc(acc[m]) for m in range(4)]
        r = [np.zeros(len(i), np.uint64) for _ in range(4)]
        iz, wiz = _k8_inv_x_minus(op[0], xx, ninv[0][sel])
        r = _k8_ext_mad(a, iz, wiz, r)
        if NO == 2:
            d = [_sub(s2[i, m], op[1]["c"][m]) for m in range(4)]
            iz, wiz = _k8_inv_x_minus(op[1], xx, ninv[1][sel])
            r = _k8_ext_mad(d, iz, wiz, r)
        out[i] = np.stack([_redc(r[m]) for m in range(4)], axis=1)
    return out


def _jax_deep(pts, opens, q_lde, q_z, gq):
    """The reference's arithmetic: `phase_deep` (ethrex_tpu/stark/
    prover.py:565-585) with two openings, the fused step's DEEP codeword
    (ethrex_tpu/parallel/core.py:103-108) with one; uint32 Montgomery."""
    from ethrex_tpu.ops import ext as jext

    def zm(z):
        return bb.to_mont_host(np.array(z, dtype=np.uint64))

    terms = []
    for z, S, t, g in opens:
        inv = jext.inv_x_minus_zeta(pts, zm(z))
        terms.append((jext.sub(S, jbb.sum_mod(jext.mul(t, g), axis=0)[None]),
                      inv))
    (s1, inv0) = terms[0]
    if q_lde is not None:
        d3 = jext.sub(np.moveaxis(q_lde, 1, -1), q_z[:, None])
        s1 = jext.add(s1, jbb.sum_mod(jext.mul(d3, gq[:, None]), axis=0))
    out = jext.mul(s1, inv0)
    if len(terms) == 2:
        out = jext.add(out, jext.mul(terms[1][0], terms[1][1]))
    return np.asarray(out)


@pytest.mark.parametrize("N,two,nq,worst", [
    (N, two, nq, False) for N in (1, _K8_CONST["PTS"] + 1, 4099)
    for two, nq in ((True, 8), (True, 0), (False, 0))]
    + [(4099, True, 16, True), (4099, False, 0, True)])
def test_k8_model_equals_jax_deep(N, two, nq, worst):
    """The k-point inversion chain, the host's constant c1 + sum_b g_b
    Q_b(zeta) (`ext._deep_consts`), the lazy sums (no accumulator wraps,
    also with every value p - 1) and the tail past N."""
    from ethrex_tpu_torch.ops import ext

    w = 5
    seed = N * 10 + nq + (2 if two else 1)
    pts = _field(seed, (N,))
    s12 = _field(seed + 1, (N, 8))
    ts = [_field(seed + 2 + o, (w, 4)) for o in (0, 1)]
    gs = [_field(seed + 4 + o, (w, 4)) for o in (0, 1)]
    q_lde, q_z, gq = (_field(seed + 6, (nq, 4, N)), _field(seed + 7, (nq, 4)),
                      _field(seed + 8, (nq, 4)))
    if worst:
        for arr in (s12, q_lde, q_z, gq, *ts, *gs):
            arr[...] = bb.P - 1
    rng = np.random.default_rng(seed)
    zs = [tuple(int(v) for v in rng.integers(0, bb.P, 4)) for _ in (0, 1)]
    nopen = 2 if two else 1
    opens = [(zs[o], s12[:, 4 * o:4 * o + 4], ts[o], gs[o])
             for o in range(nopen)]

    def th(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    kc = ext._deep_consts([(z, th(S), th(t), th(g)) for z, S, t, g in opens],
                          th(q_z) if nq else None, th(gq) if nq else None)
    u = np.uint64
    got = model_k_deep(pts.astype(u), s12[:, :4].astype(u),
                       s12[:, 4:].astype(u) if two else None,
                       q_lde.astype(u), kc.astype(u), nq)
    want = _jax_deep(pts, opens, q_lde if nq else None, q_z, gq)
    assert np.array_equal(got.astype(np.uint32), want)


def test_k8_model_base_field_zeta_on_a_point():
    """zeta = (x_9, 0, 0, 0): the norm of x_9 is 0, so its inverse is 0
    and the other norms of the same inversion are unharmed."""
    from ethrex_tpu_torch.ops import ext

    N, w = _K8_CONST["THREADS"] * 2 + 3, 3
    pts = _field(91, (N,))
    z = (int(bb.from_mont_host(pts[9:10])[0]), 0, 0, 0)
    S, t, g = _field(92, (N, 4)), _field(93, (w, 4)), _field(94, (w, 4))

    def th(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    kc = ext._deep_consts([(z, th(S), th(t), th(g))], None, None)
    u = np.uint64
    got = model_k_deep(pts.astype(u), S.astype(u), None,
                       np.zeros((0, 4, N), u), kc.astype(u), 0)
    want = _jax_deep(pts, [(z, S, t, g)], None, None, None)
    assert np.array_equal(got.astype(np.uint32), want)
    assert not want[9].any() and want[8].any() and want[10].any()


# ---------------------------------------------------------------------------
# K11: the power tables and the chunk sums of the open phase
# ---------------------------------------------------------------------------
#
# `k_open` (csrc/ext_poly_eval.cu): thread t of S = blocks x THREADS
# threads takes rows t, t + S, ...; it starts from z^t, the product of
# the binary powers z^(2^j) over the bits of t, and steps by z^S.  Each
# row's chunk words add into lazy 64-bit sums (four raw products a
# coordinate, then a fold), reduced once a thread; a block adds its
# threads' residues mod p and the blocks add into 64-bit device sums.
# The model below does the same products in the same order in numpy
# (`_mad` fails on a wrap of 2^64) for any grid, and is held against
# `ext_powers_blocked` and `eval_ext_poly_at_ext` of the JAX package.

_K11 = _cu_constants("ext_poly_eval.cu")
_W_M = np.uint64(bb.to_mont_host(11))


def _ext_mul_m(a, b):
    """`bb::ext_mul` on Montgomery words, a and b (..., 4)."""
    m = _mont
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))
    t0 = _add(_add(m(a1, b3), m(a2, b2)), m(a3, b1))
    t1 = _add(m(a2, b3), m(a3, b2))
    t2 = m(a3, b3)
    return np.stack([
        _add(m(a0, b0), m(t0, _W_M)),
        _add(_add(m(a0, b1), m(a1, b0)), m(t1, _W_M)),
        _add(_add(m(a0, b2), m(a1, b1)), _add(m(a2, b0), m(t2, _W_M))),
        _add(_add(m(a0, b3), m(a1, b2)), _add(m(a2, b1), m(a3, b0)))],
        axis=-1)


def _k11_start(z, S: int):
    """Each thread's first power z^t (t < S) from the binary powers over
    t's bits (shift and mask), and the step z^S, as a block makes them."""
    pw, a = [], z
    for _ in range(S.bit_length()):
        pw.append(a)
        a = _ext_mul_m(a, a)
    one = np.array([bb.MONT_ONE, 0, 0, 0], dtype=np.uint64)
    step = one
    t = np.arange(S)
    zt = np.tile(one, (S, 1))
    for j, w in enumerate(pw):
        if (S >> j) & 1:
            step = _ext_mul_m(step, w)
        zt = np.where(((t >> j) & 1)[:, None] == 1, _ext_mul_m(zt, w), zt)
    return zt, step


def model_k_open(zs, n: int, chunks, blocks: int):
    """`k_open` over `blocks` blocks: zs (NP, 4) Montgomery points, chunks
    (B, n, 4) Montgomery (B may be 0).  Returns the (n, 4 NP) table and
    the (B, 4) sums."""
    T = _K11["THREADS"]
    S = blocks * T
    np_ = zs.shape[0]
    starts = [_k11_start(zs[p], S) for p in range(np_)]
    z = [st[0] for st in starts]
    table = np.zeros((n, 4 * np_), dtype=np.uint64)
    B = chunks.shape[0]
    acc = [[np.zeros(S, np.uint64) for _ in range(4)] for _ in range(B)]
    t = np.arange(S)
    for k in range(-(-n // S)):
        i = t + k * S
        ok = i < n
        for p in range(np_):
            table[i[ok], 4 * p:4 * p + 4] = z[p][ok]
        if B:
            wz = [np.zeros(S, np.uint64)] + [_mont(z[0][:, m], _W_M)
                                             for m in (1, 2, 3)]
            zc = [z[0][:, m] for m in range(4)]
            ic = np.where(ok, i, 0)
            for b in range(B):
                cw = [np.where(ok, chunks[b, ic, m], 0) for m in range(4)]
                new = _k8_ext_mad(cw, zc, wz, acc[b])
                acc[b] = [np.where(ok, new[m], acc[b][m]) for m in range(4)]
        more = (i + S < n)[:, None]
        z = [np.where(more, _ext_mul_m(z[p], starts[p][1]), z[p])
             for p in range(np_)]
    sums = np.zeros((B, 4), dtype=np.uint64)
    for b in range(B):
        for m in range(4):
            v = _redc(acc[b][m]).reshape(blocks, T)
            block = v.sum(axis=1) % P             # a block's mod-p adds
            total = block.sum()                   # the device's 64-bit sum
            assert blocks * (int(P) - 1) < 2**64
            sums[b, m] = total % P
    return table, sums


@pytest.mark.parametrize("n,blocks,B,worst", [
    (1, 1, 8, False), (_K11["THREADS"] - 1, 1, 8, False),
    (3 * _K11["THREADS"] + 7, 2, 8, False), (1000, 3, 9, False),
    (300, 2, 0, False), (2 * _K11["THREADS"] + 5, 1, 16, True)])
def test_k11_model_equals_jax_powers_and_eval(n, blocks, B, worst):
    """Rows fewer than a block's threads, n not a multiple of S (a
    thread's last row past n), n = 1, more chunks than a thread keeps,
    no chunks, and every chunk word p - 1."""
    import jax.numpy as jnp

    from ethrex_tpu.ops import ext as jext
    from ethrex_tpu_torch.ops import ext

    rng = np.random.default_rng(n * 7 + blocks + B)
    pts = [tuple(int(v) for v in rng.integers(0, bb.P, 4)) for _ in (0, 1)]
    zs = ext._points_mont(pts).astype(np.uint64)
    chunks = _field(n + B, (B, n, 4))
    if worst:
        chunks[...] = bb.P - 1
    table, sums = model_k_open(zs, n, chunks.astype(np.uint64), blocks)
    for p in (0, 1):
        want = np.asarray(jext.ext_powers_blocked(jnp.asarray(
            zs[p].astype(np.uint32)), n))
        np.testing.assert_array_equal(table[:, 4 * p:4 * p + 4], want)
    if B:
        want = np.asarray(jext.eval_ext_poly_at_ext(
            jnp.asarray(chunks), jnp.asarray(zs[0].astype(np.uint32))))
        np.testing.assert_array_equal(sums, want)


@pytest.mark.parametrize("blocks", [1, 132, 264, 1 << 17])
def test_k11_index_split_covers_every_start(blocks):
    """A block keeps MAX_BITS binary powers: enough for the bits of any
    S = blocks x THREADS up to n = 2^25 rows a thread each; the bits of t
    (shift and mask) give back every t < S, so z^t and the steps of z^S
    reach every row once."""
    T = _K11["THREADS"]
    S = blocks * T
    assert S.bit_length() <= _K11["MAX_BITS"]
    t = np.arange(min(S, 1 << 20), dtype=np.int64)
    back = sum(((t >> j) & 1) << j for j in range(S.bit_length()))
    assert np.array_equal(back, t)
    n = 1 << 25
    rows = np.concatenate([np.arange(s, n, S) for s in (0, S - 1)])
    assert rows.min() == 0 and len(np.unique(rows)) == len(rows)


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("log_n", [20, 25])
def test_k11_lazy_sums_worst_case_never_wrap(log_n, B):
    """Every word p - 1 at n = 2^log_n: the most rows a thread can take (a
    grid of one block), four raw products (p-1)^2 a row onto each of its
    4 B sums, each folded after its row; then the reduction (redc needs
    a sum below p 2^32) and the device sums, one residue a block, for
    the most blocks any launch has."""
    T = _K11["THREADS"]
    n = 1 << log_n
    q = (bb.P - 1) ** 2
    acc = 0
    for _ in range(-(-n // T)):
        for _ in range(4):
            acc += q
            assert acc < 2**64, "64-bit sum wrapped"
        acc = (acc >> 32) * bb.MONT_ONE + (acc & 0xFFFFFFFF)
        assert acc < 2**60
    assert acc < bb.P << 32
    blocks = -(-n // T) * -(-B // _K11["CHUNKS"])
    assert blocks * (bb.P - 1) < 2**64


# ---------------------------------------------------------------------------
# K10: the roots of a forest
# ---------------------------------------------------------------------------

_K10 = _cu_constants("poseidon2.cu")


def _forest_rounds(sizes):
    """Walk `merkle.forest_plan` as `k_forest` reads it, with each row
    labelled (tree, level, index): every input row of a round read by
    exactly one tile (2^k nodes of one tree and level, aligned) or copied
    (k = 0), every output row written once.  Yields per round the input
    and output labels and the (in row, out row, tiles, k) of every
    block."""
    tree = np.repeat(np.arange(len(sizes)), sizes)
    level = np.zeros(len(tree), np.int64)
    idx = np.concatenate([np.arange(s) for s in sizes]) if sizes else tree
    for launches, rows in merkle.forest_plan(tuple(sizes)):
        seen = np.zeros(len(tree), np.int64)
        out = [np.full(rows, -1, np.int64) for _ in range(3)]
        work = []
        for segs, blocks in launches:
            nb = 0
            for i_, o_, first, tiles, k, S, c in segs.tolist():
                assert first == nb and 1 <= S and (S << k) <= 1 << 10
                assert k == 0 or (0 <= c < k and
                                  (S << (k - c - 1)) <= _K10["FOREST_THREADS"])
                nb += -(-tiles // S)
                for b in range(-(-tiles // S)):
                    cnt = min(S, tiles - b * S)
                    lo = i_ + ((b * S) << k)
                    r = np.arange(lo, lo + (cnt << k)).reshape(cnt, 1 << k)
                    seen[r] += 1
                    for lab in (tree, level):
                        assert (lab[r] == lab[r[:, :1]]).all()
                    assert (idx[r] == idx[r[:, :1]] + np.arange(1 << k)).all()
                    assert (idx[r[:, 0]] % (1 << k) == 0).all()
                    o = np.arange(o_ + b * S, o_ + b * S + cnt)
                    assert (out[0][o] == -1).all()
                    out[0][o] = tree[r[:, 0]]
                    out[1][o] = level[r[:, 0]] + k
                    out[2][o] = idx[r[:, 0]] >> k
                    work.append((lo, o[0], cnt, k))
            assert nb == blocks
        assert (seen == 1).all() and (out[0] >= 0).all()
        yield (tree, level, idx), out, work
        tree, level, idx = out
    assert list(tree) == list(range(len(sizes)))
    assert list(level) == [s.bit_length() - 1 for s in sizes]
    assert not idx.any()


def model_k_forest(digests, sizes):
    """`k_forest` by `merkle.forest_plan`: each block's tiles compressed
    level by level (node i of level j from nodes 2i and 2i + 1 of level
    j - 1, as the kernel pairs its shared slots), only the tiles' roots
    kept.  Returns the roots in tree order."""
    state = digests
    for _, (t, _, _), work in _forest_rounds(tuple(sizes)):
        out = torch.empty((len(t), 8), dtype=bb.I32)
        for lo, o, cnt, k in work:
            x = state[lo:lo + (cnt << k)].reshape(cnt, 1 << k, 8)
            for _ in range(k):
                x = p2.compress(x[:, 0::2], x[:, 1::2])
            out[o:o + cnt] = x[:, 0]
        state = out
    return [state[i] for i in range(len(sizes))]


_FUSED_CHAIN = {log_n: tuple(1 << (log_n + 1 - k) for k in range(log_n - 3))
                for log_n in (8, 15, 20)}


@pytest.mark.parametrize("sizes", [(1 << a,) for a in range(13)] + [
    (4, 1, 2), (64, 32, 1, 16, 8, 1), (8, 8, 8, 2, 2, 1, 1), (1, 1, 1),
    (2, 1) * 30 + (256,), (1 << 12, 1 << 11, 2, 1),
    _FUSED_CHAIN[15], _FUSED_CHAIN[20]])
def test_forest_plan_covers_every_node_once(sizes):
    """Every node of every tree made once, in ceil(max log2 size / 10)
    rounds (3 at the fused step's log_n 20, 2 at 15), one launch a round
    unless a round has more than FOREST_SEGS segments."""
    rounds = list(_forest_rounds(sizes))
    made = sum(cnt * ((1 << k) - 1) for _, _, work in rounds
               for _, _, cnt, k in work)
    assert made == sum(sizes) - len(sizes)
    assert len(rounds) == -(-(max(sizes).bit_length() - 1)
                            // merkle.FOREST_LEVELS)
    launches = sum(len(l) for l, _ in merkle.forest_plan(tuple(sizes)))
    if len(sizes) < merkle.FOREST_SEGS:
        assert launches == len(rounds)
    if sizes == _FUSED_CHAIN[20]:
        assert launches == 3
    if sizes == _FUSED_CHAIN[15]:
        assert launches == 2


@pytest.mark.parametrize("sizes", [
    (1,), (2,), (1 << 11,), (4, 1, 2), (64, 32, 1, 16, 8, 1),
    (8, 8, 8, 2, 2, 1, 1), (2, 1) * 30 + (16,), _FUSED_CHAIN[8]])
def test_forest_model_equals_jax_batched_roots(sizes):
    import jax.numpy as jnp

    d = _field(len(sizes) + sum(sizes), (sum(sizes), 8))
    want = jmerkle.batched_roots(jnp.asarray(d), sizes)
    got = model_k_forest(bb.from_numpy(d, "cpu"), sizes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bb.to_numpy(g), np.asarray(w))


def test_kernel_plan_sizes():
    """The sizes the wrappers and the tests assume are the sources'."""
    from ethrex_tpu_torch.ops import ext

    assert _K8_CONST["MAX_NQ"] == ext._DEEP_MAX_NQ
    assert ext._DEEP_WORDS == 40 + 8 * _K8_CONST["MAX_NQ"]
    assert _K7_CONST["THREADS"] % 32 == 0
    assert _K7_CONST["THREADS"] // 32 <= 32
    # K11: warp 0's lanes hold a block's 4 x CHUNKS sums, one each
    assert _K11["THREADS"] % 32 == 0 and 4 * _K11["CHUNKS"] <= 32
    # K10: the plan's limits are the kernel's
    assert (_K10["FOREST_SEGS"], _K10["FOREST_THREADS"],
            _K10["FOREST_LEVELS"]) == (merkle.FOREST_SEGS,
                                       merkle.FOREST_THREADS,
                                       merkle.FOREST_LEVELS)


# ---------------------------------------------------------------------------
# ext_batch_inv (csrc/ext_inv.cu) and eval_poly_at (csrc/poly_eval.cu)
# ---------------------------------------------------------------------------
#
# `k_ext_batch_inv` is K7's block inversion in F_p[x]/(x^4 - 11): a block
# of THREADS x CHUNK elements shares one ext inverse.  `k_eval_poly_at`
# splits each row into spans of SPAN coefficients, one block a span, and
# makes the powers of the point itself.  The models run both plans in
# numpy uint64 with the sizes read from the sources: the lazy ext
# products (`ext_mul_w`), the shuffle scans in the kernel's order, the
# binary powers and each thread's start, the quads' lazy sums and the
# rows' partial sums; `_mad` fails on a wrap of 2^64.

_EXT = _cu_constants("ext_inv.cu")
_EXT_BLOCK = _EXT["THREADS"] * _EXT["CHUNK"]
_PE = _cu_constants("poly_eval.cu")
_PE_STRIDE = 1 << _PE["LOG_STRIDE"]
_PE_SPAN = _PE["ITERS"] * _PE_STRIDE
_ONE_E = np.array([bb.MONT_ONE, 0, 0, 0], dtype=np.uint64)


def _ext_mul_w(a, b):
    """`ext_mul_w` with wb = W b (`times_w`): per coordinate four raw
    products summed lazily (the kernel's innermost first), one fold and
    one reduction."""
    wb = [None] + [_mont(b[..., m], _W_M) for m in (1, 2, 3)]
    A = [a[..., m] for m in range(4)]
    B = [b[..., m] for m in range(4)]

    def lazy(terms):
        acc = np.zeros(A[0].shape, dtype=np.uint64)
        for x, y in reversed(terms):
            acc = _mad(acc, x, y)
        return _redc(_fold(acc))

    return np.stack([
        lazy([(A[0], B[0]), (A[1], wb[3]), (A[2], wb[2]), (A[3], wb[1])]),
        lazy([(A[0], B[1]), (A[1], B[0]), (A[2], wb[3]), (A[3], wb[2])]),
        lazy([(A[0], B[2]), (A[1], B[1]), (A[2], B[0]), (A[3], wb[3])]),
        lazy([(A[0], B[3]), (A[1], B[2]), (A[2], B[1]), (A[3], B[0])])],
        axis=-1)


def _ext_inverse(a):
    """`ext_inverse`: the norm trick with the Frobenius constants."""
    from ethrex_tpu_torch.ops import ext

    fr = ext._FR_ALL.astype(np.uint64).reshape(3, 4)
    c1, c2, c3 = (_mont(a, fr[k]) for k in range(3))
    conj = _ext_mul_m(_ext_mul_m(c1, c2), c3)
    tail = _add(_add(_mont(a[..., 1], conj[..., 3]),
                     _mont(a[..., 2], conj[..., 2])),
                _mont(a[..., 3], conj[..., 1]))
    norm = _add(_mont(a[..., 0], conj[..., 0]), _mont(tail, _W_M))
    inv = _mpow(norm, bb.P - 2)
    return _mont(conj, inv[..., None])


def _ext_scans(v, lanes: int):
    """`warp_scans` over the 32 lanes of axis -2 (lanes below `lanes`
    scanned): inclusive prefix and suffix products, the shuffled value
    set to one where its lane does not exist."""
    inc, suf = v.copy(), v.copy()
    idx = np.arange(32)
    d = 1
    while d < lanes:
        u = np.concatenate([inc[..., :1, :].repeat(d, -2), inc[..., :-d, :]],
                           -2)
        w = np.concatenate([suf[..., d:, :], suf[..., -1:, :].repeat(d, -2)],
                           -2)
        u = np.where((idx < d)[:, None], _ONE_E, u)
        w = np.where((idx + d >= 32)[:, None], _ONE_E, w)
        inc, suf = _ext_mul_w(inc, u), _ext_mul_w(suf, w)
        d <<= 1
    return inc, suf


def model_k_ext_batch_inv(a):
    """`k_ext_batch_inv` over a (n, 4) uint64 Montgomery: element
    block * THREADS * CHUNK + c * THREADS + t is thread t's element c;
    returns the inverses, 0 for 0."""
    T, C = _EXT["THREADS"], _EXT["CHUNK"]
    warps = T // 32
    n = a.shape[0]
    nb = -(-n // (T * C))
    full = np.zeros((nb * T * C, 4), dtype=np.uint64)
    full[:n] = a                                # past n: zero, left out
    v = full.reshape(nb, C, T, 4).transpose(0, 2, 1, 3)   # [blk, t, c]
    zero = ~v.any(-1)
    pre = np.empty_like(v)
    run = np.broadcast_to(_ONE_E, (nb, T, 4)).copy()
    for c in range(C):
        pre[:, :, c] = run
        run = _ext_mul_w(run, np.where(zero[:, :, c, None], _ONE_E,
                                       v[:, :, c]))
    inc, suf = _ext_scans(run.reshape(nb, warps, 32, 4), 32)
    one = np.broadcast_to(_ONE_E, (nb, warps, 1, 4))
    before = np.concatenate([one, inc[:, :, :-1]], 2)
    after = np.concatenate([suf[:, :, 1:], one], 2)
    # warp 0: the warps' products on its first lanes, one elsewhere
    wt = np.broadcast_to(_ONE_E, (nb, 32, 4)).copy()
    wt[:, :warps] = inc[:, :, 31]
    wi, ws = _ext_scans(wt, warps)
    wb = np.concatenate([np.broadcast_to(_ONE_E, (nb, 1, 4)), wi[:, :-1]], 1)
    wa = np.concatenate([ws[:, 1:], ws[:, -1:]], 1)
    f = _ext_inverse(wi[:, warps - 1])[:, None]
    f = _ext_mul_w(_ext_mul_w(np.broadcast_to(f, wb.shape), wb), wa)
    inv = _ext_mul_w(_ext_mul_w(np.broadcast_to(
        f[:, :warps, None], before.shape), before), after).reshape(nb, T, 4)
    out = np.zeros_like(v)
    for c in range(C - 1, -1, -1):
        out[:, :, c] = np.where(zero[:, :, c, None], 0,
                                _ext_mul_w(pre[:, :, c], inv))
        inv = _ext_mul_w(np.where(zero[:, :, c, None], _ONE_E, v[:, :, c]),
                         inv)
    return out.transpose(0, 2, 1, 3).reshape(-1, 4)[:n]


def _ext_field(n, seed, zeros: bool):
    """(n, 4) ext elements; with zeros, zero elements at chunk, warp and
    block edges, an all-zero thread chunk, warp and block."""
    a = _field(seed, (n, 4)).astype(np.uint64)
    a[~a.any(-1)] = _ONE_E
    if not zeros:
        return a
    T, C, blk = _EXT["THREADS"], _EXT["CHUNK"], _EXT_BLOCK
    a[::max(1, n // 5)] = 0
    a[min(31, n - 1)] = a[min(32, n - 1)] = 0      # a warp's edge
    if n > blk:
        a[blk - 1] = a[blk] = 0                    # a block's edge
    if n > 2 * blk:
        for c in range(C):
            a[blk + c * T:blk + c * T + 32] = 0    # warp 0 of block 1
            a[blk + c * T + 40] = 0                # thread 40's chunk
        a[2 * blk:min(n, 3 * blk)] = 0             # a whole block
    return a


@pytest.mark.parametrize("n", [1, 33, _EXT_BLOCK - 1, _EXT_BLOCK,
                               _EXT_BLOCK + 1])
def test_ext_batch_inv_model_equals_jax_batch_inv(n):
    """Nonzero elements (the reference's contract): n below, at and
    above a block's span, a ragged last block."""
    from ethrex_tpu.ops import ext as jext

    a = _ext_field(n, n + 11, zeros=False)
    got = model_k_ext_batch_inv(a)
    want = np.asarray(jext.batch_inv(a.astype(np.uint32)))
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("n", [31, _EXT_BLOCK + 1, 3 * _EXT_BLOCK + 17])
def test_ext_batch_inv_model_with_zeros_equals_elementwise(n):
    """Zeros left out and mapped to 0, an all-zero chunk, warp and block
    among them: each element as the JAX package's element-wise inverse
    gives it."""
    from ethrex_tpu.ops import ext as jext

    a = _ext_field(n, n + 3, zeros=True)
    got = model_k_ext_batch_inv(a)
    want = np.asarray(jext.ext_inv_device(a.astype(np.uint32)))
    assert np.array_equal(got.astype(np.uint32), want)
    assert not got[~a.any(-1)].any()


def test_ext_batch_inv_model_worst_case_words():
    """Every word p - 1 (the largest raw products of the lazy sums), and
    one: still the reference's inverses."""
    from ethrex_tpu.ops import ext as jext

    a = np.full((_EXT_BLOCK + 3, 4), bb.P - 1, dtype=np.uint64)
    a[1::2] = _ONE_E
    got = model_k_ext_batch_inv(a)
    want = np.asarray(jext.batch_inv(a.astype(np.uint32)))
    assert np.array_equal(got.astype(np.uint32), want)


def _shfl_down_tree(v, steps):
    """A tree of shuffles down the last axis (32 lanes): at distance o
    lane l adds lane l + o's value times w (l + o past the warp: its
    own value, as the shuffle returns it), for (o, w) in steps."""
    lanes = np.arange(32)
    for o, w in steps:
        src = np.concatenate([v[..., o:], v[..., 32 - o:]], -1)
        src = np.where(lanes + o < 32, src, v)
        v = _add(v, _mont(src, w))
    return v


def model_k_eval_poly_at(coeffs, x_m: int, max_splits=None):
    """`k_eval_poly_at` over coeffs (rows, n) uint64 Montgomery at the
    Montgomery point x_m -> (rows,) Montgomery; `max_splits` (the
    source's MAX_SPLITS by default) set lower makes spans of several
    chunks at small n."""
    T, iters, lg = _PE["THREADS"], _PE["ITERS"], _PE["LOG_STRIDE"]
    max_splits = max_splits or _PE["MAX_SPLITS"]
    warps = T // 32
    assert _PE_STRIDE == 4 * T
    rows, n = coeffs.shape
    if rows == 0 or n == 0:
        return np.zeros(rows, dtype=np.uint64)
    chunks = -(-n // _PE_SPAN)
    mult = -(-chunks // max_splits)
    splits = -(-chunks // mult)
    L = max((splits * mult * _PE_SPAN - 1).bit_length(), lg + 1)
    assert L <= _PE["MAX_BITS"]
    # thread 0: the binary powers and the block's factor on one pass
    first = np.arange(splits, dtype=np.int64) * mult * _PE_SPAN
    pw, a = [], np.uint64(x_m % bb.P)
    factor = np.full(splits, _ONE, dtype=np.uint64)
    for j in range(L):
        pw.append(a)
        factor = np.where((first >> j) & 1 == 1, _mont(factor, a), factor)
        a = _mont(a, a)
    x = [_ONE, pw[0], pw[1], _mont(pw[0], pw[1])]
    v = np.zeros((rows, splits, T), dtype=np.uint64)
    for ch in range(mult - 1, -1, -1):          # Horner over the quads,
        i0 = (first + ch * _PE_SPAN)[:, None] + 4 * np.arange(T)[None, :]
        for k in range(iters - 1, -1, -1):      # the last first
            i = i0 + k * _PE_STRIDE
            q = np.zeros_like(v)
            for j in (3, 2, 1, 0):              # the innermost first
                cj = np.where(i + j < n,
                              coeffs[:, np.minimum(i + j, n - 1)], 0)
                q = _mad(q, cj, np.broadcast_to(x[j], cj.shape))
            v = _add(_mont(v, pw[lg]), _redc(_fold(q)))
    # lanes weigh x^(4 l) in a warp, warps x^(128 w) in the block
    v = _shfl_down_tree(v.reshape(rows, splits, warps, 32),
                        [(16 >> k, pw[6 - k]) for k in range(5)])
    w = np.zeros((rows, splits, 32), dtype=np.uint64)
    w[..., :warps] = v[..., 0]
    d, steps = warps // 2, []
    while d:
        steps.append((d, pw[lg - 1 - len(steps)]))
        d //= 2
    w = _shfl_down_tree(w, steps)
    block = _mont(w[..., 0], factor)
    # the row's word: 2^48 a block plus its residue, one 64-bit add each;
    # the count must not reach the sum's bits nor the sum the count's
    words = [sum((1 << 48) + int(b) for b in row) for row in block]
    mask = (1 << 48) - 1
    assert all(w < 2**64 and w >> 48 == splits for w in words)
    assert all((w & mask) == sum(int(b) for b in row)
               for w, row in zip(words, block))
    return np.array([w & mask for w in words], dtype=np.uint64) % P


@pytest.mark.parametrize("rows,n,worst", [
    (0, 16, False), (1, 1, False), (3, 7, False), (1, _PE_SPAN - 1, False),
    (2, _PE_SPAN, False), (2, 3 * _PE_SPAN + 5, False),
    (2, 2 * _PE_SPAN + 3, True)])
def test_eval_poly_at_model_equals_jax(rows, n, worst):
    """Rows 0 and 1, n below and at a span, a row split over several
    blocks with a tail, and every coefficient and the point p - 1."""
    import jax.numpy as jnp

    c = _field(rows * 31 + n, (rows, n)).astype(np.uint64)
    x = int(_field(n, (1,))[0])
    if worst:
        c[...] = bb.P - 1
        x = bb.P - 1
    got = model_k_eval_poly_at(c, x)
    want = np.asarray(jntt.eval_poly_at(jnp.asarray(c.astype(np.uint32)),
                                        jnp.uint32(x)))
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("max_splits,n", [(2, 5 * _PE_SPAN + 3),
                                          (3, 7 * _PE_SPAN)])
def test_eval_poly_at_model_spans_of_several_chunks(max_splits, n):
    """A row needing more than MAX_SPLITS spans takes several chunks a
    span (at a lowered MAX_SPLITS here, the kernel's at 2^28 and more
    coefficients a row): Horner runs on over the chunks, last first."""
    import jax.numpy as jnp

    c = _field(n, (2, n)).astype(np.uint64)
    x = int(_field(n + 1, (1,))[0])
    got = model_k_eval_poly_at(c, x, max_splits)
    want = np.asarray(jntt.eval_poly_at(jnp.asarray(c.astype(np.uint32)),
                                        jnp.uint32(x)))
    assert np.array_equal(got.astype(np.uint32), want)


def test_eval_poly_at_model_at_zero_and_one():
    """x = 0 gives each row's c_0 (every other power is 0); x = one the
    sum of the row."""
    c = _field(5, (2, _PE_SPAN + 9)).astype(np.uint64)
    assert np.array_equal(model_k_eval_poly_at(c, 0), c[:, 0])
    assert np.array_equal(model_k_eval_poly_at(c, bb.MONT_ONE),
                          c.sum(axis=1) % P)


@pytest.mark.parametrize("splits", [1, 16, 3000, 1 << 20])
def test_eval_poly_at_index_bits_cover_every_start(splits):
    """A block keeps L binary powers: the bits of every span's first
    index (its factor), x^STRIDE (Horner over the quads) and the trees'
    weights x^(4 d) and x^(128 d); the bits of an index give it back, and
    the weights of a thread's quads, lane and warp add up to its index
    in the span."""
    T, lg = _PE["THREADS"], _PE["LOG_STRIDE"]
    L = max((splits * _PE_SPAN - 1).bit_length(), lg + 1)
    assert L <= _PE["MAX_BITS"] and 6 < L
    first = np.arange(min(splits, 1 << 12), dtype=np.int64) * _PE_SPAN
    first = np.concatenate([first, [(splits - 1) * _PE_SPAN]])
    back = sum(((first >> j) & 1) << j for j in range(L))
    assert np.array_equal(back, first)
    t, k = np.arange(T), np.arange(_PE["ITERS"])
    lane, warp = t % 32, t // 32
    idx = k[:, None] * _PE_STRIDE + 4 * lane[None, :] + 128 * warp[None, :]
    assert np.array_equal(np.sort(idx.ravel()), np.arange(0, _PE_SPAN, 4))


def test_inv_eval_plan_sizes():
    """The sizes both models assume are the sources'."""
    assert _EXT["THREADS"] % 32 == 0 and _EXT["THREADS"] // 32 <= 32
    assert _PE["THREADS"] % 32 == 0 and _PE_STRIDE == 4 * _PE["THREADS"]
    # a row's word: a 16-bit count of its blocks over the 48-bit sum of
    # their residues
    assert _PE["MAX_SPLITS"] < 2**16
    assert _PE["MAX_SPLITS"] * (bb.P - 1) < 2**48
    # a quad's lazy sum and a thread's folded sum never wrap
    q = (bb.P - 1) ** 2
    assert 4 * q < 2**64 and (1 << 60) + q < 2**64
