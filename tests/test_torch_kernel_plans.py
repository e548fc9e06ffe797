"""The index math of kernels K1 (NTT) and K2 (Merkle subtrees), and the
lazy 64-bit sums of K3 (modular matmul) and K6 (the AIR constraints'
alpha combination), rehearsed on the CPU.

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
