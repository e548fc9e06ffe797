"""The plan of kernel K5 (`csrc/bn254_msm.cu`, the signed-window bucket
MSM over BN254 G1 and G2) rehearsed on the CPU in Python integers.

The model below runs the kernel's steps in the kernel's order, with the
window width, tile, chunk and segment sizes read from the CUDA source:
the table of bases pre-shifted per window in affine form (`k_shift`,
`k_affine`), the signed recoding with its carries (`k_digits`), the
counting sort by tile histograms, scan and ranks (`k_digits`, `k_scan`,
`k_scatter`), the chunks of each bucket by mixed additions with their
complete cases and the shuffle tree over them (`k_bucket_acc`), the
segmented running sums, the suffix scan and the tree over a warp's lanes
(`k_window_sum`), and the tree over the windows (`k_combine`).  Its
affine result is held equal to the reference's
`ethrex_tpu.ops.bn254_msm.msm` and `g2_msm`, which run their numpy
substrate on the CPU.  The plain versions of the table and of the MSM
over it (`msm_bases_plain`, `msm_with_bases_plain`) are held to the same.

Bar: equality of affine points; all arithmetic is exact.  The model's
field is the plain one (the kernel's Montgomery forms scale every
coordinate by the same R, which the homogeneous formulas carry through
unchanged).
"""

import re

import numpy as np
import pytest
import torch

from ethrex_tpu.crypto import bn254 as jbn254
from ethrex_tpu.crypto import groth16 as jgroth16
from ethrex_tpu.ops import bn254_msm as jmsm
from ethrex_tpu_torch import convert
from ethrex_tpu_torch import kernels
from ethrex_tpu_torch.crypto import bn254
from ethrex_tpu_torch.ops import bn254_msm as msm

P = bn254.P
R = bn254.R


def _cu_constants() -> dict:
    """The `constexpr int` constants of csrc/bn254_msm.cu."""
    src = (kernels.CSRC / "bn254_msm.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}


C = _cu_constants()
BITS, WINDOWS, BUCKETS = C["kWindowBits"], C["kWindows"], C["kBuckets"]
TILE, CHUNKS, SEGMENT = C["kTile"], C["kChunks"], C["kSegment"]
LANES = 32


class Fp:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def is_zero(a):
        return a == 0


class Fp2:
    zero, one = bn254.Fp2(0, 0), bn254.Fp2(1, 0)

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def is_zero(a):
        return a.is_zero()


def _inf(F):
    return (F.zero, F.zero, F.zero)


def pdbl(F, p):
    """csrc/bn254.cuh `pdbl`."""
    X, Y, Z = p
    if F.is_zero(Z):
        return p
    A, B = F.mul(X, X), F.mul(Y, Y)
    Cc = F.mul(B, B)
    xb = F.add(X, B)
    t = F.sub(F.mul(xb, xb), F.add(A, Cc))
    D = F.add(t, t)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.mul(E, E), F.add(D, D))
    c4 = F.add(F.add(Cc, Cc), F.add(Cc, Cc))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.add(c4, c4))
    return (X3, Y3, F.mul(F.add(Y, Y), Z))


def padd(F, p1, p2):
    """csrc/bn254.cuh `padd`: complete over infinity, P == Q, P == -Q."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if F.is_zero(Z1):
        return p2
    if F.is_zero(Z2):
        return p1
    Z1Z1, Z2Z2 = F.mul(Z1, Z1), F.mul(Z2, Z2)
    U1, U2 = F.mul(X1, Z2Z2), F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H, Rr = F.sub(U2, U1), F.sub(S2, S1)
    if F.is_zero(H):
        return pdbl(F, p1) if F.is_zero(Rr) else _inf(F)
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.mul(Rr, Rr), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(Rr, F.sub(V, X3)), F.mul(S1, HHH))
    return (X3, Y3, F.mul(F.mul(Z1, Z2), H))


def madd(F, p1, X2, Y2):
    """csrc/bn254.cuh `madd`: `padd` with Z2 = 1, the same cases."""
    X1, Y1, Z1 = p1
    if F.is_zero(Z1):
        return (X2, Y2, F.one)
    Z1Z1 = F.mul(Z1, Z1)
    U2 = F.mul(X2, Z1Z1)
    S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H, Rr = F.sub(U2, X1), F.sub(S2, Y1)
    if F.is_zero(H):
        return pdbl(F, p1) if F.is_zero(Rr) else _inf(F)
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(X1, HH)
    X3 = F.sub(F.sub(F.mul(Rr, Rr), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(Rr, F.sub(V, X3)), F.mul(Y1, HHH))
    return (X3, Y3, F.mul(Z1, H))


def window_bits(s: int, w: int) -> int:
    return (s >> (BITS * w)) & ((1 << BITS) - 1)


def model_digits(words: np.ndarray, live: list[bool]) -> list[list[int]]:
    """k_digits: each scalar's signed digits, window by window with the
    carry; zero for a point at infinity."""
    out = []
    for row, ok in zip(words, live):
        s = sum(int(v) << (32 * k) for k, v in enumerate(row))
        carry, digits = 0, []
        for w in range(WINDOWS):
            raw = window_bits(s, w) + carry
            d, carry = (raw - (1 << BITS), 1) if raw > BUCKETS else (raw, 0)
            digits.append(d if ok else 0)
        assert carry == 0, "the top window carried out"
        out.append(digits)
    return out


def model_sort(digits: list[list[int]]):
    """k_digits' tile histograms and ranks, k_scan's exclusive scan in
    (window, bucket, tile) order, k_scatter's placement.  Returns the
    entry list [(point, negative)] and the bucket starts."""
    n = len(digits)
    n_tiles = -(-n // TILE)
    hist = np.zeros((WINDOWS, BUCKETS, n_tiles), dtype=np.int64)
    ranks = {}
    for w in range(WINDOWS):
        for tile in range(n_tiles):
            seen = {}
            for i in range(tile * TILE, min(n, (tile + 1) * TILE)):
                key = abs(digits[i][w])
                if key:
                    ranks[w, i] = seen.get(key, 0)
                    seen[key] = ranks[w, i] + 1
                    hist[w, key - 1, tile] += 1
    flat = hist.reshape(-1)
    offs = np.concatenate([[0], np.cumsum(flat)[:-1]]).reshape(hist.shape)
    bstart = list(offs[:, :, 0].reshape(-1)) + [int(flat.sum())]
    entries = [None] * int(flat.sum())
    for i in range(n):
        for w in range(WINDOWS):
            d = digits[i][w]
            if d:
                pos = offs[w, abs(d) - 1, i // TILE] + ranks[w, i]
                assert entries[pos] is None
                entries[pos] = (i, d < 0)
    # a counting sort: each bucket lists its points in index order
    want = [(i, digits[i][w] < 0) for w in range(WINDOWS)
            for _, i in sorted((abs(digits[i][w]), i) for i in range(n)
                               if digits[i][w])]
    assert entries == want
    return entries, [int(v) for v in bstart]


def model_bases(F, pts):
    """k_shift and k_affine: Q[w][i] = 2^(BITS w) P_i as affine (x, y),
    None at infinity."""
    table = []
    for w in range(WINDOWS):
        if w:
            pts = [p for p in pts]
            for _ in range(BITS):
                pts = [pdbl(F, p) for p in pts]
        table.append([_affine(F, p) for p in pts])
    return table


def model_buckets(F, table, entries, bstart):
    """k_bucket_acc: CHUNKS lanes a bucket, each a share of the list by
    mixed additions of its window's bases, then the shuffle tree over
    the lanes."""
    sums = []
    for g in range(WINDOWS * BUCKETS):
        s, length = bstart[g], bstart[g + 1] - bstart[g]
        acc = []
        for j in range(CHUNKS):
            a = _inf(F)
            for k in range(s + length * j // CHUNKS,
                           s + length * (j + 1) // CHUNKS):
                i, negative = entries[k]
                x, y = table[g // BUCKETS][i]
                a = madd(F, a, x, F.sub(F.zero, y) if negative else y)
            acc.append(a)
        d = CHUNKS // 2
        while d >= 1:
            acc = [padd(F, acc[j], acc[j + d]) for j in range(d)]
            d //= 2
        sums.append(acc[0])
    return sums


def model_window(F, b):
    """k_window_sum over one window's buckets b[0..BUCKETS-1] (bucket
    k + 1 at b[k]): sum_k (k + 1) b[k]."""
    T, Wt = [], []
    for lane in range(LANES):
        run = acc = _inf(F)
        for k in reversed(range(lane * SEGMENT, (lane + 1) * SEGMENT)):
            run = padd(F, run, b[k])
            acc = padd(F, acc, run)
        T.append(run)
        Wt.append(acc)
    x, d = list(T), 1
    while d < LANES:            # inclusive suffix scan (shuffles down)
        x = [padd(F, x[s], x[s + d]) if s + d < LANES else x[s]
             for s in range(LANES)]
        d *= 2
    v = []
    for lane in range(LANES):
        u = x[lane + 1] if lane + 1 < LANES else _inf(F)
        k = 1
        while k < SEGMENT:
            u = pdbl(F, u)
            k *= 2
        v.append(padd(F, Wt[lane], u))
    d = LANES // 2
    while d >= 1:               # lane 0's tree
        v = [padd(F, v[s], v[s + d]) for s in range(d)]
        d //= 2
    return v[0]


def model_msm(F, pts, words):
    """The whole plan on Jacobian points (X, Y, Z) over F; returns the
    Jacobian sum."""
    table = model_bases(F, pts)
    live = [q is not None for q in table[0]]
    entries, bstart = model_sort(model_digits(words, live))
    sums = model_buckets(F, table, entries, bstart)
    v = [model_window(F, sums[w * BUCKETS:(w + 1) * BUCKETS])
         for w in range(WINDOWS)]
    d = LANES // 2
    while d >= 1:               # k_combine: lane w holds S_w
        v = [padd(F, v[s], v[s + d]) for s in range(d)]
        d //= 2
    return v[0]


def _affine(F, p):
    X, Y, Z = p
    if F.is_zero(Z):
        return None
    if F is Fp:
        zi = pow(Z, P - 2, P)
        return (X * zi * zi % P, Y * zi * zi * zi % P)
    zi = Z.inv()
    return (X * zi * zi, Y * zi * zi * zi)


def _jacobian(F, pt, lam=None):
    """A host affine point as (X, Y, Z), scaled by lam if given."""
    if pt is None:
        return _inf(F)
    if lam is None:
        return (pt[0], pt[1], F.one)
    l2 = F.mul(lam, lam)
    return (F.mul(pt[0], l2), F.mul(pt[1], F.mul(l2, lam)), lam)


def _run_g1(pts, scalars, scale=False):
    lams = [int(3 + 2 * k) if scale and k % 2 else None
            for k in range(len(pts))]
    jac = [_jacobian(Fp, p, lam) for p, lam in zip(pts, lams)]
    got = _affine(Fp, model_msm(Fp, jac, msm.scalars_to_words(scalars)))
    assert got == jmsm.msm(pts, scalars)
    return got


def test_constants_fit_the_plan():
    assert WINDOWS * BITS >= 255 and (WINDOWS - 1) * BITS < 255
    assert WINDOWS == LANES                 # k_combine: a lane a window
    assert (msm.WINDOWS, msm.WINDOW_BITS) == (WINDOWS, BITS)
    assert BUCKETS == 1 << (BITS - 1)
    assert SEGMENT * LANES == BUCKETS
    assert LANES % CHUNKS == 0 and TILE > BUCKETS
    # every scalar below r recodes without a carry out of the top window
    model_digits(msm.scalars_to_words([R - 1, (1 << 254) % R]), [True] * 2)


def _g1_points(rng, n):
    return [jbn254.g1_mul((1, 2), int(rng.integers(1, 1 << 30)))
            for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 37, 300])
def test_plan_matches_reference_g1(n):
    rng = np.random.default_rng(100 + n)
    pts = _g1_points(rng, n)
    scalars = [int.from_bytes(rng.bytes(40), "big") % R for _ in range(n)]
    got = _run_g1(pts, scalars)
    host = None
    for pt, s in zip(pts, scalars):
        host = bn254.g1_add(host, bn254.g1_mul(pt, s))
    assert got == host


def _edge_cases():
    g = (1, 2)
    neg_g = (1, P - 2)
    top = (1 << 253) | (0xFF << 240)       # window 30 carries into 31
    many = [jbn254.g1_mul(g, k) for k in range(1, 11)]
    return {
        "zeros": ([g, many[6]], [0, 0]),
        "r_minus_1": ([g, many[2]], [R - 1, R - 1]),
        "top_carry": ([g, g, many[2]], [top, R - 2, top - 1]),
        "duplicates": ([g] * 5 + [many[4]] * 4, [3, 3, 3, 5, 3, 3, 3, 3, 7]),
        "p_and_minus_p": ([g, many[1], neg_g], [5, 9, 5]),
        "cancel": ([g, g], [5, R - 5]),
        "none": ([None, g, None], [3, 2, 9]),
        "all_none": ([None, None], [3, 2]),
        "n_above_2c": ([many[k % 10] for k in range(300)],
                       [(k * 7919) % 256 for k in range(300)]),
    }


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_plan_edge_cases_match_reference(case):
    pts, scalars = _edge_cases()[case]
    got = _run_g1(pts, scalars)
    if case in ("zeros", "cancel", "all_none"):
        assert got is None


def test_plan_takes_jacobian_points():
    # points whose Z is not one (every other point scaled by lam) are
    # made affine in the table; the sum is the same group element
    rng = np.random.default_rng(9)
    pts = _g1_points(rng, 12) + [(1, 2), (1, P - 2)]
    scalars = [int(v) for v in rng.integers(1, 1 << 40, size=12)] + [7, 7]
    _run_g1(pts, scalars, scale=True)


def test_plan_matches_reference_g2():
    rng = np.random.default_rng(7)
    pts = [jbn254.g2_mul(jgroth16.G2, int(rng.integers(1, 1 << 20)))
           for _ in range(37)] + [None]
    pts[5] = pts[3]                         # a duplicate in every bucket
    scalars = [int.from_bytes(rng.bytes(40), "big") % R for _ in range(38)]
    scalars[5] = scalars[3]
    ours = [convert.g2_point(p) for p in pts]
    jac = [_jacobian(Fp2, p) for p in ours]
    got = _affine(Fp2, model_msm(Fp2, jac, msm.scalars_to_words(scalars)))
    assert got == convert.g2_point(jmsm.g2_msm(pts, scalars))


def test_plan_g2_opposite_points_cancel():
    q = convert.g2_point(jbn254.g2_mul(jgroth16.G2, 11))
    neg = (q[0], -q[1])
    jac = [_jacobian(Fp2, p) for p in (q, neg, q)]
    got = model_msm(Fp2, jac, msm.scalars_to_words([6, 6, 2]))
    want = jmsm.g2_msm([jbn254.g2_mul(jgroth16.G2, 11)], [2])
    assert _affine(Fp2, got) == convert.g2_point(want)


def _bases_tensors(pts, fp2=False):
    conv = msm.g2_points_to_device if fp2 else msm.points_to_device
    return conv(pts, "cpu")


def _from_words(w) -> int:
    return sum((int(v) & 0xFFFFFFFF) << (32 * k) for k, v in enumerate(w))


def test_plain_bases_table_is_the_shifted_points():
    rng = np.random.default_rng(11)
    pts = _g1_points(rng, 3) + [None]
    table = msm.msm_bases_plain(*_bases_tensors(pts))
    assert tuple(table.shape) == (WINDOWS, 4, 2, 8)
    rinv = pow(1 << 256, -1, P)
    for w in (0, 1, 17, WINDOWS - 1):
        for i, pt in enumerate(pts):
            x, y = (_from_words(table[w, i, k].numpy()) * rinv % P
                    for k in (0, 1))
            want = None if pt is None else jbn254.g1_mul(pt, 1 << (BITS * w))
            assert (None if x == y == 0 else (x, y)) == want


@pytest.mark.parametrize("fp2", [False, True])
def test_plain_msm_over_bases_matches_reference(fp2):
    rng = np.random.default_rng(12)
    if fp2:
        ref = [jbn254.g2_mul(jgroth16.G2, int(rng.integers(1, 1 << 20)))
               for _ in range(3)] + [None]
        pts = [convert.g2_point(p) for p in ref]
    else:
        ref = pts = _g1_points(rng, 3) + [None]
    scalars = [int(v) for v in rng.integers(1, 1 << 30, size=4)]
    table = msm.msm_bases(*_bases_tensors(pts, fp2), fp2)   # plain, CPU
    words = torch.from_numpy(msm.scalars_to_words(scalars).view(np.int32))
    got = msm.msm_with_bases(table, words, fp2)             # plain, CPU
    want = msm.msm_device(*_bases_tensors(pts, fp2), words, fp2)
    assert msm.same_point(got, want, fp2)
    ours = msm.g2_msm(pts, scalars, device="cpu") if fp2 else \
        msm.msm(pts, scalars, device="cpu")
    theirs = jmsm.g2_msm(ref, scalars) if fp2 else jmsm.msm(ref, scalars)
    assert ours == (convert.g2_point(theirs) if fp2 else theirs)
