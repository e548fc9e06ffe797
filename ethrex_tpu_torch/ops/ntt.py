"""BabyBear NTT / iNTT / coset LDE over the last axis.

Port of `ethrex_tpu/ops/ntt.py`.  Every transform is one call of
`scaled_ntt`:

    y = post * NTT_{n_out}(zero_pad(pre * x))        (over the last axis)

which on a CUDA tensor launches kernel K1 (`csrc/ntt.cu`) once per pass of
`ntt_plan` (two passes up to 2^22 points, three up to 2^33: the bit
reversal, the pre-scale and the zero pad fused into the first pass's
loads, the post-scale into the last pass's stores) and on a CPU tensor
runs the plain version, the same in-order radix-2 Cooley-Tukey as the JAX
function.  An in-order DFT has exactly one right answer, so both equal the
JAX programs bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import babybear as bb


@functools.lru_cache(maxsize=None)
def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _stage_twiddles(log_n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Montgomery twiddles for each DIT stage s: w_{2^{s+1}}^j, j < 2^s."""
    root = bb.root_of_unity(log_n)
    if inverse:
        root = bb.inv_host(root)
    tw = []
    for s in range(log_n):
        m = 1 << (s + 1)
        w_m = pow(root, (1 << log_n) // m, bb.P)
        tw.append(bb.to_mont_host(bb.powers_host(w_m, m // 2)))
    return tuple(tw)


_DEVICE_CACHE: dict = {}


def _cached(key, device, make):
    """Per-device cache of host-precomputed constant tensors."""
    full = key + (str(device),)
    t = _DEVICE_CACHE.get(full)
    if t is None:
        t = bb.from_numpy(make(), device)
        _DEVICE_CACHE[full] = t
    return t


def scaled_ntt_plain(x, inverse: bool = False, n_out: int | None = None,
                     pre=None, post=None):
    """Plain PyTorch version of `scaled_ntt` (same arguments): the
    in-order radix-2 Cooley-Tukey of the JAX function, stage by stage."""
    m = x.shape[-1]
    n = m if n_out is None else int(n_out)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, m)
    rows = x2.shape[0]
    log_n = n.bit_length() - 1
    if pre is not None:
        x2 = bb.mont_mul(x2, pre)
    if n > m:
        x2 = torch.cat([x2, torch.zeros((rows, n - m), dtype=bb.I32,
                                        device=x2.device)], dim=1)
    if log_n:
        perm = torch.from_numpy(_bitrev_perm(log_n)).to(x2.device)
        x2 = x2[:, perm]
        twiddles = _stage_twiddles(log_n, inverse)
        for s in range(log_n):
            half = 1 << s
            w = bb.from_numpy(twiddles[s], x2.device)
            xs = x2.reshape(rows, n // (2 * half), 2 * half)
            u = xs[..., :half]
            t = bb.mont_mul(xs[..., half:], w)
            x2 = torch.cat([bb.add(u, t), bb.sub(u, t)], dim=-1)
            x2 = x2.reshape(rows, n)
    if post is not None:
        x2 = bb.mont_mul(x2, post)
    return x2.reshape(lead + (n,))


# the pass plan of kernel K1: at most NTT_MAX_L stages a pass, a tile of
# at most NTT_TILE_ELEMS words (G columns of 2^L) in shared memory, and
# G in [1, NTT_MAX_G] neighbouring columns (or tiles) per block so that
# each global access is a run of G words
NTT_MAX_L = 11
NTT_TILE_ELEMS = 1 << 14
NTT_MAX_G = 32
NTT_RADIX_LOG = 3            # stages per register round inside a pass
                             # (the kernel takes 1-3)


def ntt_plan(log_n: int) -> list[tuple[int, int, int]]:
    """Kernel K1's passes over a 2^log_n-point transform: (S, L, G) each,
    S the stages done before the pass, L the stages it does, G the
    columns per block.

    Pass 1 (S = 0) loads G whole tiles of 2^L bit-reversed inputs: input
    j = rev_L(l) 2^(log_n - L) + o + g for tile position l, so each run of
    G inputs is contiguous.  Pass p > 1 loads, for G neighbouring columns
    c, the 2^L elements c + 2^S jj of each block of 2^(S + L), pre-twiddles
    element jj by w_(2^(S+L))^(rev_L(jj) c) and transforms it in place.
    Every pass does its L stages as a bit-reversed-input DIT in shared
    memory, NTT_RADIX_LOG stages per register round."""
    if log_n == 0:
        return [(0, 0, 1)]
    passes = -(-log_n // NTT_MAX_L)
    plan, S = [], 0
    for i in range(passes):
        L = -(-(log_n - S) // (passes - i))
        avail = (1 << (log_n - L)) if S == 0 else (1 << S)
        G = max(1, min(NTT_MAX_G, NTT_TILE_ELEMS >> L, avail))
        plan.append((S, L, G))
        S += L
    return plan


def spread_first_pass(m: int, log_n: int, L: int) -> bool:
    """Pass 1 of a transform with m <= n / 8 inputs (an LDE of blowup 8 or
    more): its nonzero inputs sit at tile positions that are multiples of
    8, so the kernel's load copies each to its 8 neighbours in place of
    stages 0-2, and the register rounds start at stage 3."""
    return L >= 3 and m << 3 <= 1 << log_n


def radix_rounds(L: int, start: int = 0) -> list[tuple[int, int]]:
    """(first stage, stages) of each register round of an L-stage pass
    whose rounds start at stage `start`."""
    rounds, sa = [], start
    while sa < L:
        R = min(NTT_RADIX_LOG, L - sa)
        rounds.append((sa, R))
        sa += R
    return rounds


def pretwiddle_split(log_m: int) -> int:
    """Low bits h of the two-level table w^e = lo[e % 2^h] * hi[e >> h]
    over e < 2^log_m."""
    return (log_m + 1) // 2


def _root(log_n: int, inverse: bool) -> int:
    root = bb.root_of_unity(log_n)
    return bb.inv_host(root) if inverse else root


def _local_twiddles(L: int, inverse: bool, device):
    """w_(2^L)^e for e < 2^(L-1) (Montgomery): the butterflies of a pass."""
    return _cached(("ltw", L, inverse), device, lambda: bb.to_mont_host(
        bb.powers_host(_root(L, inverse), max(1, (1 << L) // 2))))


def _pretwiddle_tables(log_m: int, inverse: bool, device):
    """(lo, hi) with lo[e] = w^e, hi[e] = w^(e 2^h), w = w_(2^log_m)."""
    h = pretwiddle_split(log_m)
    w = _root(log_m, inverse)
    lo = _cached(("ptw_lo", log_m, inverse), device, lambda: bb.to_mont_host(
        bb.powers_host(w, 1 << h)))
    hi = _cached(("ptw_hi", log_m, inverse), device, lambda: bb.to_mont_host(
        bb.powers_host(pow(w, 1 << h, bb.P), 1 << (log_m - h))))
    return lo, hi, h


def scaled_ntt(x, inverse: bool = False, n_out: int | None = None,
               pre=None, post=None):
    """post * NTT_{n_out}(zero_pad(pre * x)) over the last axis of x.

    x: (..., m) int32 Montgomery; n_out >= m a power of two (default m);
    pre: (m,) Montgomery or None; post: (n_out,), (1,) or None.  The
    inverse transform uses the inverse root and applies no 1/n itself
    (callers fold it into `post` or `pre`)."""
    m = x.shape[-1]
    n = m if n_out is None else int(n_out)
    log_n = n.bit_length() - 1
    if 1 << log_n != n or n < m:
        raise ValueError(f"NTT size must be a power of 2 >= {m}, got {n}")
    if x.device.type != "cuda":
        return scaled_ntt_plain(x, inverse, n, pre, post)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, m)
    kernels.require_int32_cuda(x2, "ntt input")
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    dev = x.device
    out = torch.empty((rows, n), dtype=bb.I32, device=dev)
    if pre is not None:
        pre = pre.contiguous()
        if pre.numel() != m:
            raise ValueError("pre-scale length must equal the input length")
    if post is not None:
        post = post.contiguous()
        if post.numel() not in (1, n):
            raise ValueError("post-scale length must be 1 or n_out")
    if rows == 0:
        return out.reshape(lead + (n,))
    plan = ntt_plan(log_n)
    for i, (S, L, G) in enumerate(plan):
        first, last = i == 0, i == len(plan) - 1
        tw = _local_twiddles(L, inverse, dev)
        if first:
            lo = hi = tw
            h = 0
        else:
            lo, hi, h = _pretwiddle_tables(S + L, inverse, dev)
        kernels.call(
            "ntt_pass", dev, kernels.ptr(x2) if first else None,
            x2.stride(0), m, kernels.ptr(out), rows, log_n, S, L, G,
            kernels.ptr(pre) if first and pre is not None else None,
            kernels.ptr(post) if last and post is not None else None,
            1 if post is not None and post.numel() == 1 else 0,
            kernels.ptr(tw), kernels.ptr(lo), kernels.ptr(hi), h,
            1 if first and spread_first_pass(m, log_n, L) else 0,
            NTT_RADIX_LOG)
    kernels.count("ntt")
    return out.reshape(lead + (n,))


def _n_inv(log_n: int, device):
    return _cached(("ninv", log_n), device, lambda: bb.to_mont_host(
        np.array([bb.inv_host(1 << log_n)], dtype=np.uint64)))


def ntt(x, inverse: bool = False):
    """In-order NTT (or iNTT, including the 1/n) over the last axis."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of 2, got {n}")
    if log_n == 0:
        return x
    post = _n_inv(log_n, x.device) if inverse else None
    return scaled_ntt(x, inverse=inverse, post=post)


def intt(x):
    return ntt(x, inverse=True)


def _coset_powers_np(log_n: int, shift: int) -> np.ndarray:
    return bb.to_mont_host(bb.powers_host(shift, 1 << log_n))


def lde_prescale(log_n: int, shift: int, device):
    """shift^i / n (Montgomery): the iNTT's 1/n and the coset powers of
    `coset_lde`, folded into one pre-scale of its forward transform."""
    n = 1 << log_n
    return _cached(("lde_pre", log_n, shift), device, lambda: bb.to_mont_host(
        bb.powers_host(shift, n).astype(np.uint64)
        * bb.inv_host(n) % bb.P))


def coset_lde(x, log_blowup: int, shift: int = bb.GENERATOR):
    """Low-degree extension onto the coset shift*H' of size n*2^log_blowup
    (natural order).  x: evaluations over the size-n subgroup."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    coeffs = scaled_ntt(x, inverse=True)
    return scaled_ntt(coeffs, n_out=n << log_blowup,
                      pre=lde_prescale(log_n, shift % bb.P, x.device))


def coset_intt(x, shift: int = bb.GENERATOR):
    """Evaluations over the coset shift*H (natural order) -> coefficients."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    shift %= bb.P
    post = _cached(("cintt_post", log_n, shift), x.device,
                   lambda: bb.to_mont_host(
                       bb.powers_host(bb.inv_host(shift), n).astype(np.uint64)
                       * bb.inv_host(n) % bb.P))
    return scaled_ntt(x, inverse=True, post=post)


def coset_evals_from_coeffs(coeffs, n_out: int, shift: int = bb.GENERATOR):
    """Coefficients (..., m), m <= n_out -> evaluations on the coset
    shift*H' with |H'| = n_out, natural order."""
    m = coeffs.shape[-1]
    log_out = n_out.bit_length() - 1
    shift %= bb.P
    pre = _cached(("cpow_m", log_out, shift, m), coeffs.device,
                  lambda: _coset_powers_np(log_out, shift)[:m])
    return scaled_ntt(coeffs, n_out=n_out, pre=pre)


def _point_mont(point) -> int:
    """A base-field point given in Montgomery form (int or 0-dim tensor)
    -> its canonical value."""
    if isinstance(point, torch.Tensor):
        point = int(point.item())
    return int(bb.from_mont_host(np.array([int(point) & 0xFFFFFFFF],
                                          dtype=np.uint32))[0])


def eval_poly_at_plain(coeffs, point):
    """Plain version of `eval_poly_at`: the power table times the
    coefficients, summed mod p."""
    n = coeffs.shape[-1]
    pows = bb.from_numpy(bb.to_mont_host(bb.powers_host(_point_mont(point),
                                                        n)), coeffs.device)
    return bb.sum_mod(bb.mont_mul(coeffs, pows), dim=-1)


def eval_poly_at(coeffs, point):
    """Polynomials at one base-field point: coeffs (..., n) Montgomery,
    point a Montgomery scalar (int or 0-dim tensor) -> (...) Montgomery.
    The reference runs a Horner scan; the value is unique, so any order
    of the sum gives it.  Kernel `eval_poly_at` on a CUDA tensor: each
    row split over several blocks, the powers made on the card from the
    point (by value, or read by the kernel from a 0-dim device tensor),
    so the call builds no host table and does not sync."""
    if coeffs.device.type != "cuda":
        return eval_poly_at_plain(coeffs, point)
    kernels.require_int32_cuda(coeffs, "eval_poly_at")
    n = coeffs.shape[-1]
    lead = coeffs.shape[:-1]
    c = coeffs.reshape(-1, n)
    if c.stride(-1) != 1:
        c = c.contiguous()
    rows = c.shape[0]
    dev = coeffs.device
    xp, xv = None, 0
    if isinstance(point, torch.Tensor) and point.device.type == "cuda":
        if point.numel() != 1 or point.device != dev:
            raise ValueError("eval_poly_at: the point must be one element "
                             "on the coefficients' device")
        xp = point.reshape(()).to(torch.int32)
    else:
        xv = int(point.item() if isinstance(point, torch.Tensor)
                 else point) & 0xFFFFFFFF
    if n == 0 or rows == 0:
        return torch.zeros(lead, dtype=bb.I32, device=dev)
    out = torch.empty((rows,), dtype=bb.I32, device=dev)
    # each row's count of finished blocks and sum, in one 64-bit word
    words = torch.zeros(rows, dtype=torch.int64, device=dev)
    aligned = c.data_ptr() % 16 == 0 and (rows == 1 or c.stride(0) % 4 == 0)
    kernels.call("eval_poly_at", dev, kernels.ptr(c), c.stride(0), n, rows,
                 None if xp is None else kernels.ptr(xp), xv, int(aligned),
                 kernels.ptr(words), kernels.ptr(out))
    kernels.count("eval_poly_at")
    return out.reshape(lead)


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

def _ntt_host(vals: np.ndarray, root: int) -> np.ndarray:
    """Canonical in-order radix-2 DFT with `root` (numpy, uint64 lanes)."""
    n = len(vals)
    log_n = n.bit_length() - 1
    p = np.uint64(bb.P)
    x = np.asarray(vals, dtype=np.uint64)[_bitrev_perm(log_n)] % p
    for s in range(log_n):
        half = 1 << s
        w = bb.powers_host(pow(root, n // (2 * half), bb.P), half)
        xs = x.reshape(n // (2 * half), 2 * half)
        u = xs[:, :half]
        t = (xs[:, half:] * w.astype(np.uint64)) % p
        x = np.concatenate([(u + t) % p, (u + p - t) % p], axis=1).reshape(n)
    return x


def interpolate_host(values: np.ndarray) -> np.ndarray:
    """Canonical host interpolation: evaluations over the size-p subgroup
    (natural order) -> coefficient vector.

    The JAX function runs an O(p^2) inverse DFT; this O(p log p) one gives
    the same unique coefficients and stays fast for length-n columns."""
    p_len = len(values)
    log_p = p_len.bit_length() - 1
    if 1 << log_p != p_len:
        raise ValueError("periodic length must be a power of two")
    vals = np.asarray([int(v) % bb.P for v in values], dtype=np.uint64)
    w_inv = bb.inv_host(bb.root_of_unity(log_p))
    out = _ntt_host(vals, w_inv)
    return ((out * np.uint64(bb.inv_host(p_len))) % np.uint64(bb.P)).astype(
        np.uint32)


def domain_points(log_size: int, shift: int) -> np.ndarray:
    """Canonical evaluation-domain points shift * g^i (host numpy)."""
    g = bb.root_of_unity(log_size)
    pts = bb.powers_host(g, 1 << log_size).astype(np.uint64)
    return ((pts * (shift % bb.P)) % bb.P).astype(np.uint32)
