"""BabyBear NTT / iNTT / coset LDE over the last axis.

Port of `ethrex_tpu/ops/ntt.py`.  Every transform is one call of
`scaled_ntt`:

    y = post * NTT_{n_out}(zero_pad(pre * x))        (over the last axis)

which on a CUDA tensor launches kernel K1 (`csrc/ntt.cu`: bit-reversal
gather with the pre-scale and zero pad fused in, the radix-2 stages, the
post-scale) and on a CPU tensor runs the plain version, the same in-order
radix-2 Cooley-Tukey as the JAX function.  An in-order DFT has exactly one
right answer, so both equal the JAX programs bit for bit.
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


def _twiddle_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """All stage twiddles back to back (stage s at offset 2^s - 1)."""
    def make():
        tw = _stage_twiddles(log_n, inverse)
        return np.concatenate(tw) if tw else np.zeros(1, np.uint32)
    return _cached(("tw", log_n, inverse), device, make)


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
    out = torch.empty((rows, n), dtype=bb.I32, device=x.device)
    dev = x.device
    if pre is not None:
        pre = pre.contiguous()
        if pre.numel() != m:
            raise ValueError("pre-scale length must equal the input length")
    kernels.call("ntt_prepare", dev, kernels.ptr(x2), kernels.ptr(out),
                 kernels.ptr(pre) if pre is not None else None, rows, m,
                 x2.stride(0), log_n, 1 if pre is not None else 0)
    kernels.call("ntt_stages", dev, kernels.ptr(out),
                 kernels.ptr(_twiddle_table(log_n, inverse, dev)), rows,
                 log_n)
    if post is not None:
        post = post.contiguous()
        if post.numel() not in (1, n):
            raise ValueError("post-scale length must be 1 or n_out")
        kernels.call("ntt_scale", dev, kernels.ptr(out), kernels.ptr(post),
                     rows, log_n, 1 if post.numel() == 1 else 0)
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
