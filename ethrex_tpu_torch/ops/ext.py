"""Quartic extension field F_p[x]/(x^4 - 11) over BabyBear.

Port of `ethrex_tpu/ops/ext.py`.  Device representation: a trailing axis of
4 int32 Montgomery base coordinates; host representation: 4-tuples of
canonical ints (the `h_*` ops, copied unchanged).  The device ops are plain
PyTorch (on the card too); power tables of a single point are built on the
host, where the chain of products is short, and expanded on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import babybear as bb

W = 11  # x^4 = W
DEG = 4

_W_M = int(bb.to_mont_host(W))


# ---------------------------------------------------------------------------
# Device ops — tensors of shape (..., 4), Montgomery
# ---------------------------------------------------------------------------

def from_base(a):
    """Embed base-field tensor (...,) -> ext (..., 4)."""
    z = torch.zeros(a.shape + (3,), dtype=bb.I32, device=a.device)
    return torch.cat([a[..., None], z], dim=-1)


def add(a, b):
    return bb.add(a, b)


def sub(a, b):
    return bb.sub(a, b)


def mul(a, b):
    """Schoolbook quartic multiply with x^4 = W reduction."""
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))
    m = bb.mont_mul
    add_ = bb.add

    def wmul(x):
        return m(x, _W_M)

    c0 = add_(m(a0, b0), wmul(add_(add_(m(a1, b3), m(a2, b2)), m(a3, b1))))
    c1 = add_(add_(m(a0, b1), m(a1, b0)), wmul(add_(m(a2, b3), m(a3, b2))))
    c2 = add_(add_(m(a0, b2), m(a1, b1)), add_(m(a2, b0), wmul(m(a3, b3))))
    c3 = add_(add_(m(a0, b3), m(a1, b2)), add_(m(a2, b1), m(a3, b0)))
    return torch.stack([c0, c1, c2, c3], dim=-1)


def scalar_mul(a, s):
    """Multiply ext (..., 4) by a base-field tensor s (...,)."""
    return bb.mont_mul(a, s[..., None])


def _point_host(point) -> tuple:
    if isinstance(point, torch.Tensor):
        return to_host(point)
    return tuple(int(v) % bb.P for v in point)


def _powers_host(z: tuple, n: int) -> np.ndarray:
    """[1, z, ..., z^{n-1}] canonical, (n, 4) uint32."""
    out = np.empty((n, DEG), dtype=np.uint32)
    acc = ONE_H
    for i in range(n):
        out[i] = acc
        acc = h_mul(acc, z)
    return out


def ext_powers(point, n: int, device=None):
    """[1, z, z^2, ..., z^{n-1}] as an (n, 4) Montgomery tensor.

    `point` is a device (4,) tensor or a canonical host tuple; the powers
    of one point are unique, so the host chain equals the JAX scan."""
    if device is None:
        device = point.device if isinstance(point, torch.Tensor) else "cpu"
    z = _point_host(point)
    return bb.from_numpy(bb.to_mont_host(_powers_host(z, n)), device)


def ext_powers_blocked(point, n: int, block: int = 128, device=None):
    """[1, z, ..., z^{n-1}] via z^{a+Bb} = (z^B)^b * z^a: two short host
    tables and one outer product of ext multiplies on the device."""
    if device is None:
        device = point.device if isinstance(point, torch.Tensor) else "cpu"
    if n <= block:
        return ext_powers(point, n, device)
    z = _point_host(point)
    nb = -(-n // block)
    small = ext_powers(z, block, device)                    # (B, 4)
    big = ext_powers(h_pow(z, block), nb, device)           # (nb, 4)
    out = mul(big[:, None, :].expand(nb, block, DEG),
              small[None, :, :].expand(nb, block, DEG))
    return out.reshape(nb * block, DEG)[:n]


def eval_base_poly_at_ext(coeffs, point):
    """Evaluate base-coefficient polys at an ext point.

    coeffs: (..., n) base Montgomery; point: (4,) ext Montgomery tensor or
    canonical tuple.  Returns (..., 4) via the modular matmul (..., n) @
    (n, 4) (kernel K3 on the card)."""
    n = coeffs.shape[-1]
    pows = ext_powers_blocked(point, n, device=coeffs.device)
    return bb.mod_matmul(coeffs, pows)


# Frobenius x -> x^p acts coordinate-wise: coordinate j of x^{p^k} is
# coordinate j of x times W^{j*(p-1)/4*k}.
_FR_K = (bb.P - 1) // 4
_FR = [
    np.asarray(bb.to_mont_host(np.array(
        [pow(W, (j * _FR_K * k) % (bb.P - 1), bb.P) for j in range(4)],
        dtype=np.uint32)))
    for k in (1, 2, 3)
]


def frobenius(a, k: int = 1):
    """a^{p^k} for k in 1..3 — coordinate-wise mask multiply."""
    return bb.mont_mul(a, bb.from_numpy(_FR[k - 1], a.device))


def inv_x_minus_zeta(x, zeta):
    """Batch inverse of (x_i - zeta) for base-field points x.

    x: (...,) base Montgomery; zeta: (4,) ext Montgomery (not in the base
    field).  1/(x - z) = conj(x) / N(x), with conj(x) the product over the
    three other conjugates (a cubic with ext coefficients) and N(x) the
    base-field minimal polynomial of z; N inverts through
    `babybear.batch_mont_inv` (kernel K7 on the card).  Returns (..., 4)."""
    z1 = frobenius(zeta, 1)
    z2 = frobenius(zeta, 2)
    z3 = frobenius(zeta, 3)
    s1 = add(add(z1, z2), z3)
    s2 = add(add(mul(z1, z2), mul(z1, z3)), mul(z2, z3))
    s3 = mul(mul(z1, z2), z3)
    e1 = add(zeta, s1)[..., 0]
    e2 = add(mul(zeta, s1), s2)[..., 0]
    e3 = add(mul(zeta, s2), s3)[..., 0]
    e4 = mul(zeta, s3)[..., 0]

    shape = x.shape + (DEG,)
    acc = sub(from_base(x), s1.expand(shape))
    acc = add(scalar_mul(acc, x), s2.expand(shape))
    conj = sub(scalar_mul(acc, x), s3.expand(shape))
    m = bb.mont_mul
    nacc = bb.sub(x, e1)
    nacc = bb.add(m(nacc, x), e2)
    nacc = bb.sub(m(nacc, x), e3)
    norm = bb.add(m(nacc, x), e4)
    return scalar_mul(conj, bb.batch_mont_inv(norm))


def eval_ext_poly_at_ext(coeffs, point):
    """Ext-coefficient polys at an ext point: coeffs (..., n, 4)."""
    n = coeffs.shape[-2]
    pows = ext_powers_blocked(point, n, device=coeffs.device)
    terms = mul(pows.expand(coeffs.shape), coeffs)
    return bb.sum_mod(terms, dim=-2)


# ---------------------------------------------------------------------------
# Host ops — canonical int 4-tuples (verifier side)
# ---------------------------------------------------------------------------

ZERO_H = (0, 0, 0, 0)
ONE_H = (1, 0, 0, 0)


def h_from_base(a: int):
    return (int(a) % bb.P, 0, 0, 0)


def h_add(a, b):
    return tuple((x + y) % bb.P for x, y in zip(a, b))


def h_sub(a, b):
    return tuple((x - y) % bb.P for x, y in zip(a, b))


def h_mul(a, b):
    p = bb.P
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    c0 = (a0 * b0 + W * (a1 * b3 + a2 * b2 + a3 * b1)) % p
    c1 = (a0 * b1 + a1 * b0 + W * (a2 * b3 + a3 * b2)) % p
    c2 = (a0 * b2 + a1 * b1 + a2 * b0 + W * a3 * b3) % p
    c3 = (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % p
    return (c0, c1, c2, c3)


def h_scalar_mul(a, s: int):
    return tuple(x * s % bb.P for x in a)


def h_pow(a, e: int):
    result = ONE_H
    base = a
    while e:
        if e & 1:
            result = h_mul(result, base)
        e >>= 1
        if e:
            base = h_mul(base, base)
    return result


def h_inv(a):
    """Inverse by solving the 4x4 multiplication-matrix system mod p."""
    if a == ZERO_H:
        raise ZeroDivisionError("ext zero has no inverse")
    p = bb.P
    cols = []
    cur = a
    for _ in range(4):
        cols.append(cur)
        cur = (W * cur[3] % p, cur[0], cur[1], cur[2])
    m = [[cols[j][i] for j in range(4)] for i in range(4)]
    rhs = [1, 0, 0, 0]
    for col in range(4):
        piv = next(r for r in range(col, 4) if m[r][col] % p != 0)
        m[col], m[piv] = m[piv], m[col]
        rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = pow(m[col][col], p - 2, p)
        m[col] = [x * inv % p for x in m[col]]
        rhs[col] = rhs[col] * inv % p
        for r in range(4):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [(x - f * y) % p for x, y in zip(m[r], m[col])]
                rhs[r] = (rhs[r] - f * rhs[col]) % p
    return tuple(rhs)


def h_div(a, b):
    return h_mul(a, h_inv(b))


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def to_host(a) -> tuple:
    """Device ext element (4,) Montgomery -> canonical host tuple."""
    return tuple(int(x) for x in bb.from_mont_host(bb.to_numpy(a)))


def to_device(a, device) -> torch.Tensor:
    """Canonical host tuple -> device (4,) Montgomery."""
    return bb.from_numpy(bb.to_mont_host(np.asarray(a, dtype=np.uint64)),
                         device)
