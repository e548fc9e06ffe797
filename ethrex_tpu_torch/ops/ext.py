"""Quartic extension field F_p[x]/(x^4 - 11) over BabyBear.

Port of `ethrex_tpu/ops/ext.py`.  Device representation: a trailing axis of
4 int32 Montgomery base coordinates; host representation: 4-tuples of
canonical ints (the `h_*` ops, copied unchanged).  The elementwise device
ops (`add`, `mul`, ...) are plain PyTorch; the prover's extension-field
passes are kernels, each with its plain version beside it (run on a CPU
tensor only):

  K8  `deep_compose`      the DEEP composition codeword (csrc/deep_compose.cu)
  K9  `quotient_combine`  the quotient's divisor combination
                          (csrc/quotient_combine.cu)
  K11 `powers_table`, `eval_ext_poly_at_ext`  the power table of a point
                          and ext polynomials at it (csrc/ext_poly_eval.cu)

Power tables of a single point start from two short host tables (the chain
of products is short there) and are expanded on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
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


def _mul_rows_host(a: np.ndarray, b: tuple) -> np.ndarray:
    """Canonical ext rows a (m, 4) uint64 times one canonical element b."""
    p = np.uint64(bb.P)
    c = [np.uint64(int(v) % bb.P) for v in b]
    x = [a[:, j] for j in range(DEG)]

    def t(i, j):
        return x[i] * c[j] % p

    w = np.uint64(W)
    out = np.empty_like(a)
    out[:, 0] = (t(0, 0) + w * ((t(1, 3) + t(2, 2) + t(3, 1)) % p)) % p
    out[:, 1] = (t(0, 1) + t(1, 0) + w * ((t(2, 3) + t(3, 2)) % p)) % p
    out[:, 2] = (t(0, 2) + t(1, 1) + t(2, 0) + w * t(3, 3)) % p
    out[:, 3] = (t(0, 3) + t(1, 2) + t(2, 1) + t(3, 0)) % p
    return out


def _powers_host(z: tuple, n: int) -> np.ndarray:
    """[1, z, ..., z^{n-1}] canonical, (n, 4) uint32, by doubling:
    out[k:2k] = out[:k] * z^k (one numpy pass per doubling).  The powers
    of one point are unique, so any order of products gives them."""
    out = np.zeros((n, DEG), dtype=np.uint64)
    if n == 0:
        return out.astype(np.uint32)
    out[0, 0] = 1
    k, step = 1, tuple(int(v) % bb.P for v in z)
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = _mul_rows_host(out[:m], step)
        step = h_mul(step, step)
        k += m
    return out.astype(np.uint32)


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


def _short_tables(point, n: int, device):
    """(small, big, blk): z^0..z^(blk-1) and (z^blk)^0..(z^blk)^(nb-1),
    the two host tables that z^i = big[i // blk] * small[i % blk]
    expands; blk is about sqrt(n), so both stay short."""
    z = _point_host(point)
    blk = 1 << max(7, (max(n, 1).bit_length() + 1) // 2)
    nb = -(-n // blk)
    return (ext_powers(z, blk, device), ext_powers(h_pow(z, blk), nb, device),
            blk)


def powers_table(point, n: int, device=None):
    """[1, z, ..., z^{n-1}] as an (n, 4) Montgomery tensor on `device`.
    Kernel K11 (`ext_powers_table`) on the card; the plain version,
    `ext_powers_blocked`, on the CPU."""
    if device is None:
        device = point.device if isinstance(point, torch.Tensor) else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return ext_powers_blocked(point, n, device=device)
    small, big, blk = _short_tables(point, n, device)
    out = torch.empty((n, DEG), dtype=bb.I32, device=device)
    kernels.call("ext_powers_table", device, kernels.ptr(small),
                 kernels.ptr(big), kernels.ptr(out), n, blk)
    kernels.count("ext_poly_eval")
    return out


def eval_base_poly_at_ext(coeffs, point):
    """Evaluate base-coefficient polys at an ext point.

    coeffs: (..., n) base Montgomery; point: (4,) ext Montgomery tensor or
    canonical tuple.  Returns (..., 4) via the modular matmul (..., n) @
    (n, 4) (kernels K11 and K3 on the card)."""
    n = coeffs.shape[-1]
    pows = powers_table(point, n, device=coeffs.device)
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


_FR_H = [[pow(W, (j * _FR_K * k) % (bb.P - 1), bb.P) for j in range(4)]
         for k in (1, 2, 3)]


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


def eval_ext_poly_at_ext_plain(coeffs, point):
    """Plain version of `eval_ext_poly_at_ext`."""
    n = coeffs.shape[-2]
    pows = ext_powers_blocked(point, n, device=coeffs.device)
    terms = mul(pows.expand(coeffs.shape), coeffs)
    return bb.sum_mod(terms, dim=-2)


# threads per block of the K11 reduction, and the least number of
# coefficients each thread sums
_EVAL_THREADS = 256
_EVAL_PER_THREAD = 8


def eval_ext_poly_at_ext(coeffs, point):
    """Ext-coefficient polys at an ext point: coeffs (..., n, 4) (any
    strides) -> (..., 4).  Kernel K11 on a CUDA tensor."""
    if coeffs.device.type != "cuda":
        return eval_ext_poly_at_ext_plain(coeffs, point)
    kernels.require_int32_cuda(coeffs, "eval_ext_poly_at_ext")
    if coeffs.shape[-1] != DEG:
        raise ValueError("coefficients need a trailing axis of 4")
    lead = coeffs.shape[:-2]
    n = coeffs.shape[-2]
    c = coeffs.reshape((-1, n, DEG))    # a view for the prover's chunks
    rows = c.shape[0]
    dev = coeffs.device
    small, big, blk = _short_tables(point, n, dev)
    G = max(1, min(1024, -(-n // (_EVAL_THREADS * _EVAL_PER_THREAD))))
    partial = torch.empty((rows, G, DEG), dtype=bb.I32, device=dev)
    out = torch.empty((rows, DEG), dtype=bb.I32, device=dev)
    kernels.call("ext_poly_eval", dev, kernels.ptr(c), c.stride(0),
                 c.stride(1), c.stride(2), kernels.ptr(small),
                 kernels.ptr(big), blk, n, rows, G,
                 kernels.ptr(partial), kernels.ptr(out))
    kernels.count("ext_poly_eval")
    return out.reshape(lead + (DEG,))


# ---------------------------------------------------------------------------
# K9: the quotient's divisor combination
# ---------------------------------------------------------------------------

def quotient_combine_plain(acc, x_minus_glast, inv_stack, lde_cols, cols,
                           bound_vals, apow_b, B: int):
    """Plain version of `quotient_combine` (the reference's loop)."""
    N = acc.shape[0]
    inv_xn1 = inv_stack[:B].repeat(N // B)
    q_acc = scalar_mul(acc, bb.mont_mul(x_minus_glast, inv_xn1))
    base_off = B + N
    for j, c in enumerate(cols):
        diff = bb.sub(lde_cols[c], bound_vals[j])
        inv_x = inv_stack[base_off + j * N: base_off + (j + 1) * N]
        q_acc = add(q_acc, bb.mont_mul(
            bb.mont_mul(diff, inv_x)[:, None], apow_b[j][None, :]))
    return q_acc


def quotient_combine(acc, x_minus_glast, inv_stack, lde_cols, cols,
                     bound_vals, apow_b, B: int):
    """acc (N, 4) * (x - g^(n-1)) / (x^n - 1) plus, per boundary j,
    (lde_cols[cols[j]] - bound_vals[j]) / (x - g^rj) * apow_b[j].

    inv_stack is the prover's divisor-inverse stack [B | N | nb N];
    lde_cols (w, N); cols a list of nb column indices; bound_vals (nb,);
    apow_b (nb, 4); all Montgomery.  Kernel K9 on a CUDA tensor."""
    if acc.device.type != "cuda":
        return quotient_combine_plain(acc, x_minus_glast, inv_stack,
                                      lde_cols, cols, bound_vals, apow_b, B)
    N = acc.shape[0]
    nb = len(cols)
    if B & (B - 1) or inv_stack.numel() != B + N + nb * N:
        raise ValueError("inverse stack does not match B, N and the "
                         "boundaries")
    if lde_cols.shape[1] != N or acc.shape != (N, DEG):
        raise ValueError("acc and the LDE must cover the same N points")
    for t, name in ((acc, "acc"), (x_minus_glast, "x_minus_glast"),
                    (inv_stack, "inv_stack"), (lde_cols, "lde_cols")):
        kernels.require_int32_cuda(t, f"quotient_combine {name}")
    dev = acc.device
    acc = acc.contiguous()
    lde_cols = lde_cols.contiguous()
    cols_t = torch.tensor(list(cols) or [0], dtype=torch.int32, device=dev)
    bvals = bound_vals.contiguous() if nb else cols_t
    apb = apow_b.contiguous() if nb else cols_t
    out = torch.empty((N, DEG), dtype=bb.I32, device=dev)
    kernels.call("quotient_combine", dev, kernels.ptr(acc),
                 kernels.ptr(x_minus_glast.contiguous()),
                 kernels.ptr(inv_stack.contiguous()), kernels.ptr(lde_cols),
                 kernels.ptr(cols_t), kernels.ptr(bvals), kernels.ptr(apb),
                 kernels.ptr(out), N, B, nb)
    kernels.count("quotient_combine")
    return out


# ---------------------------------------------------------------------------
# K8: the DEEP composition codeword
# ---------------------------------------------------------------------------

def deep_compose_plain(pts_m, openings, q_lde=None, q_z=None, gq=None):
    """Plain version of `deep_compose` (the reference's arithmetic)."""
    device = pts_m.device
    terms = []
    for point, S, t, g in openings:
        inv = inv_x_minus_zeta(pts_m, to_device(point, device))
        terms.append((sub(S, bb.sum_mod(mul(t, g), dim=0)[None]), inv))
    (s1, inv0), rest = terms[0], terms[1:]
    if q_lde is not None:
        q_ext = q_lde.permute(0, 2, 1)                             # (B, N, 4)
        d3 = sub(q_ext, q_z[:, None])
        s1 = add(s1, bb.sum_mod(mul(d3, gq[:, None]), dim=0))
        del d3
    out = mul(s1, inv0)
    for s2, inv1 in rest:
        out = add(out, mul(s2, inv1))
    return out


def _h_dot(t, g) -> tuple:
    """sum_i t_i g_i over canonical ext rows (host)."""
    acc = ZERO_H
    for a, b in zip(t, g):
        acc = h_add(acc, h_mul(tuple(int(v) for v in a),
                               tuple(int(v) for v in b)))
    return acc


def _conj_norm_coeffs(point) -> list[int]:
    """Canonical [s1, s2, s3 (ext), e1..e4 (base)] of 1/(x - z) =
    conj(x) / N(x) (see `inv_x_minus_zeta`), on the host."""
    z = tuple(int(v) % bb.P for v in point)
    z1, z2, z3 = (tuple(z[j] * _FR_H[k][j] % bb.P for j in range(4))
                  for k in range(3))
    s1 = h_add(h_add(z1, z2), z3)
    s2 = h_add(h_add(h_mul(z1, z2), h_mul(z1, z3)), h_mul(z2, z3))
    s3 = h_mul(h_mul(z1, z2), z3)
    e = [h_add(z, s1)[0], h_add(h_mul(z, s1), s2)[0],
         h_add(h_mul(z, s2), s3)[0], h_mul(z, s3)[0]]
    return list(s1) + list(s2) + list(s3) + e


def deep_compose(pts_m, openings, q_lde=None, q_z=None, gq=None):
    """The DEEP codeword over the LDE domain points pts_m (N,):

        sum_o (S_o - sum_i t_o[i] g_o[i]) / (x - z_o)
          + sum_b gq[b] (q_lde[b] - q_z[b]) / (x - z_0)

    openings: one or two (z (canonical host tuple), S (N, 4), t (w, 4),
    g (w, 4)); q_lde (nb, 4, N), q_z (nb, 4), gq (nb, 4), or None for no
    quotient chunks (the fused prove step).  Montgomery tensors.  Kernel
    K8 on a CUDA tensor."""
    if pts_m.device.type != "cuda":
        return deep_compose_plain(pts_m, openings, q_lde, q_z, gq)
    if len(openings) not in (1, 2):
        raise ValueError("deep_compose takes one or two openings")
    dev = pts_m.device
    N = pts_m.shape[0]
    consts = []
    for point, S, t, g in openings:
        if S.shape != (N, DEG):
            raise ValueError("an opening's S must be (N, 4)")
        c = _h_dot(bb.from_mont_host(bb.to_numpy(t)),
                   bb.from_mont_host(bb.to_numpy(g)))
        consts += _conj_norm_coeffs(point) + list(c)
    if len(openings) == 1:
        consts += [0] * 20
    nq = 0
    if q_lde is not None:
        nq = q_lde.shape[0]
        if q_lde.shape != (nq, DEG, N):
            raise ValueError("q_lde must be (nb, 4, N)")
        consts += [int(v) for v in bb.from_mont_host(
            bb.to_numpy(gq)).reshape(-1)]
        consts += [int(v) for v in bb.from_mont_host(
            bb.to_numpy(q_z)).reshape(-1)]
    kc = bb.mont_tensor(consts, dev)
    s1m = openings[0][1].contiguous()
    s2m = openings[1][1].contiguous() if len(openings) == 2 else s1m
    q = q_lde.contiguous() if nq else s1m
    for x, name in ((pts_m, "pts_m"), (s1m, "S"), (s2m, "S"), (q, "q_lde")):
        kernels.require_int32_cuda(x, f"deep_compose {name}")
    out = torch.empty((N, DEG), dtype=bb.I32, device=dev)
    kernels.call("deep_compose", dev, kernels.ptr(pts_m.contiguous()),
                 kernels.ptr(s1m), kernels.ptr(s2m), kernels.ptr(q),
                 kernels.ptr(kc), kernels.ptr(out), N, nq,
                 1 if len(openings) == 2 else 0)
    kernels.count("deep_compose")
    return out


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
