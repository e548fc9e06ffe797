"""BN254 G1 and G2 multi-scalar multiplication: kernel K5 and its plain
version.

Port of `ethrex_tpu/ops/bn254_msm.py`, the Groth16 wrap's prover hot loop
(`crypto/groth16.py prove`: three G1 MSMs over witness-length point tables
and one G2 MSM).  Field elements travel as the reference's 16 limbs of 16
bits in Montgomery form (R = 2^256), held in int32 tensors ((n, 16) for Fp,
(n, 2, 16) for Fp2 = Fp[u]/(u^2 + 1)); points are Jacobian with infinity as
Z = 0.  Scalars travel as (n, 8) int32 tensors of their 32-bit words, least
significant first (`scalars_to_words`).

Kernel K5 (`csrc/bn254_msm.cu`) is a signed-window bucket (Pippenger) sum
with WINDOWS windows of WINDOW_BITS bits over a table of bases pre-shifted
per window, Q_{w,i} = 2^(8 w) P_i in affine form: `msm_bases` builds the
table (two launches), `msm_with_bases` runs the MSM over it (six
launches), and `msm_device` does both.  `msm` and `g2_msm` take a table
the caller keeps (`point_bases`): the wrap builds its key's four once
(`prover/groth16_wrap.py wrap_tables`).

On a CPU tensor each wrapper runs its plain version below, the
reference's algorithm limb for limb (16-bit limbs in int64, CIOS product
with split lo/hi-16 accumulators): per scalar bit, LSB first, a masked
accumulation into a running point, then one doubling of the base,

    acc_i <- acc_i + (bit_ij ? P_i : O);   P_i <- 2 P_i
    result = tree_sum_i acc_i              (ceil(log2 n) point additions)

which gives the reference's Jacobian result.  The kernel sums in another
order, so the Jacobian representatives differ; the group elements, and so
the affine points `msm` and `g2_msm` return, are equal (`same_point`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .. import kernels
from .. import require_cuda
from ..crypto import bn254

L = 16          # limbs
LB = 16         # bits per limb
MASK = 0xFFFF


def _cu_constant(name: str) -> int:
    src = (kernels.CSRC / "bn254_msm.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# K5's windows, read from csrc/bn254_msm.cu: the table of bases holds
# 2^(WINDOW_BITS w) P_i for w < WINDOWS
WINDOWS = _cu_constant("kWindows")
WINDOW_BITS = _cu_constant("kWindowBits")

P_INT = bn254.P
R_INT = (1 << (L * LB)) % P_INT          # Montgomery radix 2^256 mod p
R2_INT = (R_INT * R_INT) % P_INT
NP_INT = (-pow(P_INT, -1, 1 << LB)) % (1 << LB)   # -p^-1 mod 2^16


def _to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (LB * i)) & 0xFFFF for i in range(L)],
                    dtype=np.uint32)


def _from_limbs(a) -> int:
    return sum(int(v) << (LB * i) for i, v in enumerate(np.asarray(a)))


P_LIMBS = _to_limbs(P_INT)


def to_mont_host(x: int) -> np.ndarray:
    return _to_limbs((x % P_INT) * R_INT % P_INT)


def from_mont_host(a) -> int:
    return _from_limbs(a) * pow(R_INT, P_INT - 2, P_INT) % P_INT


# ---------------------------------------------------------------------------
# plain field arithmetic: (..., 16) int64 tensors of 16-bit limbs
# (the reference's numpy substrate, ops/bn254_msm.py:346-551)
# ---------------------------------------------------------------------------

def _p64(device) -> torch.Tensor:
    return torch.from_numpy(P_LIMBS.astype(np.int64)).to(device)


def _ge(a, b):
    """a >= b lexicographically from the top limb down (bool (...)): the
    sign of the highest limb where they differ."""
    d = a - b
    pos = torch.arange(1, L + 1, device=a.device)
    top = ((d != 0) * pos).amax(dim=-1)
    at_top = torch.gather(d, -1, (top - 1).clamp(min=0)[..., None])[..., 0]
    return (top == 0) | (at_top > 0)


def _lookahead(gen, prop):
    """Carry (or borrow) into each limb and out of the top one, for limbs
    that each generate or propagate at most one: the carry out of limb i
    is `gen` at the highest limb <= i that does not propagate."""
    idx = torch.arange(gen.shape[-1], device=gen.device)
    last = torch.cummax(torch.where(prop, -1, idx), dim=-1).values
    cout = (last >= 0) & torch.gather(gen, -1, last.clamp(min=0))
    cin = torch.cat([torch.zeros_like(cout[..., :1]), cout[..., :-1]], -1)
    return cin.to(torch.int64), cout[..., -1]


def _sub_raw(a, b):
    """a - b mod 2^256 (a >= b for the callers), by borrow lookahead."""
    d = a - b
    bin_, _ = _lookahead(d < 0, d == 0)
    return (d - bin_) & MASK


def _carry(s):
    """Normalise limbs of at most 17 bits; returns (limbs, carry out)."""
    cin, cout = _lookahead(s > MASK, s == MASK)
    return (s + cin) & MASK, cout


def fadd(a, b):
    s, carry = _carry(a + b)
    p = _p64(a.device)
    over = carry | _ge(s, p)
    red = _sub_raw(s, p)
    return torch.where(over[..., None], red, s)


def fsub(a, b):
    p = _p64(a.device)
    lt = ~_ge(a, b)
    ap, _ = _carry(a + torch.where(lt[..., None], p, torch.zeros_like(p)))
    return _sub_raw(ap, b)


def _skew_sum(x):
    """(..., L, L) -> (..., 2L): column k sums x[i, j] over i + j = k."""
    n = x.shape[-1]
    y = torch.nn.functional.pad(x, (0, n + 1))          # (..., L, 2L+1)
    y = y.flatten(-2)[..., :n * 2 * n].unflatten(-1, (n, 2 * n))
    return y.sum(dim=-2)


def fmul(a, b):
    """Montgomery product over 16-bit limbs (CIOS, the reference's
    ops/bn254_msm.py:118).  Limb sums are kept unsplit in int64 (below
    2^38) and carried once at the end; this changes no m_i, since round i
    reads t_i mod 2^16 after the carry from below, and the products of
    later rounds never reach limb i, so the whole schoolbook product is
    summed first (one skewed sum) and only the m * p terms run round by
    round.  Round i works on the window t[i:] of a 2L+2 buffer instead of
    shifting t, so the result is t[L:2L+2]."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(shape + (L,))
    b = b.expand(shape + (L,))
    p = _p64(a.device)
    t = torch.nn.functional.pad(
        _skew_sum(a[..., :, None] * b[..., None, :]), (0, 2))
    for i in range(L):
        m = ((t[..., i] & MASK) * NP_INT) & MASK
        t[..., i:i + L] += m[..., None] * p
        t[..., i + 1] += t[..., i] >> LB           # t[i] ends in 16 zeros
    x = t[..., L:]
    for _ in range(3):                              # limbs < 2^38 -> 2^16
        x = (x & MASK) + torch.nn.functional.pad(x[..., :-1] >> LB, (1, 0))
    x, _ = _carry(x)
    out = x[..., :L]
    over = (x[..., L:] > 0).any(dim=-1) | _ge(out, p)
    red = _sub_raw(out, p)
    return torch.where(over[..., None], red, out)


class FpOps:
    add = staticmethod(fadd)
    sub = staticmethod(fsub)
    mul = staticmethod(fmul)

    @staticmethod
    def sqr(a):
        return fmul(a, a)

    @staticmethod
    def is_zero(v):
        return (v == 0).all(dim=-1)

    @staticmethod
    def expand(mask):
        return mask[..., None]


class Fp2Ops:
    """BN254 Fp2 = Fp[u]/(u^2 + 1) over limb pairs (..., 2, 16).  The Fp
    ops are elementwise over the leading axes, so the two coordinates go
    through one call, and the three products of `mul` through one."""

    add = staticmethod(fadd)
    sub = staticmethod(fsub)

    @staticmethod
    def mul(a, b):
        # (a0 + a1 u)(b0 + b1 u): t0 = a0 b0, t1 = a1 b1,
        # mid = (a0 + a1)(b0 + b1); c0 = t0 - t1, c1 = (mid - t0) - t1
        sums = fadd(torch.stack([a[..., 0, :], b[..., 0, :]], dim=-2),
                    torch.stack([a[..., 1, :], b[..., 1, :]], dim=-2))
        lhs = torch.cat([a, sums[..., :1, :]], dim=-2)
        rhs = torch.cat([b, sums[..., 1:, :]], dim=-2)
        t = fmul(lhs, rhs)                       # (..., 3, 16)
        t0, t1 = t[..., 0:1, :], t[..., 1:2, :]
        d = fsub(torch.cat([t0, t[..., 2:3, :]], dim=-2),
                 torch.cat([t1, t0], dim=-2))    # t0 - t1, mid - t0
        return torch.cat([d[..., 0:1, :], fsub(d[..., 1:2, :], t1)], dim=-2)

    @classmethod
    def sqr(cls, a):
        return cls.mul(a, a)

    @staticmethod
    def is_zero(v):
        return (v == 0).flatten(-2).all(dim=-1)

    @staticmethod
    def expand(mask):
        return mask[..., None, None]


def point_double(X, Y, Z, F=FpOps):
    A = F.sqr(X)
    B_ = F.sqr(Y)
    C = F.sqr(B_)
    t = F.sub(F.sqr(F.add(X, B_)), F.add(A, C))
    D = F.add(t, t)                        # 2*((X+B)^2 - A - C)
    E = F.add(F.add(A, A), A)              # 3A (curve a = 0 in both groups)
    Fq = F.sqr(E)
    X3 = F.sub(Fq, F.add(D, D))
    c4 = F.add(F.add(C, C), F.add(C, C))
    c8 = F.add(c4, c4)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), c8)
    Z3 = F.mul(F.add(Y, Y), Z)
    inf = F.expand(F.is_zero(Z))
    return (torch.where(inf, X, X3), torch.where(inf, Y, Y3),
            torch.where(inf, Z, Z3))


def point_add(X1, Y1, Z1, X2, Y2, Z2, F=FpOps):
    """Jacobian add handling inf on either side and P == Q via doubling."""
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    Rr = F.sub(S2, S1)
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(Rr)
    HH = F.sqr(H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.sqr(Rr), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(Rr, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(F.mul(Z1, Z2), H)
    # doubling case: H == 0 and R == 0
    dX, dY, dZ = point_double(X1, Y1, Z1, F)
    dbl = F.expand(h_zero & r_zero)
    X3 = torch.where(dbl, dX, X3)
    Y3 = torch.where(dbl, dY, Y3)
    Z3 = torch.where(dbl, dZ, Z3)
    # opposite points (H == 0, R != 0) -> infinity
    opp = F.expand(h_zero & ~r_zero)
    X3 = torch.where(opp, torch.zeros_like(X3), X3)
    Y3 = torch.where(opp, torch.zeros_like(Y3), Y3)
    Z3 = torch.where(opp, torch.zeros_like(Z3), Z3)
    # infinity on either input
    i1 = F.expand(F.is_zero(Z1))
    i2 = F.expand(F.is_zero(Z2))
    X3 = torch.where(i1, X2, torch.where(i2, X1, X3))
    Y3 = torch.where(i1, Y2, torch.where(i2, Y1, Y3))
    Z3 = torch.where(i1, Z2, torch.where(i2, Z1, Z3))
    return X3, Y3, Z3


# ---------------------------------------------------------------------------
# MSM over device tensors: K5 on the card, the plain version on the CPU
# ---------------------------------------------------------------------------

def words_to_bits(words) -> torch.Tensor:
    """(n, 8) int32 scalar words -> (n, nbits) int64 0/1, LSB first, with
    nbits the longest scalar's bit length (at least 1)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=w.device)
    bits = ((w[:, :, None] >> shifts) & 1).flatten(1)
    set_at = torch.nonzero(bits.any(dim=0))
    nbits = int(set_at[-1, 0]) + 1 if len(set_at) else 1
    return bits[:, :nbits]


def msm_device_plain(X, Y, Z, words, fp2: bool = False):
    """Plain version of `msm_device` (the reference's `_np_msm`: a
    double-and-add per point over the scalar's bits, then a tree sum)."""
    F = Fp2Ops if fp2 else FpOps
    X, Y, Z = (v.to(torch.int64) for v in (X, Y, Z))
    aX, aY, aZ = (torch.zeros_like(X), torch.zeros_like(Y),
                  torch.zeros_like(Z))
    bit_rows = words_to_bits(words)
    for j in range(bit_rows.shape[1]):
        mask = bit_rows[:, j]
        mask = mask[:, None, None] if fp2 else mask[:, None]
        aX, aY, aZ = point_add(aX, aY, aZ, X * mask, Y * mask, Z * mask, F)
        X, Y, Z = point_double(X, Y, Z, F)
    n = aX.shape[0]
    while n > 1:
        half = (n + 1) // 2
        if half * 2 - n:
            pad = torch.zeros_like(aX[:1])
            aX, aY, aZ = (torch.cat([v, pad]) for v in (aX, aY, aZ))
        aX, aY, aZ = point_add(aX[:half], aY[:half], aZ[:half],
                               aX[half:], aY[half:], aZ[half:], F)
        n = half
    return tuple(v[0].to(torch.int32) for v in (aX, aY, aZ))


def finv(a):
    """a^-1 (Montgomery in and out; 0 -> 0) by Fermat, a^(p - 2), as
    csrc/bn254.cuh `inv`: the bits of p - 2 below the top, a squaring
    each and a product for each set bit."""
    x = a
    e = P_INT - 2
    for bit in reversed(range(e.bit_length() - 1)):
        x = fmul(x, x)
        if (e >> bit) & 1:
            x = fmul(x, a)
    return x


def _to_words(limbs):
    """(..., 16) 16-bit limbs (int64) -> (..., 8) int32 32-bit words."""
    w = limbs[..., 0::2] | (limbs[..., 1::2] << LB)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _to_limbs16(words):
    """(..., 8) int32 32-bit words -> (..., 16) int64 16-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> LB], dim=-1).flatten(-2)


def msm_bases_plain(X, Y, Z, fp2: bool = False):
    """Plain version of `msm_bases`: the (WINDOWS, n, 2, 8) int32 table
    ((WINDOWS, n, 2, 2, 8) with fp2) of 2^(WINDOW_BITS w) P_i in affine
    Montgomery words, x then y; (0, 0) for the point at infinity."""
    F = Fp2Ops if fp2 else FpOps
    P = tuple(v.to(torch.int64) for v in (X, Y, Z))
    jac = [P]
    for _ in range(1, WINDOWS):
        for _ in range(WINDOW_BITS):
            P = point_double(*P, F)
        jac.append(P)
    JX, JY, JZ = (torch.stack([p[k] for p in jac]) for k in range(3))
    if fp2:
        norm = fadd(fmul(JZ[..., 0, :], JZ[..., 0, :]),
                    fmul(JZ[..., 1, :], JZ[..., 1, :]))
        t = finv(norm)[..., None, :]
        c0 = fmul(JZ[..., :1, :], t)
        c1 = fsub(torch.zeros_like(c0), fmul(JZ[..., 1:, :], t))
        zi = torch.cat([c0, c1], dim=-2)
    else:
        zi = finv(JZ)
    zi2 = F.mul(zi, zi)
    ax, ay = F.mul(JX, zi2), F.mul(JY, F.mul(zi2, zi))
    return _to_words(torch.stack([ax, ay], dim=2))


def msm_bases(X, Y, Z, fp2: bool = False):
    """K5's table of bases for the points (X, Y, Z) (see
    `msm_bases_plain`).  Two launches of K5's `bn254_msm_bases` on a CUDA
    tensor."""
    if X.device.type != "cuda":
        return msm_bases_plain(X, Y, Z, fp2)
    limb_shape = (2, L) if fp2 else (L,)
    n = X.shape[0]
    for t, name in ((X, "X"), (Y, "Y"), (Z, "Z")):
        kernels.require_int32_cuda(t, f"bn254 msm bases {name}")
    if any(tuple(t.shape) != (n,) + limb_shape for t in (X, Y, Z)):
        raise ValueError(f"msm_bases: X, Y, Z must be (n,) + {limb_shape}")
    X, Y, Z = (t.contiguous() for t in (X, Y, Z))
    fp2_flag = 1 if fp2 else 0
    lib = kernels.lib()
    jac = torch.empty(lib.bn254_msm_bytes(n, fp2_flag, 2), dtype=torch.uint8,
                      device=X.device)
    bases = torch.empty((WINDOWS, n, 2) + ((2, 8) if fp2 else (8,)),
                        dtype=torch.int32, device=X.device)
    if bases.numel() * 4 != lib.bn254_msm_bytes(n, fp2_flag, 1):
        raise RuntimeError("msm_bases: table size differs from the kernel's")
    kernels.call("bn254_msm_bases", X.device, kernels.ptr(X), kernels.ptr(Y),
                 kernels.ptr(Z), kernels.ptr(jac), n, fp2_flag,
                 kernels.ptr(bases))
    kernels.count("bn254_msm_bases")
    return bases


def msm_with_bases_plain(bases, words, fp2: bool = False):
    """Plain version of `msm_with_bases`: the double-and-add over the
    table's window 0 (the points themselves, affine)."""
    X, Y = _to_limbs16(bases[0, :, 0]), _to_limbs16(bases[0, :, 1])
    one = torch.from_numpy(to_mont_host(1).astype(np.int64)).to(X.device)
    Z = torch.zeros_like(X)
    live = ((X != 0).flatten(1).any(1) | (Y != 0).flatten(1).any(1))
    if fp2:
        Z[live, 0] = one
    else:
        Z[live] = one
    return msm_device_plain(X, Y, Z, words, fp2)


def msm_with_bases(bases, words, fp2: bool = False):
    """sum_i s_i * P_i in Jacobian Montgomery limbs ((16,) or (2, 16)
    each of X, Y, Z) over a table from `msm_bases` of the points P_i;
    words: (n, 8) int32, the 32-bit words of each scalar s_i < 2^255,
    least significant first.  Six launches of kernel K5 on a CUDA
    tensor."""
    if bases.device.type != "cuda":
        return msm_with_bases_plain(bases, words, fp2)
    n = words.shape[0]
    table_shape = (WINDOWS, n, 2) + ((2, 8) if fp2 else (8,))
    for t, name in ((bases, "bases"), (words, "words")):
        kernels.require_int32_cuda(t, f"bn254 msm {name}")
    if tuple(bases.shape) != table_shape or tuple(words.shape) != (n, 8):
        raise ValueError(f"msm_with_bases: bases must be {table_shape} and "
                         "words (n, 8)")
    bases, words = bases.contiguous(), words.contiguous()
    fp2_flag = 1 if fp2 else 0
    scratch = torch.empty(kernels.lib().bn254_msm_bytes(n, fp2_flag, 0),
                          dtype=torch.uint8, device=words.device)
    limb_shape = (2, L) if fp2 else (L,)
    out = torch.zeros((3,) + limb_shape, dtype=torch.int32,
                      device=words.device)
    kernels.call("bn254_msm", words.device, kernels.ptr(bases),
                 kernels.ptr(words), kernels.ptr(scratch), n, fp2_flag,
                 kernels.ptr(out))
    kernels.count("bn254_msm_g2" if fp2 else "bn254_msm_g1")
    return out[0], out[1], out[2]


def msm_device(X, Y, Z, words, fp2: bool = False):
    """sum_i s_i * P_i in Jacobian Montgomery limbs.  X, Y, Z: (n, 16)
    int32 limbs (or (n, 2, 16) with fp2), words: (n, 8) int32, the 32-bit
    words of each scalar s_i < 2^255, least significant first.  Returns
    (X, Y, Z) of shape (16,) or (2, 16).  On a CUDA tensor kernel K5:
    the table of bases, then the MSM over it."""
    if X.device.type != "cuda":
        return msm_device_plain(X, Y, Z, words, fp2)
    return msm_with_bases(msm_bases(X, Y, Z, fp2), words, fp2)


def same_point(a, b, fp2: bool = False) -> bool:
    """Whether two Jacobian results (X, Y, Z) in Montgomery limbs (tensors
    or arrays of (16,) or (2, 16)) are one group element: both at
    infinity, or X1 Z2^2 = X2 Z1^2 and Y1 Z2^3 = Y2 Z1^3 mod p.  The
    relations are homogeneous, so they hold on the Montgomery forms."""
    def elem(v):
        v = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        v = v.astype(np.int64) & MASK
        if fp2:
            return bn254.Fp2(_from_limbs(v[0]), _from_limbs(v[1]))
        return _from_limbs(v) % P_INT

    (x1, y1, z1), (x2, y2, z2) = ([elem(v) for v in p] for p in (a, b))
    if fp2:
        inf1, inf2 = z1.is_zero(), z2.is_zero()
        if inf1 or inf2:
            return inf1 and inf2
        z1s, z2s = z1 * z1, z2 * z2
        return x1 * z2s == x2 * z1s and y1 * z2s * z2 == y2 * z1s * z1
    if z1 == 0 or z2 == 0:
        return z1 == z2
    z1s, z2s = z1 * z1 % P_INT, z2 * z2 % P_INT
    return (x1 * z2s - x2 * z1s) % P_INT == 0 and \
        (y1 * z2s * z2 - y2 * z1s * z1) % P_INT == 0


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------

def points_to_device(points: list, device="cpu") -> tuple:
    """Affine host points [(x, y) or None] -> Montgomery Jacobian limb
    tensors (n, 16) int32."""
    n = len(points)
    X = np.zeros((n, L), dtype=np.uint32)
    Y = np.zeros((n, L), dtype=np.uint32)
    Z = np.zeros((n, L), dtype=np.uint32)
    one = to_mont_host(1)
    for i, pt in enumerate(points):
        if pt is None:
            continue
        X[i] = to_mont_host(pt[0])
        Y[i] = to_mont_host(pt[1])
        Z[i] = one
    return tuple(torch.from_numpy(v.view(np.int32)).to(device)
                 for v in (X, Y, Z))


def g2_points_to_device(points: list, device="cpu") -> tuple:
    """Affine host G2 points [(Fp2, Fp2) or None] -> Montgomery Jacobian
    limb tensors (n, 2, 16) int32."""
    n = len(points)
    X = np.zeros((n, 2, L), dtype=np.uint32)
    Y = np.zeros((n, 2, L), dtype=np.uint32)
    Z = np.zeros((n, 2, L), dtype=np.uint32)
    one = to_mont_host(1)
    for i, pt in enumerate(points):
        if pt is None:
            continue
        X[i, 0] = to_mont_host(pt[0].c0)
        X[i, 1] = to_mont_host(pt[0].c1)
        Y[i, 0] = to_mont_host(pt[1].c0)
        Y[i, 1] = to_mont_host(pt[1].c1)
        Z[i, 0] = one
    return tuple(torch.from_numpy(v.view(np.int32)).to(device)
                 for v in (X, Y, Z))


def scalars_to_bits(scalars: list[int], bits: int = 256) -> np.ndarray:
    """(n, bits) uint32 0/1, LSB first, of each scalar mod r."""
    n = len(scalars)
    nbytes = (max(bits, 1) + 7) // 8
    raw = np.frombuffer(b"".join(
        (int(s) % bn254.R).to_bytes(max(nbytes, 32), "little")
        for s in scalars), dtype=np.uint8).reshape(n, max(nbytes, 32))
    return np.unpackbits(raw, axis=1, bitorder="little")[:, :bits].astype(
        np.uint32)


def scalars_to_words(scalars: list[int]) -> np.ndarray:
    """(n, 8) uint32: the 32-bit words of each scalar mod r, least
    significant first."""
    raw = b"".join((int(s) % bn254.R).to_bytes(32, "little")
                   for s in scalars)
    return np.frombuffer(raw, dtype="<u4").reshape(len(scalars), 8).astype(
        np.uint32)


def point_bases(points: list, fp2: bool, device):
    """K5's table of bases (`msm_bases`) for a host point list on
    `device`, for `msm` and `g2_msm` to take; the caller keeps it as long
    as the points (a proving key's) stay fixed."""
    conv = g2_points_to_device if fp2 else points_to_device
    return msm_bases(*conv(points, device), fp2)


def _run_msm(points, scalars, fp2: bool, device, bases):
    words = torch.from_numpy(scalars_to_words(scalars).view(np.int32)).to(
        device)
    if bases is not None:
        out = msm_with_bases(bases, words, fp2)
    else:
        conv = g2_points_to_device if fp2 else points_to_device
        out = msm_device(*conv(points, device), words, fp2)
    return tuple(v.cpu().numpy().view(np.uint32) for v in out)


def msm(points: list, scalars: list[int], device="cuda",
        bases=None) -> tuple | None:
    """sum_i scalars[i] * points[i] over G1; returns affine (x, y) or None
    (infinity).  Points are host affine ints; the MSM runs on `device`
    ("cuda" unless the caller asks for the CPU), over `bases`, the
    points' table from `point_bases`, where the caller gives one."""
    if len(points) != len(scalars):
        raise ValueError("points/scalars length mismatch")
    if not points:
        return None
    aX, aY, aZ = _run_msm(points, scalars, False, require_cuda(device),
                          bases)
    z = from_mont_host(aZ)
    if z == 0:
        return None
    x = from_mont_host(aX)
    y = from_mont_host(aY)
    zinv = pow(z, P_INT - 2, P_INT)
    zinv2 = zinv * zinv % P_INT
    return (x * zinv2 % P_INT, y * zinv2 * zinv % P_INT)


def g2_msm(points: list, scalars: list[int], device="cuda",
           bases=None) -> tuple | None:
    """sum_i scalars[i] * points[i] over G2; affine (Fp2, Fp2) or None.
    `device` and `bases` as for `msm`."""
    if len(points) != len(scalars):
        raise ValueError("points/scalars length mismatch")
    if not points:
        return None
    aX, aY, aZ = _run_msm(points, scalars, True, require_cuda(device),
                          bases)
    z = bn254.Fp2(from_mont_host(aZ[0]), from_mont_host(aZ[1]))
    if z.c0 == 0 and z.c1 == 0:
        return None
    x = bn254.Fp2(from_mont_host(aX[0]), from_mont_host(aX[1]))
    y = bn254.Fp2(from_mont_host(aY[0]), from_mont_host(aY[1]))
    zinv = z.inv()
    zinv2 = zinv * zinv
    return (x * zinv2, y * zinv2 * zinv)
