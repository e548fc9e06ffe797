"""BabyBear prime field arithmetic over torch.int32 tensors (Montgomery form).

Port of `ethrex_tpu/ops/babybear.py`.  Elements are residues below
p = 15 * 2^27 + 1 in Montgomery form (R = 2^32), stored in int32 tensors:
p < 2^31, so the bit pattern is the uint32 the JAX package holds.  Sums and
differences stay in int32 (a - (p - b) never leaves (-p, p)); products widen
to int64, where a 31-bit by 31-bit product is exact.  Every operation
returns the canonical residue, so results equal the JAX functions bit for
bit whatever the order of the arithmetic.

Three kernels live here: `mod_matmul` (K3, `csrc/mod_matmul.cu`),
`batch_mont_inv` (K7, `csrc/batch_inv.cu`, with its divisor entry
`divisor_stack_inv`) and `to_mont_cols` (the trace's upload,
`csrc/to_mont.cu`).  On a CUDA tensor each wrapper
launches its kernel; on a CPU tensor it runs the plain version beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

# ---------------------------------------------------------------------------
# Field constants
# ---------------------------------------------------------------------------

P = 2013265921  # 15 * 2^27 + 1
TWO_ADICITY = 27
GENERATOR = 31  # multiplicative generator of F_p^*

_R = (1 << 32) % P          # Montgomery radix R = 2^32 mod p
_R2 = (_R * _R) % P         # R^2 mod p
_RINV = pow(_R, P - 2, P)   # R^{-1} mod p
_NP = (-pow(P, -1, 1 << 32)) % (1 << 32)  # -p^{-1} mod 2^32

_ROOT = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)

MONT_ONE = _R   # 1 in Montgomery form

I32 = torch.int32


# ---------------------------------------------------------------------------
# Host helpers (numpy / Python ints)
# ---------------------------------------------------------------------------

def root_of_unity(log_n: int) -> int:
    """Canonical primitive 2^log_n-th root of unity."""
    if log_n > TWO_ADICITY:
        raise ValueError(f"2-adicity exceeded: {log_n} > {TWO_ADICITY}")
    return pow(_ROOT, 1 << (TWO_ADICITY - log_n), P)


def inv_host(a: int) -> int:
    return pow(a, P - 2, P)


def powers_host(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ...] canonical, as numpy uint32."""
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out.astype(np.uint32)
    # doubling: out[k:2k] = out[:k] * base^k
    out[0] = 1
    k = 1
    step = base % P
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = (out[:m] * np.uint64(step)) % np.uint64(P)
        step = step * step % P
        k += m
    return out.astype(np.uint32)


def to_mont_host(a):
    """Host-side canonical -> Montgomery (numpy uint32)."""
    return ((np.asarray(a, dtype=np.uint64) * _R) % P).astype(np.uint32)


def from_mont_host(a):
    """Host-side Montgomery -> canonical; accepts uint32 or int32 arrays."""
    a = np.asarray(a)
    if a.dtype == np.int32:
        a = a.view(np.uint32)
    return ((a.astype(np.uint64) * _RINV) % P).astype(np.uint32)


# ---------------------------------------------------------------------------
# numpy <-> torch boundary
# ---------------------------------------------------------------------------

def from_numpy(a, device) -> torch.Tensor:
    """np.uint32 field array -> int32 tensor on `device` (same bits)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 field tensor -> np.uint32 array (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def const(v: int, device) -> torch.Tensor:
    """0-dim int32 tensor holding the Montgomery form of canonical v."""
    return torch.tensor(int(v) % P * _R % P, dtype=I32, device=device)


def mont_tensor(values, device) -> torch.Tensor:
    """Canonical ints -> Montgomery int32 tensor on `device`."""
    return from_numpy(to_mont_host(np.asarray(values, dtype=np.uint64) % P),
                      device)


# ---------------------------------------------------------------------------
# Montgomery arithmetic (plain PyTorch; exact)
# ---------------------------------------------------------------------------

def add(a, b):
    s = a - (P - b)
    return torch.where(s < 0, s + P, s)


def sub(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d)


def neg(a):
    return torch.where(a == 0, a, P - a)


def mont_mul(a, b):
    """a * b * R^{-1} mod p (canonical); int32 in, int32 out."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(int(b), dtype=torch.int64, device=a.device)
    x = (a.to(torch.int64) * b.to(torch.int64)) % P
    return ((x * _RINV) % P).to(I32)


def mont_sqr(a):
    return mont_mul(a, a)


def to_mont(a):
    return mont_mul(a, _R2)


def from_mont(a):
    return mont_mul(a, 1)


def to_mont_cols_plain(a):
    """Plain version of `to_mont_cols`."""
    return to_mont(a.T.contiguous())


def to_mont_cols(a):
    """(n, w) canonical residues (a trace as uploaded; last stride 1) ->
    (w, n) Montgomery columns.  Kernel `to_mont_cols` on a CUDA tensor:
    the transpose and the conversion in one pass."""
    if a.dim() != 2:
        raise ValueError("to_mont_cols takes an (n, w) matrix")
    if a.device.type != "cuda":
        return to_mont_cols_plain(a)
    kernels.require_int32_cuda(a, "to_mont_cols")
    if a.stride(1) != 1:
        a = a.contiguous()
    n, w = a.shape
    out = torch.empty((w, n), dtype=I32, device=a.device)
    kernels.call("to_mont_cols", a.device, kernels.ptr(a), kernels.ptr(out),
                 n, w, a.stride(0))
    kernels.count("to_mont_cols")
    return out


def mont_pow(a, e: int):
    """a^e for a static Python-int exponent (square and multiply)."""
    if e < 0:
        raise ValueError("negative exponent; use mont_inv")
    result = torch.full_like(a, MONT_ONE)
    base = a
    while e:
        if e & 1:
            result = mont_mul(result, base)
        e >>= 1
        if e:
            base = mont_sqr(base)
    return result


def mont_inv(a):
    """Field inverse via Fermat (a^{p-2}); a must be nonzero."""
    return mont_pow(a, P - 2)


def batch_mont_inv_plain(a):
    """Plain version of `batch_mont_inv`: a per-element Fermat power (0
    maps to 0).  The JAX version uses Montgomery's trick over two
    associative scans; a field inverse is unique, so the residues are the
    same."""
    return mont_inv(a)


def batch_mont_inv(a):
    """Elementwise inverse of a nonzero array (Montgomery in and out).
    Kernel K7 on a CUDA tensor, the Fermat power on a CPU tensor."""
    if a.device.type != "cuda":
        return batch_mont_inv_plain(a)
    kernels.require_int32_cuda(a, "batch_mont_inv")
    src = a.contiguous()
    out = torch.empty_like(src)
    kernels.call("batch_inv", a.device, kernels.ptr(src), kernels.ptr(out),
                 src.numel())
    kernels.count("batch_inv")
    return out


def divisor_stack_inv_plain(pts_m, head, consts):
    """Plain version of `divisor_stack_inv`: the stack made as the
    prover made it before the kernel (canonical int64 differences, one
    conversion to Montgomery form), then `batch_mont_inv_plain`."""
    pts = from_mont(pts_m).to(torch.int64)
    stack = torch.cat(
        [torch.tensor([int(v) % P for v in head], dtype=torch.int64,
                      device=pts.device)]
        + [(pts - int(c)) % P for c in consts]).to(I32)
    return batch_mont_inv_plain(to_mont(stack))


def divisor_stack_inv(pts_m, head, consts):
    """The inverses of [head..., pts - consts[0], pts - consts[1], ...]
    (B + len(consts) N,) for the domain points pts_m (N,) (Montgomery)
    and canonical ints head and consts: the quotient's divisor stack.  0
    where a value is 0.  On a CUDA tensor kernel K7 inverts the head and
    its divisor entry the rest, from pts_m alone (the differences are
    never stored)."""
    if pts_m.device.type != "cuda":
        return divisor_stack_inv_plain(pts_m, head, consts)
    kernels.require_int32_cuda(pts_m, "divisor_stack_inv")
    dev = pts_m.device
    src = pts_m.contiguous()
    B, N = len(head), src.numel()
    out = torch.empty(B + len(consts) * N, dtype=I32, device=dev)
    if B:
        out[:B] = batch_mont_inv(mont_tensor(list(head), dev))
    if consts:
        cm = mont_tensor(list(consts), dev)
        kernels.call("divisor_inv", dev, kernels.ptr(src), kernels.ptr(cm),
                     len(consts), kernels.ptr(out[B:]), N)
        kernels.count("divisor_inv")
    return out


def sum_mod(x, dim: int = -1):
    """Mod-p sum along `dim` (int64 accumulation; exact below 2^32 terms)."""
    return (x.to(torch.int64).sum(dim=dim) % P).to(I32)


# ---------------------------------------------------------------------------
# Modular matmul: kernel K3 (csrc/mod_matmul.cu) with its plain version
# ---------------------------------------------------------------------------

# below this many rows, and with k above one k-slice, the split-k kernel
# (a block per group of rows and k-slice) keeps the card busy; otherwise
# one thread per row does.  The open phase's shapes, (115, 2^19) ..
# (354, 2^19) and (90, 2^22), take 128-1,024 slices.  _SPLITK_CHUNK is
# SPLIT_CHUNK of csrc/mod_matmul.cu (256 threads x 16 positions).
_SPLITK_MAX_ROWS = 2048
_SPLITK_CHUNK = 4096


def mod_matmul_plain(a, b, montgomery: bool = True):
    """Plain PyTorch `a @ b mod p`; a: (..., n, k), b: (k, m) int32.

    Sums canonical products (a*b mod p) in int64 over k-slices small
    enough to bound the temporaries; exact for any k < 2^32."""
    lead = a.shape[:-1]
    k = a.shape[-1]
    if b.shape[0] != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m = b.shape[1]
    a2 = a.reshape(-1, k)
    n = a2.shape[0]
    acc = torch.zeros((n, m), dtype=torch.int64, device=a.device)
    b64 = b.to(torch.int64)
    step = max(1, (1 << 24) // max(1, n * m))
    for k0 in range(0, k, step):
        a_c = a2[:, k0:k0 + step].to(torch.int64)
        prod = (a_c[:, :, None] * b64[None, k0:k0 + step, :]) % P
        acc += prod.sum(dim=1)
        acc %= P
    if montgomery:
        # sum (aR)(bR) = R^2 * sum ab  ->  one R^{-1} gives R * sum ab
        acc = (acc * _RINV) % P
    return acc.to(I32).reshape(lead + (m,))


def mod_matmul(a, b, montgomery: bool = True):
    """Exact `a @ b mod p`; a: (..., n, k) (any strides), b: (k, m).

    With montgomery=True inputs and result are Montgomery form; with
    montgomery=False all values are canonical (the JAX function's two
    modes).  On a CUDA tensor this launches kernel K3.  Callers that have
    two right-hand sides for one `a` pass them side by side, m = 8: one
    read of `a` (the results are the same columns)."""
    if a.device.type != "cuda":
        return mod_matmul_plain(a, b, montgomery)
    kernels.require_int32_cuda(a, "mod_matmul a")
    kernels.require_int32_cuda(b, "mod_matmul b")
    k = a.shape[-1]
    if b.shape[0] != k or b.dim() != 2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m = b.shape[1]
    if m > 8:
        raise ValueError("mod_matmul kernel supports at most 8 outputs")
    lead = a.shape[:-1]
    if a.dim() != 2:
        a = a.reshape(-1, k)
    n = a.shape[0]
    b = b.contiguous()
    out = torch.empty((n, m), dtype=I32, device=a.device)
    rs, cs = a.stride(0), a.stride(1)
    mont = 1 if montgomery else 0
    if n > _SPLITK_MAX_ROWS or k <= _SPLITK_CHUNK:
        kernels.call("mod_matmul_rows", a.device, kernels.ptr(a),
                     kernels.ptr(b), kernels.ptr(out), n, k, m, rs, cs, mont)
    else:
        splits = -(-k // _SPLITK_CHUNK)
        part = torch.empty((n, splits, m), dtype=I32, device=a.device)
        kernels.call("mod_matmul_splitk", a.device, kernels.ptr(a),
                     kernels.ptr(b), kernels.ptr(part), kernels.ptr(out), n,
                     k, m, rs, cs, splits, mont)
    kernels.count("mod_matmul")
    return out.reshape(lead + (m,))
