"""FRI low-degree test over the BabyBear quartic extension.

Port of `ethrex_tpu/ops/fri.py`.  Codeword convention: evaluations over the
coset shift*<g> of size N in natural order; one fold pairs index i with
i + N/2:

    f'(y_i) = (f(x_i) + f(-x_i))/2 + beta * (f(x_i) - f(-x_i)) / (2 x_i)

Each layer commits a Merkle tree whose leaf i is (f[i], f[i+N/2]) as 8
base limbs (hashed in place from the codeword, kernel K2), then folds with
kernel K4 (`csrc/fri_fold.cu`).  Layers stay on the device; the query
openings gather only the rows and siblings they need.  `verify` is a copy
of the host verifier.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from . import babybear as bb
from . import ext
from . import merkle
from . import ntt as _ntt
from .challenger import Challenger

_INV2 = int(bb.inv_host(2))


def _fold_inv_points_np(log_n: int, shift: int) -> np.ndarray:
    """Montgomery inverses of the first half of the coset domain points."""
    n = 1 << log_n
    g_inv = bb.inv_host(bb.root_of_unity(log_n))
    s_inv = bb.inv_host(shift % bb.P)
    pows = bb.powers_host(g_inv, n // 2)
    return bb.to_mont_host((pows.astype(np.uint64) * s_inv) % bb.P)


def fold_plain(codeword, beta, inv_pts, inv2):
    """Plain PyTorch version of `fold` (the JAX `_fold`)."""
    half = codeword.shape[0] // 2
    lo = codeword[:half]
    hi = codeword[half:]
    s = ext.scalar_mul(ext.add(lo, hi), inv2.expand(half))
    d = ext.scalar_mul(ext.sub(lo, hi), bb.mont_mul(inv2, inv_pts))
    return ext.add(s, ext.mul(beta.expand(d.shape), d))


def fold(codeword, beta, inv_pts, inv2):
    """One fold: codeword (2h, 4), beta (4,), inv_pts (h,), inv2 (1,), all
    Montgomery -> (h, 4).  Kernel K4 on a CUDA tensor."""
    if codeword.device.type != "cuda":
        return fold_plain(codeword, beta, inv_pts, inv2)
    for t, name in ((codeword, "codeword"), (beta, "beta"),
                    (inv_pts, "inv_pts"), (inv2, "inv2")):
        kernels.require_int32_cuda(t, f"fri fold {name}")
    codeword = codeword.contiguous()
    half = codeword.shape[0] // 2
    if codeword.shape != (2 * half, 4) or inv_pts.numel() != half:
        raise ValueError("fold expects a (2h, 4) codeword and h points")
    out = torch.empty((half, 4), dtype=bb.I32, device=codeword.device)
    kernels.call("fri_fold", codeword.device, kernels.ptr(codeword),
                 kernels.ptr(beta.contiguous()),
                 kernels.ptr(inv_pts.contiguous()),
                 kernels.ptr(inv2.contiguous()), kernels.ptr(out), half)
    kernels.count("fri_fold")
    return out


def pair_leaves(codeword):
    """The layer's leaf matrix, (f[i] || f[i+N/2]) per row, as the grouped
    (2, N/2, 4) view that `poseidon2.hash_leaves` reads in place."""
    half = codeword.shape[0] // 2
    return codeword.reshape(2, half, 4)


@dataclasses.dataclass
class FriParams:
    log_blowup: int = 2
    num_queries: int = 40
    log_final_size: int = 5
    shift: int = bb.GENERATOR
    grinding_bits: int = 16


@dataclasses.dataclass
class FriProof:
    roots: list
    final_coeffs: list
    queries: list
    pow_nonce: int = 0


class FriProver:
    """Holds per-layer device state so queries can be opened after index
    sampling."""

    def __init__(self, params: FriParams):
        self.params = params

    def commit_phase(self, codeword, challenger: Challenger):
        p = self.params
        dev = codeword.device
        log_n = codeword.shape[0].bit_length() - 1
        shift = p.shift % bb.P
        inv2 = bb.from_numpy(bb.to_mont_host(np.array([_INV2])), dev)
        self.layers = []   # (codeword, levels) device tensors
        self.roots = []
        while log_n > p.log_final_size:
            levels = merkle.commit_levels(pair_leaves(codeword))
            root = [int(x) for x in bb.from_mont_host(bb.to_numpy(
                levels[-1][0]))]
            challenger.absorb_elems(root)
            self.layers.append((codeword, levels))
            self.roots.append(root)
            beta = ext.to_device(challenger.sample_ext(), dev)
            inv_pts = bb.from_numpy(_fold_inv_points_np(log_n, shift), dev)
            codeword = fold(codeword, beta, inv_pts, inv2)
            shift = (shift * shift) % bb.P
            log_n -= 1
        coeffs_dev = _ntt.coset_intt(codeword.T.contiguous(), shift=shift).T
        coeffs = bb.from_mont_host(bb.to_numpy(coeffs_dev))
        self.final_coeffs = [tuple(int(v) for v in row) for row in coeffs]
        deg_bound = (1 << p.log_final_size) >> p.log_blowup
        for row in self.final_coeffs[deg_bound:]:
            if row != (0, 0, 0, 0):
                raise ValueError("FRI final polynomial exceeds degree bound "
                                 "(input codeword was not low-degree)")
        for row in self.final_coeffs:
            challenger.absorb_ext(row)
        return self.roots, self.final_coeffs

    def open_queries(self, indices) -> list:
        out = [[] for _ in indices]
        idx = np.asarray(indices, dtype=np.int64)
        for codeword, levels in self.layers:
            half = codeword.shape[0] // 2
            idx = idx % half
            sel = torch.from_numpy(np.concatenate([idx, idx + half])).to(
                codeword.device)
            vals = bb.from_mont_host(bb.to_numpy(codeword[sel]))
            paths = merkle.open_paths(levels, idx)
            nq = len(idx)
            for q in range(nq):
                lo = tuple(int(v) for v in vals[q])
                hi = tuple(int(v) for v in vals[nq + q])
                out[q].append({"values": [lo, hi], "path": paths[q]})
        return out

    def prove(self, codeword, challenger: Challenger):
        """Full FRI round.  Returns (FriProof, query_indices)."""
        self.commit_phase(codeword, challenger)
        nonce = challenger.grind(self.params.grinding_bits)
        n0 = self.layers[0][0].shape[0]
        bits = (n0 // 2).bit_length() - 1
        indices = challenger.sample_indices(bits, self.params.num_queries)
        queries = self.open_queries(indices)
        return (FriProof(self.roots, self.final_coeffs, queries, nonce),
                indices)


def verify(proof: FriProof, log_n0: int, challenger: Challenger,
           params: FriParams):
    """Host-side FRI verification (canonical arithmetic only).

    Returns (query_indices, layer0_values); raises ValueError on failure."""
    p_ = params
    num_layers = log_n0 - p_.log_final_size
    if len(proof.roots) != num_layers:
        raise ValueError("FRI: wrong number of layer roots")

    betas = []
    shifts = []
    shift = p_.shift % bb.P
    for root in proof.roots:
        challenger.absorb_elems(root)
        betas.append(challenger.sample_ext())
        shifts.append(shift)
        shift = (shift * shift) % bb.P
    final_shift = shift
    final_size = 1 << p_.log_final_size
    if len(proof.final_coeffs) != final_size:
        raise ValueError("FRI: wrong final coefficient count")
    deg_bound = final_size >> p_.log_blowup
    for row in proof.final_coeffs[deg_bound:]:
        if tuple(row) != (0, 0, 0, 0):
            raise ValueError("FRI: final polynomial exceeds degree bound")
    for row in proof.final_coeffs:
        challenger.absorb_ext(row)
    if not challenger.check_grind(proof.pow_nonce, p_.grinding_bits):
        raise ValueError("FRI: proof-of-work grinding check failed")

    bits = log_n0 - 1
    indices = challenger.sample_indices(bits, p_.num_queries)
    if len(proof.queries) != p_.num_queries:
        raise ValueError("FRI: wrong query count")

    inv2 = bb.inv_host(2)
    layer0_values = []
    for q, per_layer in zip(indices, proof.queries):
        if len(per_layer) != num_layers:
            raise ValueError("FRI: wrong layer count in query")
        carried = None
        raw = q
        for k, opening in enumerate(per_layer):
            log_nk = log_n0 - k
            half = 1 << (log_nk - 1)
            idx = raw % half
            lo, hi = (tuple(int(v) for v in x) for x in opening["values"])
            if len(lo) != 4 or len(hi) != 4:
                raise ValueError("FRI: opening values must be 4-limb ext elements")
            if not merkle.verify_opening(
                proof.roots[k], idx, list(lo) + list(hi), opening["path"],
                log_nk - 1,
            ):
                raise ValueError(f"FRI: bad merkle opening at layer {k}")
            if carried is not None:
                got = lo if raw < half else hi
                if got != carried:
                    raise ValueError(f"FRI: fold mismatch entering layer {k}")
            if k == 0:
                layer0_values.append((idx, lo, hi))
            x = shifts[k] * pow(bb.root_of_unity(log_nk), idx, bb.P) % bb.P
            s = ext.h_scalar_mul(ext.h_add(lo, hi), inv2)
            d = ext.h_scalar_mul(
                ext.h_sub(lo, hi), inv2 * bb.inv_host(x) % bb.P
            )
            carried = ext.h_add(s, ext.h_mul(betas[k], d))
            raw = idx
        log_nf = log_n0 - num_layers
        x_f = final_shift * pow(bb.root_of_unity(log_nf), raw, bb.P) % bb.P
        acc = ext.ZERO_H
        for c in reversed(proof.final_coeffs):
            acc = ext.h_add(ext.h_mul(acc, ext.h_from_base(x_f)), tuple(c))
        if acc != carried:
            raise ValueError("FRI: final polynomial mismatch")
    return indices, layer0_values
