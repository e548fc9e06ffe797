"""The fused prove step: trace -> LDE -> Merkle commit -> DEEP combination
-> FRI fold chain, with the Fiat-Shamir challenges as inputs.

Port of `ethrex_tpu/parallel/core.py` `build_prove_step` (`step`, :86),
the reference's second entry point (`__graft_entry__.entry()` and the
bench's core measurement), on one device and with no mesh.  Its steps and
kernels, in the reference's order:

  1. coset LDE of the trace columns                          K1
  2. Merkle root over the LDE rows                           K2
  3. the trace at zeta (iNTT, power table, matmul)           K1, K11, K3
     and the DEEP codeword (comb - const) / (x - zeta),      K3, K8
     where comb = LDE rows @ gamma powers
  4. every FRI fold first                                    K4
     then one leaf hash over every layer's paired leaves     K2
     and every layer's root, level by level                  K10

The values equal the reference's jitted step bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import require_cuda
from ..ops import babybear as bb
from ..ops import ext
from ..ops import fri
from ..ops import merkle
from ..ops import ntt
from ..ops import poseidon2 as p2


def build_prove_step(log_n: int, width: int, log_blowup: int = 2,
                     log_final_size: int = 5, device=None):
    """Returns (step_fn, example_args).  step_fn(trace_cols, zeta, gamma,
    betas) -> (trace_root (8,), fri_roots (tuple of (8,)), final_codeword
    (2^log_final_size, 4)).

    trace_cols: (width, n) int32 Montgomery; zeta, gamma: (4,) ext;
    betas: (L, 4) ext FRI challenges, L = log_n + log_blowup -
    log_final_size.  The tables and the example arguments live on
    `device` (the card unless the caller asks for the CPU); the example
    arguments come from np.random.default_rng(0) as the reference's do."""
    device = require_cuda(device)
    n = 1 << log_n
    log_N = log_n + log_blowup
    L = log_N - log_final_size
    shift = bb.GENERATOR
    pts_m = bb.from_numpy(bb.to_mont_host(ntt.domain_points(log_N, shift)),
                          device)
    inv2 = bb.from_numpy(bb.to_mont_host(np.array([fri._INV2])), device)
    fold_invs = []
    s = shift
    for k in range(L):
        fold_invs.append(bb.from_numpy(fri._fold_inv_points_np(log_N - k, s),
                                       device))
        s = (s * s) % bb.P

    def step(trace_cols, zeta, gamma, betas):
        # 1-2. column LDE, then the root of the tree over its rows
        lde_cols = ntt.coset_lde(trace_cols, log_blowup, shift=shift)
        lde_rows = lde_cols.T
        troot = merkle.commit_levels(lde_rows)[-1][0]
        # 3. sum_w gamma^w (T_w(x) - T_w(zeta)) / (x - zeta)
        tz = ext.eval_base_poly_at_ext(ntt.intt(trace_cols), zeta)
        gpow = ext.ext_powers(gamma, width, device)
        comb = bb.mod_matmul(lde_rows, gpow)
        del lde_cols, lde_rows
        cw = ext.deep_compose(pts_m, [(ext.to_host(zeta), comb, tz, gpow)])
        del comb
        # 4. fold all layers first, then hash every layer's paired leaves
        # in one call and build all the trees level by level
        layer_leaves = []
        for k in range(L):
            half = cw.shape[0] // 2
            layer_leaves.append(torch.cat([cw[:half], cw[half:]], dim=-1))
            cw = fri.fold(cw, betas[k], fold_invs[k], inv2)
        sizes = tuple(lv.shape[0] for lv in layer_leaves)
        digests = p2.hash_leaves(torch.cat(layer_leaves))
        del layer_leaves
        fri_roots = merkle.batched_roots(digests, sizes)
        return troot, tuple(fri_roots), cw

    rng = np.random.default_rng(0)
    trace = rng.integers(0, bb.P, size=(width, n), dtype=np.uint32)

    def ext_arg():
        return ext.to_device(tuple(int(x) for x in rng.integers(0, bb.P, 4)),
                             device)

    example_args = (bb.from_numpy(bb.to_mont_host(trace), device), ext_arg(),
                    ext_arg(), torch.stack([ext_arg() for _ in range(L)]))
    return step, example_args
