"""DEEP-FRI STARK prover over PyTorch tensors, with the hot kernels in CUDA.

Port of `ethrex_tpu/stark/prover.py` (`prove`, :632, and the phase bodies
of `_build_phases`, :458-583).  Pipeline per proof:

  1. commit    coset LDE (kernel K1) + Poseidon2 Merkle tree (K2)
  2. quotient  alpha <- transcript; AIR constraints over the LDE domain
               and their alpha-combination in one pass (generated kernel
               K6, stark/air_codegen.py `combine`), divisor inverses (K7,
               once per shape), divisors and boundary terms (K9), coset
               iNTT and chunk re-evaluation (K1), Merkle (K2)
  3. open      zeta <- transcript; trace and quotient at zeta, zeta*g
               (K1 iNTT; K11: both power tables and the quotient chunks
               at zeta in one launch; K3 at both points in one pass)
  4. deep      gamma <- transcript; the DEEP composition codeword (K3 at
               both openings' powers in one pass, then K8)
  5. fri       fold (K4) + Merkle (K2) per layer, query openings

The transcript order, the host query openings and the proof dict (keys and
value types) are the JAX prover's, so proofs are equal under
`json.dumps(..., sort_keys=True)`.  Left out for a later slice: the
checkpoint store, the fault legs and degradation ladder, tracing spans and
mesh sharding (with checkpointing off they never change the proof bytes).

Phase walls are bounded by `torch.cuda.synchronize()` on the card and
returned by `prove_with_stats`, with each phase's span on the host's
`time.perf_counter()` clock (so a profiler trace can be cut by phase).  The build-time tables (periodic-column
LDEs, the divisor inverses, the domain points) are cached per
(air.cache_key(), log_n, log_blowup, shift, device).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import require_cuda
from ..ops import babybear as bb
from ..ops import ext
from ..ops import fri
from ..ops import merkle
from ..ops import ntt
from ..ops.challenger import Challenger
from . import air_codegen
from .air import Air


@dataclasses.dataclass(frozen=True)
class StarkParams:
    log_blowup: int = 2
    num_queries: int = 40
    log_final_size: int = 5
    shift: int = bb.GENERATOR
    grinding_bits: int = 16


def _stretch_coeffs(coeffs: np.ndarray, n: int, p_len: int) -> np.ndarray:
    """Spread period-p coefficients onto the size-n domain:
    f(x) = g(x^{n/p}) has coeff k*(n/p) = g_k."""
    out = np.zeros(n, dtype=np.uint32)
    out[:: n // p_len] = coeffs
    return out


@dataclasses.dataclass
class _Tables:
    periodic: torch.Tensor  # (P, N) Montgomery LDE of the periodic columns
    inv_stack: torch.Tensor  # [1/(x^n - 1) per coset class (B), 1/(x - g^{n-1}),
    #                          1/(x - g^r) per boundary], Montgomery
    x_minus_glast: torch.Tensor
    pts_m: torch.Tensor      # domain points, Montgomery
    bounds_struct: list
    num_constraints: int


_TABLE_CACHE: dict = {}


def _tables(air: Air, log_n: int, lb: int, shift: int, device) -> _Tables:
    key = (air.cache_key(), log_n, lb, shift, str(device))
    cached = _TABLE_CACHE.get(key)
    if cached is not None:
        return cached
    n = 1 << log_n
    B = 1 << lb
    N = n << lb
    log_N = log_n + lb
    g_n = bb.root_of_unity(log_n)
    bounds_struct = [(r % n, c) for (r, c, _) in
                     air.boundaries([0] * air.num_pub_inputs, n)]

    pts_m = bb.to_mont_cols(bb.from_numpy(
        ntt.domain_points(log_N, shift), device)[:, None])[0]
    glast = pow(g_n, n - 1, bb.P)
    s_n = pow(shift, n, bb.P)
    uB = pow(bb.root_of_unity(log_N), n, bb.P)
    # [1/(x^n - 1) per coset class, 1/(x - g^(n-1)), 1/(x - g^r) per
    # boundary]: K7's divisor entry makes the differences from pts_m as
    # it inverts them
    inv_stack = bb.divisor_stack_inv(
        pts_m, [(s_n * pow(uB, i, bb.P) - 1) % bb.P for i in range(B)],
        [glast] + [pow(g_n, r, bb.P) for (r, _) in bounds_struct])

    periodic_cols = air.periodic_columns(n)
    if len(periodic_cols) != air.num_periodic:
        raise ValueError("periodic_columns does not match num_periodic")
    periodic = torch.empty((0, N), dtype=bb.I32, device=device)
    if periodic_cols:
        rows = []
        for vals in periodic_cols:
            vals = np.asarray(vals, dtype=np.uint32) % bb.P
            p_len = len(vals)
            if n % p_len:
                raise ValueError("periodic column length must divide n")
            coeffs = bb.to_mont_host(ntt.interpolate_host(vals))
            rows.append(_stretch_coeffs(coeffs, n, p_len))
        periodic = ntt.coset_evals_from_coeffs(
            bb.from_numpy(np.stack(rows), device), N, shift=shift)
    tables = _Tables(
        periodic=periodic, inv_stack=inv_stack,
        x_minus_glast=bb.sub(pts_m, bb.const(glast, device)), pts_m=pts_m,
        bounds_struct=bounds_struct,
        num_constraints=air.num_constraints)
    _TABLE_CACHE[key] = tables
    return tables


# ---------------------------------------------------------------------------
# phase bodies
# ---------------------------------------------------------------------------

def phase_commit(cols, lb: int, shift: int):
    """cols (w, n) -> (lde_cols (w, N), Merkle levels over its rows)."""
    lde_cols = ntt.coset_lde(cols, lb, shift=shift)
    levels = merkle.commit_levels(lde_cols.T)   # rows read in place
    return lde_cols, levels


def phase_quotient(air: Air, tb: _Tables, lde_cols, alpha, bound_vals,
                   n: int, lb: int, shift: int):
    """Returns (chunks (B, n, 4), q_lde (B, 4, N), Merkle levels)."""
    device = lde_cols.device
    B = 1 << lb
    w, N = lde_cols.shape
    K = tb.num_constraints
    nb = len(tb.bounds_struct)
    # the alpha powers, made on the host (the combination's kernels take
    # them as launch parameters)
    apow = ext.ext_powers(alpha, K + nb, "cpu")                    # (K+nb, 4)
    # random linear combination of the constraints, sum_k C_k(x) alpha^k:
    # kernel K6 folds each constraint into the sum as it makes it, so the
    # (K, N) constraint block of the reference never exists; the next row
    # of LDE point i is point i + B (read in place; the plain version
    # rolls the LDE)
    acc = air_codegen.combine(air, lde_cols, tb.periodic, B, apow)  # (N, 4)
    # the divisors and the boundary terms (kernel K9)
    q_acc = ext.quotient_combine(
        acc, tb.x_minus_glast, tb.inv_stack, lde_cols,
        [c for (_, c) in tb.bounds_struct], bound_vals,
        apow[K:K + nb].to(device), B)
    del acc
    qc_t = ntt.coset_intt(q_acc.T.contiguous(), shift=shift)      # (4, N)
    chunks_t = qc_t.reshape(4, B, n).permute(1, 0, 2)              # (B, 4, n)
    q_lde = ntt.coset_evals_from_coeffs(chunks_t, N, shift=shift)  # (B, 4, N)
    levels = merkle.commit_levels(q_lde.reshape(B * 4, N).T)
    return chunks_t.permute(0, 2, 1), q_lde, levels


def phase_open(cols, chunks, zeta, zeta_g):
    """The trace (w, n) and the quotient chunks (B, n, 4) at zeta and
    zeta g (canonical host tuples): (t_z, t_zg, q_z)."""
    tcoeffs = ntt.intt(cols)
    # both points' power tables, in the column blocks of K3's (n, 8)
    # operand, and the chunks at zeta in one pass (K11); then the trace
    # at both points in one pass over its coefficients (K3)
    pows, q_z = ext.open_powers((zeta, zeta_g), tcoeffs.shape[-1], chunks)
    res = bb.mod_matmul(tcoeffs, pows)
    return res[..., :4], res[..., 4:], q_z


def phase_deep(tb: _Tables, lde_cols, q_lde, t_z, t_zg, q_z, zeta, zeta_g,
               gamma):
    device = lde_cols.device
    w = lde_cols.shape[0]
    B = q_lde.shape[0]
    gpow = ext.ext_powers(gamma, 2 * w + B, device)
    lde_rows = lde_cols.T
    # the two column combinations in one pass over the LDE (K3, m = 8),
    # then 1/(x - zeta), 1/(x - zeta g), the quotient chunks and the sum
    # in one pass (K8, which reads the two halves of each row in place)
    s12 = bb.mod_matmul(lde_rows, torch.cat([gpow[:w], gpow[w:2 * w]],
                                            dim=1))                # (N, 8)
    return ext.deep_compose(
        tb.pts_m, [(zeta, s12[:, :4], t_z, gpow[:w]),
                   (zeta_g, s12[:, 4:], t_zg, gpow[w:2 * w])],
        q_lde=q_lde, q_z=q_z, gq=gpow[2 * w:])


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------

def _canon_rows(t: torch.Tensor) -> np.ndarray:
    return bb.from_mont_host(bb.to_numpy(t))


def prove(air: Air, trace: np.ndarray, pub_inputs: list[int],
          params: StarkParams = StarkParams(), device="cuda") -> dict:
    """Prove one AIR on `device` ("cuda" unless the caller asks for the
    CPU); the proof dict equals the JAX prover's."""
    return prove_with_stats(air, trace, pub_inputs, params, device)[0]


def prove_with_stats(air: Air, trace: np.ndarray, pub_inputs: list[int],
                     params: StarkParams = StarkParams(), device="cuda"):
    """`prove`, also returning {"phase_s": {phase: wall seconds},
    "phase_spans": [(phase, start, end) on time.perf_counter()],
    "peak_bytes_by_phase": {phase: torch.cuda.max_memory_allocated at
    its end} (on the card), ...}."""
    device = require_cuda(device)
    n, w = trace.shape
    if w != air.width:
        raise ValueError(f"trace width {w} != AIR width {air.width}")
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("trace length must be a power of two")
    lb = params.log_blowup
    B = 1 << lb
    if air.max_degree > B:
        raise ValueError("constraint degree exceeds blowup")
    if len(pub_inputs) != air.num_pub_inputs:
        raise ValueError("public input count mismatch")
    N = n << lb
    shift = params.shift % bb.P
    g_n = bb.root_of_unity(log_n)

    walls: dict = {}
    spans: list = []
    peaks: dict = {}
    clock = [time.perf_counter()]

    def mark(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            # the running peak since the caller last reset it: the phase
            # where it rises is the one that sets it
            peaks[name] = torch.cuda.max_memory_allocated(device)
        now = time.perf_counter()
        walls[name] = walls.get(name, 0.0) + (now - clock[0])
        spans.append((name, clock[0], now))
        clock[0] = now

    t_start = clock[0]
    tb = _tables(air, log_n, lb, shift, device)
    mark("tables")

    ch = Challenger()
    ch.absorb_elems([n, w, B])
    ch.absorb_elems([v % bb.P for v in pub_inputs])
    cols = bb.to_mont_cols(bb.from_numpy(trace, device))   # (w, n)
    mark("upload")

    # ---- 1. trace commitment --------------------------------------------
    lde_cols, levels_t = phase_commit(cols, lb, shift)
    trace_root = bb.to_numpy(levels_t[-1][0])
    ch.absorb_digest(trace_root)
    mark("commit")
    alpha = ch.sample_ext()

    # ---- 2. constraint quotient -----------------------------------------
    bounds = air.boundaries(pub_inputs, n)
    bound_vals = bb.mont_tensor([v % bb.P for (_, _, v) in bounds], device)
    chunks, q_lde, levels_q = phase_quotient(
        air, tb, lde_cols, alpha, bound_vals, n, lb, shift)
    q_root = bb.to_numpy(levels_q[-1][0])
    ch.absorb_digest(q_root)
    mark("quotient")
    zeta = ch.sample_ext()

    # ---- 3. out-of-domain openings --------------------------------------
    zeta_g = ext.h_mul(zeta, ext.h_from_base(g_n))
    t_z, t_zg, q_z = phase_open(cols, chunks, zeta, zeta_g)
    t_at_z = [tuple(int(x) for x in row) for row in _canon_rows(t_z)]
    t_at_zg = [tuple(int(x) for x in row) for row in _canon_rows(t_zg)]
    q_at_z = [tuple(int(x) for x in row) for row in _canon_rows(q_z)]
    for tup in t_at_z + t_at_zg + q_at_z:
        ch.absorb_ext(tup)
    del cols, chunks
    mark("open")
    gamma = ch.sample_ext()

    # ---- 4. DEEP composition + 5. FRI ------------------------------------
    F = phase_deep(tb, lde_cols, q_lde, t_z, t_zg, q_z, zeta, zeta_g, gamma)
    mark("deep")
    fparams = fri.FriParams(
        log_blowup=lb, num_queries=params.num_queries,
        log_final_size=params.log_final_size, shift=shift,
        grinding_bits=params.grinding_bits,
    )
    fprover = fri.FriProver(fparams)
    fri_proof, indices = fprover.prove(F, ch)
    fri_dict = {
        "roots": fri_proof.roots,
        "final_coeffs": [list(c) for c in fri_proof.final_coeffs],
        "queries": fri_proof.queries,
        "pow_nonce": fri_proof.pow_nonce,
    }
    del F, fprover
    mark("fri")

    # ---- openings of trace/quotient at the query indices -----------------
    half = N // 2
    idx = np.asarray(indices, dtype=np.int64)
    both = np.concatenate([idx, idx + half])
    sel = torch.from_numpy(both).to(device)
    t_rows = _canon_rows(lde_cols[:, sel].T)                 # (2Q, w)
    q_rows = _canon_rows(q_lde.reshape(B * 4, N)[:, sel].T)  # (2Q, 4B)
    t_paths = merkle.open_paths(levels_t, both)
    q_paths = merkle.open_paths(levels_q, both)
    nq = len(indices)
    openings = []
    for qi in range(nq):
        entry = {}
        for name, rows_c, paths in (("trace", t_rows, t_paths),
                                    ("quotient", q_rows, q_paths)):
            for tag, k in (("lo", qi), ("hi", nq + qi)):
                entry[f"{name}_{tag}"] = [int(v) for v in rows_c[k]]
                entry[f"{name}_{tag}_path"] = paths[k]
        openings.append(entry)
    mark("query")

    proof = {
        "n": n, "width": w, "log_blowup": lb,
        "pub_inputs": [int(v) % bb.P for v in pub_inputs],
        "trace_root": [int(x) for x in bb.from_mont_host(trace_root)],
        "quotient_root": [int(x) for x in bb.from_mont_host(q_root)],
        "trace_at_zeta": [tuple(v) for v in t_at_z],
        "trace_at_zeta_g": [tuple(v) for v in t_at_zg],
        "quotient_at_zeta": [tuple(v) for v in q_at_z],
        "fri": fri_dict,
        "openings": openings,
    }
    stats = {"phase_s": walls, "phase_spans": spans,
             "peak_bytes_by_phase": peaks,
             "total_s": time.perf_counter() - t_start,
             "device": str(device), "n": n, "width": w, "N": N,
             "num_constraints": tb.num_constraints}
    return proof, stats
