"""Independent host-side STARK verifier (canonical-integer arithmetic).

A copy of `ethrex_tpu/stark/verifier.py`, so that the port checks its own
proofs without the JAX package.  The periodic-column interpolants come from
the port's O(p log p) `interpolate_host`, which returns the same
coefficients as the reference's O(p^2) one.
"""

from __future__ import annotations

import numpy as np

from ..ops.ntt import interpolate_host
from ..ops import babybear as bb
from ..ops import ext
from ..ops import fri
from ..ops import merkle
from ..ops.challenger import Challenger
from .air import Air, HostExtOps
from .prover import StarkParams


class VerificationError(Exception):
    pass


_INTERP_CACHE: dict = {}


def _periodic_interpolants(air: Air, n: int) -> list[list[int]]:
    """Coefficient vectors of the AIR's periodic columns (O(p^2) host
    interpolation done once per (AIR structure, n))."""
    key = (air.cache_key(), n)
    cached = _INTERP_CACHE.get(key)
    if cached is None:
        cached = [
            [int(v) for v in interpolate_host(
                np.asarray(vals, dtype=np.uint32) % bb.P)]
            for vals in air.periodic_columns(n)
        ]
        _INTERP_CACHE[key] = cached
    return cached


def _fail(msg: str):
    raise VerificationError(msg)


def verify(air: Air, proof: dict, params: StarkParams = StarkParams(),
           fri_verify_fn=None):
    """Verify an untrusted proof dict.  Returns True or raises
    VerificationError — structural garbage (missing keys, wrong types) is
    converted to VerificationError, never an unhandled crash.

    `fri_verify_fn(fri_proof, log_N, challenger, fparams) -> (indices,
    layer0)` overrides the FRI query verification step — the aggregation
    path (stark/aggregate.py) substitutes a derivation that defers the
    Merkle-opening work to the outer recursion STARK."""
    try:
        return _verify(air, proof, params, fri_verify_fn)
    except VerificationError:
        raise
    except (KeyError, TypeError, IndexError, ValueError, AttributeError) as e:
        raise VerificationError(f"malformed proof: {type(e).__name__}: {e}")


def _verify(air: Air, proof: dict, params: StarkParams,
            fri_verify_fn=None):
    n = proof["n"]
    w = proof["width"]
    lb = proof["log_blowup"]
    if lb != params.log_blowup:
        _fail("blowup mismatch")
    if w != air.width:
        _fail("width mismatch")
    B = 1 << lb
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        _fail("bad trace length")
    N = n << lb
    log_N = log_n + lb
    shift = params.shift % bb.P
    g_n = bb.root_of_unity(log_n)
    g_N = bb.root_of_unity(log_N)
    pub = [int(v) % bb.P for v in proof["pub_inputs"]]
    if len(pub) != air.num_pub_inputs:
        _fail("public input count mismatch")

    ch = Challenger()
    ch.absorb_elems([n, w, B])
    ch.absorb_elems(pub)
    ch.absorb_elems(proof["trace_root"])
    alpha = ch.sample_ext()
    ch.absorb_elems(proof["quotient_root"])
    zeta = ch.sample_ext()

    t_at_z = [tuple(int(x) for x in t) for t in proof["trace_at_zeta"]]
    t_at_zg = [tuple(int(x) for x in t) for t in proof["trace_at_zeta_g"]]
    q_at_z = [tuple(int(x) for x in t) for t in proof["quotient_at_zeta"]]
    if len(t_at_z) != w or len(t_at_zg) != w or len(q_at_z) != B:
        _fail("opening count mismatch")
    for tup in t_at_z + t_at_zg + q_at_z:
        ch.absorb_ext(tup)
    gamma = ch.sample_ext()

    # ---- constraint identity at zeta ------------------------------------
    hops = HostExtOps()
    # periodic columns: evaluate the cached interpolants at zeta
    periodic_at_z = []
    for coeffs in _periodic_interpolants(air, n):
        p_len = len(coeffs)
        point = ext.h_pow(zeta, n // p_len)   # f(z) = g(z^{n/p})
        acc = ext.ZERO_H
        for c in reversed(coeffs):
            acc = ext.h_add(ext.h_mul(acc, point), ext.h_from_base(c))
        periodic_at_z.append(acc)
    cons = air.constraints(t_at_z, t_at_zg, periodic_at_z, hops)
    bounds = air.boundaries(pub, n)
    zeta_n = ext.h_pow(zeta, n)
    z_trans_num = ext.h_sub(zeta_n, ext.ONE_H)              # zeta^n - 1
    z_trans_den = ext.h_sub(zeta, ext.h_from_base(pow(g_n, n - 1, bb.P)))
    inv_zt = ext.h_div(z_trans_den, z_trans_num)            # 1/Z_t(zeta)

    acc = ext.ZERO_H
    a_pow = ext.ONE_H
    for c in cons:
        acc = ext.h_add(acc, ext.h_mul(a_pow, c))
        a_pow = ext.h_mul(a_pow, alpha)
    lhs = ext.h_mul(acc, inv_zt)
    for (r, c, v) in bounds:
        num = ext.h_sub(t_at_z[c], ext.h_from_base(v))
        den = ext.h_sub(zeta, ext.h_from_base(pow(g_n, r % n, bb.P)))
        lhs = ext.h_add(lhs, ext.h_mul(a_pow, ext.h_div(num, den)))
        a_pow = ext.h_mul(a_pow, alpha)
    rhs = ext.ZERO_H
    zp = ext.ONE_H
    for i in range(B):
        rhs = ext.h_add(rhs, ext.h_mul(zp, q_at_z[i]))
        zp = ext.h_mul(zp, zeta_n)
    if lhs != rhs:
        _fail("constraint identity fails at zeta")

    # ---- FRI -------------------------------------------------------------
    fparams = fri.FriParams(
        log_blowup=lb, num_queries=params.num_queries,
        log_final_size=params.log_final_size, shift=shift,
        grinding_bits=params.grinding_bits,
    )
    fri_proof = fri.FriProof(
        roots=proof["fri"]["roots"],
        final_coeffs=[tuple(c) for c in proof["fri"]["final_coeffs"]],
        queries=proof["fri"]["queries"],
        pow_nonce=int(proof["fri"].get("pow_nonce", 0)),
    )
    try:
        indices, layer0 = (fri_verify_fn or fri.verify)(
            fri_proof, log_N, ch, fparams)
    except ValueError as e:
        _fail(str(e))

    # ---- DEEP cross-check at each query ----------------------------------
    openings = proof["openings"]
    if len(openings) != len(indices):
        _fail("opening count != query count")
    half = N // 2
    zeta_g = ext.h_mul(zeta, ext.h_from_base(g_n))
    for (q, (pair_idx, fri_lo, fri_hi)), entry in zip(
        zip(indices, layer0), openings
    ):
        if pair_idx != q % half:
            _fail("query index mismatch")
        for tag, idx, fri_val in (("lo", q, fri_lo), ("hi", q + half, fri_hi)):
            t_row = [int(v) for v in entry[f"trace_{tag}"]]
            q_row = [int(v) for v in entry[f"quotient_{tag}"]]
            if len(t_row) != w or len(q_row) != B * 4:
                _fail("bad opening row width")
            if not merkle.verify_opening(
                proof["trace_root"], idx, t_row,
                entry[f"trace_{tag}_path"], log_N,
            ):
                _fail("bad trace opening")
            if not merkle.verify_opening(
                proof["quotient_root"], idx, q_row,
                entry[f"quotient_{tag}_path"], log_N,
            ):
                _fail("bad quotient opening")
            x = shift * pow(g_N, idx, bb.P) % bb.P
            x_h = ext.h_from_base(x)
            inv_xz = ext.h_inv(ext.h_sub(x_h, zeta))
            inv_xzg = ext.h_inv(ext.h_sub(x_h, zeta_g))
            val = ext.ZERO_H
            g_pow = ext.ONE_H
            for j in range(w):
                diff = ext.h_sub(ext.h_from_base(t_row[j]), t_at_z[j])
                val = ext.h_add(val, ext.h_mul(g_pow, ext.h_mul(inv_xz, diff)))
                g_pow = ext.h_mul(g_pow, gamma)
            for j in range(w):
                diff = ext.h_sub(ext.h_from_base(t_row[j]), t_at_zg[j])
                val = ext.h_add(val, ext.h_mul(g_pow, ext.h_mul(inv_xzg, diff)))
                g_pow = ext.h_mul(g_pow, gamma)
            for i in range(B):
                q_val = tuple(q_row[i * 4 + k] for k in range(4))
                diff = ext.h_sub(q_val, q_at_z[i])
                val = ext.h_add(val, ext.h_mul(g_pow, ext.h_mul(inv_xz, diff)))
                g_pow = ext.h_mul(g_pow, gamma)
            if val != tuple(fri_val):
                _fail("DEEP value mismatch with FRI layer 0")
    return True
