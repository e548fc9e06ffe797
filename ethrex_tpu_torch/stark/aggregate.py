"""Recursive aggregation: N inner STARKs -> one outer FRI-verifier STARK.

A copy of `ethrex_tpu/stark/aggregate.py` over the port's prover and
verifier.  The FRI query phase of every inner proof (the Merkle openings
and fold equations that dominate native verification) is proven once,
in-circuit, by a single outer STARK over
`models/fri_verifier_air.FriVerifyAir`, and the inner proofs' per-query
Merkle path data is dropped from the aggregate.  This is the `compressed`
proof format; the `groth16` format wraps the outer digest
(`prover/groth16_wrap.py`).

Trust split (documented in fri_verifier_air):
  * in-circuit: leaf hashing, path folds to the layer roots, index-bit
    decomposition, fold equations, cross-layer value chaining;
  * aggregate verifier (host, cheap scalar work): Fiat-Shamir transcript
    re-derivation (roots -> betas, indices), domain points x, layer
    shapes, final-polynomial evaluation, and the digest recomputation
    that binds every in-circuit segment message to those derived values.

What remains native per inner proof is the non-FRI part of verification
(constraint identity at zeta, DEEP cross-check, trace/quotient openings)
— `verify_aggregated` below runs it via stark/verifier.verify with the
FRI step swapped out.
"""

from __future__ import annotations

import dataclasses
import time

from ..models import fri_verifier_air as fva
from ..ops import babybear as bb
from ..ops import ext
from ..ops import fri
from ..ops.challenger import Challenger
from . import prover as stark_prover
from . import verifier as stark_verifier
from .air import Air
from .prover import StarkParams

_INV2 = bb.inv_host(2)


class AggregationError(ValueError):
    pass


def derive_query_items(fri_proof: fri.FriProof, log_n0: int,
                       challenger: Challenger, fparams: fri.FriParams,
                       with_paths: bool):
    """Mirror fri.verify's transcript and scalar math WITHOUT the Merkle
    opening checks.  Returns (indices, layer0_values, items) where each
    item is a FriVerifyAir work unit: {"msg": [...], and with_paths also
    "path"/"bits"}.  Raises ValueError on structural mismatch or on a
    failed non-Merkle check (fold chain, final polynomial).
    """
    p_ = fparams
    num_layers = log_n0 - p_.log_final_size
    if len(fri_proof.roots) != num_layers:
        raise ValueError("FRI: wrong number of layer roots")
    betas = []
    shifts = []
    shift = p_.shift % bb.P
    for root in fri_proof.roots:
        challenger.absorb_elems(root)
        betas.append(challenger.sample_ext())
        shifts.append(shift)
        shift = (shift * shift) % bb.P
    final_shift = shift
    final_size = 1 << p_.log_final_size
    if len(fri_proof.final_coeffs) != final_size:
        raise ValueError("FRI: wrong final coefficient count")
    deg_bound = final_size >> p_.log_blowup
    for row in fri_proof.final_coeffs[deg_bound:]:
        if tuple(row) != (0, 0, 0, 0):
            raise ValueError("FRI: final polynomial exceeds degree bound")
    for row in fri_proof.final_coeffs:
        challenger.absorb_ext(tuple(row))
    if not challenger.check_grind(fri_proof.pow_nonce, p_.grinding_bits):
        raise ValueError("FRI: proof-of-work grinding check failed")

    bits = log_n0 - 1
    indices = challenger.sample_indices(bits, p_.num_queries)
    if len(fri_proof.queries) != p_.num_queries:
        raise ValueError("FRI: wrong query count")

    items = []
    layer0_values = []
    for q, per_layer in zip(indices, fri_proof.queries):
        if len(per_layer) != num_layers:
            raise ValueError("FRI: wrong layer count in query")
        carried = None
        raw = q
        for k, opening in enumerate(per_layer):
            log_nk = log_n0 - k
            half = 1 << (log_nk - 1)
            depth = log_nk - 1
            idx = raw % half
            s_bit = 1 if raw >= half else 0
            lo, hi = (tuple(int(v) % bb.P for v in x)
                      for x in opening["values"])
            if len(lo) != 4 or len(hi) != 4:
                raise ValueError("FRI: opening values must be ext elements")
            if carried is not None:
                got = hi if s_bit else lo
                if got != carried:
                    raise ValueError(
                        f"FRI: fold mismatch entering layer {k}")
            if k == 0:
                layer0_values.append((idx, lo, hi))
            x = shifts[k] * pow(bb.root_of_unity(log_nk), idx, bb.P) % bb.P
            s = ext.h_scalar_mul(ext.h_add(lo, hi), _INV2)
            d = ext.h_scalar_mul(ext.h_sub(lo, hi),
                                 _INV2 * bb.inv_host(x) % bb.P)
            carried = ext.h_add(s, ext.h_mul(betas[k], d))

            msg = [0] * fva.MSG_LIMBS
            msg[fva.MF_FIRST] = 1 if k == 0 else 0
            msg[fva.MF_K] = k
            msg[fva.MF_HALF] = half % bb.P
            msg[fva.MF_DEPTH] = depth
            msg[fva.MF_X] = x
            msg[fva.MF_LO:fva.MF_LO + 4] = list(lo)
            msg[fva.MF_HI:fva.MF_HI + 4] = list(hi)
            msg[fva.MF_BETA:fva.MF_BETA + 4] = list(betas[k])
            msg[fva.MF_ROOT:fva.MF_ROOT + 8] = [
                int(v) % bb.P for v in fri_proof.roots[k]]
            msg[fva.MF_COUT:fva.MF_COUT + 4] = list(carried)
            msg[fva.MF_IDX] = idx
            msg[fva.MF_SBIT] = s_bit
            msg[fva.MF_LAST] = 1 if k == num_layers - 1 else 0
            item = {"msg": msg}
            if with_paths:
                path = opening["path"]
                if len(path) != depth:
                    raise ValueError("FRI: wrong path depth")
                item["path"] = [[int(v) % bb.P for v in sib]
                                for sib in path]
                item["bits"] = [(idx >> j) & 1 for j in range(depth)]
            items.append(item)
            raw = idx
        # final-polynomial check (host side; the circuit chain ends at the
        # last layer's carried_out, which the digest binds)
        log_nf = log_n0 - num_layers
        x_f = final_shift * pow(bb.root_of_unity(log_nf), raw, bb.P) % bb.P
        acc = ext.ZERO_H
        for c in reversed(fri_proof.final_coeffs):
            acc = ext.h_add(ext.h_mul(acc, ext.h_from_base(x_f)), tuple(c))
        if acc != carried:
            raise ValueError("FRI: final polynomial mismatch")
    return indices, layer0_values, items


def _strip_paths(proof: dict) -> dict:
    out = dict(proof)
    out["fri"] = dict(proof["fri"])
    out["fri"]["queries"] = [
        [{"values": opening["values"]} for opening in per_layer]
        for per_layer in proof["fri"]["queries"]
    ]
    return out


def _inner_fri_items(air: Air, proof: dict, params: StarkParams,
                     with_paths: bool):
    """Replay the inner proof's transcript up to the FRI phase, then
    derive the aggregation work items (mirrors stark/verifier._verify's
    challenger schedule)."""
    n = proof["n"]
    w = proof["width"]
    lb = proof["log_blowup"]
    log_N = (n.bit_length() - 1) + lb
    ch = Challenger()
    ch.absorb_elems([n, w, 1 << lb])
    ch.absorb_elems([int(v) % bb.P for v in proof["pub_inputs"]])
    ch.absorb_elems(proof["trace_root"])
    ch.sample_ext()   # alpha
    ch.absorb_elems(proof["quotient_root"])
    ch.sample_ext()   # zeta
    for tup in (proof["trace_at_zeta"] + proof["trace_at_zeta_g"]
                + proof["quotient_at_zeta"]):
        ch.absorb_ext(tuple(tup))
    ch.sample_ext()   # gamma
    fparams = fri.FriParams(
        log_blowup=lb, num_queries=params.num_queries,
        log_final_size=params.log_final_size, shift=params.shift % bb.P,
        grinding_bits=params.grinding_bits)
    fri_proof = fri.FriProof(
        roots=proof["fri"]["roots"],
        final_coeffs=[tuple(c) for c in proof["fri"]["final_coeffs"]],
        queries=proof["fri"]["queries"],
        pow_nonce=int(proof["fri"].get("pow_nonce", 0)))
    return derive_query_items(fri_proof, log_N, ch, fparams, with_paths)


@dataclasses.dataclass
class AggregateProof:
    inners: list          # path-stripped inner proof dicts
    outer: dict           # FriVerifyAir STARK proof (pub input = digest)
    max_depth: int
    seg_periods: int


def aggregate(airs: list[Air], proofs: list[dict],
              params: StarkParams = StarkParams(),
              outer_params: StarkParams | None = None,
              device="cuda", stats: dict | None = None,
              traces: dict | None = None) -> AggregateProof:
    """Prove the aggregate: one FriVerifyAir STARK covering every FRI
    query opening of every inner proof, on `device` ("cuda" unless the
    caller asks for the CPU).  If `stats` is a dict it receives the host
    trace-generation wall, the outer trace shape and the outer prover's
    phase walls; if `traces` is a dict it keeps the outer STARK's (air,
    trace, public inputs) under "outer"."""
    if not proofs:
        raise AggregationError("nothing to aggregate")
    items = []
    max_depth = 1
    for air, proof in zip(airs, proofs):
        _, _, proof_items = _inner_fri_items(air, proof, params,
                                             with_paths=True)
        items.extend(proof_items)
        for it in proof_items:
            max_depth = max(max_depth, it["msg"][fva.MF_DEPTH])
    air_out = fva.FriVerifyAir(max_depth)
    t0 = time.perf_counter()
    trace = fva.generate_fri_verify_trace(
        items, max_depth, air_out.seg_periods)
    # the honest trace ends on the transcript sponge's output: the digest
    # that fva.transcript_digest recomputes (the AIR's boundary rows)
    digest = [int(v) for v in trace[-1, fva.T_STATE:fva.T_STATE + 8]]
    trace_s = time.perf_counter() - t0
    outer, outer_stats = stark_prover.prove_with_stats(
        air_out, trace, digest, outer_params or params, device=device)
    if traces is not None:
        traces["outer"] = (air_out, trace, digest)
    if stats is not None:
        stats.update(trace_s=trace_s, items=len(items),
                     trace_shape=tuple(trace.shape), outer=outer_stats)
    return AggregateProof(
        inners=[_strip_paths(p) for p in proofs], outer=outer,
        max_depth=max_depth, seg_periods=air_out.seg_periods)


def aggregate_groups(groups: list[tuple[list[Air], list[dict]]],
                     params: StarkParams = StarkParams(),
                     outer_params: StarkParams | None = None,
                     device="cuda"
                     ) -> tuple[AggregateProof, list[tuple[int, int]]]:
    """Cross-batch recursion entry: each group is one
    batch's (airs, proofs); every group's FRI query work lands in the SAME
    outer STARK.  Returns (agg, slices) where slices[i] = (start, stop)
    into agg.inners for group i, so the caller can reassemble per-batch
    payloads from the flattened, path-stripped inners."""
    airs: list[Air] = []
    proofs: list[dict] = []
    slices: list[tuple[int, int]] = []
    for g_airs, g_proofs in groups:
        if len(g_airs) != len(g_proofs):
            raise AggregationError("air/proof count mismatch in group")
        start = len(proofs)
        airs.extend(g_airs)
        proofs.extend(g_proofs)
        slices.append((start, len(proofs)))
    agg = aggregate(airs, proofs, params, outer_params, device=device)
    return agg, slices


def verify_aggregated(airs: list[Air], agg: AggregateProof,
                      params: StarkParams = StarkParams(),
                      outer_params: StarkParams | None = None) -> bool:
    """Verify every inner proof with the FRI Merkle work replaced by the
    outer recursion STARK.  Raises VerificationError / AggregationError."""
    if len(airs) != len(agg.inners):
        raise AggregationError("air/proof count mismatch")
    all_msgs: list[list[int]] = []

    def make_hook(collector):
        def hook(fri_proof, log_n0, ch, fparams):
            indices, layer0, items = derive_query_items(
                fri_proof, log_n0, ch, fparams, with_paths=False)
            collector.extend(it["msg"] for it in items)
            return indices, layer0
        return hook

    for air, proof in zip(airs, agg.inners):
        stark_verifier.verify(air, proof, params,
                              fri_verify_fn=make_hook(all_msgs))

    air_out = fva.FriVerifyAir(agg.max_depth, agg.seg_periods)
    digest = fva.transcript_digest(all_msgs, agg.seg_periods)
    outer_pub = [int(v) % bb.P for v in agg.outer["pub_inputs"]]
    if outer_pub != [int(v) % bb.P for v in digest]:
        raise AggregationError("outer digest does not match inner proofs")
    stark_verifier.verify(air_out, agg.outer, outer_params or params)
    return True
