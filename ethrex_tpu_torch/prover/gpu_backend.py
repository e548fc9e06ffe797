"""The proof formats past `stark` for a batch's STARKs, on the card.

`prove_formats` is the tail of `TpuBackend._prove_impl`
(`ethrex_tpu/prover/tpu_backend.py:753-798`) over the port: given the
batch's AIRs and their STARK proofs (state proof and binding proof first),
it aggregates every inner proof's FRI query work into one outer
FriVerifyAir STARK (`compressed`) and, for `groth16`, wraps the outer
digest in a BN254 Groth16 proof.  It returns the same keys the reference
writes into the batch proof dict.  The port's `GpuBackend._prove_impl`
(a later slice) calls it after proving the inner STARKs.
"""

from __future__ import annotations

from ..stark import aggregate as agg_mod
from ..stark.prover import StarkParams
from . import groth16_wrap
from . import protocol

# the backend's STARK parameters (ethrex_tpu/prover/tpu_backend.py:96)
PARAMS = StarkParams(log_blowup=3, num_queries=40, log_final_size=4)


def prove_formats(airs: list, proofs: list[dict], encoded: bytes,
                  proof_format: str, device="cuda",
                  params: StarkParams = PARAMS,
                  outer_params: StarkParams | None = None,
                  stats: dict | None = None) -> dict:
    """The batch-proof entries of `proof_format` for inner proofs already
    made with `params`:

      * "stark": {} (the inner proofs stand as they are);
      * "compressed": {"inner": path-stripped inner proofs, in order,
        which replace the batch proof's own; "aggregate": {"outer",
        "max_depth", "seg_periods"}};
      * "groth16": the same plus "groth16": the wire-form wrap proof of the
        outer digest, blinded with `encoded[:32]` as the reference does.

    Runs on `device` ("cuda" unless the caller asks for the CPU).  The
    outer STARK uses `outer_params` (default: `params`, as the reference
    backend does).  If `stats` is a dict it receives the aggregation's
    statistics under "aggregate"."""
    if proof_format not in protocol.FORMATS:
        raise ValueError(f"unknown proof format {proof_format!r}")
    if len(airs) != len(proofs):
        raise ValueError("air/proof count mismatch")
    if proof_format == protocol.FORMAT_STARK:
        return {}
    agg_stats: dict = {}
    agg = agg_mod.aggregate(airs, proofs, params, outer_params,
                            device=device, stats=agg_stats)
    if stats is not None:
        stats["aggregate"] = agg_stats
    out = {
        "inner": agg.inners,
        "aggregate": {"outer": agg.outer, "max_depth": agg.max_depth,
                      "seg_periods": agg.seg_periods},
    }
    if proof_format == protocol.FORMAT_GROTH16:
        wrapped = groth16_wrap.wrap_prove(
            [int(v) for v in agg.outer["pub_inputs"]], rnd=encoded[:32],
            device=device)
        out["groth16"] = groth16_wrap.proof_to_json(wrapped)
    return out
