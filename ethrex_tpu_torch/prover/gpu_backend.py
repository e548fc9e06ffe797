"""A batch's STARKs and proof formats on the card.

`prove_vm_stages` is `TpuBackend._prove_impl`'s VM mode
(`ethrex_tpu/prover/tpu_backend.py:640-799`) from the point where
execution and `build_vm_batch` have produced their artifacts: it proves
the state-update STARK, the TransferAir, TokenAir and BytecodeAir STARKs
of the VM batch and the binding STARK, then the requested format.

`prove_formats` is its tail (`tpu_backend.py:753-798`): given the batch's
AIRs and their STARK proofs (state proof and binding proof first), it
aggregates every inner proof's FRI query work into one outer FriVerifyAir
STARK (`compressed`) and, for `groth16`, wraps the outer digest in a
BN254 Groth16 proof.  Both return the keys the reference writes into the
batch proof dict.  The execution in front of them (EVM, witness,
`build_vm_batch`) and `GpuBackend._prove_impl` are not ported yet.
"""

from __future__ import annotations

import time

from ..models import bytecode_air as bca
from ..models import poseidon2_air as pair
from ..models import state_update_air as sua
from ..models import token_air as tka
from ..models import transfer_air as ta
from ..stark import aggregate as agg_mod
from ..stark import prover as stark_prover
from ..stark.prover import StarkParams
from . import groth16_wrap
from . import protocol

# the backend's STARK parameters (ethrex_tpu/prover/tpu_backend.py:96)
PARAMS = StarkParams(log_blowup=3, num_queries=40, log_final_size=4)


def output_to_limbs(output_bytes: bytes) -> list[int]:
    """ProgramOutput.encode() -> 24-bit BabyBear limbs (raw byte slices;
    the full output is absorbed by the sponge)."""
    padded = output_bytes + b"\x00" * ((-len(output_bytes)) % 3)
    limbs = [int.from_bytes(padded[i:i + 3], "big")
             for i in range(0, len(padded), 3)]
    limbs.append(len(output_bytes))  # length limb: no padding ambiguity
    return limbs


def binding_limbs(output_bytes: bytes, r_pre: list[int], r_post: list[int],
                  digest: list[int],
                  vmdigest: list[int] | None = None,
                  tokdigest: list[int] | None = None,
                  bcdigests: list | None = None) -> list[int]:
    """Message of the binding sponge: output bytes, the state proof's 24
    public limbs, a mode limb + statement digest for each VM circuit
    (zeroed in claimed-log mode), then the generic-call digests prefixed
    by their count: one padded stream."""
    limbs = output_to_limbs(output_bytes) + list(r_pre) + list(r_post) \
        + list(digest)
    for d in (vmdigest, tokdigest):
        limbs += [0] * 9 if d is None else [1] + list(d)
    bcdigests = bcdigests or []
    limbs += [len(bcdigests)]
    for d in bcdigests:
        limbs += list(d)
    return pair.pad_message_limbs(limbs)


def _schedule_for(depth: int) -> int:
    """seg_periods for a tree depth (smallest power of two fitting the
    3-leaf + depth-fold + tail schedule; >= 8)."""
    need = depth + 5
    return max(8, 1 << (need - 1).bit_length())


def _mode_of(vm_batch) -> str:
    """The VM batch's mode: "generic" with bytecode calls, else "token"
    with token segments, else "transfer"."""
    return "generic" if vm_batch.bc_calls else (
        "token" if vm_batch.tok_segs else "transfer")


def prove_vm_stages(records, r_pre, r_post, depth: int, encoded: bytes,
                    vm_batch, proof_format: str, device="cuda",
                    params: StarkParams = PARAMS,
                    stats: dict | None = None,
                    traces: dict | None = None) -> tuple[dict, list, list]:
    """Prove a VM-mode batch whose execution artifacts are given.

    records, r_pre, r_post, depth: the state-update log (AccessRecords)
    and its tree; encoded: ProgramOutput.encode(); vm_batch: a VmBatch
    (TxSeg/CbSeg stream, TokSeg stream, BcCalls).  Proves, serially on
    `device` (the card unless the caller asks for the CPU): the state
    STARK, TransferAir, TokenAir when there are token segments, one
    BytecodeAir per generic call, then the binding STARK over the
    VM-mode message, then `prove_formats` over [state, binding,
    transfer, token, bytecode...].  Each VM AIR's public digest comes from
    its segments (`transfer_public_inputs`, `token_public_inputs`,
    `bytecode_public_inputs`), as the reference computes it, not from the
    trace it proves.

    Returns (out, airs, proofs).  `out` holds the reference's keys:
    "depth", "seg_periods", "state_proof", "proof", "vm_proof",
    "tok_proof" and "bc_proofs" where present, and "aggregate" /
    "groth16" for those formats.  `airs` and `proofs` are the inner
    STARKs in aggregation order, with their full proofs (the formats past
    `stark` strip the Merkle paths of `out`'s copies).  With `stats` a
    dict, it receives each proof's host walls (public inputs, trace) and
    prover stats, and the aggregation's stats.  With `traces` a dict, it
    keeps each proof's (air, trace, public inputs) under the same names
    ("outer" for the aggregate), so a caller can prove them again."""
    if proof_format not in protocol.FORMATS:
        raise ValueError(f"unknown proof format {proof_format!r}")
    st = stats if stats is not None else {}

    def job(name, air, make_pub, make_trace):
        t0 = time.perf_counter()
        pub = make_pub()
        t1 = time.perf_counter()
        trace = make_trace()
        t2 = time.perf_counter()
        proof, pst = stark_prover.prove_with_stats(air, trace, pub, params,
                                                   device)
        if traces is not None:
            traces[name] = (air, trace, pub)
        del trace
        st[name] = {"pub_s": t1 - t0, "trace_s": t2 - t1, **pst}
        return proof, pub

    S = _schedule_for(depth)
    air = sua.StateUpdateAir(depth, seg_periods=S)
    state_proof, pub = job(
        "state", air,
        lambda: sua.state_update_public_inputs(records, r_pre, r_post, S),
        lambda: sua.generate_state_update_trace(records, r_pre, depth, S))
    vm_air = ta.TransferAir()
    vm_proof, vm_pub = job(
        "transfer", vm_air,
        lambda: ta.transfer_public_inputs(vm_batch.segs),
        lambda: ta.generate_transfer_trace(vm_batch.segs))
    tok_air = tok_proof = tok_pub = None
    if vm_batch.tok_segs:
        tok_air = tka.TokenAir()
        tok_proof, tok_pub = job(
            "token", tok_air,
            lambda: tka.token_public_inputs(vm_batch.tok_segs),
            lambda: tka.generate_token_trace(vm_batch.tok_segs))
    bc_airs, bc_proofs, bc_pubs = [], [], []
    for i, call in enumerate(vm_batch.bc_calls):
        bc_air = bca.BytecodeAir()
        proof, pub_bc = job(
            f"bytecode{i}", bc_air,
            lambda c=call: bca.bytecode_public_inputs(c.steps),
            lambda c=call: bca.generate_bytecode_trace(c.steps, c.snaps))
        bc_airs.append(bc_air)
        bc_proofs.append(proof)
        bc_pubs.append(pub_bc)

    limbs = binding_limbs(encoded, r_pre, r_post, pub[16:24], vm_pub,
                          tok_pub, bc_pubs)
    bind_air = pair.Poseidon2SpongeAir(num_chunks=len(limbs) // 8)
    bind_proof, _ = job("binding", bind_air,
                        lambda: pair.sponge_public_inputs(limbs),
                        lambda: pair.generate_sponge_trace(limbs))
    out = {"depth": depth, "seg_periods": S, "state_proof": state_proof,
           "proof": bind_proof, "vm_proof": vm_proof}
    if tok_proof is not None:
        out["tok_proof"] = tok_proof
    if bc_proofs:
        out["bc_proofs"] = bc_proofs
    airs = [air, bind_air, vm_air] + ([tok_air] if tok_air else []) + bc_airs
    proofs = [state_proof, bind_proof, vm_proof] + \
        ([tok_proof] if tok_proof else []) + bc_proofs
    fmt = prove_formats(airs, proofs, encoded, proof_format, device=device,
                        params=params, stats=st, traces=traces)
    if "inner" in fmt:
        inners = fmt.pop("inner")
        out["state_proof"], out["proof"], out["vm_proof"] = inners[:3]
        cursor = 3
        if tok_proof is not None:
            out["tok_proof"] = inners[cursor]
            cursor += 1
        if bc_proofs:
            out["bc_proofs"] = inners[cursor:cursor + len(bc_proofs)]
    out.update(fmt)
    return out, airs, proofs


def prove_formats(airs: list, proofs: list[dict], encoded: bytes,
                  proof_format: str, device="cuda",
                  params: StarkParams = PARAMS,
                  outer_params: StarkParams | None = None,
                  stats: dict | None = None,
                  traces: dict | None = None) -> dict:
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
    statistics under "aggregate"; if `traces` is a dict it keeps the
    outer STARK's (air, trace, public inputs) under "outer"."""
    if proof_format not in protocol.FORMATS:
        raise ValueError(f"unknown proof format {proof_format!r}")
    if len(airs) != len(proofs):
        raise ValueError("air/proof count mismatch")
    if proof_format == protocol.FORMAT_STARK:
        return {}
    agg_stats: dict = {}
    agg = agg_mod.aggregate(airs, proofs, params, outer_params,
                            device=device, stats=agg_stats, traces=traces)
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
