"""The batch prover on the card: `GpuBackend`, from a `ProgramInput` to the
batch-proof dict, and back: its verification.

`GpuBackend.prove` is `TpuBackend._prove_impl`
(`ethrex_tpu/prover/tpu_backend.py:587-799`): it executes the batch
statelessly over its witness (`guest.execution.execution_program`),
classifies it (`guest.transfer_log.build_vm_batch`, or the claimed-log
mode when that raises `NotTransferBatch`), builds the state-update access
records, and proves through `prove_vm_stages`.  The dict it returns has
the reference's keys and values, with the reference's backend tag, so the
reference's verifier and L1 accept it.  Inside a batch context
(prover/checkpoint, opened by the proof client) the execution artifacts
are checkpointed and every STARK, the binding proof and the aggregation
run in a job scope of their own, so a killed prove resumes from its last
finished phase.

`prove_vm_stages` proves a batch whose execution artifacts are given: the
state-update STARK, the TransferAir, TokenAir and BytecodeAir STARKs of
the VM batch (none in claimed-log mode) and the binding STARK, then the
requested format.  `prove_formats` is its tail
(`tpu_backend.py:753-798`): given the batch's AIRs and their STARK proofs
(state proof and binding proof first), it aggregates every inner proof's
FRI query work into one outer FriVerifyAir STARK (`compressed`) and, for
`groth16`, wraps the outer digest in a BN254 Groth16 proof.  The proving
jobs run one after another on one device.

The verification half (`verify`, `verify_with_input`,
`verify_submission`, `check_coverage`, `stark_components`;
`tpu_backend.py:803-1036`) and the committer's classifier
(`expected_vm_mode`, `vm_mode_from_artifacts`) run on the host, over the
port's `stark/verifier.py`, `stark.aggregate.verify_aggregated` and
`groth16_wrap.wrap_verify`: `GpuBackend(device="cpu")` verifies without a
card.
"""

from __future__ import annotations

import time

from .. import require_cuda
from ..crypto.keccak import keccak256
from ..guest import access_log
from ..guest import bytecode_vm as bv
from ..guest import flat_model
from ..guest import token_template as tmpl
from ..guest import transfer_log as tl_mod
from ..guest.execution import ProgramInput, ProgramOutput, execution_program
from ..guest.witness_oracles import WitnessOracles
from ..models import bytecode_air as bca
from ..models import poseidon2_air as pair
from ..models import state_update_air as sua
from ..models import token_air as tka
from ..models import transfer_air as ta
from ..ops import babybear as bb
from ..primitives.account import EMPTY_CODE_HASH
from ..stark import aggregate as agg_mod
from ..stark import prover as stark_prover
from ..stark import verifier as stark_verifier
from ..stark.prover import StarkParams
from ..utils import faults
from . import checkpoint as ckpt_mod
from . import groth16_wrap
from . import protocol
from . import runtime_errors as rt
from .backend import ProverBackend

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


def _vm_meta_json(vm_batch) -> dict:
    """The batch proof's "vm" entry: the mode and the claimed per-tx
    metadata the verifier rebuilds the VM digests from
    (`tpu_backend.py:144`)."""
    blocks = []
    codes: dict[str, str] = {}   # contract addr -> bytecode (one per
    for b in vm_batch.blocks:    # contract, however many calls hit it)
        txs = []
        for t in b.txs:
            row = {"sender": t.sender.hex(), "to": t.recipient.hex(),
                   "value": t.value, "fee": t.fee, "tip": t.tip}
            if t.kind == "tok":
                row.update({"kind": "tok", "gas": t.gas,
                            "dst": t.dst.hex(), "amount": t.amount})
            elif t.kind == "gen":
                row.update({"kind": "gen", "gas": t.gas,
                            "data": t.data.hex(),
                            "steps": [s.to_json() for s in t.steps]})
                codes[t.recipient.hex()] = t.code.hex()
            txs.append(row)
        blocks.append({"coinbase": b.coinbase.hex(),
                       "base_fee": b.base_fee, "txs": txs})
    out = {"mode": _mode_of(vm_batch), "blocks": blocks}
    if codes:
        out["codes"] = codes
    return out


def _vm_stream_from_claims(vm_meta: dict, blocks_log: list):
    """Build the VM digest streams a verifier recomputes from the claimed
    tx list + the claimed write log; performs the native structural and
    fee-relation checks of vm mode.  Returns (transfer_items, tok_items,
    bc_pubs) where bc_pubs holds one 8-limb digest per generic call (the
    claimed step lists are pinned to the claimed code/calldata/log by
    guest/bytecode_vm.check_steps — data indexing, no EVM execution).
    Raises ValueError on any mismatch."""
    mode = vm_meta.get("mode")
    if mode not in ("transfer", "token", "generic"):
        raise ValueError("unknown vm mode")
    blocks = vm_meta["blocks"]
    if len(blocks) != len(blocks_log):
        raise ValueError("vm block count does not match the log")

    def acct_digests(entry, want_addr: bytes):
        if entry[0] != "acct":
            raise ValueError("vm log entry is not an account write")
        _, addr, _, old_rlp, new_rlp, cleared = entry
        if addr != want_addr or cleared:
            raise ValueError("vm log entry address mismatch")
        old = [0] * 8 if not old_rlp else flat_model.account_value_digest(
            flat_model.AccountState.decode(old_rlp))
        new = [0] * 8 if not new_rlp else flat_model.account_value_digest(
            flat_model.AccountState.decode(new_rlp))
        return flat_model.account_key_digest(addr), old, new

    def slot_row(entry, want_addr: bytes, want_slot: int):
        if entry[0] != "slot":
            raise ValueError("vm log entry is not a storage write")
        _, addr, slot, old_v, new_v = entry
        if addr != want_addr or int(slot) != want_slot:
            raise ValueError("vm slot row does not match the claimed call")
        old_v, new_v = int(old_v), int(new_v)
        if not (0 <= old_v < 1 << 256 and 0 <= new_v < 1 << 256):
            raise ValueError("vm slot value out of range")
        return old_v, new_v

    # untrusted-size guards, mirroring the 1MB write_log cap in _check
    claimed_codes = vm_meta.get("codes", {})
    if len(claimed_codes) > 1024 or any(
            len(c) > 2 * 0x40000 for c in claimed_codes.values()):
        raise ValueError("vm code claims too large")

    items = []
    tok_items = []
    bc_pubs: list = []
    for bmeta, rows in zip(blocks, blocks_log):
        coinbase = bytes.fromhex(bmeta["coinbase"])
        base_fee = int(bmeta["base_fee"])
        cursor = 0
        touched_contracts: list[bytes] = []
        gen_codes: dict[bytes, bytes] = {}
        for txm in bmeta["txs"]:
            value = int(txm["value"])
            fee = int(txm["fee"])
            tip = int(txm["tip"])
            kind = txm.get("kind", "xfer")
            if not (0 <= value < 1 << 256 and 0 <= tip <= fee < 1 << 256):
                raise ValueError("vm tx amounts out of range")
            sender = bytes.fromhex(txm["sender"])
            to = bytes.fromhex(txm["to"])
            if kind == "tok":
                if mode not in ("token", "generic"):
                    raise ValueError("token tx outside token mode")
                if value != 0:
                    raise ValueError("token call with value")
                g = int(txm["gas"])
                # fee = g*price, tip = g*(price - base_fee): g divides
                # both and their difference is g*base_fee; g's own truth
                # is witness-checked via the replayed balances
                if g < 21000 or fee - tip != g * base_fee \
                        or fee % g or tip % g:
                    raise ValueError("vm token fee out of model")
            elif kind == "gen":
                if mode != "generic":
                    raise ValueError("generic tx outside generic mode")
                if value != 0:
                    raise ValueError("generic call with value")
                g = int(txm["gas"])
                if g < 21000 or fee - tip != g * base_fee \
                        or fee % g or tip % g:
                    raise ValueError("vm generic fee out of model")
            elif fee - tip != 21000 * base_fee:
                raise ValueError("vm fee does not match the base fee")
            ks, os_, ns = acct_digests(rows[cursor], sender)
            cursor += 1
            if kind == "gen":
                code_hex = claimed_codes.get(txm["to"])
                if code_hex is None:
                    raise ValueError("vm generic call without code claim")
                if len(txm["steps"]) > bv.MAX_STEPS \
                        or len(txm["data"]) > 2_000_000:
                    raise ValueError("vm generic claims too large")
                code = bytes.fromhex(code_hex)
                data = bytes.fromhex(txm["data"])
                steps = [bv.StepRec.from_json(s) for s in txm["steps"]]
                touched: list[int] = []
                seen: set[int] = set()
                for st in steps:
                    if st.op in (bv.OP_SLOAD, bv.OP_SSTORE) \
                            and st.a not in seen:
                        seen.add(st.a)
                        touched.append(st.a)
                slot_rows = []
                for slot in touched:
                    old_v, new_v = slot_row(rows[cursor], to, slot)
                    cursor += 1
                    slot_rows.append((slot, old_v, new_v))
                try:
                    bv.check_steps(code, data, sender, 0, steps,
                                   slot_rows, address=to)
                except bv.StepCheckError as e:
                    raise ValueError(f"vm generic steps: {e}")
                bc_pubs.append(bca.bc_digest_stream(steps))
                if to not in touched_contracts:
                    touched_contracts.append(to)
                if gen_codes.setdefault(to, code) != code:
                    raise ValueError("vm generic code claim inconsistent")
                kr = flat_model.account_key_digest(to)
                orr = nr = [0] * 8
            elif kind == "tok":
                amount = int(txm["amount"])
                dst = bytes.fromhex(txm["dst"])
                if not (0 <= amount < 1 << 256):
                    raise ValueError("vm token amount out of range")
                if amount == 0:
                    tok_items.append((0, 0, 0, 0, 0, 0, 0, True))
                else:
                    kf = tmpl.balance_slot(sender)
                    kt = tmpl.balance_slot(dst)
                    fold, fnew = slot_row(rows[cursor], to, kf)
                    cursor += 1
                    told, tnew = slot_row(rows[cursor], to, kt)
                    cursor += 1
                    if to not in touched_contracts:
                        touched_contracts.append(to)
                    tok_items.append((amount, kf, fold, fnew,
                                      kt, told, tnew, False))
                kr = flat_model.account_key_digest(to)
                orr = nr = [0] * 8
            elif value == 0:
                # no-op credit: no log row; the circuit's NOP segment
                # absorbs zero digests and pins the amount to zero
                kr = flat_model.account_key_digest(to)
                orr = nr = [0] * 8
            else:
                kr, orr, nr = acct_digests(rows[cursor], to)
                cursor += 1
            if tip == 0:
                kc = flat_model.account_key_digest(coinbase)
                oc = nc = [0] * 8
            else:
                kc, oc, nc = acct_digests(rows[cursor], coinbase)
                cursor += 1
            txf = (ta._limbs11(value), ta._limbs11(fee), ta._limbs11(tip))
            items.append(("tx", txf, (ks, os_, ns, kr, orr, nr)))
            items.append(("cb", None, (kc, oc, nc)))
        # each touched token contract: ONE account row at block end whose
        # fields other than storage_root are unchanged (the storage_root
        # transition itself is MPT work the witness replay audits)
        for caddr in touched_contracts:
            entry = rows[cursor]
            cursor += 1
            if entry[0] != "acct" or entry[1] != caddr or entry[5]:
                raise ValueError("vm contract row mismatch")
            old_rlp, new_rlp = entry[3], entry[4]
            if not old_rlp or not new_rlp:
                raise ValueError("vm contract lifecycle change")
            o = flat_model.AccountState.decode(old_rlp)
            n = flat_model.AccountState.decode(new_rlp)
            if (o.nonce, o.balance, o.code_hash) != \
                    (n.nonce, n.balance, n.code_hash):
                raise ValueError("vm contract fields changed")
            code = gen_codes.get(caddr)
            if code is not None:
                # pin the claimed bytecode to the account row r_pre binds
                want = EMPTY_CODE_HASH if not code else keccak256(code)
                if o.code_hash != want:
                    raise ValueError("vm generic code hash mismatch")
        if cursor != len(rows):
            raise ValueError("vm log shape mismatch")
    if mode == "token" and not tok_items:
        raise ValueError("token mode without token txs")
    if mode == "generic" and not bc_pubs:
        raise ValueError("generic mode without generic txs")
    return items, tok_items, bc_pubs


def vm_mode_from_artifacts(blocks, coarse_log, receipts, witness,
                           initial_root: bytes) -> str:
    """The VM-circuit coverage an honest prover reaches on this batch,
    classified from execution artifacts already in hand (the committer
    captures them during witness generation — no extra execution)."""
    try:
        oracles = WitnessOracles(witness, initial_root)
        vb = tl_mod.build_vm_batch(blocks, coarse_log, receipts,
                                   oracles=oracles)
    except tl_mod.NotTransferBatch:
        return "claimed"
    return _mode_of(vb)


def expected_vm_mode(program_input: ProgramInput) -> str:
    """The classifier over a bare ProgramInput (stateless re-execution;
    committers with live artifacts use vm_mode_from_artifacts)."""
    program_input = _own_input(program_input)
    blocks_log: list = []
    receipts: list = []
    output = execution_program(program_input, write_log=blocks_log,
                               receipts_out=receipts)
    return vm_mode_from_artifacts(program_input.blocks, blocks_log,
                                  receipts, program_input.witness,
                                  output.initial_state_root)


def _own_input(program_input) -> ProgramInput:
    """Another package's ProgramInput (a proof client's, a test's) is read
    through its wire form, as the coordinator sent it."""
    if isinstance(program_input, ProgramInput):
        return program_input
    return ProgramInput.from_json(program_input.to_json())


def prove_vm_stages(records, r_pre, r_post, depth: int, encoded: bytes,
                    vm_batch, proof_format: str, device="cuda",
                    params: StarkParams = PARAMS,
                    stats: dict | None = None,
                    traces: dict | None = None) -> tuple[dict, list, list]:
    """Prove a batch whose execution artifacts are given.

    records, r_pre, r_post, depth: the state-update log (AccessRecords)
    and its tree; encoded: ProgramOutput.encode(); vm_batch: a VmBatch
    (TxSeg/CbSeg stream, TokSeg stream, BcCalls), or None for the
    claimed-log mode.  Proves, serially on `device` (the card unless the
    caller asks for the CPU): the state STARK, then with a VM batch
    TransferAir, TokenAir when there are token segments and one
    BytecodeAir per generic call, then the binding STARK over the
    message of the mode, then `prove_formats` over [state, binding,
    transfer, token, bytecode...].  Each VM AIR's public digest comes from
    its segments (`transfer_public_inputs`, `token_public_inputs`,
    `bytecode_public_inputs`), as the reference computes it, not from the
    trace it proves.

    Returns (out, airs, proofs).  `out` holds the reference's keys:
    "depth", "seg_periods", "state_proof", "proof", and "vm_proof",
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
        # the job name scopes this STARK's phase checkpoints
        with ckpt_mod.job_scope(name):
            proof, pst = stark_prover.prove_with_stats(air, trace, pub,
                                                       params, device)
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
    vm_air = vm_proof = vm_pub = None
    if vm_batch is not None:
        vm_air = ta.TransferAir()
        vm_proof, vm_pub = job(
            "transfer", vm_air,
            lambda: ta.transfer_public_inputs(vm_batch.segs),
            lambda: ta.generate_transfer_trace(vm_batch.segs))
    tok_air = tok_proof = tok_pub = None
    if vm_batch is not None and vm_batch.tok_segs:
        tok_air = tka.TokenAir()
        tok_proof, tok_pub = job(
            "token", tok_air,
            lambda: tka.token_public_inputs(vm_batch.tok_segs),
            lambda: tka.generate_token_trace(vm_batch.tok_segs))
    bc_airs, bc_proofs, bc_pubs = [], [], []
    for i, call in enumerate(vm_batch.bc_calls if vm_batch else []):
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
           "proof": bind_proof}
    if vm_proof is not None:
        out["vm_proof"] = vm_proof
    if tok_proof is not None:
        out["tok_proof"] = tok_proof
    if bc_proofs:
        out["bc_proofs"] = bc_proofs
    airs = [air, bind_air] + ([vm_air] if vm_air else []) \
        + ([tok_air] if tok_air else []) + bc_airs
    proofs = [state_proof, bind_proof] + ([vm_proof] if vm_proof else []) \
        + ([tok_proof] if tok_proof else []) + bc_proofs
    fmt = prove_formats(airs, proofs, encoded, proof_format, device=device,
                        params=params, stats=st, traces=traces)
    if "inner" in fmt:
        inners = fmt.pop("inner")
        out["state_proof"], out["proof"] = inners[:2]
        cursor = 2
        if vm_proof is not None:
            out["vm_proof"] = inners[cursor]
            cursor += 1
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
    with ckpt_mod.job_scope("aggregate"):
        agg = agg_mod.aggregate(airs, proofs, params, outer_params,
                                device=device, stats=agg_stats,
                                traces=traces)
    if stats is not None:
        stats["aggregate"] = agg_stats
    out = {
        "inner": agg.inners,
        "aggregate": {"outer": agg.outer, "max_depth": agg.max_depth,
                      "seg_periods": agg.seg_periods},
    }
    if proof_format == protocol.FORMAT_GROTH16:
        t0 = time.perf_counter()
        wrapped = groth16_wrap.wrap_prove(
            [int(v) for v in agg.outer["pub_inputs"]], rnd=encoded[:32],
            device=device)
        out["groth16"] = groth16_wrap.proof_to_json(wrapped)
        if stats is not None:
            stats["wrap_s"] = time.perf_counter() - t0
    return out


class GpuBackend(ProverBackend):
    """The STARK prover backend on the card.  Its proofs carry the
    reference's backend tag (`protocol.PROVER_TPU`): they are the same
    bytes, so the reference's verifier, coordinator and L1 take them."""

    prover_type = protocol.PROVER_TPU

    def __init__(self, device=None):
        # the card unless the caller asks for the CPU; no fallback
        self.device = require_cuda(device)

    def prewarm(self) -> int:
        """Build what a cold prover would otherwise build inside its first
        proof: the kernel library (`kernels.build`, one nvcc a source) and
        the Groth16 wrap's keys (host setup, minutes), which the wrap's
        tables of bases are made from at its first wrap.  This card's
        counterpart of the reference's executable cache.  Touches no CUDA
        tensor, so the proof client runs it on a thread of its own.
        Returns the count warmed: the library's kernels and the key; 0 on
        the CPU, where the plain versions need nothing built."""
        if self.device.type != "cuda":
            return 0
        from .. import kernels

        kernels.build()
        kernels.lib()
        groth16_wrap.wrap_keys()
        return len(kernels.KERNELS) + 1

    def prove(self, program_input: ProgramInput, proof_format: str,
              stats: dict | None = None, traces: dict | None = None,
              artifacts: dict | None = None) -> dict:
        """The batch proof of `program_input` in `proof_format`.

        With `stats` a dict, it receives the host walls of execution
        ("execute_s"), classification ("build_vm_batch_s") and the access
        records ("records_s"), the mode ("mode") and what
        `prove_vm_stages` records; `traces` is passed on to it.  With
        `artifacts` a dict, it receives the inner STARKs' AIRs ("airs")
        and full proofs ("proofs"), in aggregation order.  Inside a
        batch context the execution artifacts are checkpointed
        (`tpu_backend.py:594-629`): a restarted prove skips the EVM."""
        if proof_format not in protocol.FORMATS:
            raise ValueError(f"unknown proof format {proof_format!r}")
        program_input = _own_input(program_input)
        st = stats if stats is not None else {}
        t0 = time.perf_counter()
        ckpt_ctx = ckpt_mod.current_context()
        exe_parts = {"kind": "proof_ckpt", "job": "backend",
                     "phase": "execute", "format": proof_format}
        exe_pay = (ckpt_mod.load(ckpt_ctx.batch_id, exe_parts)
                   if ckpt_ctx is not None else None)
        if exe_pay is not None:
            rt.note_resume("execute")
            encoded = exe_pay["encoded"]
            blocks_log = exe_pay["blocks_log"]
            receipts = exe_pay["receipts"]
            initial_root = exe_pay["initial_root"]
        else:
            blocks_log = []
            receipts = []
            output = rt.guard_phase(
                "execute", "-",
                lambda: execution_program(program_input,
                                          write_log=blocks_log,
                                          receipts_out=receipts))
            encoded = output.encode()
            initial_root = output.initial_state_root
            if ckpt_ctx is not None:
                ckpt_mod.store(ckpt_ctx.batch_id, exe_parts,
                               {"encoded": encoded,
                                "blocks_log": blocks_log,
                                "receipts": receipts,
                                "initial_root": initial_root},
                               meta={"lease_token": ckpt_ctx.lease_token})
            faults.inject("backend.phase", None, kinds=("drop",))
        t1 = time.perf_counter()
        vm_batch = None
        try:
            oracles = WitnessOracles(program_input.witness, initial_root)
            vm_batch = tl_mod.build_vm_batch(program_input.blocks,
                                             blocks_log, receipts,
                                             oracles=oracles)
            blocks_log = vm_batch.blocks_log
        except tl_mod.NotTransferBatch:
            pass
        t2 = time.perf_counter()
        entries = access_log.flatten_entries(blocks_log)
        records, r_pre, r_post, depth = \
            access_log.build_access_records(entries)
        t3 = time.perf_counter()
        st.update(execute_s=t1 - t0, build_vm_batch_s=t2 - t1,
                  records_s=t3 - t2,
                  mode="claimed" if vm_batch is None else _mode_of(vm_batch))
        out, airs, proofs = prove_vm_stages(
            records, r_pre, r_post, depth, encoded, vm_batch, proof_format,
            device=self.device, stats=st, traces=traces)
        if artifacts is not None:
            artifacts.update(airs=airs, proofs=proofs)
        proof = {
            "backend": self.prover_type,
            "format": proof_format,
            "output": "0x" + encoded.hex(),
            "write_log": access_log.raw_log_to_json(blocks_log),
            "depth": out["depth"],
            "seg_periods": out["seg_periods"],
            "state_proof": out["state_proof"],
            "proof": out["proof"],
        }
        if vm_batch is not None:
            proof["vm"] = _vm_meta_json(vm_batch)
            for key in ("vm_proof", "tok_proof", "bc_proofs"):
                if key in out:
                    proof[key] = out[key]
        for key in ("aggregate", "groth16"):
            if key in out:
                proof[key] = out[key]
        return proof

    # -- verification -------------------------------------------------------

    def _reconstruct(self, proof: dict):
        """Rebuild the AIRs and collect the inner STARKs of one batch
        proof, enforcing every public-input binding against the claimed
        log along the way (no STARK verification happens here).  Returns
        (airs, proofs, blocks_log, encoded); shared by `_check` and by
        `stark_components` (the cross-batch aggregation path)."""
        if proof.get("backend") != self.prover_type:
            raise ValueError("wrong backend tag")
        encoded = bytes.fromhex(proof["output"][2:])
        if sum(len(b) for b in proof["write_log"]) > 1_000_000:
            raise ValueError("write log too large")
        blocks_log = access_log.raw_log_from_json(proof["write_log"])

        # recompute the flat commitments from the claimed log; the tree
        # shape is fully determined by the log, so the proof's claimed
        # depth/seg_periods get no attacker freedom (a huge claimed depth
        # would otherwise allocate 2^depth leaves before any AIR check)
        entries = access_log.flatten_entries(blocks_log)
        records, r_pre, r_post, depth = \
            access_log.build_access_records(entries)
        S = _schedule_for(depth)
        if int(proof["depth"]) != depth or int(proof["seg_periods"]) != S:
            raise ValueError("claimed tree shape does not match the log")
        segments = sua.segment_count(len(records))
        digest = sua.log_digest(records, S, segments)

        state = proof["state_proof"]
        claimed_pub = [int(v) % bb.P for v in state["pub_inputs"]]
        if claimed_pub != r_pre + r_post + digest:
            raise ValueError("state proof publics do not match the log")
        air = sua.StateUpdateAir(depth, seg_periods=S)

        # vm mode: the circuits' public digests are recomputed from the
        # SAME claimed log (plus the claimed tx list), so the write log's
        # account values are constrained by EVM transfer semantics and
        # its storage slots by the token-template semantics
        vm_meta = proof.get("vm")
        vm_air = None
        vm_proof = None
        vm_pub = None
        tok_air = None
        tok_proof = None
        tok_pub = None
        bc_pubs: list = []
        bc_proofs: list = []
        bc_airs: list = []
        if vm_meta is not None:
            items, tok_items, bc_pubs = _vm_stream_from_claims(vm_meta,
                                                               blocks_log)
            vm_pub = ta.vm_digest_stream(items)
            vm_proof = proof["vm_proof"]
            if [int(v) % bb.P for v in vm_proof["pub_inputs"]] != vm_pub:
                raise ValueError("vm proof does not bind this log")
            vm_air = ta.TransferAir()
            if tok_items:
                tok_pub = tka.tok_digest_stream(tok_items)
                tok_proof = proof["tok_proof"]
                if [int(v) % bb.P for v in tok_proof["pub_inputs"]] != \
                        tok_pub:
                    raise ValueError("token proof does not bind this log")
                tok_air = tka.TokenAir()
            if bc_pubs:
                bc_proofs = proof.get("bc_proofs") or []
                if len(bc_proofs) != len(bc_pubs):
                    raise ValueError("generic proof count mismatch")
                for p, pub in zip(bc_proofs, bc_pubs):
                    if [int(v) % bb.P for v in p["pub_inputs"]] != pub:
                        raise ValueError(
                            "generic proof does not bind its steps")
                    bc_airs.append(bca.BytecodeAir())

        limbs = binding_limbs(encoded, r_pre, r_post, digest, vm_pub,
                              tok_pub, bc_pubs)
        bind = proof["proof"]
        if [int(v) for v in bind["pub_inputs"][:len(limbs)]] != limbs:
            raise ValueError("binding proof does not bind this statement")
        bind_air = pair.Poseidon2SpongeAir(num_chunks=len(limbs) // 8)

        airs = [air, bind_air]
        proofs = [state, bind]
        if vm_air is not None:
            airs.append(vm_air)
            proofs.append(vm_proof)
        if tok_air is not None:
            airs.append(tok_air)
            proofs.append(tok_proof)
        airs.extend(bc_airs)
        proofs.extend(bc_proofs)
        return airs, proofs, blocks_log, encoded

    def stark_components(self, proof: dict):
        """The (airs, inner STARK proofs) of a FORMAT_STARK batch proof,
        FRI paths intact, publics validated against the claimed log —
        the raw material l2/aggregator.py feeds into
        stark.aggregate.aggregate_groups for cross-batch recursion."""
        if proof.get("aggregate") is not None:
            raise ValueError("proof is already aggregated: its inner FRI "
                             "paths are gone and cannot be re-aggregated")
        airs, proofs, _, _ = self._reconstruct(proof)
        return airs, proofs

    def _check(self, proof: dict):
        """Shared verification core; returns the parsed raw log + claimed
        output bytes, or raises."""
        airs, proofs, blocks_log, encoded = self._reconstruct(proof)

        agg_info = proof.get("aggregate")
        if agg_info is not None:
            # compressed/groth16: every proof verified through the outer
            # recursion STARK (their FRI paths are gone from the wire)
            agg = agg_mod.AggregateProof(
                inners=proofs, outer=agg_info["outer"],
                max_depth=int(agg_info["max_depth"]),
                seg_periods=int(agg_info["seg_periods"]))
            agg_mod.verify_aggregated(airs, agg, PARAMS)
            wrapped = proof.get("groth16")
            if wrapped is not None:
                if not groth16_wrap.wrap_verify(
                        groth16_wrap.proof_from_json(wrapped),
                        [int(v) for v in agg.outer["pub_inputs"]]):
                    raise ValueError("groth16 wrap rejected")
        else:
            for a, p in zip(airs, proofs):
                if not stark_verifier.verify(a, p, PARAMS):
                    raise ValueError("proof rejected")
        return blocks_log, encoded

    def verify(self, proof: dict) -> bool:
        try:
            self._check(proof)
            return True
        except (KeyError, ValueError, TypeError, IndexError,
                access_log.LogAuditError,
                stark_verifier.VerificationError):
            return False

    def verify_submission(self, proof: dict) -> bool:
        """Structural gate only: the full STARK audit is expensive and
        stays in send_proofs (verify_with_input); at submit time the
        coordinator just needs enough shape to reject wire corruption and
        free the assignment slot for honest provers."""
        try:
            bytes.fromhex(proof["output"][2:])
            return (proof.get("backend") == self.prover_type
                    and isinstance(proof.get("proof"), dict)
                    and isinstance(proof.get("state_proof"), dict)
                    and isinstance(proof.get("write_log"), list))
        except (KeyError, TypeError, ValueError):
            return False

    def check_coverage(self, proof: dict, expected_mode: str) -> bool:
        """Reject mode downgrades WITHOUT the witness: the committer
        derived `expected_mode` by running the same deterministic
        classifier the honest prover runs, so any other mode on the wire
        is a forgery attempt (most importantly claimed-log for a batch
        the circuits cover)."""
        if not expected_mode:
            return True    # pre-metadata batches: no constraint
        vm = proof.get("vm")
        actual = vm.get("mode") if isinstance(vm, dict) else "claimed"
        return actual == expected_mode

    def verify_with_input(self, proof: dict,
                          program_input: ProgramInput) -> bool:
        """Full audit: every STARK + the witness MPT replay (trie ops
        only, no EVM) against the claimed initial/final state roots; in
        vm mode, the claimed tx metadata is REBUILT from the batch's
        signed txs + a re-execution (closing the wire-verifier's
        authenticity gaps: tx list, per-tx gas, and the token template's
        code hash, which build_vm_batch pins against the real pre-state);
        plus a downgrade check: a batch the circuits cover must carry
        the vm proofs.  Runs on the host; no card needed."""
        program_input = _own_input(program_input)
        try:
            blocks_log, encoded = self._check(proof)
            output = ProgramOutput.decode(encoded)
            access_log.replay_log_against_witness(
                blocks_log, program_input.witness.nodes,
                output.initial_state_root, output.final_state_root)
            oracles = WitnessOracles(program_input.witness,
                                     output.initial_state_root)
            vm_meta = proof.get("vm")
            if vm_meta is None:
                # downgrade check: a batch the circuits cover must carry
                # the vm proofs.  The static predicate over-approximates
                # the circuits' scope (a generic-shape call may still
                # leave the executed subset), so on ambiguity re-derive
                # applicability exactly as the prover would.
                if not all(tl_mod.is_plain_transfer(tx)
                           or tl_mod.is_token_call_shape(tx)
                           or tl_mod.is_generic_call_shape(tx)
                           for blk in program_input.blocks
                           for tx in blk.body.transactions):
                    return True
                try:
                    coarse: list = []
                    receipts: list = []
                    execution_program(program_input, write_log=coarse,
                                      receipts_out=receipts)
                    tl_mod.build_vm_batch(program_input.blocks, coarse,
                                          receipts, oracles=oracles)
                except tl_mod.NotTransferBatch:
                    return True
                return False
            # rebuild the vm metadata from the real signed txs and a
            # re-execution; claimed metadata must match it exactly
            try:
                coarse = []
                receipts = []
                execution_program(program_input, write_log=coarse,
                                  receipts_out=receipts)
                rebuilt = tl_mod.build_vm_batch(program_input.blocks,
                                                coarse, receipts,
                                                oracles=oracles)
            except tl_mod.NotTransferBatch:
                return False
            return _vm_meta_json(rebuilt) == vm_meta
        except (KeyError, ValueError, TypeError, IndexError,
                access_log.LogAuditError,
                stark_verifier.VerificationError):
            return False
