"""Carry a proof job's inputs across from the JAX package to the port.

The "weights" of this system are the AIR's shape, the trace, the public
inputs and the STARK parameters.  The JAX side hands them over as numpy
arrays and plain Python values; these helpers build the port's objects
from them.  The proofs travel both ways: STARK proof dicts, aggregate
proofs, and BN254 points and Groth16 proofs (G2 coordinates are Fp2
objects of either package).  Nothing here imports `ethrex_tpu`: where a
conversion builds one of its objects, the caller passes the class.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .crypto import bn254
from .guest import bytecode_vm as bv
from .guest import transfer_log as tl
from .models import bytecode_air as bca
from .models import poseidon2_air as pair
from .models import state_update_air as sua
from .models import token_air as tka
from .models import transfer_air as ta
from .ops import babybear as bb
from .stark.aggregate import AggregateProof
from .stark.prover import StarkParams


def field_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """np.uint32 field elements -> int32 tensor with the same bits."""
    if np.asarray(a).dtype != np.uint32:
        raise TypeError(f"expected uint32 field elements, got {a.dtype}")
    return bb.from_numpy(a, device)


def field_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 field tensor -> np.uint32 with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return bb.to_numpy(t)


_AIRS = {
    "StateUpdateAir": lambda spec: sua.StateUpdateAir(
        int(spec["depth"]), seg_periods=int(spec.get("seg_periods", 16))),
    "Poseidon2SpongeAir": lambda spec: pair.Poseidon2SpongeAir(
        int(spec["num_chunks"])),
    "TransferAir": lambda spec: ta.TransferAir(),
    "TokenAir": lambda spec: tka.TokenAir(),
    "BytecodeAir": lambda spec: bca.BytecodeAir(),
}


def air_from_spec(spec: dict):
    """The port's AIR for a JAX AIR's structure, e.g.
    {"air": "StateUpdateAir", "depth": 2, "seg_periods": 8},
    {"air": "Poseidon2SpongeAir", "num_chunks": 3} or {"air":
    "TransferAir"} (TokenAir and BytecodeAir take no parameters either)."""
    name = spec["air"]
    if name not in _AIRS:
        raise ValueError(f"no port of AIR {name!r} (have {sorted(_AIRS)})")
    return _AIRS[name](spec)


def stark_params(fields: dict) -> StarkParams:
    """StarkParams from the JAX StarkParams' fields (dataclasses.asdict)."""
    names = {f.name for f in dataclasses.fields(StarkParams)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown StarkParams fields {sorted(unknown)}")
    return StarkParams(**{k: int(v) for k, v in fields.items()})


# ---------------------------------------------------------------------------
# VM-mode segments
# ---------------------------------------------------------------------------

def _copy_attrs(cls, seg):
    """A `cls` instance holding `seg`'s attributes (the TxSeg / CbSeg
    constructors take account states; their objects hold limbs)."""
    out = cls.__new__(cls)
    out.__dict__.update({k: (list(v) if isinstance(v, list) else v)
                         for k, v in vars(seg).items()})
    return out


def vm_seg(seg):
    """A TxSeg or CbSeg of either package -> the port's."""
    cls = {"tx": ta.TxSeg, "cb": ta.CbSeg}[seg.kind]
    return _copy_attrs(cls, seg)


def tok_seg(seg):
    """A TokSeg of either package -> the port's."""
    return tl.TokSeg(**{f.name: getattr(seg, f.name)
                        for f in dataclasses.fields(tl.TokSeg)})


def step_rec(step):
    """A bytecode StepRec of either package -> the port's."""
    return bv.StepRec(**{f.name: getattr(step, f.name)
                         for f in dataclasses.fields(bv.StepRec)})


def snapshot(snap):
    """A bytecode Snapshot of either package -> the port's."""
    return bv.Snapshot(stack=tuple(snap.stack), mem=tuple(snap.mem))


def bc_call(call):
    """A BcCall of either package -> the port's."""
    return tl.BcCall(steps=[step_rec(s) for s in call.steps],
                     snaps=[snapshot(s) for s in call.snaps])


def vm_batch(batch):
    """A VmBatch of either package -> the port's (blocks_log and the
    block metadata carried as they are)."""
    return tl.VmBatch(blocks_log=batch.blocks_log,
                      segs=[vm_seg(s) for s in batch.segs],
                      tok_segs=[tok_seg(s) for s in batch.tok_segs],
                      blocks=list(batch.blocks),
                      bc_calls=[bc_call(c) for c in batch.bc_calls])


# ---------------------------------------------------------------------------
# proofs
# ---------------------------------------------------------------------------

def proof_dict(proof: dict) -> dict:
    """A STARK proof dict of either package as plain JSON values (tuples
    become lists); the two packages' provers and verifiers read it."""
    return json.loads(json.dumps(proof))


def aggregate_proof(agg, cls=AggregateProof):
    """An aggregate proof of either package -> `cls` (the port's
    AggregateProof by default; pass the JAX package's class to go back)."""
    return cls(inners=[proof_dict(p) for p in agg.inners],
               outer=proof_dict(agg.outer), max_depth=int(agg.max_depth),
               seg_periods=int(agg.seg_periods))


def g1_point(pt):
    """A G1 point (x, y) or None (infinity), as Python ints."""
    return None if pt is None else (int(pt[0]), int(pt[1]))


def g2_point(pt, fp2=bn254.Fp2):
    """A G2 point (Fp2 x, Fp2 y) or None of either package -> `fp2`
    coordinates (the port's Fp2 by default)."""
    if pt is None:
        return None
    return tuple(fp2(int(c.c0), int(c.c1)) for c in pt)


def groth16_proof(proof: dict, fp2=bn254.Fp2) -> dict:
    """A Groth16 proof {"a": G1, "b": G2, "c": G1} of either package, with
    its G2 coordinates as `fp2`."""
    return {"a": g1_point(proof["a"]), "b": g2_point(proof["b"], fp2),
            "c": g1_point(proof["c"])}
