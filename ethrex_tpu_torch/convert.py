"""Carry a proof job's inputs across from the JAX package to the port.

The "weights" of this system are the AIR's shape, the trace, the public
inputs and the STARK parameters.  The JAX side hands them over as numpy
arrays and plain Python values; these helpers build the port's objects
from them.  Nothing here imports `ethrex_tpu`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import poseidon2_air as pair
from .models import state_update_air as sua
from .ops import babybear as bb
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
}


def air_from_spec(spec: dict):
    """The port's AIR for a JAX AIR's structure, e.g.
    {"air": "StateUpdateAir", "depth": 2, "seg_periods": 8} or
    {"air": "Poseidon2SpongeAir", "num_chunks": 3}."""
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
