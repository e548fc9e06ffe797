"""PyTorch/CUDA port of the ethrex_tpu STARK prover.

The JAX package `ethrex_tpu` is the reference; this package mirrors its
module layout (`ops/`, `stark/`, `models/`) and computes the same values
bit for bit.  Field elements are BabyBear residues in Montgomery form held
in `torch.int32` tensors (every value is below p < 2^31, so the bit pattern
equals the uint32 the JAX package holds).  The hot kernels are CUDA C++
under `csrc/`, built at first launch by `kernels/`; on a CPU tensor each
wrapper runs its plain PyTorch version instead.

Nothing here imports `jax` or `ethrex_tpu`: host code the port needs (the
Poseidon2 constants, the challenger, the state tree, the verifier) is kept
as its own copy.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device every public entry point uses unless told otherwise."""
    return torch.device("cuda")


def require_cuda(device=None) -> torch.device:
    """Resolve an entry point's `device=` argument.

    None and "cuda" mean the card.  Asking for the card on a machine
    without one raises: nothing falls back to the CPU unless the caller
    passes device="cpu" explicitly.
    """
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
