"""Entry point of the port's fused prove step.

`entry()` mirrors the reference's `__graft_entry__.entry()`: the fused
prove step (trace LDE -> Poseidon2 Merkle commit -> DEEP combination ->
FRI fold chain, `parallel/core.py`) at log_n=10, width=16, log_blowup=2,
log_final_size=5, with its example arguments.

    from ethrex_tpu_torch.entry import entry
    step, args = entry()            # on the card
    troot, fri_roots, final_cw = step(*args)
"""

from __future__ import annotations


def entry(device=None):
    """(step_fn, example_args) on `device` (the card unless the caller
    passes device="cpu")."""
    from .parallel.core import build_prove_step

    return build_prove_step(log_n=10, width=16, log_blowup=2,
                            log_final_size=5, device=device)
